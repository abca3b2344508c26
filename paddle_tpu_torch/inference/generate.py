"""KV-cache autoregressive decoding for LlamaForCausalLM.

Counterpart of ``paddle_tpu/inference/generate.py`` on PyTorch and CUDA.
The forward over a statically shaped KV cache is the same: token-major
``(layers, B, max_len, KV, D)`` for MHA, head-major ``(layers, B, KV,
max_len, D)`` for GQA (the decode-attention kernel's layout). Where the
JAX package compiles a ``lax.scan`` into one program, the port runs a
Python loop of eager launches, except for the chunk: on a card,
``decode_chunk`` replays its T steps as one CUDA graph (``_ChunkGraph``).
Each prefill, admission prefill or chunk call counts as one dispatch
(``dispatch_count``), so the serving accounting matches the JAX
package's. The caches are updated in place: the carry is never copied
between steps.

Routing, as in the JAX package: a GQA single-token step (S == 1) with
``flags.use_decode_attention`` goes to the decode-attention kernel
(``ops/kernels/decode_attention.py``; per-row ``(B,)`` positions on the
chunked serving path, int8 K/V tiles under ``int8wk``); prefill and MHA
take the masked dense form. Quantized projections and the head go to the
int8 matmul kernel (``ops/kernels/int8_matmul.py``) when the matmul has
at most 64 rows, else to a matmul against the weight cast to the
activations' dtype, as the JAX package leaves them to XLA.

Positions are a Python int (the whole batch at one offset: prefill, the
fused loop) or a per-row ``(B,)`` tensor (the chunked serving carry,
where rows admitted at different times sit at different offsets).

Sampling (``do_sample``, ``temperature``, ``top_k``, ``top_p``, ``seed``)
draws from the JAX package's key streams (``paddle_tpu_torch/random.py``,
whose threefry hashing is a CUDA kernel on the card): the fused loop and
the per-token path split ONE batch key per step, the chunk splits each
row's own key (``DecodeState.keys``), so a row's draws depend only on its
seed. The temperature clamp, top-k and top-p filter are
``_filter_logits``, the JAX package's.

The serving engine's device admission ring (``AdmissionRing``): an
admission prefill stages its rows' logits and K/V into ring rows
(``ring_admit_prefill``), and the next chunk splices them into the carry
at their slots before its T steps (``_ring_splice``), inside the same
chunk graph. On a card each admission-prefill key (rows, bucket, quant,
ring buffers, every route flag's value: ``flags.route_snapshot()``) runs
eagerly once, then replays one CUDA graph (``_PrefillGraph``).

The serving engine's prefix-cache route admits by host row copy instead:
``admit_prefill`` with a ``prepare`` callback (which copies cached slabs
into the prefill's batch-N caches) replays one CUDA graph a (rows,
bucket, quant, every route flag's value) key on a card; the graph owns those
caches.

Speculative decoding (Leviathan et al., arXiv:2211.17192; ``draft_model=``
a ``LlamaForCausalLM`` or ``"skip:N"``, ``num_speculative_tokens`` K): a
round runs K + 1 draft single-token forwards (the decode-attention kernel
at per-row positions) and one target forward over the K + 1 positions
(the masked dense form, S > 1), then accepts greedily by exact match or,
sampling, by ``u * q(d) < p(d)`` over the filtered distributions with the
residual ``max(p - q, 0)`` correction (``_spec_round``). ``generate`` runs
two prefills and ONE counted decode dispatch (a Python loop of rounds with
a host check between them); a speculative carry's ``decode_chunk`` runs
exactly T rounds, one CUDA graph a key on a card. The JAX package's
``mode="drop"`` writes of the emit buffer go to a dump column that nothing
reads.

Multi-tenant LoRA (``init_decode_state(adapter_idx=)``, the serving
engine's ``adapter_store=``): when the params carry stacked
``lora.<name>.A`` (N+1, d_in, r) / ``.B`` (N+1, r, d_out) tensors, each
projection of a row adds ``(x @ A[i]) @ B[i]`` for the row's adapter
index ``i`` (``DecodeState.adapter_idx``; row 0 of every stack is zeros,
the base model) after its base product, on the int8 routes too (``_mm``).
The head takes no delta; a speculative draft stays base. The gather and
the two batched matmuls are a torch composition, as the JAX package
leaves them to XLA. A captured chunk or prefill graph reads the stacks
through raw pointers, so its key holds their addresses and the graph
holds the tensors: stacks that a hot swap replaces get a new key (one
eager warm-up, then a new capture).

Every entry point (``generate``, ``admit_prefill``, ``init_decode_state``,
``decode_chunk``, ``ring_admit_prefill``, ``ring_admit_draft``) runs
under ``torch.inference_mode()``: the model's parameters are trainable,
and decoding records no autograd graph.

Every dispatch goes through one guard (``LlamaDecoder._dispatch``, the
JAX decoder's ``_counted``), under the JAX package's site names
(``decode.prefill``, ``decode.step``, ``decode.fused``, ``decode.chunk``,
``decode.chunk_step``, ``decode.admit_prefill``, ``decode.spec_demote``,
``spec.prefill``, ``spec.round``, ``spec.decode``; a speculative chunk
uses the plain chunk's site): the fault hook fires before anything
touches the carry, then the count, the obs span with its cost record, and
the work, all inside ``resilient_call``. Because the chunk graphs write
the carry in place, a fault that fires before the work leaves the carry
as it was, and a retry or a lower rung runs on the same carry.
``generate`` walks the JAX package's degradation ladder (speculative ->
chunked -> fused -> per-token); ``spec_demote`` commits a speculative
carry's pending tokens for the plain chunk, and ``_chunk_step`` is the
serving ladder's one-step chunk.

``generate``'s fused loop (prefill plus one ``decode.fused`` dispatch)
is one CUDA graph replay on a card, as the JAX package's is one compiled
program: a key (batch, steps, the sampling statics, the eos, the quant
recipe, the LoRA stacks' addresses, every route flag) runs eagerly at its
first call, captures at its second and replays after. The loop keeps its
positions in a device tensor that the graph advances, and takes the
prefill's logits, the start positions, the key of ``seed`` and the
temperature as inputs copied in, so one graph serves every prompt length
of a batch. The graph owns its caches: the prefill writes into them
(zeroed first), and the tokens come back as a clone. The CPU, the
per-token rung and ``decode_fallback`` stay eager.

Not ported yet (ROADMAP.md queue 1): meshes.
"""

from __future__ import annotations

import collections
import dataclasses
import os
from typing import Any, Optional

import numpy as np
import torch
import torch.nn.functional as F

from paddle_tpu_torch import obs
from paddle_tpu_torch import random as rnd
from paddle_tpu_torch.device import resolve_device
from paddle_tpu_torch.flags import flags
from paddle_tpu_torch.inference.eos import _normalize_eos, _trim_after_eos
from paddle_tpu_torch.models.llama import LlamaConfig, _rope_tables
from paddle_tpu_torch.obs import cost as _cost
from paddle_tpu_torch.ops import kernels as _kernels
from paddle_tpu_torch.ops.kernels import decode_attention as _da
from paddle_tpu_torch.ops.kernels import int8_matmul as _i8
from paddle_tpu_torch.quantization import weight_quantize
from paddle_tpu_torch.quantization.kv_cache import (dequantize_kv,
                                                    is_quantized_kv,
                                                    quant_kv_zeros,
                                                    quantize_kv_rows,
                                                    resolve_decode_quant)
from paddle_tpu_torch.runtime.resilience import (DecodeFailedError,
                                                 DegradationEvent,
                                                 GenerateResult,
                                                 classify_error,
                                                 fault_injector,
                                                 record_event,
                                                 resilient_call)

__all__ = ["LlamaDecoder", "DecodeState", "AdmissionRing"]


def _not_ported(what: str, item: str):
    return NotImplementedError(
        f"{what} is not ported to paddle_tpu_torch yet (ROADMAP.md queue "
        f"1: {item})")


@dataclasses.dataclass
class DecodeState:
    """The re-enterable carry of the chunked decode loop: next-token
    ``logits``, both KV caches (stacked tensors, or ``{"q", "s"}`` dicts
    under ``int8wk``), PER-ROW cache positions, PER-ROW threefry keys
    (each row's draws depend only on its own key), the done mask, per-row
    eos ids (``-1`` = none) and temperatures. ``decode_chunk`` advances it
    by T tokens in one dispatch; the serving engine admits rows into it.

    A SPECULATIVE carry (``init_decode_state(draft_model=...)``) also
    holds the draft's caches, a per-row pending token ``tok`` (emitted but
    not yet in the caches; ``-1`` = pick from ``logits``, a fresh row),
    per-row cumulative ``spec_rounds`` / ``spec_accepted``, the per-row
    speculative switch ``spec_on`` (None = every row) and the host-side
    ``spec`` (``{"ekey", "K"}``). ``logits`` are then the verify logits at
    the pending token's position. ``nv`` is a speculative chunk's output:
    each row's count of valid tokens in the returned buffer.
    ``adapter_idx`` routes each row through its LoRA adapter's deltas (0 =
    base; None = no adapters at all)."""

    logits: torch.Tensor  # (B, V) f32
    kc: Any
    vc: Any
    pos: torch.Tensor     # (B,) int64 — per-row next cache write position
    keys: torch.Tensor    # (B, 2) int32 — per-row uint32 key words
    done: torch.Tensor    # (B,) bool — frozen rows (eos hit / slot free)
    eos: torch.Tensor     # (B,) int64 — per-row eos id, -1 = none
    temp: torch.Tensor    # (B,) f32 — per-row sampling temperature
    dkc: Any = None       # draft caches (speculative carries)
    dvc: Any = None
    tok: Optional[torch.Tensor] = None  # (B,) int64, -1 = pick from logits
    spec_rounds: Optional[torch.Tensor] = None    # (B,) int64, cumulative
    spec_accepted: Optional[torch.Tensor] = None  # (B,) int64, cumulative
    nv: Optional[torch.Tensor] = None   # (B,) int64, valid tokens of a chunk
    adapter_idx: Optional[torch.Tensor] = None   # (B,) int64, 0 = base
    spec_on: Optional[torch.Tensor] = None   # (B,) bool, None = all rows
    spec: Any = None      # host-side: {"ekey", "K"}


def _filter_logits(logits, temperature=1.0, top_k=None, top_p=None):
    """Temperature / top-k / top-p filtering over the last axis, the JAX
    package's ``_filter_logits``: the temperature (a float, or a tensor
    that broadcasts, e.g. (B, 1)) clamped at 1e-6 divides the logits;
    entries below the k-th largest, then those outside the smallest
    nucleus of mass ``top_p``, go to -inf."""
    if isinstance(temperature, torch.Tensor):
        t = temperature.to(logits.dtype)
    else:
        # a device tensor, never a host scalar: CUDA divides by a host
        # scalar through its reciprocal
        t = torch.full((), float(np.float32(temperature)),
                       dtype=logits.dtype, device=logits.device)
    lg = logits / torch.clamp(t, min=float(np.float32(1e-6)))
    if top_k is not None:
        k, V = int(top_k), lg.shape[-1]
        if 0 < k <= V:
            kth = torch.topk(lg, k, dim=-1).values[..., -1:]
        else:    # JAX's clamped index into the ascending sort
            at = min(max(V - k if k > 0 else -k, 0), V - 1)
            kth = torch.sort(lg, dim=-1).values[..., at:at + 1]
        lg = torch.where(lg < kth, float("-inf"), lg)
    if top_p is not None:
        sorted_lg = torch.sort(lg, dim=-1, descending=True).values
        probs = torch.softmax(sorted_lg, dim=-1)
        cum = torch.cumsum(probs, dim=-1)
        # smallest logit still inside the nucleus
        keep_n = ((cum - probs) < float(top_p)).sum(-1, keepdim=True)
        cutoff = sorted_lg.gather(-1, torch.clamp(keep_n - 1, min=0))
        lg = torch.where(lg < cutoff, float("-inf"), lg)
    return lg


def _sample_rows(logits, keys, temp, top_k, top_p):
    """The chunk programs' per-row pick: each row splits its own key
    (``jax.vmap(split)``), keeps the first half and draws from the
    filtered logits with the second. Returns ``(new keys, tokens)``."""
    kk = rnd.split_rows(keys)                       # (B, 2, 2)
    flt = _filter_logits(logits, temp[:, None], top_k, top_p)
    return kk[:, 0], rnd.categorical_rows(kk[:, 1].contiguous(), flt)


def _sample_batch(logits, key, temperature, top_k, top_p):
    """The fused loop's and the per-token path's pick: one batch key,
    split once; a categorical over the whole (B, V) under the second
    half. Returns ``(new key, tokens)``."""
    kk = rnd.split(key)
    return kk[0], rnd.categorical(
        kk[1], _filter_logits(logits, temperature, top_k, top_p))


def _rms(x, w, eps):
    xf = x.float()
    return (xf * torch.rsqrt(xf.pow(2).mean(-1, keepdim=True) + eps)
            ).to(x.dtype) * w


def _rope_at(x, pos, cfg: LlamaConfig, p):
    """Rotate (B, S, H, D) by positions ``pos + [0..S)`` from the tables
    precomputed at init. ``pos``: int, or per-row (B,) tensor."""
    S = x.shape[1]
    d2 = cfg.head_dim // 2
    if isinstance(pos, torch.Tensor):
        idx = pos[:, None] + torch.arange(S, device=x.device)   # (B, S)
        cos = p["rope.cos"][idx].to(x.dtype)[:, :, None, :]
        sin = p["rope.sin"][idx].to(x.dtype)[:, :, None, :]
    else:
        cos = p["rope.cos"][pos:pos + S].to(x.dtype)[None, :, None, :]
        sin = p["rope.sin"][pos:pos + S].to(x.dtype)[None, :, None, :]
    x1, x2 = x[..., :d2], x[..., d2:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], -1)


def _mm(x, p, name, aidx=None):
    """x @ weight, through the int8 weight-only path when the decoder
    quantized this matrix: the int8 matmul kernel for decode-sized row
    counts (at most 64; it keeps the scale in f32 and rounds once), and
    for larger prefills the JAX package's own form, a matmul against the
    weight cast to x's dtype times the scale in x's dtype.

    ``aidx`` (B,) adds each row's LoRA delta when ``p`` holds the stacks
    ``lora.<name>.A`` / ``.B``: ``(x @ A[aidx]) @ B[aidx]`` in the stacks'
    dtype, cast to the base output's dtype and added after the base
    product (``_lora_delta``). Row 0 adds exact zeros."""
    q = p.get(name + ":int8")
    if q is None:
        out = x @ p[name]
    else:
        scale = p[name + ":scale"]
        lead = x.shape[:-1]
        x2 = x.reshape(-1, x.shape[-1])
        if _i8.supported(x2, q):
            out = _i8.int8_matmul(x2.contiguous(), q, scale)
        else:
            out = (x2 @ q.to(x.dtype)) * scale.to(x.dtype)
        out = out.reshape(*lead, q.shape[1])
    if aidx is not None:
        A = p.get("lora." + name + ".A")
        if A is not None:
            d = _lora_delta(x, A, p["lora." + name + ".B"], aidx)
            out = out + d.to(out.dtype)
    return out


def _lora_delta(x, A, B, aidx):
    """Each row's ``(x @ A[i]) @ B[i]``: x (B, d_in) or (B, S, d_in), the
    stacks (N+1, d_in, r) and (N+1, r, d_out) gathered at ``aidx`` (B,),
    two batched matmuls in the stacks' dtype (an f32 stack never on TF32,
    as the JAX package's f32 einsums are exact f32)."""
    xa = x.to(A.dtype)
    flat = xa.dim() == 2
    if flat:
        xa = xa[:, None]
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        d = torch.bmm(torch.bmm(xa, A[aidx]), B[aidx])
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    return d[:, 0] if flat else d


def _lora_stacks(p) -> tuple:
    """The decoder's ``lora.*`` stacks, in name order: what a captured
    graph that reads them must keep alive."""
    return tuple(p[k] for k in sorted(p) if k.startswith("lora."))


def _cache_layer(kc, li: int):
    """One layer's buffer (a view) out of a stacked cache."""
    if is_quantized_kv(kc):
        return {"q": kc["q"][li], "s": kc["s"][li]}
    return kc[li]


def _cache_update(buf, t, pos, head_major: bool) -> None:
    """Write t into ONE layer's cache buffer at [pos, pos+S), in place.
    Head-major: buf (B, KV, L, D), t (B, KV, S, D); token-major: buf
    (B, L, KV, D), t (B, S, KV, D). A quantized buffer quantizes the
    incoming rows by per-row absmax and updates both leaves with the same
    index math."""
    if is_quantized_kv(buf):
        qt = quantize_kv_rows(t)
        _cache_update(buf["q"], qt["q"], pos, head_major)
        _cache_update(buf["s"], qt["s"], pos, head_major)
        return
    S = t.shape[2] if head_major else t.shape[1]
    t = t.to(buf.dtype)
    if isinstance(pos, torch.Tensor):
        rows = torch.arange(t.shape[0], device=buf.device)[:, None]
        idx = pos[:, None] + torch.arange(S, device=buf.device)  # (B, S)
        if head_major:
            buf[rows, :, idx] = t.transpose(1, 2)
        else:
            buf[rows, idx] = t
    elif head_major:
        buf[:, :, pos:pos + S] = t
    else:
        buf[:, pos:pos + S] = t


def _row_scatter(dst, src, idx) -> None:
    """Copy whole batch rows ``src[j] -> dst[idx[j]]`` along the cache
    batch axis (``ndim - 4``: 1 for the stacked caches), in place, over
    both leaves of a quantized cache. The JAX package's ``_row_scatter``
    drops indices past the batch (``mode="drop"``); torch has none, so a
    caller that must drop a row points it at a dump row of ``dst``
    (``AdmissionRing``). Outside a dump row the indices must be distinct:
    ``index_copy_`` with repeated indices is nondeterministic on CUDA."""
    if is_quantized_kv(dst):
        _row_scatter(dst["q"], src["q"], idx)
        _row_scatter(dst["s"], src["s"], idx)
        return
    dst.index_copy_(dst.dim() - 4, idx, src.to(dst.dtype))


def _row_copy(dst, src, slot: int, row: int, head_major: bool) -> None:
    """Copy batch row ``row`` of ``src`` into row ``slot`` of ``dst``
    (stacked caches, both leaves of a quantized one), in place. ``src``
    may be shorter on the length axis (a bucketed prefix slab): its
    columns land at ``[0, src_len)`` and the rest of the row keeps what it
    held, masked until decode overwrites it (the JAX engine's
    ``_admit_row``)."""
    if is_quantized_kv(dst):
        _row_copy(dst["q"], src["q"], slot, row, head_major)
        _row_copy(dst["s"], src["s"], slot, row, head_major)
        return
    ax = 3 if head_major else 2
    dst.narrow(1, slot, 1).narrow(ax, 0, src.shape[ax]).copy_(
        src.narrow(1, row, 1))


def _batch_rows(cache, n: int):
    """The first ``n`` batch rows of a stacked cache, as a view: each
    layer's rows stay contiguous."""
    if is_quantized_kv(cache):
        return {k: v.narrow(1, 0, n) for k, v in cache.items()}
    return cache.narrow(1, 0, n)


def _zero_cache(cache) -> None:
    if is_quantized_kv(cache):
        for v in cache.values():
            v.zero_()
    else:
        cache.zero_()


def _dense_attention(q, kc_l, vc_l, pos, max_len: int, head_major: bool):
    """Masked dense cache attention (prefill, MHA, or the kernel turned
    off): q (B, S, H, D) against one layer's whole cache (dequantized to
    q's dtype), bottom-right causal (query i sees positions <= pos + i).
    The JAX package's arithmetic: products in q's dtype, the softmax in
    f32, the probabilities rounded back to q's dtype."""
    B, S, H, D = q.shape
    dev = q.device
    kk = dequantize_kv(kc_l, q.dtype)
    vv = dequantize_kv(vc_l, q.dtype)
    if isinstance(pos, torch.Tensor):
        qpos = pos.reshape(-1, 1, 1, 1)
    else:
        qpos = pos
    qpos = qpos + torch.arange(S, device=dev)[None, None, :, None]
    mask = torch.arange(max_len, device=dev)[None, None, None, :] <= qpos
    if head_major:
        rep = H // kk.shape[1]
        kk = kk.repeat_interleave(rep, dim=1)
        vv = vv.repeat_interleave(rep, dim=1)
        scores = torch.einsum("bqhd,bhkd->bhqk", q, kk)
    else:
        scores = torch.einsum("bqhd,bkhd->bhqk", q, kk)
    scores = scores / torch.sqrt(torch.full(
        (), float(D), dtype=torch.float32, device=dev)).to(q.dtype)
    scores = torch.where(mask, scores.float(), float("-inf"))
    attn = torch.softmax(scores, dim=-1).to(q.dtype)
    if head_major:
        out = torch.einsum("bhqk,bhkd->bqhd", attn, vv)
    else:
        out = torch.einsum("bhqk,bkhd->bqhd", attn, vv)
    return out.reshape(B, S, H * D)


def _block_forward(p, cfg: LlamaConfig, li: int, h, kc, vc, pos,
                   max_len: int, aidx=None):
    """One decoder block over h (B, S, hidden), writing this step's K/V
    into the cache at [pos, pos+S) before attending over it. ``aidx``
    routes the four projections through each row's LoRA deltas."""
    B, S, _ = h.shape
    H, KV, D = cfg.num_attention_heads, cfg.num_key_value_heads, cfg.head_dim
    pre = f"model.layers.{li}."

    x = _rms(h, p[pre + "input_layernorm.weight"], cfg.rms_norm_eps)
    qkv = _mm(x, p, pre + "self_attn.qkv.weight", aidx)
    q = qkv[..., :H * D].reshape(B, S, H, D)
    k = qkv[..., H * D:H * D + KV * D].reshape(B, S, KV, D)
    v = qkv[..., H * D + KV * D:].reshape(B, S, KV, D)
    q = _rope_at(q, pos, cfg, p)
    k = _rope_at(k, pos, cfg, p)

    head_major = H // KV > 1
    kc_l, vc_l = _cache_layer(kc, li), _cache_layer(vc, li)
    _cache_update(kc_l, k.transpose(1, 2) if head_major else k, pos,
                  head_major)
    _cache_update(vc_l, v.transpose(1, 2) if head_major else v, pos,
                  head_major)

    quant_kv = is_quantized_kv(kc_l)
    kbuf = kc_l["q"] if quant_kv else kc_l
    q1 = q[:, 0]
    if (head_major and S == 1 and flags.use_decode_attention
            and _da.supported(q1, kbuf)):
        q1 = q1.contiguous()
        if quant_kv:
            out = _da.decode_attention(q1, kc_l["q"], vc_l["q"], pos + 1,
                                       k_scale=kc_l["s"],
                                       v_scale=vc_l["s"])
        else:
            out = _da.decode_attention(q1, kc_l, vc_l, pos + 1)
        out = out.reshape(B, S, H * D)
    else:
        out = _dense_attention(q, kc_l, vc_l, pos, max_len, head_major)
    h = h + _mm(out, p, pre + "self_attn.o_proj.weight", aidx)

    x = _rms(h, p[pre + "post_attention_layernorm.weight"],
             cfg.rms_norm_eps)
    gu = _mm(x, p, pre + "mlp.gate_up.weight", aidx)
    f = gu.shape[-1] // 2
    return h + _mm(F.silu(gu[..., :f]) * gu[..., f:], p,
                   pre + "mlp.down_proj.weight", aidx)


def _forward_cached(p, cfg: LlamaConfig, ids, kc, vc, pos, max_len: int,
                    return_all: bool = False, aidx=None):
    """ids (B, S) -> f32 logits of the LAST position (B, V), or of all S
    positions (B, S, V) with ``return_all``; the caches update in place.
    ``aidx`` (B,): per-row LoRA adapter index (projections only: the head
    stays base)."""
    h = p["model.embed_tokens.weight"][ids]
    for li in range(cfg.num_hidden_layers):
        h = _block_forward(p, cfg, li, h, kc, vc, pos, max_len, aidx)
    h = _rms(h, p["model.norm.weight"], cfg.rms_norm_eps)
    hh = h if return_all else h[:, -1]
    if "head:int8" in p:
        return _mm(hh, p, "head").float()
    head = (p["model.embed_tokens.weight"].T if cfg.tie_word_embeddings
            else p["lm_head.weight"])
    return (hh @ head).float()


def _build_params(model, max_len: int, weight_dtype: Optional[str],
                  device) -> dict:
    """Decode-shape a model's weights on ``device``: fused qkv and
    gate_up matmuls, optional int8 weight-only quantization (with a
    dedicated int8 copy of the head), rope tables for the whole cache
    window."""
    cfg = model.config
    raw = {n: t.detach().to(device) for n, t in model.named_parameters()}
    for li in range(cfg.num_hidden_layers):
        pre = f"model.layers.{li}."
        raw[pre + "self_attn.qkv.weight"] = torch.cat(
            [raw.pop(pre + "self_attn.q_proj.weight"),
             raw.pop(pre + "self_attn.k_proj.weight"),
             raw.pop(pre + "self_attn.v_proj.weight")], dim=1)
        raw[pre + "mlp.gate_up.weight"] = torch.cat(
            [raw.pop(pre + "mlp.gate_proj.weight"),
             raw.pop(pre + "mlp.up_proj.weight")], dim=1)
    p = {}
    for name, v in raw.items():
        if (weight_dtype == "int8" and v.ndim == 2
                and ("self_attn." in name or "mlp." in name)):
            p[name + ":int8"], p[name + ":scale"] = weight_quantize(v)
            continue
        p[name] = v
    if weight_dtype == "int8":
        # the head is the single biggest matrix of a step: quantize a
        # dedicated copy (tied: the transposed embedding)
        head = (p["model.embed_tokens.weight"].T if cfg.tie_word_embeddings
                else p.pop("lm_head.weight"))
        p["head:int8"], p["head:scale"] = weight_quantize(head)
    p["rope.cos"], p["rope.sin"] = _rope_tables(
        max_len, cfg.head_dim, cfg.rope_theta, cfg.torch_dtype,
        device=device)
    return p


class LlamaDecoder:
    """Greedy and sampled decoder over a static KV cache.

    ``generate`` runs prefill plus one fused decode loop (2 dispatches),
    or with ``chunk_size=T`` prefill plus ceil(N/T) re-enterable chunks
    (``init_decode_state`` / ``decode_chunk``, the serving substrate);
    greedy tokens are identical either way, sampled ones come from the
    JAX package's streams (one batch key on the fused and per-token
    paths, per-row keys in the chunks). ``dispatch_count`` counts
    prefill, admission-prefill and chunk calls, one each.

    ``quant``: ``"int8w"`` quantizes the projection matrices and a copy
    of the head to per-channel int8 (the int8 matmul kernel streams them
    int8); ``"int8wk"`` also stores the KV cache int8 with per-row
    scales, which the decode-attention kernel dequantizes in registers.
    Default from ``FLAGS_decode_quant`` / ``PADDLE_TPU_DECODE_QUANT``.

    ``device`` defaults to ``cuda`` and raises without a card;
    ``device="cpu"`` runs every kernel's plain version."""

    def __init__(self, model, max_len: int = 512,
                 weight_dtype: Optional[str] = None, mesh=None,
                 partition_rules=None, quant: Optional[str] = None,
                 device=None):
        if mesh is not None or partition_rules is not None:
            raise _not_ported("mesh-sharded decode (mesh=, "
                              "partition_rules=)", "mesh")
        self.device = resolve_device(device)
        self.quant = resolve_decode_quant(quant, weight_dtype)
        self.weight_dtype = "int8" if self.quant else None
        self.quant_kv = self.quant == "int8wk"
        self.cfg = model.config
        self.max_len = int(max_len)
        self._head_major = (self.cfg.num_attention_heads
                            != self.cfg.num_key_value_heads)
        self.params = _build_params(model, self.max_len, self.weight_dtype,
                                    self.device)
        self.dispatch_count = 0
        # retry events of the dispatches (generate() starts it anew; the
        # serving engine reads it by offset)
        self._events: list = []
        self.last_resilience = None
        self.last_spec_stats = None
        # draft-model state of speculative decoding, by draft key
        self._spec_engines: dict = {}
        # chunk / admission-prefill key -> its captured graph, or None
        # after the key's eager warm-up; the oldest keys go first past
        # _CHUNK_GRAPHS / _PREFILL_GRAPHS
        self._chunk_graphs: "collections.OrderedDict[tuple, Any]" = \
            collections.OrderedDict()
        self._prefill_graphs: "collections.OrderedDict[tuple, Any]" = \
            collections.OrderedDict()
        # fused-loop key -> its _PrefillGraph (None after the warm-up);
        # the oldest go first past _FUSED_GRAPHS
        self._fused_graphs: "collections.OrderedDict[tuple, Any]" = \
            collections.OrderedDict()

    # -- buffers -----------------------------------------------------------
    def _empty_cache(self, B: int, cfg: Optional[LlamaConfig] = None):
        """Zeroed stacked caches for B rows, of the target's config or of
        a draft's ``cfg``."""
        cfg = self.cfg if cfg is None else cfg
        KV, D = cfg.num_key_value_heads, cfg.head_dim
        per = ((B, KV, self.max_len, D)
               if cfg.num_attention_heads != KV
               else (B, self.max_len, KV, D))
        shape = (cfg.num_hidden_layers,) + per

        def z():
            if self.quant_kv:
                return quant_kv_zeros(shape, self.device)
            return torch.zeros(shape, dtype=cfg.torch_dtype,
                               device=self.device)
        return z(), z()

    def _ids(self, input_ids) -> torch.Tensor:
        return torch.as_tensor(np.asarray(input_ids), dtype=torch.long,
                               device=self.device)

    def _fwd(self, ids, kc, vc, pos, return_all=False, aidx=None):
        return _forward_cached(self.params, self.cfg, ids, kc, vc, pos,
                               self.max_len, return_all, aidx)

    # -- counted entries: one dispatch each --------------------------------
    def _dispatch(self, site: str, fn, *args, graphed: bool = False,
                  weights=None):
        """The one guard every dispatch goes through (the JAX decoder's
        ``_counted``). Per attempt, in order: the fault hook
        ``fault_injector.on_call(site)``, fired before anything touches
        the carry (a failed attempt is a dispatch that never ran, so the
        counts stay comparable with a run without faults); the count;
        with obs on, the span named after the site with the dispatch's
        cost record and the ``dispatches.<site>`` counter; then the work,
        ``fn(*args)``. The whole is wrapped in ``resilient_call``, whose
        retry events go to ``self._events``. ``graphed``: ``fn`` replays
        CUDA graphs on a card and enters ``_cost.eager_pass`` itself
        around its eager runs; otherwise the whole of ``fn`` is eager.
        ``weights``: the tensors the dispatch reads besides its arguments
        (default the decoder's params), for the cost record's bytes."""
        def work():
            if graphed:
                return fn(*args)
            with _cost.eager_pass(self.device):
                return fn(*args)

        def attempt():
            fault_injector.on_call(site)
            self.dispatch_count += 1
            if not obs.enabled():
                return work()
            with obs.span(site, kind="dispatch") as sp:
                if flags.obs_cost_analysis:
                    with _cost.cost_pass(
                            site, args, weights=(self.params if weights
                                                 is None else weights)
                    ) as cp:
                        out = work()
                    rec = cp.finish(out)
                    if rec:
                        sp.annotate(**rec)
                else:
                    out = work()
            obs.metrics.counter(
                "dispatches." + site,
                "device dispatches executed at this site").inc()
            return out

        return resilient_call(attempt, site=site,
                              on_event=self._events.append)

    def _prefill(self, ids, kc, vc):
        return self._dispatch("decode.prefill", self._fwd, ids, kc, vc, 0)

    def _as_long(self, a) -> Optional[torch.Tensor]:
        """Host ints (or None) as an int64 tensor on the decoder's
        device."""
        if a is None:
            return None
        return torch.as_tensor(np.asarray(a), dtype=torch.long,
                               device=self.device)

    @torch.inference_mode()
    def admit_prefill(self, ids, true_len, pos0, kc=None, vc=None,
                      return_all: bool = False, prepare=None, aidx=None):
        """Length-bucketed admission prefill: ``ids`` (N, bucket) right-
        padded rows land in the cache at ``[pos0, pos0 + bucket)`` per
        row; returns ``(logits, kc, vc)`` with each row's logits taken at
        position ``true_len - 1`` (causal masking hides the padded tail,
        and decode overwrites its cache rows before they could unmask),
        or all positions' logits (N, bucket, V) with ``return_all``.
        ``kc``/``vc`` default to fresh batch-N caches, which ``prepare(kc,
        vc)`` may preload (the prefix cache's slabs) before the forward.
        ``aidx`` (N,) prefills each row through its LoRA adapter's deltas.

        Without caches or ``return_all``, on a card, the first call of a
        key (rows, bucket, quant, the adapter stacks, every route flag)
        runs eagerly, the second captures a CUDA graph and later ones
        replay it: the graph owns its caches, which are zeroed and handed
        to ``prepare`` before each replay, and the returned caches are the
        graph's, valid until the key's next call."""
        ids = self._ids(ids)
        aidx = self._as_long(aidx)
        args = (ids, self._as_long(true_len), self._as_long(pos0), aidx)
        return self._dispatch("decode.admit_prefill", self._admit_run,
                              args, kc, vc, return_all, prepare,
                              graphed=True)

    def _admit_run(self, args, kc, vc, return_all, prepare):
        """``admit_prefill``'s dispatch: a key's graph on a card, else the
        eager forward."""
        ids, aidx = args[0], args[3]
        N, w = ids.shape
        key = ("admit", N, w, self.quant, self._adapter_key(aidx),
               flags.route_snapshot())
        if (kc is None and not return_all and self.device.type == "cuda"
                and not _warm_up(self._prefill_graphs, key,
                                 _PREFILL_GRAPHS)):
            graphs = self._prefill_graphs
            if graphs[key] is None:
                graphs[key] = _PrefillGraph(
                    self, N, lambda ids, tl, p0, a, kc, vc:
                    self._admit_body(ids, tl, p0, kc, vc, a), zero=False)
            g = graphs[key]
            for c in g.caches:
                _zero_cache(c)
            if prepare is not None:
                prepare(*g.caches)
            return (g.run(*args), *g.caches)
        with _cost.eager_pass(self.device):
            if kc is None:
                kc, vc = self._empty_cache(N)
            if prepare is not None:
                prepare(kc, vc)
            if return_all:
                return (self._fwd(ids, kc, vc, args[2], return_all=True,
                                  aidx=aidx), kc, vc)
            return self._admit_body(*args[:3], kc, vc, aidx), kc, vc

    def _adapter_key(self, aidx) -> Optional[tuple]:
        """The adapter part of a graph key: None for a base-only call,
        else the stacks' addresses (a captured graph reads the stacks it
        saw, so replaced stacks need another graph)."""
        if aidx is None:
            return None
        return tuple(t.data_ptr() for t in _lora_stacks(self.params))

    def _admit_body(self, ids, true_len, pos0, kc, vc, aidx=None):
        """``admit_prefill``'s forward: each row's logits at position
        ``true_len - 1``."""
        logits = self._fwd(ids, kc, vc, pos0, return_all=True, aidx=aidx)
        return logits[torch.arange(ids.shape[0], device=ids.device),
                      true_len - 1]

    def _ring_prefill(self, ids, true_len, pos0, idx, kc, vc, ring,
                      aidx=None):
        """``ring_admit_prefill``'s body: prefill ``ids`` into the fresh
        batch-N caches ``kc``/``vc`` (through each row's adapter with
        ``aidx``), then stage each row's logits at position ``true_len -
        1`` and its K/V into ring rows ``idx``."""
        logits = self._admit_body(ids, true_len, pos0, kc, vc, aidx)
        ring.logits.index_copy_(0, idx, logits)
        _row_scatter(ring.kc, kc, idx)
        _row_scatter(ring.vc, vc, idx)

    def _staged(self, site, key, args, body, cfg=None,
                weights=None) -> None:
        """One counted dispatch at ``site`` of a ring-staging prefill
        ``body(*args, kc, vc)`` over fresh batch-N caches (of ``cfg``,
        default the target's): eager on the CPU and at a key's first call
        on a card, then one CUDA graph a key, whose own caches are zeroed
        inside it. An ``args`` entry may be None (no adapters)."""
        self._dispatch(site, self._staged_run, key, args, body, cfg,
                       graphed=True, weights=weights)

    def _staged_run(self, key, args, body, cfg) -> None:
        if self.device.type != "cuda" or _warm_up(self._prefill_graphs,
                                                  key, _PREFILL_GRAPHS):
            with _cost.eager_pass(self.device):
                body(*args, *self._empty_cache(args[0].shape[0], cfg))
            return
        graphs = self._prefill_graphs
        if graphs[key] is None:
            graphs[key] = _PrefillGraph(self, args[0].shape[0], body,
                                        cfg=cfg)
        graphs[key].run(*args)

    @torch.inference_mode()
    def ring_admit_prefill(self, ids, true_len, pos0, ring: "AdmissionRing",
                           ring_idx, aidx=None) -> None:
        """``admit_prefill`` that stages its results on the device: each
        row's logits and K/V land in ring rows ``ring_idx`` (distinct free
        rows) of ``ring`` in the same dispatch, and the next chunk splices
        them into the carry. ``aidx`` (N,) prefills each row through its
        LoRA adapter's deltas. On a card the first call of a key (rows,
        bucket, quant, the ring's buffers, the adapter stacks, every
        route flag's value) runs eagerly, the second captures a CUDA graph and
        later ones replay it: the JAX package's one compiled program per
        (rows, bucket)."""
        ids = self._ids(ids)
        aidx = self._as_long(aidx)
        args = (ids, self._as_long(true_len), self._as_long(pos0),
                self._as_long(ring_idx), aidx)
        N, w = ids.shape
        key = ("ring", N, w, self.quant, ring.addresses(),
               self._adapter_key(aidx), flags.route_snapshot())
        self._staged("decode.admit_prefill", key, args,
                     lambda ids, tl, p0, idx, a, kc, vc:
                     self._ring_prefill(ids, tl, p0, idx, kc, vc, ring, a))

    @torch.inference_mode()
    def ring_admit_draft(self, ids, ring: "AdmissionRing", ring_idx,
                         eng: dict) -> None:
        """The draft's admission prefill, staged into the ring's draft
        caches: one counted dispatch a group (the JAX engine's
        ``ring_admit_draft``), one CUDA graph a key on a card."""
        ids = self._ids(ids)
        idx = self._as_long(ring_idx)
        N, w = ids.shape
        key = ("draft", N, w, self.quant, eng["ekey"], ring.addresses(),
               flags.route_snapshot())

        def body(ids, idx, dkc, dvc):
            _forward_cached(eng["params"], eng["cfg"], ids, dkc, dvc, 0,
                            self.max_len)
            _row_scatter(ring.dkc, dkc, idx)
            _row_scatter(ring.dvc, dvc, idx)
        self._staged("spec.prefill", key, (ids, idx), body, cfg=eng["cfg"],
                     weights=eng["params"])

    def _fused_loop(self, logits, pos, key, temperature, kc, vc,
                    eos: Optional[int], steps: int, sample):
        """The whole token loop (steps forwards, steps + 1 picks) from the
        prefill's ``logits`` and each row's start position ``pos`` (B,),
        which the loop advances on the device; rows that emitted ``eos``
        stay pinned to it. ``sample`` is ``(top_k, top_p)`` for a sampled
        loop, whose one batch ``key`` splits once a pick, at the f32 0-dim
        ``temperature``; greedy passes None for all three. No host sync:
        on a card it is captured as one graph."""
        done = torch.zeros(logits.shape[0], dtype=torch.bool,
                           device=logits.device)

        def pick(logits, key, done):
            if sample is None:
                tok = torch.argmax(logits, -1)
            else:
                key, tok = _sample_batch(logits, key, temperature, *sample)
            if eos is not None:
                tok = torch.where(done, eos, tok)
                done = done | (tok == eos)
            return tok, key, done

        toks = []
        for _ in range(steps):
            tok, key, done = pick(logits, key, done)
            toks.append(tok)
            logits = self._fwd(tok[:, None], kc, vc, pos)
            pos = pos + 1
        toks.append(pick(logits, key, done)[0])
        return torch.stack(toks, 1)

    def _fused_graph(self, key) -> Optional["_PrefillGraph"]:
        """The fused loop's graph holder for ``key``, or None where the
        loop runs eagerly (the CPU; a key's first call on a card)."""
        if self.device.type != "cuda" or _warm_up(self._fused_graphs, key,
                                                  _FUSED_GRAPHS):
            return None
        graphs = self._fused_graphs
        if graphs[key] is None:
            B = key[1]
            graphs[key] = _PrefillGraph(
                self, B, lambda lg, pos, k, t, kc, vc: self._fused_loop(
                    lg, pos, k, t, kc, vc, key[4], key[2], key[3]),
                zero=False)
        return graphs[key]

    def _fused_run(self, g, args, kc, vc, eos, steps, sample):
        """``decode.fused``'s dispatch: a replay of the key's graph ``g``
        (whose caches ``kc``/``vc`` the prefill filled), or the eager
        loop; returns the tokens (B, steps + 1)."""
        if g is not None:
            return g.run(*args).clone()
        with _cost.eager_pass(self.device):
            return self._fused_loop(*args, kc, vc, eos, steps, sample)

    def _chunk_steps(self, st: DecodeState, steps: int, sample=None,
                     ring: Optional["AdmissionRing"] = None):
        """T steps of the token loop over the per-row carry, after the
        ring's splice when ``ring`` is given. Done rows emit their eos (0
        without one); rows past their budget keep stepping to the chunk
        boundary with ``pos`` clamped to the last cache slot, so their
        discarded writes stay inside the buffer. ``sample``: ``(top_k,
        top_p)`` draws each row from its own key; None is greedy."""
        if ring is not None:
            st = _ring_splice(st, ring)
        logits, pos, keys, done, eos = (st.logits, st.pos, st.keys,
                                        st.done, st.eos)
        fill = torch.where(eos >= 0, eos, 0)
        toks = []
        for _ in range(steps):
            if sample is None:
                tok = torch.argmax(logits, -1)
            else:
                keys, tok = _sample_rows(logits, keys, st.temp, *sample)
            tok = torch.where(done, fill, tok)
            done = done | (tok == eos)
            toks.append(tok)
            logits = self._fwd(tok[:, None], st.kc, st.vc, pos,
                               aidx=st.adapter_idx)
            pos = torch.clamp(pos + 1, max=self.max_len - 1)
        return torch.stack(toks, 1), dataclasses.replace(
            st, logits=logits, pos=pos, keys=keys, done=done)

    def _chunk_decode(self, st: DecodeState, steps: int, sample=None,
                      ring: Optional["AdmissionRing"] = None):
        """One counted ``decode.chunk`` dispatch of ``_chunk_steps``. On a
        card, the first chunk of a key (batch, T, quant recipe, the
        caches' addresses, the sampling statics, the ring's buffers, the
        adapter stacks, every route flag's value) runs eagerly; the second
        captures the chunk into a CUDA graph and every later one replays
        it. A failed capture raises."""
        return self._dispatch("decode.chunk", self._chunk_run, st, steps,
                              sample, ring, graphed=True)

    def _chunk_step(self, st: DecodeState, sample=None,
                    ring: Optional["AdmissionRing"] = None):
        """One counted ``decode.chunk_step`` dispatch: a one-step chunk,
        the serving ladder's per-token rung (the JAX ``_chunk_step`` /
        ``_ring_chunk_step``); a key of its own, eager on the CPU and
        graphed on a card like any chunk."""
        return self._dispatch("decode.chunk_step", self._chunk_run, st, 1,
                              sample, ring, graphed=True)

    def _chunk_run(self, st: DecodeState, steps: int, sample, ring):
        key = (st.logits.shape[0], steps, self.quant, _addresses(st.kc),
               _addresses(st.vc), sample,
               None if ring is None else ring.addresses(),
               self._adapter_key(st.adapter_idx), flags.route_snapshot())
        body = lambda s: self._chunk_steps(s, steps, sample, ring)  # noqa
        return self._graphed_chunk(key, st, body, _CARRY, ())

    def _graphed_chunk(self, key, st: DecodeState, body, fields, outs):
        """Run ``body(st)`` eagerly (the CPU; a key's first call on a
        card), or capture it once as a ``_ChunkGraph`` over ``fields`` of
        the carry (plus output-only ``outs``) and replay it."""
        if self.device.type != "cuda" or _warm_up(self._chunk_graphs, key,
                                                  _CHUNK_GRAPHS):
            with _cost.eager_pass(self.device):
                return body(st)
        graphs = self._chunk_graphs
        if graphs[key] is None:
            graphs[key] = _ChunkGraph(st, body, fields, outs,
                                      keep=_lora_stacks(self.params))
        return graphs[key].run(st)

    # -- speculative decoding ----------------------------------------------
    def _resolve_k(self, draft_model, num_speculative_tokens,
                   draft_quant) -> int:
        """The draft length K of a speculative ask (the
        ``decode_speculative_tokens`` flag when not given), or 0 without
        a draft model, after the JAX package's argument checks."""
        if draft_model is None:
            if num_speculative_tokens is not None:
                raise ValueError("num_speculative_tokens requires a "
                                 "draft_model")
            if draft_quant is not None:
                raise ValueError("draft_quant requires a draft_model")
            return 0
        K = int(num_speculative_tokens if num_speculative_tokens is not None
                else flags.decode_speculative_tokens)
        if K < 1:
            raise ValueError(f"num_speculative_tokens must be >= 1, got {K}")
        return K

    def _spec_engine(self, draft_model, draft_quant: Optional[str] = None):
        """The draft side of speculative decoding, cached by draft key:
        ``{"cfg", "params", "ekey"}``. ``draft_model``: a
        ``LlamaForCausalLM`` with the target's vocab (its weights built on
        the decoder's device like the target's), or ``"skip:N"``, the
        target's first N layers with its final norm and head.
        ``draft_quant="int8w"`` quantizes a separate draft's weights only."""
        cfg = self.cfg
        if draft_quant not in (None, "int8w"):
            raise ValueError(
                f"draft_quant must be None or 'int8w', got {draft_quant!r}")
        if isinstance(draft_model, str):
            if not draft_model.startswith("skip:"):
                raise ValueError(
                    "draft_model must be a LlamaForCausalLM or 'skip:N' "
                    f"(layer-skip view of the target), got {draft_model!r}")
            if draft_quant is not None:
                raise ValueError(
                    "draft_quant does not compose with 'skip:N' drafts: "
                    "the layer-skip view reuses the TARGET's params, so "
                    "quantize the target (quant='int8w') instead")
            n = int(draft_model.split(":", 1)[1])
            if not 0 < n < cfg.num_hidden_layers:
                raise ValueError(
                    f"'skip:{n}' needs 0 < N < num_hidden_layers "
                    f"({cfg.num_hidden_layers})")
            ekey = ("skip", n)
        else:
            ekey = ("model", id(draft_model), draft_quant)
        eng = self._spec_engines.get(ekey)
        if eng is not None:
            return eng
        if isinstance(draft_model, str):
            dcfg = dataclasses.replace(cfg, num_hidden_layers=n)
            dp = self.params
        else:
            dcfg = draft_model.config
            if dcfg.vocab_size != cfg.vocab_size:
                raise ValueError(
                    f"draft vocab_size {dcfg.vocab_size} != target "
                    f"vocab_size {cfg.vocab_size}")
            dp = _build_params(draft_model, self.max_len,
                               "int8" if draft_quant else self.weight_dtype,
                               self.device)
        eng = {"cfg": dcfg, "params": dp, "ekey": ekey}
        self._spec_engines[ekey] = eng
        return eng

    def _draft_prefill(self, eng, ids, dkc, dvc) -> None:
        """The draft's prompt prefill: one counted dispatch."""
        self._dispatch("spec.prefill", _forward_cached, eng["params"],
                       eng["cfg"], ids, dkc, dvc, 0, self.max_len,
                       weights=())

    def _spec_round(self, eng, tok, pos, keys, done, kc, vc, dkc, dvc,
                    eos, temp, K: int, sample, spec_on=None, aidx=None):
        """One draft-propose / target-verify / accept round (the JAX
        package's ``_spec_round`` and ``_spec_round_rows`` in one). ``pos``
        (B,) is per row. ``keys``: one batch key (2,) split once a round
        with ``temp`` a float (the fused loop and the per-round path), or
        per-row keys (B, 2) with per-row ``temp`` (B,) (the chunks). ``eos``
        (B,), -1 = none; done rows flush their eos fill at the full K + 1
        rate. ``spec_on`` (B,) bool demotes False rows to verify-free
        decode (acceptance 0, the target's own pick). ``aidx`` (B,) routes
        the TARGET's verify through each row's LoRA deltas; the draft
        stays base (a mismatched draft costs acceptance, never
        correctness: every emitted token is verified). The draft runs K + 1
        single-token forwards (the last keeps its cache whole when every
        proposal is accepted), the target one forward over the K + 1
        positions. Returns ``(emit (B, K + 1), a (B,), tok_next (B,),
        lg_a (B, V), keys, done)``: emit slots ``< a`` hold the accepted
        drafts, slot ``a`` the correction or bonus token; ``lg_a`` are the
        verify logits at each row's accepted position."""
        B = tok.shape[0]
        dev = tok.device
        rows = keys is not None and keys.dim() == 2
        if sample is not None:
            if rows:
                kk = rnd.split_rows(keys)                    # (B, 2, 2)
                keys = kk[:, 0]
                rk = rnd.split_rows(kk[:, 1].contiguous(), 3)
                dkeys = rnd.split_rows(rk[:, 0].contiguous(), K)
                u = rnd.uniform_rows(rk[:, 1].contiguous(), K)
                ckey = rk[:, 2].contiguous()
                t2, t3 = temp[:, None], temp[:, None, None]
                draw = rnd.categorical_rows
            else:
                keys, sub = rnd.split(keys)
                rk = rnd.split(sub, 3)
                dkeys = rnd.split(rk[0], K)
                u = rnd.uniform(rk[1], (B, K))
                ckey = rk[2]
                t2 = t3 = temp
                draw = rnd.categorical
        cur, props, flts = tok, [], []
        for j in range(K + 1):
            lg = _forward_cached(eng["params"], eng["cfg"], cur[:, None],
                                 dkc, dvc, pos + j, self.max_len)
            if j == K:
                break
            if sample is None:
                cur = torch.argmax(lg, -1)
            else:
                flts.append(_filter_logits(lg, t2, *sample))
                cur = draw(dkeys[:, j].contiguous() if rows else dkeys[j],
                           flts[-1])
            props.append(cur)
        props = torch.stack(props, 1)                        # (B, K)
        all_lg = self._fwd(torch.cat([tok[:, None], props], 1), kc, vc,
                           pos, return_all=True, aidx=aidx)  # (B, K+1, V)
        V = all_lg.shape[-1]

        def at(x, idx):     # x (B, n, V) at per-row position idx (B,)
            return x.gather(1, idx.view(B, 1, 1).expand(B, 1, V))[:, 0]

        if sample is not None:
            pprob = torch.softmax(_filter_logits(all_lg, t3, *sample), -1)
            qprob = torch.softmax(torch.stack(flts, 1), -1)  # (B, K, V)
            pd = pprob[:, :K].gather(-1, props[..., None])[..., 0]
            qd = qprob.gather(-1, props[..., None])[..., 0]
            a = torch.cumprod((u * qd < pd).long(), 1).sum(1)
            if spec_on is not None:
                a = torch.where(spec_on, a, 0)
            pa = at(pprob, a)
            resid = torch.clamp(pa - at(qprob, torch.clamp(a, max=K - 1)),
                                min=0.0)
            rs = resid.sum(-1, keepdim=True)
            pos_rs = rs > 0
            resid = torch.where(pos_rs, resid / torch.where(pos_rs, rs, 1.0),
                                pa)
            dist = torch.where((a == K)[:, None], pa, resid)
            if spec_on is not None:
                dist = torch.where(spec_on[:, None], dist, pa)
            corr = draw(ckey, torch.log(dist))
        else:
            tgt = torch.argmax(all_lg, -1)                   # (B, K+1)
            a = torch.cumprod((props == tgt[:, :K]).long(), 1).sum(1)
            if spec_on is not None:
                a = torch.where(spec_on, a, 0)
            corr = tgt.gather(1, a[:, None])[:, 0]
        jidx = torch.arange(K + 1, device=dev)[None, :]
        ext = torch.cat([props, torch.zeros_like(props[:, :1])], 1)
        emit = torch.where(jidx < a[:, None], ext,
                           torch.where(jidx == a[:, None], corr[:, None], 0))
        fill = torch.where(eos >= 0, eos, 0)
        a = torch.where(done, K, a)
        emit = torch.where(done[:, None], fill[:, None], emit)
        valid = jidx <= a[:, None]
        hit = (emit == eos[:, None]) & valid
        after = (torch.cumsum(hit.long(), 1) - hit.long()) > 0
        emit = torch.where(after & valid, fill[:, None], emit)
        done = done | hit.any(1)
        tok_next = emit.gather(1, a[:, None])[:, 0]
        return emit, a, tok_next, at(all_lg, a), keys, done

    def _spec_loop(self, eng, logits, kc, vc, dkc, dvc, S: int,
                   eos: Optional[int], max_new: int, K: int, sample,
                   temperature: float, seed: int):
        """The fused speculative loop: a fresh pick
        from the prefill logits, then rounds until every row holds
        ``max_new`` tokens (a host check between rounds). Each round
        commits a per-row 1..K+1 tokens into a ``(B, max_new + 1)`` buffer
        whose last column takes the writes the JAX package drops. Returns
        ``(buf (B, max_new), rounds, accepted)`` over live rows."""
        B, dev = logits.shape[0], logits.device
        eos_t = torch.full((B,), -1 if eos is None else eos,
                           dtype=torch.long, device=dev)
        done = torch.zeros((B,), dtype=torch.bool, device=dev)
        key = None
        if sample is None:
            tok = torch.argmax(logits, -1)
        else:
            key, tok = _sample_batch(logits, rnd.PRNGKey(seed, device=dev),
                                     temperature, *sample)
        if eos is not None:
            done = tok == eos
        buf = torch.zeros((B, max_new + 1), dtype=torch.long, device=dev)
        buf[:, 0] = tok
        pos = torch.full((B,), S, dtype=torch.long, device=dev)
        jidx = torch.arange(K + 1, device=dev)[None, :]
        sr = torch.zeros((), dtype=torch.long, device=dev)
        sa = torch.zeros((), dtype=torch.long, device=dev)
        while True:
            cnt = pos - S + 1
            active = cnt < max_new
            if not bool(active.any()):
                break
            live = active & ~done
            # a finished row keeps riding the rounds: its (discarded)
            # writes stay where a round still fits the cache
            emit, a, tok2, _, key, done2 = self._spec_round(
                eng, tok, torch.clamp(pos, max=self.max_len - K - 1),
                key, done, kc, vc, dkc, dvc, eos_t, temperature, K, sample)
            sr = sr + live.sum()
            sa = sa + torch.where(live, a, 0).sum()
            idx = cnt[:, None] + jidx
            valid = (jidx <= a[:, None]) & active[:, None] & (idx < max_new)
            buf.scatter_(1, torch.where(valid, idx, max_new), emit)
            pos = torch.where(active, pos + a + 1, pos)
            tok = torch.where(active, tok2, tok)
            done = torch.where(active, done2, done)
        return buf[:, :max_new], int(sr), int(sa)

    def _generate_speculative(self, ids, max_new, eos, sample, temperature,
                              seed, eng, K):
        """Fused speculative decode: prefill (target) + prefill (draft) +
        ONE decode dispatch; records ``last_spec_stats``."""
        B, S = ids.shape
        kc, vc = self._empty_cache(B)
        dkc, dvc = self._empty_cache(B, eng["cfg"])
        logits = self._prefill(ids, kc, vc)
        self._draft_prefill(eng, ids, dkc, dvc)
        buf, sr, sa = self._dispatch("spec.decode", self._spec_loop, eng,
                                     logits, kc, vc, dkc, dvc, S, eos,
                                     max_new, K, sample, temperature, seed)
        self._record_spec_stats(sr, sa, K)
        return buf.cpu().numpy()

    def _generate_speculative_fallback(self, ids, max_new, eos, sample,
                                       temperature, seed, eng, K):
        """One counted dispatch and one host sync per round (the
        ``decode_fallback`` debugging path): the same rounds and key
        stream as the fused loop, so the same tokens."""
        B, S = ids.shape
        dev = self.device
        kc, vc = self._empty_cache(B)
        dkc, dvc = self._empty_cache(B, eng["cfg"])
        logits = self._prefill(ids, kc, vc)
        self._draft_prefill(eng, ids, dkc, dvc)
        eos_t = torch.full((B,), -1 if eos is None else eos,
                           dtype=torch.long, device=dev)
        key = None
        if sample is None:
            tok = torch.argmax(logits, -1)
        else:
            key, tok = _sample_batch(logits, rnd.PRNGKey(seed, device=dev),
                                     temperature, *sample)
        done = (tok == eos) if eos is not None else torch.zeros(
            (B,), dtype=torch.bool, device=dev)
        buf = np.zeros((B, max_new), np.int64)
        buf[:, 0] = tok.cpu().numpy()
        count = np.ones((B,), np.int64)
        pos = torch.full((B,), S, dtype=torch.long, device=dev)
        sr = sa = 0
        while bool((count < max_new).any()):
            active = count < max_new
            live = active & ~done.cpu().numpy()
            emit, a, tok2, _, key, done2 = self._dispatch(
                "spec.round", self._spec_round,
                eng, tok, torch.clamp(pos, max=self.max_len - K - 1),
                key, done, kc, vc, dkc, dvc, eos_t, temperature, K, sample)
            emit_h, a_h = emit.cpu().numpy(), a.cpu().numpy()
            sr += int(live.sum())
            sa += int(a_h[live].sum())
            for b in np.flatnonzero(active):
                n = min(int(a_h[b]) + 1, int(max_new - count[b]))
                buf[b, count[b]:count[b] + n] = emit_h[b, :n]
                count[b] += int(a_h[b]) + 1
            act = torch.as_tensor(active, device=dev)
            pos = torch.where(act, pos + a + 1, pos)
            tok = torch.where(act, tok2, tok)
            done = torch.where(act, done2, done)
        self._record_spec_stats(sr, sa, K)
        return buf

    def _spec_chunk_steps(self, st: DecodeState, steps: int, K: int,
                          sample=None, ring: Optional["AdmissionRing"] = None):
        """Exactly ``steps`` = T speculative rounds over the per-row carry
        (the JAX package's ``spec_chunk``), after the ring's splice when
        ``ring`` is given. Rows without a pending token pick it fresh
        from ``logits`` first. Returns ``(buf (B, T * (K + 1) + 1), new
        state)`` with the new state's ``nv`` each row's valid count; the
        buffer's last column, past every valid count, takes the writes the
        JAX package drops. Rows past their budget keep their writes where
        a full round still fits the cache."""
        if ring is not None:
            st = _ring_splice(st, ring)
        logits, pos, keys, done, eos = (st.logits, st.pos, st.keys,
                                        st.done, st.eos)
        tok, sr, sa, son = (st.tok, st.spec_rounds, st.spec_accepted,
                            st.spec_on)
        eng = self._spec_engines[st.spec["ekey"]]
        B, dev = logits.shape[0], logits.device
        fill = torch.where(eos >= 0, eos, 0)
        need = tok < 0
        if sample is None:
            cand = torch.argmax(logits, -1)
        else:
            keys2, cand = _sample_rows(logits, keys, st.temp, *sample)
            keys = torch.where(need[:, None], keys2, keys)
        cand = torch.where(done, fill, cand)
        done = torch.where(need, done | (cand == eos), done)
        tok = torch.where(need, cand, tok)
        W = steps * (K + 1) + 1
        buf = torch.zeros((B, W + 1), dtype=torch.long, device=dev)
        buf[:, 0] = torch.where(need, tok, 0)
        cnt = need.long()
        jidx = torch.arange(K + 1, device=dev)[None, :]
        for _ in range(steps):
            live = ~done if son is None else ~done & son
            emit, a, tok, logits, keys, done = self._spec_round(
                eng, tok, pos, keys, done, st.kc, st.vc, st.dkc, st.dvc,
                eos, st.temp, K, sample, son, st.adapter_idx)
            buf.scatter_(1, torch.where(jidx <= a[:, None],
                                        cnt[:, None] + jidx, W), emit)
            sr = sr + live.long()
            sa = sa + torch.where(live, a, 0)
            cnt = cnt + a + 1
            pos = torch.clamp(pos + a + 1, max=self.max_len - K - 1)
        return buf[:, :W], dataclasses.replace(
            st, logits=logits, pos=pos, keys=keys, done=done, tok=tok,
            spec_rounds=sr, spec_accepted=sa, nv=cnt)

    def _spec_chunk_decode(self, st: DecodeState, steps: int, K: int,
                           sample=None,
                           ring: Optional["AdmissionRing"] = None):
        """One counted dispatch of ``_spec_chunk_steps``, at the plain
        chunk's site (``decode.chunk``: to the serving ladder and fault
        plans there is one chunk dispatch site, whatever program backs
        it); on a card one CUDA graph a key (batch, T, K, quant, the
        caches' addresses, the draft, the sampling statics, the ring's
        buffers, the adapter stacks, every route flag's value), its first
        call eager."""
        return self._dispatch("decode.chunk", self._spec_chunk_run, st,
                              steps, K, sample, ring, graphed=True)

    def _spec_chunk_run(self, st: DecodeState, steps: int, K: int, sample,
                        ring):
        key = ("spec", st.logits.shape[0], steps, K, self.quant,
               _addresses(st.kc), _addresses(st.vc), _addresses(st.dkc),
               _addresses(st.dvc), st.spec["ekey"], st.spec_on is None,
               sample, None if ring is None else ring.addresses(),
               self._adapter_key(st.adapter_idx), flags.route_snapshot())
        body = lambda s: self._spec_chunk_steps(  # noqa: E731
            s, steps, K, sample, ring)
        return self._graphed_chunk(key, st, body, _SPEC_CARRY, ("nv",))

    @torch.inference_mode()
    def spec_demote(self, st: DecodeState) -> DecodeState:
        """The one-time speculative -> chunked demotion of a live carry
        (the JAX decoder's ``spec_demote``): one counted masked forward
        (``decode.spec_demote``) commits each row's pending token to the
        target caches, giving pick-ready logits and ``pos + 1`` where a
        token was committed; a row with no pending token (``tok < 0``)
        keeps its logits and its ``pos``, and its placeholder write at
        ``pos`` is overwritten by the next real write there before
        attention could unmask it. The draft side of the carry is
        dropped, so the plain chunk serves the state from here on."""
        return self._dispatch("decode.spec_demote", self._spec_demote_body,
                              st)

    def _spec_demote_body(self, st: DecodeState) -> DecodeState:
        need = st.tok >= 0
        lg = self._fwd(torch.where(need, st.tok, 0)[:, None], st.kc, st.vc,
                       st.pos, aidx=st.adapter_idx)
        return dataclasses.replace(
            st, logits=torch.where(need[:, None], lg, st.logits),
            pos=torch.where(need, torch.clamp(st.pos + 1,
                                              max=self.max_len - 1), st.pos),
            dkc=None, dvc=None, tok=None, nv=None, spec=None, spec_on=None)

    def _record_spec_stats(self, rounds: int, accepted: int, K: int):
        self.last_spec_stats = {
            "rounds": rounds,
            "accepted_drafts": accepted,
            # mean accepted drafts per verify round over live rows
            "acceptance_len_mean": (accepted / rounds) if rounds
            else float(K),
            "num_speculative_tokens": K,
        }

    # -- chunked resumable decode ------------------------------------------
    @torch.inference_mode()
    def init_decode_state(self, input_ids, eos_token_id=None,
                          temperature: float = 1.0, seed: int = 0,
                          draft_model=None,
                          num_speculative_tokens: Optional[int] = None,
                          draft_quant: Optional[str] = None,
                          adapter_idx=None,
                          speculative=None) -> DecodeState:
        """Prefill (one dispatch) and build the carry for
        ``decode_chunk``; every row starts from the same prompt tensor.
        Per-row keys are ``split(PRNGKey(seed), B)``, per-row
        temperatures ``temperature``. With ``draft_model`` the carry is
        speculative: the draft's prefilled caches (one more counted
        dispatch), the pending-token sentinel ``tok = -1`` and zeroed
        acceptance counts; ``speculative`` (B,) bools turn rows off
        (verify-free decode in the same chunk). ``adapter_idx`` (B,) ints
        route each row through its LoRA adapter (the params must carry the
        ``lora.*`` stacks, ``serving/lora``): the prefill then runs as the
        admission prefill with every row at its full length, one counted
        dispatch, so each row's prompt K/V is its tenant's."""
        if speculative is not None and draft_model is None:
            raise ValueError("speculative=(B,) row mask requires a "
                             "draft_model")
        K = self._resolve_k(draft_model, num_speculative_tokens,
                            draft_quant)
        eng = self._spec_engine(draft_model, draft_quant) if K else None
        ids = self._ids(input_ids)
        B, S = ids.shape
        kc, vc = self._empty_cache(B)
        aidx = self._as_long(adapter_idx)
        dev = self.device
        if aidx is None:
            logits = self._prefill(ids, kc, vc)
        else:
            logits = self._dispatch(
                "decode.admit_prefill", self._admit_body,
                ids, torch.full((B,), S, dtype=torch.long, device=dev),
                torch.zeros((B,), dtype=torch.long, device=dev), kc, vc,
                aidx)
        eos = _normalize_eos(eos_token_id)
        kw = {"adapter_idx": aidx}
        if eng is not None:
            dkc, dvc = self._empty_cache(B, eng["cfg"])
            self._draft_prefill(eng, ids, dkc, dvc)
            zeros = torch.zeros((B,), dtype=torch.long, device=dev)
            kw.update(dkc=dkc, dvc=dvc, tok=torch.full_like(zeros, -1),
                      spec_rounds=zeros, spec_accepted=zeros.clone(),
                      spec={"ekey": eng["ekey"], "K": K})
            if speculative is not None:
                kw["spec_on"] = torch.as_tensor(
                    np.asarray(speculative, np.bool_), device=dev)
        return DecodeState(
            logits=logits, kc=kc, vc=vc,
            pos=torch.full((B,), S, dtype=torch.long, device=dev),
            keys=rnd.split(rnd.PRNGKey(seed, device=dev), B),
            done=torch.zeros((B,), dtype=torch.bool, device=dev),
            eos=torch.full((B,), -1 if eos is None else eos,
                           dtype=torch.long, device=dev),
            temp=torch.full((B,), float(np.float32(temperature)),
                            dtype=torch.float32, device=dev), **kw)

    @torch.inference_mode()
    def decode_chunk(self, state: DecodeState, num_tokens: int,
                     do_sample: bool = False, top_k: Optional[int] = None,
                     top_p: Optional[float] = None,
                     K: Optional[int] = None):
        """Advance the carry by ``num_tokens`` steps in one dispatch;
        returns ``(tokens (B, num_tokens), new_state)``. ``do_sample``
        draws each row from its own key at its temperature, filtered by
        ``top_k`` / ``top_p`` (which act only when sampling, as in the JAX
        package). A speculative carry runs ``num_tokens`` verify ROUNDS
        instead: the buffer is ``(B, num_tokens * (K + 1) + 1)`` and the
        new state's ``nv`` holds each row's valid count, at least
        ``num_tokens``. ``K`` overrides the carry's draft length for this
        chunk (the adaptive-K hook); a plain carry ignores it."""
        sample = _sample_spec(do_sample, top_k, top_p)
        if state.dkc is not None:
            K = int(state.spec["K"]) if K is None else int(K)
            return self._spec_chunk_decode(state, int(num_tokens), K, sample)
        return self._chunk_decode(state, int(num_tokens), sample)

    def _generate_chunked(self, ids, max_new, eos, sample, temperature,
                          seed, chunk_size):
        T = int(chunk_size)
        if T < 1:
            raise ValueError(f"chunk_size must be >= 1, got {T}")
        state = self.init_decode_state(ids, eos_token_id=eos,
                                       temperature=temperature, seed=seed)
        out, got = [], 0
        while got < max_new:
            toks, state = self._chunk_decode(state, min(T, max_new - got),
                                             sample)
            out.append(toks.cpu().numpy())
            got += out[-1].shape[1]
            if eos is not None and bool(state.done.all()):
                break
        return np.concatenate(out, axis=1)

    def _generate_chunked_spec(self, ids, max_new, eos, sample,
                               temperature, seed, draft_model, draft_quant,
                               K, chunk_size):
        """Chunked speculative decode: two prefills and chunks of
        ``chunk_size`` rounds, each committing a per-row >= T tokens.
        Greedy tokens equal the fused speculative path's for every
        slicing; ``last_spec_stats`` are the carry's cumulative counts."""
        T = int(chunk_size)
        if T < 1:
            raise ValueError(f"chunk_size must be >= 1, got {T}")
        state = self.init_decode_state(
            ids, eos_token_id=eos, temperature=temperature, seed=seed,
            draft_model=draft_model, num_speculative_tokens=K,
            draft_quant=draft_quant)
        B = ids.shape[0]
        buf = np.zeros((B, max_new), np.int64)
        got = np.zeros((B,), np.int64)
        while True:
            toks, state = self._spec_chunk_decode(state, T, K, sample)
            toks_h, nv_h = toks.cpu().numpy(), state.nv.cpu().numpy()
            for b in range(B):
                n = min(int(nv_h[b]), int(max_new - got[b]))
                if n > 0:
                    buf[b, got[b]:got[b] + n] = toks_h[b, :n]
                    got[b] += n
            if bool((got >= max_new).all()):
                break
            if eos is not None and bool(state.done.all()):
                # post-eos columns hold the eos fill, as in the fused path
                for b in range(B):
                    buf[b, got[b]:] = eos
                break
            full = got >= max_new
            if full.any():
                # budget-filled rows freeze: they stop counting rounds
                state = dataclasses.replace(
                    state, done=state.done | torch.as_tensor(
                        full, device=self.device))
        self._record_spec_stats(int(state.spec_rounds.sum()),
                                int(state.spec_accepted.sum()), K)
        return buf

    def _generate_fused(self, ids, max_new, eos, sample, temperature,
                        seed):
        """Prefill, then the fused loop as one counted dispatch: on a card
        one graph replay a key (module docstring), whose own caches the
        prefill writes into."""
        B, S = ids.shape
        steps = max_new - 1
        key = ("fused", B, steps, sample, eos, self.quant,
               tuple(t.data_ptr() for t in _lora_stacks(self.params)),
               flags.route_snapshot())
        g = self._fused_graph(key)
        if g is None:
            kc, vc = self._empty_cache(B)
        else:
            kc, vc = g.caches
            _zero_cache(kc)
            _zero_cache(vc)
        logits = self._prefill(ids, kc, vc)
        pos = torch.full((B,), S, dtype=torch.long, device=self.device)
        if sample is None:
            rkey = temp = None
        else:
            rkey = rnd.PRNGKey(seed, device=self.device)
            temp = torch.full((), float(np.float32(temperature)),
                              dtype=torch.float32, device=self.device)
        return self._dispatch("decode.fused", self._fused_run, g,
                              (logits, pos, rkey, temp), kc, vc, eos, steps,
                              sample, graphed=True).cpu().numpy()

    def _generate_per_token(self, ids, max_new, eos, sample, temperature,
                            seed):
        """One counted dispatch and one host sync per token (the
        ``decode_fallback`` debugging path); returns the new tokens. The
        sampled stream is the fused loop's."""
        B, S = ids.shape
        kc, vc = self._empty_cache(B)
        logits = self._prefill(ids, kc, vc)
        key = None if sample is None else rnd.PRNGKey(seed,
                                                      device=self.device)
        done = np.zeros((B,), bool)
        out = []
        for i in range(max_new):
            if sample is None:
                nxt = torch.argmax(logits, -1)
            else:
                key, nxt = _sample_batch(logits, key, temperature, *sample)
            nxt = nxt.cpu().numpy()
            if eos is not None:
                nxt = np.where(done, eos, nxt)
                done |= nxt == eos
            out.append(nxt[:, None])
            if (eos is not None and done.all()) or i == max_new - 1:
                break
            logits = self._dispatch("decode.step", self._fwd,
                                    self._ids(nxt[:, None]), kc, vc, S + i)
        return np.concatenate(out, axis=1)

    @torch.inference_mode()
    def generate(self, input_ids, max_new_tokens: int = 32,
                 eos_token_id: Optional[int] = None,
                 do_sample: bool = False, temperature: float = 1.0,
                 top_k: Optional[int] = None, top_p: Optional[float] = None,
                 seed: int = 0, draft_model=None,
                 num_speculative_tokens: Optional[int] = None,
                 draft_quant: Optional[str] = None,
                 chunk_size: Optional[int] = None):
        """Decode. input_ids: (B, S) ints. Returns a ``GenerateResult``
        (B, S + new), trimmed after the step where every row has emitted
        ``eos_token_id`` (None or negative = no eos). Greedy by default;
        ``do_sample=True`` draws from the temperature / top-k / top-p
        filtered distribution with the JAX package's key stream for
        ``seed``. ``chunk_size=T`` runs the chunked path (greedy: the same
        tokens; sampled: per-row keys ``split(PRNGKey(seed), B)``, the
        JAX chunked stream). ``draft_model`` (a ``LlamaForCausalLM`` or
        ``"skip:N"``) decodes speculatively with K =
        ``num_speculative_tokens`` (default the
        ``decode_speculative_tokens`` flag) drafts a round: two prefills
        and one decode dispatch (per round with ``decode_fallback``, per
        chunk with ``chunk_size``); greedy tokens equal plain greedy
        decoding, and ``last_spec_stats`` holds the acceptance counts.

        Dispatch failures walk the degradation ladder (the JAX package's:
        speculative -> chunked -> fused -> per-token, each rung present
        as the arguments and ``decode_fallback`` allow) when
        ``FLAGS_resilience_auto_degrade`` is on: a transient error that
        outlives its retries steps down with a ``DegradationEvent``; a
        fatal one propagates as it is; an exhausted ladder (or
        auto-degrade off) dumps the flight recorder's postmortem and
        raises ``DecodeFailedError``. Greedy levels give the same tokens.
        The result's ``.resilience`` (also ``last_resilience``) holds the
        level, the requested level, the retries, the degradations and
        every event."""
        eos = _normalize_eos(eos_token_id)
        ids_np = np.asarray(input_ids)
        B, S = ids_np.shape
        # admission hook: batch-conditional faults fire here, before any
        # device work
        fault_injector.on_call("decode.generate", batch=B)
        if S + max_new_tokens > self.max_len:
            raise ValueError(f"prompt {S} + {max_new_tokens} new tokens "
                             f"exceeds max_len {self.max_len}")
        if max_new_tokens <= 0:
            return ids_np
        K = self._resolve_k(draft_model, num_speculative_tokens,
                            draft_quant)
        sample = _sample_spec(do_sample, top_k, top_p)
        ids = self._ids(ids_np)
        fallback = decode_fallback_active()
        args = (ids, max_new_tokens, eos, sample, temperature, seed)
        ladder = []
        if K:
            if S + max_new_tokens + K > self.max_len:
                raise ValueError(
                    f"speculative decode can overshoot the cache by up to "
                    f"K={K} slots: prompt {S} + {max_new_tokens} new + {K} "
                    f"exceeds max_len {self.max_len}; build the decoder "
                    f"with more slack")
            eng = self._spec_engine(draft_model, draft_quant)
            if chunk_size is not None and not fallback:
                ladder.append(("speculative", lambda: (
                    self._generate_chunked_spec(*args, draft_model,
                                                draft_quant, K,
                                                chunk_size))))
            else:
                gen = (self._generate_speculative_fallback if fallback
                       else self._generate_speculative)
                ladder.append(("speculative", lambda: gen(*args, eng, K)))
        if chunk_size is not None and not fallback:
            ladder.append(("chunked", lambda: self._generate_chunked(
                *args, chunk_size)))
        if not fallback:
            ladder.append(("fused", lambda: self._generate_fused(*args)))
        ladder.append(("per_token",
                       lambda: self._generate_per_token(*args)))

        self._events = []
        self.last_resilience = None
        # cleared before the ladder runs: a speculative rung that fails
        # must not leave an earlier call's acceptance counts behind
        self.last_spec_stats = None
        degradations = []
        toks, level = None, None
        for li, (name, run) in enumerate(ladder):
            try:
                toks = run()
                level = name
                break
            except Exception as e:
                if classify_error(e) != "transient":
                    raise
                if (li == len(ladder) - 1
                        or not flags.resilience_auto_degrade):
                    obs.record_crash(
                        "decode.ladder_exhausted", error=e,
                        extra={"site": "decode.generate",
                               "failed_level": name,
                               "degradations": [d.as_dict()
                                                for d in degradations]})
                    raise DecodeFailedError(
                        f"decode failed at ladder level {name!r} with no "
                        f"further fallback: {str(e)[:300]}",
                        events=list(self._events), last_error=e) from e
                ev = DegradationEvent(
                    site="decode.generate", from_level=name,
                    to_level=ladder[li + 1][0],
                    error_class=type(e).__name__, error=str(e)[:300])
                record_event(ev)
                self._events.append(ev)
                degradations.append(ev)
        if eos is not None:
            toks = _trim_after_eos(toks, eos)
        out = np.concatenate([ids_np, toks.astype(ids_np.dtype)], axis=1)
        self.last_resilience = {
            "level": level,
            "requested_level": ladder[0][0],
            "retries": sum(1 for e in self._events
                           if getattr(e, "kind", "") == "retry"),
            "degradations": [e.as_dict() for e in degradations],
            "events": [e.as_dict() for e in self._events],
        }
        return GenerateResult.wrap(out, self.last_resilience)


# captured graphs a decoder keeps (each holds its own memory pool): chunk
# keys (one per serving carry, and one per K under adaptive K), and
# admission-prefill keys (one per (rows, bucket) and route in serving). On
# an H100 80GB (700 W), chip_smoke.py's prefix line holds 7 prefill keys
# and 5 chunk keys with 3.4-3.7 GB reserved in all, its speculative line
# 7 and 4 with 3.1 GB: the caps leave room for more buckets and for
# adaptive K's 4 keys at the default K.
_CHUNK_GRAPHS = 8
_PREFILL_GRAPHS = 16
# fused generate() loops: one key per (batch, new tokens, sampling, eos)
# a caller uses; each graph owns its batch-B caches. On an H100 80GB
# (700 W), chip_smoke.py's bundle line reserves 323 MB for its 4 fused
# keys (B 8, max_len 256, 95 and 31 steps, unquantized and int8w), about
# 81 MB a key
_FUSED_GRAPHS = 4


def _sample_spec(do_sample: bool, top_k, top_p):
    """The sampling statics of a chunk or loop: ``(top_k, top_p)`` when
    sampling, None for greedy (the filter acts only when sampling)."""
    if not do_sample:
        return None
    return (None if top_k is None else int(top_k),
            None if top_p is None else float(top_p))


def _warm_up(graphs: "collections.OrderedDict", key, keep: int) -> bool:
    """Mark ``key`` used in the LRU ``graphs``; True the first time it is
    seen (its call runs eagerly, the warm-up; the next one captures)."""
    if key not in graphs:
        graphs[key] = None
        while len(graphs) > keep:
            graphs.popitem(last=False)
        return True
    graphs.move_to_end(key)
    return False


def _addresses(cache) -> tuple:
    if is_quantized_kv(cache):
        return cache["q"].data_ptr(), cache["s"].data_ptr()
    return (cache.data_ptr(),)


@dataclasses.dataclass
class AdmissionRing:
    """The device admission ring of a serving carry (the JAX engine's
    ring buffers and splice arguments): R staging rows of logits and K/V,
    which ``LlamaDecoder.ring_admit_prefill`` writes; the per-row splice
    metadata (destination slot, -1 for an empty row; resume position,
    key, eos, temperature), which the host ``load``s before each chunk;
    and the carry's caches with one extra batch row, row B, the dump row
    that empty ring rows write into (``_ring_splice``). A speculative
    carry's ring also stages the draft's caches (``ring_admit_draft``)
    and each row's speculative switch ``son``; a LoRA carry's ring each
    row's adapter index ``aidx``."""

    logits: torch.Tensor   # (R, V) f32
    kc: Any
    vc: Any
    slot: torch.Tensor     # (R,) int64, -1 = empty
    pos: torch.Tensor      # (R,) int64
    keys: torch.Tensor     # (R, 2) int32
    eos: torch.Tensor      # (R,) int64
    temp: torch.Tensor     # (R,) f32
    carry_kc: Any          # the carry's caches, B + 1 batch rows
    carry_vc: Any
    dkc: Any = None        # speculative: staged draft caches, R rows
    dvc: Any = None
    carry_dkc: Any = None  # the carry's draft caches, B + 1 batch rows
    carry_dvc: Any = None
    son: Optional[torch.Tensor] = None   # (R,) bool
    aidx: Optional[torch.Tensor] = None  # (R,) int64, LoRA carries

    @classmethod
    def allocate(cls, dec: LlamaDecoder, R: int, carry_kc, carry_vc,
                 draft_cfg: Optional[LlamaConfig] = None, carry_dkc=None,
                 carry_dvc=None, lora: bool = False):
        dev = dec.device
        kc, vc = dec._empty_cache(R)
        long = dict(dtype=torch.long, device=dev)
        spec = {}
        if lora:
            spec["aidx"] = torch.zeros((R,), **long)
        if draft_cfg is not None:
            dkc, dvc = dec._empty_cache(R, draft_cfg)
            spec.update(dkc=dkc, dvc=dvc, carry_dkc=carry_dkc,
                        carry_dvc=carry_dvc,
                        son=torch.ones((R,), dtype=torch.bool, device=dev))
        return cls(
            logits=torch.zeros((R, dec.cfg.vocab_size), dtype=torch.float32,
                               device=dev),
            kc=kc, vc=vc, slot=torch.full((R,), -1, **long),
            pos=torch.zeros((R,), **long),
            keys=torch.zeros((R, 2), dtype=torch.int32, device=dev),
            eos=torch.full((R,), -1, **long),
            temp=torch.ones((R,), dtype=torch.float32, device=dev),
            carry_kc=carry_kc, carry_vc=carry_vc, **spec)

    def load(self, slot, pos, keys, eos, temp, son=None, aidx=None) -> None:
        """Copy the host's splice metadata (numpy arrays) into the device
        buffers the chunk reads."""
        host = [(self.slot, np.asarray(slot, np.int64)),
                (self.pos, np.asarray(pos, np.int64)),
                (self.keys, np.asarray(keys, np.uint32).view(np.int32)),
                (self.eos, np.asarray(eos, np.int64)),
                (self.temp, np.asarray(temp, np.float32))]
        if son is not None:
            host.append((self.son, np.asarray(son, np.bool_)))
        if aidx is not None:
            host.append((self.aidx, np.asarray(aidx, np.int64)))
        for dst, a in host:
            dst.copy_(torch.from_numpy(a))

    def addresses(self) -> tuple:
        out = (self.logits.data_ptr(), *_addresses(self.kc),
               *_addresses(self.vc), self.slot.data_ptr(),
               *_addresses(self.carry_kc), *_addresses(self.carry_vc))
        if self.dkc is not None:
            out += (*_addresses(self.dkc), *_addresses(self.dvc),
                    *_addresses(self.carry_dkc), *_addresses(self.carry_dvc))
        if self.aidx is not None:
            out += (self.aidx.data_ptr(),)
        return out


def _ring_splice(st: DecodeState, ring: AdmissionRing) -> DecodeState:
    """The ring prologue of the JAX package's ``ring_chunk_decode`` and
    ``spec_chunk``: each staged ring row lands in the carry at its slot
    (K/V, logits, pos, key, eos, temperature, a LoRA carry's adapter
    index; ``done`` cleared; under speculation also the draft's K/V and
    the row's switch, with the pending token and the acceptance counts
    reset). torch has no dropping
    scatter, so the K/V rows go through ``index_copy_`` with empty ring
    rows pointed at the carry caches' dump row B (never read: the carry
    is the first B rows), and the per-row fields through a select over a
    (B, R) match of slots, which leaves unmatched rows as they were. Both
    are capturable and exact."""
    B = st.logits.shape[0]
    slot = ring.slot
    tgt = torch.where(slot >= 0, slot, B)
    _row_scatter(ring.carry_kc, ring.kc, tgt)
    _row_scatter(ring.carry_vc, ring.vc, tgt)
    match = slot[None, :] == torch.arange(B, device=slot.device)[:, None]
    has = match.any(1)
    src = match.to(torch.int32).argmax(1)

    def put(carry, staged):
        sel = has.view(-1, *([1] * (carry.dim() - 1)))
        return torch.where(sel, staged[src], carry)

    spec = {}
    if ring.dkc is not None and st.dkc is not None:
        _row_scatter(ring.carry_dkc, ring.dkc, tgt)
        _row_scatter(ring.carry_dvc, ring.dvc, tgt)
        spec = dict(tok=torch.where(has, -1, st.tok),
                    spec_rounds=torch.where(has, 0, st.spec_rounds),
                    spec_accepted=torch.where(has, 0, st.spec_accepted),
                    spec_on=put(st.spec_on, ring.son))
    if ring.aidx is not None:
        spec["adapter_idx"] = put(st.adapter_idx, ring.aidx)
    return dataclasses.replace(
        st, logits=put(st.logits, ring.logits), pos=put(st.pos, ring.pos),
        keys=put(st.keys, ring.keys), done=st.done & ~has,
        eos=put(st.eos, ring.eos), temp=put(st.temp, ring.temp), **spec)


# the carry fields a captured chunk copies in and clones out (``adapter_idx``
# when the carry has it); a speculative chunk's too (``spec_on`` likewise),
# and its output ``nv``
_CARRY = ("logits", "pos", "keys", "done", "eos", "temp", "adapter_idx")
_SPEC_CARRY = _CARRY + ("tok", "spec_rounds", "spec_accepted", "spec_on")


class _ChunkGraph:
    """A chunk body captured once as a CUDA graph over static copies of
    the small carry ``fields`` (those the carry has) and the caller's KV
    caches themselves, which it updates in place as the eager chunk does
    (the serving engine writes admitted rows into them between chunks).
    ``run`` copies a carry in, replays, and returns clones of the tokens
    and of the output fields (``fields`` plus ``outs``), so an earlier
    ``DecodeState`` keeps its values when a later chunk replays. ``keep``
    holds the tensors the body reads outside the carry that another
    owner may drop (the LoRA stacks), for the graph's lifetime."""

    def __init__(self, st: DecodeState, body, fields, outs=(), keep=()):
        self.keep = keep
        self.fields = tuple(n for n in fields if getattr(st, n) is not None)
        self.outs = self.fields + tuple(outs)
        self.inputs = dataclasses.replace(
            st, **{n: getattr(st, n).clone() for n in self.fields})
        self.graph = torch.cuda.CUDAGraph()
        self.replays = 0
        before = _kernels.launch_counts()
        with _kernels.capture(self.graph,
                              capture_error_mode=_kernels._CAPTURE_MODE):
            self.toks, self.out = body(self.inputs)
        self.launches = _kernels.captured_launches(before)

    def run(self, st: DecodeState):
        for name in self.fields:
            getattr(self.inputs, name).copy_(getattr(st, name))
        self.graph.replay()
        self.replays += 1
        _kernels.add_launches(self.launches)
        return self.toks.clone(), dataclasses.replace(
            st, **{n: getattr(self.out, n).clone() for n in self.outs})


class _PrefillGraph:
    """A body ``body(*args, kc, vc)`` for one key (an admission prefill,
    a staged ring prefill, the fused decode loop) captured as a CUDA graph
    over static copies of its inputs ``args`` and its own batch-N caches
    (of ``cfg``, default the target's), zeroed inside the graph as a
    fresh prefill's are when ``zero``; else the caller prepares them
    before ``run`` (they exist from construction on). Every buffer the
    graph reads or writes lives on this object for the graph's lifetime,
    the decoder's LoRA stacks included. An ``args`` entry may be None
    (passed through). ``run`` captures at its first call, then copies the
    inputs in, replays, and returns the body's output."""

    def __init__(self, dec: LlamaDecoder, N: int, body, cfg=None,
                 zero: bool = True):
        self.keep = _lora_stacks(dec.params)
        self.caches = dec._empty_cache(N, cfg)
        self.body, self.zero = body, zero
        self.graph = None
        self.replays = 0

    def _capture(self, args) -> None:
        self.args = tuple(None if a is None else a.clone() for a in args)
        self.graph = torch.cuda.CUDAGraph()
        before = _kernels.launch_counts()
        with _kernels.capture(self.graph,
                              capture_error_mode=_kernels._CAPTURE_MODE):
            if self.zero:
                for c in self.caches:
                    _zero_cache(c)
            self.out = self.body(*self.args, *self.caches)
        self.launches = _kernels.captured_launches(before)

    def run(self, *args):
        if self.graph is None:
            self._capture(args)
        for dst, src in zip(self.args, args):
            if dst is not None:
                dst.copy_(src)
        self.graph.replay()
        self.replays += 1
        _kernels.add_launches(self.launches)
        return self.out


def decode_fallback_active() -> bool:
    """True when the per-token debugging path is requested, via the
    ``decode_fallback`` flag or the ``PADDLE_TPU_DECODE_FALLBACK`` env."""
    if flags.decode_fallback:
        return True
    return os.environ.get("PADDLE_TPU_DECODE_FALLBACK", "").strip().lower() \
        in ("1", "true", "yes", "on")
