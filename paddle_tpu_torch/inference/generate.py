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
ring buffers, every flag's value) runs eagerly once, then replays one
CUDA graph (``_PrefillGraph``).

Every entry point (``generate``, ``admit_prefill``, ``init_decode_state``,
``decode_chunk``, ``ring_admit_prefill``) runs under
``torch.inference_mode()``: the model's parameters are trainable, and
decoding records no autograd graph.

Not ported yet (ROADMAP.md queue 1): speculative decoding
(``draft_model=``), LoRA (``adapter_idx=``), meshes, the retry and
degradation ladder, a CUDA graph of the fused loop.
"""

from __future__ import annotations

import collections
import dataclasses
import os
from typing import Any, Optional

import numpy as np
import torch
import torch.nn.functional as F

from paddle_tpu_torch import random as rnd
from paddle_tpu_torch.device import resolve_device
from paddle_tpu_torch.flags import flags
from paddle_tpu_torch.models.llama import LlamaConfig, _rope_tables
from paddle_tpu_torch.ops import kernels as _kernels
from paddle_tpu_torch.ops.kernels import decode_attention as _da
from paddle_tpu_torch.ops.kernels import int8_matmul as _i8
from paddle_tpu_torch.quantization import weight_quantize
from paddle_tpu_torch.quantization.kv_cache import (dequantize_kv,
                                                    is_quantized_kv,
                                                    quant_kv_zeros,
                                                    quantize_kv_rows,
                                                    resolve_decode_quant)
from paddle_tpu_torch.runtime.resilience import GenerateResult

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
    by T tokens in one dispatch; the serving engine admits rows into it."""

    logits: torch.Tensor  # (B, V) f32
    kc: Any
    vc: Any
    pos: torch.Tensor     # (B,) int64 — per-row next cache write position
    keys: torch.Tensor    # (B, 2) int32 — per-row uint32 key words
    done: torch.Tensor    # (B,) bool — frozen rows (eos hit / slot free)
    eos: torch.Tensor     # (B,) int64 — per-row eos id, -1 = none
    temp: torch.Tensor    # (B,) f32 — per-row sampling temperature


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


def _mm(x, p, name):
    """x @ weight, through the int8 weight-only path when the decoder
    quantized this matrix: the int8 matmul kernel for decode-sized row
    counts (at most 64; it keeps the scale in f32 and rounds once), and
    for larger prefills the JAX package's own form, a matmul against the
    weight cast to x's dtype times the scale in x's dtype."""
    q = p.get(name + ":int8")
    if q is None:
        return x @ p[name]
    scale = p[name + ":scale"]
    lead = x.shape[:-1]
    x2 = x.reshape(-1, x.shape[-1])
    if _i8.supported(x2, q):
        out = _i8.int8_matmul(x2.contiguous(), q, scale)
    else:
        out = (x2 @ q.to(x.dtype)) * scale.to(x.dtype)
    return out.reshape(*lead, q.shape[1])


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
                   max_len: int):
    """One decoder block over h (B, S, hidden), writing this step's K/V
    into the cache at [pos, pos+S) before attending over it."""
    B, S, _ = h.shape
    H, KV, D = cfg.num_attention_heads, cfg.num_key_value_heads, cfg.head_dim
    pre = f"model.layers.{li}."

    x = _rms(h, p[pre + "input_layernorm.weight"], cfg.rms_norm_eps)
    qkv = _mm(x, p, pre + "self_attn.qkv.weight")
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
    h = h + _mm(out, p, pre + "self_attn.o_proj.weight")

    x = _rms(h, p[pre + "post_attention_layernorm.weight"],
             cfg.rms_norm_eps)
    gu = _mm(x, p, pre + "mlp.gate_up.weight")
    f = gu.shape[-1] // 2
    return h + _mm(F.silu(gu[..., :f]) * gu[..., f:], p,
                   pre + "mlp.down_proj.weight")


def _forward_cached(p, cfg: LlamaConfig, ids, kc, vc, pos, max_len: int,
                    return_all: bool = False):
    """ids (B, S) -> f32 logits of the LAST position (B, V), or of all S
    positions (B, S, V) with ``return_all``; the caches update in place."""
    h = p["model.embed_tokens.weight"][ids]
    for li in range(cfg.num_hidden_layers):
        h = _block_forward(p, cfg, li, h, kc, vc, pos, max_len)
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
        self.last_resilience = None
        # chunk / admission-prefill key -> its captured graph, or None
        # after the key's eager warm-up; the oldest keys go first past
        # _CHUNK_GRAPHS / _PREFILL_GRAPHS
        self._chunk_graphs: "collections.OrderedDict[tuple, Any]" = \
            collections.OrderedDict()
        self._prefill_graphs: "collections.OrderedDict[tuple, Any]" = \
            collections.OrderedDict()

    # -- buffers -----------------------------------------------------------
    def _empty_cache(self, B: int):
        cfg = self.cfg
        KV, D = cfg.num_key_value_heads, cfg.head_dim
        per = ((B, KV, self.max_len, D) if self._head_major
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

    def _fwd(self, ids, kc, vc, pos, return_all=False):
        return _forward_cached(self.params, self.cfg, ids, kc, vc, pos,
                               self.max_len, return_all)

    # -- counted entries: one dispatch each --------------------------------
    def _prefill(self, ids, kc, vc):
        self.dispatch_count += 1
        return self._fwd(ids, kc, vc, 0)

    @torch.inference_mode()
    def admit_prefill(self, ids, true_len, pos0, kc=None, vc=None,
                      return_all: bool = False):
        """Length-bucketed admission prefill: ``ids`` (N, bucket) right-
        padded rows land in the cache at ``[pos0, pos0 + bucket)`` per
        row; returns ``(logits, kc, vc)`` with each row's logits taken at
        position ``true_len - 1`` (causal masking hides the padded tail,
        and decode overwrites its cache rows before they could unmask),
        or all positions' logits (N, bucket, V) with ``return_all``.
        ``kc``/``vc`` default to fresh batch-N caches."""
        ids = self._ids(ids)
        N = ids.shape[0]
        if kc is None:
            kc, vc = self._empty_cache(N)
        true_len = torch.as_tensor(np.asarray(true_len), dtype=torch.long,
                                   device=self.device)
        pos0 = torch.as_tensor(np.asarray(pos0), dtype=torch.long,
                               device=self.device)
        self.dispatch_count += 1
        logits = self._fwd(ids, kc, vc, pos0, return_all=True)
        if not return_all:
            logits = logits[torch.arange(N, device=self.device),
                            true_len - 1]
        return logits, kc, vc

    def _ring_prefill(self, ids, true_len, pos0, kc, vc, ring, idx):
        """``ring_admit_prefill``'s body: prefill ``ids`` into the fresh
        batch-N caches ``kc``/``vc``, then stage each row's logits at
        position ``true_len - 1`` and its K/V into ring rows ``idx``."""
        logits = self._fwd(ids, kc, vc, pos0, return_all=True)
        logits = logits[torch.arange(ids.shape[0], device=ids.device),
                        true_len - 1]
        ring.logits.index_copy_(0, idx, logits)
        _row_scatter(ring.kc, kc, idx)
        _row_scatter(ring.vc, vc, idx)

    @torch.inference_mode()
    def ring_admit_prefill(self, ids, true_len, pos0, ring: "AdmissionRing",
                           ring_idx) -> None:
        """``admit_prefill`` that stages its results on the device: each
        row's logits and K/V land in ring rows ``ring_idx`` (distinct free
        rows) of ``ring`` in the same dispatch, and the next chunk splices
        them into the carry. On a card the first call of a key (rows,
        bucket, quant, the ring's buffers, every flag's value) runs
        eagerly, the second captures a CUDA graph and later ones replay
        it: the JAX package's one compiled program per (rows, bucket)."""
        ids = self._ids(ids)
        as_long = lambda a: torch.as_tensor(     # noqa: E731
            np.asarray(a), dtype=torch.long, device=self.device)
        args = (ids, as_long(true_len), as_long(pos0), as_long(ring_idx))
        self.dispatch_count += 1
        N, w = ids.shape
        key = (N, w, self.quant, ring.addresses(), flags.snapshot())
        if self.device.type != "cuda" or _warm_up(self._prefill_graphs,
                                                  key, _PREFILL_GRAPHS):
            kc, vc = self._empty_cache(N)
            self._ring_prefill(args[0], args[1], args[2], kc, vc, ring,
                               args[3])
            return
        graphs = self._prefill_graphs
        if graphs[key] is None:
            graphs[key] = _PrefillGraph(self, ring, N, w)
        graphs[key].run(*args)

    def _fused_decode(self, logits, kc, vc, pos0: int, eos: Optional[int],
                      steps: int, sample, temperature: float, seed: int):
        """The whole token loop (steps forwards, steps + 1 picks); rows
        that emitted ``eos`` stay pinned to it. ``sample`` is ``(top_k,
        top_p)`` for a sampled loop, whose one batch key splits once a
        pick, or None for greedy."""
        self.dispatch_count += 1
        done = torch.zeros(logits.shape[0], dtype=torch.bool,
                           device=self.device)
        key = None if sample is None else rnd.PRNGKey(seed,
                                                      device=self.device)

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
        for i in range(steps):
            tok, key, done = pick(logits, key, done)
            toks.append(tok)
            logits = self._fwd(tok[:, None], kc, vc, pos0 + i)
        toks.append(pick(logits, key, done)[0])
        return torch.stack(toks, 1)

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
            logits = self._fwd(tok[:, None], st.kc, st.vc, pos)
            pos = torch.clamp(pos + 1, max=self.max_len - 1)
        return torch.stack(toks, 1), dataclasses.replace(
            st, logits=logits, pos=pos, keys=keys, done=done)

    def _chunk_decode(self, st: DecodeState, steps: int, sample=None,
                      ring: Optional["AdmissionRing"] = None):
        """One counted dispatch of ``_chunk_steps``. On a card, the first
        chunk of a key (batch, T, quant recipe, the caches' addresses, the
        sampling statics, the ring's buffers, every flag's value) runs
        eagerly; the second captures the chunk into a CUDA graph and every
        later one replays it. A failed capture raises."""
        self.dispatch_count += 1
        key = (st.logits.shape[0], steps, self.quant, _addresses(st.kc),
               _addresses(st.vc), sample,
               None if ring is None else ring.addresses(), flags.snapshot())
        if self.device.type != "cuda" or _warm_up(self._chunk_graphs, key,
                                                  _CHUNK_GRAPHS):
            return self._chunk_steps(st, steps, sample, ring)
        graphs = self._chunk_graphs
        if graphs[key] is None:
            graphs[key] = _ChunkGraph(self, st, steps, sample, ring)
        return graphs[key].run(st)

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
        temperatures ``temperature``. The JAX package's signature: a
        ``draft_model`` and ``adapter_idx`` are refused as not ported; the
        speculative arguments without a draft model raise the reference's
        ``ValueError``."""
        if speculative is not None and draft_model is None:
            raise ValueError("speculative=(B,) row mask requires a "
                             "draft_model")
        _check_speculative(draft_model, num_speculative_tokens, draft_quant)
        if adapter_idx is not None:
            raise _not_ported("LoRA routing (adapter_idx=)", "LoRA")
        ids = self._ids(input_ids)
        B, S = ids.shape
        kc, vc = self._empty_cache(B)
        logits = self._prefill(ids, kc, vc)
        eos = _normalize_eos(eos_token_id)
        dev = self.device
        return DecodeState(
            logits=logits, kc=kc, vc=vc,
            pos=torch.full((B,), S, dtype=torch.long, device=dev),
            keys=rnd.split(rnd.PRNGKey(seed, device=dev), B),
            done=torch.zeros((B,), dtype=torch.bool, device=dev),
            eos=torch.full((B,), -1 if eos is None else eos,
                           dtype=torch.long, device=dev),
            temp=torch.full((B,), float(np.float32(temperature)),
                            dtype=torch.float32, device=dev))

    @torch.inference_mode()
    def decode_chunk(self, state: DecodeState, num_tokens: int,
                     do_sample: bool = False, top_k: Optional[int] = None,
                     top_p: Optional[float] = None,
                     K: Optional[int] = None):
        """Advance the carry by ``num_tokens`` steps in one dispatch;
        returns ``(tokens (B, num_tokens), new_state)``. ``do_sample``
        draws each row from its own key at its temperature, filtered by
        ``top_k`` / ``top_p`` (which act only when sampling, as in the JAX
        package). A speculative draft length ``K`` is refused as not
        ported."""
        if K is not None:
            raise _not_ported("speculative chunks (K=)",
                              "speculative serving")
        return self._chunk_decode(state, int(num_tokens),
                                  _sample_spec(do_sample, top_k, top_p))

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

    def _generate_fused(self, ids, max_new, eos, sample, temperature,
                        seed):
        B, S = ids.shape
        kc, vc = self._empty_cache(B)
        logits = self._prefill(ids, kc, vc)
        return self._fused_decode(logits, kc, vc, S, eos, max_new - 1,
                                  sample, temperature, seed).cpu().numpy()

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
            self.dispatch_count += 1
            logits = self._fwd(self._ids(nxt[:, None]), kc, vc, S + i)
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
        JAX chunked stream). A ``draft_model`` is refused as not ported,
        after the reference's own checks (``max_len``, then the
        speculative arguments without a draft model)."""
        eos = _normalize_eos(eos_token_id)
        ids_np = np.asarray(input_ids)
        B, S = ids_np.shape
        if S + max_new_tokens > self.max_len:
            raise ValueError(f"prompt {S} + {max_new_tokens} new tokens "
                             f"exceeds max_len {self.max_len}")
        if max_new_tokens <= 0:
            return ids_np
        _check_speculative(draft_model, num_speculative_tokens, draft_quant)
        sample = _sample_spec(do_sample, top_k, top_p)
        ids = self._ids(ids_np)
        if decode_fallback_active():
            level = "per_token"
            toks = self._generate_per_token(ids, max_new_tokens, eos,
                                            sample, temperature, seed)
        elif chunk_size is not None:
            level = "chunked"
            toks = self._generate_chunked(ids, max_new_tokens, eos, sample,
                                          temperature, seed, chunk_size)
        else:
            level = "fused"
            toks = self._generate_fused(ids, max_new_tokens, eos, sample,
                                        temperature, seed)
        if eos is not None:
            toks = _trim_after_eos(toks, eos)
        out = np.concatenate([ids_np, toks.astype(ids_np.dtype)], axis=1)
        self.last_resilience = {"level": level, "requested_level": level,
                                "retries": 0, "degradations": [],
                                "events": []}
        return GenerateResult.wrap(out, self.last_resilience)


# captured graphs a decoder keeps (each holds its own memory pool): chunk
# keys, and admission-prefill keys (one per prompt bucket in serving)
_CHUNK_GRAPHS = 4
_PREFILL_GRAPHS = 8


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
    that empty ring rows write into (``_ring_splice``)."""

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

    @classmethod
    def allocate(cls, dec: LlamaDecoder, R: int, carry_kc, carry_vc):
        dev = dec.device
        kc, vc = dec._empty_cache(R)
        long = dict(dtype=torch.long, device=dev)
        return cls(
            logits=torch.zeros((R, dec.cfg.vocab_size), dtype=torch.float32,
                               device=dev),
            kc=kc, vc=vc, slot=torch.full((R,), -1, **long),
            pos=torch.zeros((R,), **long),
            keys=torch.zeros((R, 2), dtype=torch.int32, device=dev),
            eos=torch.full((R,), -1, **long),
            temp=torch.ones((R,), dtype=torch.float32, device=dev),
            carry_kc=carry_kc, carry_vc=carry_vc)

    def load(self, slot, pos, keys, eos, temp) -> None:
        """Copy the host's splice metadata (numpy arrays) into the device
        buffers the chunk reads."""
        host = (np.asarray(slot, np.int64), np.asarray(pos, np.int64),
                np.asarray(keys, np.uint32).view(np.int32),
                np.asarray(eos, np.int64), np.asarray(temp, np.float32))
        for dst, a in zip((self.slot, self.pos, self.keys, self.eos,
                           self.temp), host):
            dst.copy_(torch.from_numpy(a))

    def addresses(self) -> tuple:
        return (self.logits.data_ptr(), *_addresses(self.kc),
                *_addresses(self.vc), self.slot.data_ptr(),
                *_addresses(self.carry_kc), *_addresses(self.carry_vc))


def _ring_splice(st: DecodeState, ring: AdmissionRing) -> DecodeState:
    """The ring prologue of the JAX package's ``ring_chunk_decode``: each
    staged ring row lands in the carry at its slot (K/V, logits, pos,
    key, eos, temperature; ``done`` cleared). torch has no dropping
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

    return dataclasses.replace(
        st, logits=put(st.logits, ring.logits), pos=put(st.pos, ring.pos),
        keys=put(st.keys, ring.keys), done=st.done & ~has,
        eos=put(st.eos, ring.eos), temp=put(st.temp, ring.temp))


# the carry fields a captured chunk copies in and clones out
_CARRY = ("logits", "pos", "keys", "done", "eos", "temp")


class _ChunkGraph:
    """``_chunk_steps`` captured once as a CUDA graph over static copies
    of the small carry (``_CARRY``) and the caller's KV caches themselves,
    which it updates in place as the eager chunk does (the serving engine
    writes admitted rows into them between chunks). ``run`` copies a
    carry in, replays, and returns clones of the outputs, so an earlier
    ``DecodeState`` keeps its values when a later chunk replays."""

    def __init__(self, dec: LlamaDecoder, st: DecodeState, steps: int,
                 sample, ring: Optional[AdmissionRing]):
        self.inputs = dataclasses.replace(
            st, **{n: getattr(st, n).clone() for n in _CARRY})
        self.graph = torch.cuda.CUDAGraph()
        before = _kernels.launch_counts()
        with torch.cuda.graph(self.graph):
            self.toks, self.out = dec._chunk_steps(self.inputs, steps,
                                                   sample, ring)
        self.launches = _kernels.captured_launches(before)

    def run(self, st: DecodeState):
        for name in _CARRY:
            getattr(self.inputs, name).copy_(getattr(st, name))
        self.graph.replay()
        _kernels.add_launches(self.launches)
        return self.toks.clone(), dataclasses.replace(
            st, **{n: getattr(self.out, n).clone() for n in _CARRY})


class _PrefillGraph:
    """``ring_admit_prefill`` for one (rows, bucket) captured as a CUDA
    graph over static inputs (ids, true lengths, start positions, ring
    rows) and its own batch-N caches, zeroed inside the graph as a fresh
    prefill's are. ``run`` copies the inputs in and replays."""

    def __init__(self, dec: LlamaDecoder, ring: AdmissionRing, N: int,
                 w: int):
        long = dict(dtype=torch.long, device=dec.device)
        self.args = (torch.zeros((N, w), **long), torch.ones((N,), **long),
                     torch.zeros((N,), **long), torch.zeros((N,), **long))
        ids, true_len, pos0, idx = self.args
        # held for the graph's lifetime: it reads and writes them
        self.caches = kc, vc = dec._empty_cache(N)
        self.graph = torch.cuda.CUDAGraph()
        before = _kernels.launch_counts()
        with torch.cuda.graph(self.graph):
            _zero_cache(kc)
            _zero_cache(vc)
            dec._ring_prefill(ids, true_len, pos0, kc, vc, ring, idx)
        self.launches = _kernels.captured_launches(before)

    def run(self, *args) -> None:
        for dst, src in zip(self.args, args):
            dst.copy_(src)
        self.graph.replay()
        _kernels.add_launches(self.launches)


def _check_speculative(draft_model, num_speculative_tokens,
                       draft_quant) -> None:
    """The reference's checks of the speculative arguments: without a
    draft model, ``num_speculative_tokens`` or ``draft_quant`` is a
    ``ValueError``; a draft model itself is not ported."""
    if draft_model is not None:
        raise _not_ported("speculative decoding (draft_model=)",
                          "speculative serving")
    if num_speculative_tokens is not None:
        raise ValueError("num_speculative_tokens requires a draft_model")
    if draft_quant is not None:
        raise ValueError("draft_quant requires a draft_model")


def decode_fallback_active() -> bool:
    """True when the per-token debugging path is requested, via the
    ``decode_fallback`` flag or the ``PADDLE_TPU_DECODE_FALLBACK`` env."""
    if flags.decode_fallback:
        return True
    return os.environ.get("PADDLE_TPU_DECODE_FALLBACK", "").strip().lower() \
        in ("1", "true", "yes", "on")


def _normalize_eos(eos_token_id) -> Optional[int]:
    """``None`` or any negative id (the bundles' ``-1``) means no eos."""
    if eos_token_id is None:
        return None
    e = int(eos_token_id)
    return None if e < 0 else e


def _trim_after_eos(toks: np.ndarray, eos_token_id: int) -> np.ndarray:
    """Drop columns past the point where every row has emitted eos; a row
    whose first token is eos keeps length 1."""
    hit = toks == eos_token_id
    n = toks.shape[1]
    first = np.where(hit.any(axis=1), hit.argmax(axis=1), n - 1)
    return toks[:, :int(first.max()) + 1]
