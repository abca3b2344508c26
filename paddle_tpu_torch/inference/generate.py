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

Every entry point (``generate``, ``admit_prefill``, ``init_decode_state``,
``decode_chunk``) runs under ``torch.inference_mode()``: the model's
parameters are trainable, and decoding records no autograd graph.

Not ported yet (ROADMAP.md queue 1): sampling (``do_sample=True`` needs a
threefry2x32 matching ``jax.random`` bit for bit), speculative decoding
(``draft_model=``), LoRA (``adapter_idx=``), meshes, the retry and
degradation ladder, CUDA graphs of the fused loop and of prefills.
"""

from __future__ import annotations

import collections
import dataclasses
import os
from typing import Any, Optional

import numpy as np
import torch
import torch.nn.functional as F

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

__all__ = ["LlamaDecoder", "DecodeState"]


def _not_ported(what: str, item: str):
    return NotImplementedError(
        f"{what} is not ported to paddle_tpu_torch yet (ROADMAP.md queue "
        f"1: {item})")


@dataclasses.dataclass
class DecodeState:
    """The re-enterable carry of the chunked decode loop: next-token
    ``logits``, both KV caches (stacked tensors, or ``{"q", "s"}`` dicts
    under ``int8wk``), PER-ROW cache positions, the done mask and per-row
    eos ids (``-1`` = none). ``decode_chunk`` advances it by T tokens in
    one dispatch; the serving engine copies admitted rows into it."""

    logits: torch.Tensor  # (B, V) f32
    kc: Any
    vc: Any
    pos: torch.Tensor     # (B,) int64 — per-row next cache write position
    done: torch.Tensor    # (B,) bool — frozen rows (eos hit / slot free)
    eos: torch.Tensor     # (B,) int64 — per-row eos id, -1 = none


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
    """Greedy decoder over a static KV cache.

    ``generate`` runs prefill plus one fused decode loop (2 dispatches),
    or with ``chunk_size=T`` prefill plus ceil(N/T) re-enterable chunks
    (``init_decode_state`` / ``decode_chunk``, the serving substrate);
    greedy tokens are identical either way. ``dispatch_count`` counts
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
        # chunk key -> its _ChunkGraph, or None after the key's eager
        # warm-up chunk; the oldest keys go first past _CHUNK_GRAPHS
        self._chunk_graphs: "collections.OrderedDict[tuple, Any]" = \
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

    def _fused_decode(self, logits, kc, vc, pos0: int, eos: Optional[int],
                      steps: int):
        """The whole greedy token loop (steps forwards, steps + 1 picks);
        rows that emitted ``eos`` stay pinned to it."""
        self.dispatch_count += 1
        done = torch.zeros(logits.shape[0], dtype=torch.bool,
                           device=self.device)

        def pick(logits, done):
            tok = torch.argmax(logits, -1)
            if eos is not None:
                tok = torch.where(done, eos, tok)
                done = done | (tok == eos)
            return tok, done

        toks = []
        for i in range(steps):
            tok, done = pick(logits, done)
            toks.append(tok)
            logits = self._fwd(tok[:, None], kc, vc, pos0 + i)
        toks.append(pick(logits, done)[0])
        return torch.stack(toks, 1)

    def _chunk_steps(self, st: DecodeState, steps: int):
        """T steps of the greedy loop over the per-row carry. Done rows
        emit their eos (0 without one); rows past their budget keep
        stepping to the chunk boundary with ``pos`` clamped to the last
        cache slot, so their discarded writes stay inside the buffer."""
        logits, pos, done, eos = st.logits, st.pos, st.done, st.eos
        fill = torch.where(eos >= 0, eos, 0)
        toks = []
        for _ in range(steps):
            tok = torch.where(done, fill, torch.argmax(logits, -1))
            done = done | (tok == eos)
            toks.append(tok)
            logits = self._fwd(tok[:, None], st.kc, st.vc, pos)
            pos = torch.clamp(pos + 1, max=self.max_len - 1)
        return torch.stack(toks, 1), dataclasses.replace(
            st, logits=logits, pos=pos, done=done)

    def _chunk_decode(self, st: DecodeState, steps: int):
        """One counted dispatch of ``_chunk_steps``. On a card, the first
        chunk of a key (batch, T, quant recipe, the caches' addresses,
        every flag's value) runs eagerly; the second captures the chunk
        into a CUDA graph and every later one replays it. A failed capture
        raises."""
        self.dispatch_count += 1
        if self.device.type != "cuda":
            return self._chunk_steps(st, steps)
        key = (st.logits.shape[0], steps, self.quant, _addresses(st.kc),
               _addresses(st.vc), flags.snapshot())
        graphs = self._chunk_graphs
        if key not in graphs:
            graphs[key] = None
            while len(graphs) > _CHUNK_GRAPHS:
                graphs.popitem(last=False)
            return self._chunk_steps(st, steps)
        graphs.move_to_end(key)
        if graphs[key] is None:
            graphs[key] = _ChunkGraph(self, st, steps)
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
        The JAX package's signature: the greedy carry holds no per-row
        temperature or keys, so ``temperature`` and ``seed`` other than
        their defaults, a ``draft_model`` and ``adapter_idx`` are refused
        as not ported; the speculative arguments without a draft model
        raise the reference's ``ValueError``."""
        if speculative is not None and draft_model is None:
            raise ValueError("speculative=(B,) row mask requires a "
                             "draft_model")
        _check_speculative(draft_model, num_speculative_tokens, draft_quant)
        if temperature != 1.0 or seed != 0:
            raise _not_ported("per-row sampling state (temperature=, "
                              "seed=)", "threefry sampling")
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
            done=torch.zeros((B,), dtype=torch.bool, device=dev),
            eos=torch.full((B,), -1 if eos is None else eos,
                           dtype=torch.long, device=dev))

    @torch.inference_mode()
    def decode_chunk(self, state: DecodeState, num_tokens: int,
                     do_sample: bool = False, top_k: Optional[int] = None,
                     top_p: Optional[float] = None,
                     K: Optional[int] = None):
        """Advance the carry by ``num_tokens`` greedy steps in one
        dispatch; returns ``(tokens (B, num_tokens), new_state)``. The JAX
        package's signature: sampling (``do_sample``, ``top_k``,
        ``top_p``) and a speculative draft length ``K`` are refused as not
        ported."""
        if do_sample or top_k is not None or top_p is not None:
            raise _not_ported("sampling (do_sample=, top_k=, top_p=)",
                              "threefry sampling")
        if K is not None:
            raise _not_ported("speculative chunks (K=)",
                              "speculative serving")
        return self._chunk_decode(state, int(num_tokens))

    def _generate_chunked(self, ids, max_new, eos, chunk_size):
        T = int(chunk_size)
        if T < 1:
            raise ValueError(f"chunk_size must be >= 1, got {T}")
        state = self.init_decode_state(ids, eos_token_id=eos)
        out, got = [], 0
        while got < max_new:
            toks, state = self.decode_chunk(state, min(T, max_new - got))
            out.append(toks.cpu().numpy())
            got += out[-1].shape[1]
            if eos is not None and bool(state.done.all()):
                break
        return np.concatenate(out, axis=1)

    def _generate_fused(self, ids, max_new, eos):
        B, S = ids.shape
        kc, vc = self._empty_cache(B)
        logits = self._prefill(ids, kc, vc)
        return self._fused_decode(logits, kc, vc, S, eos,
                                  max_new - 1).cpu().numpy()

    def _generate_per_token(self, ids, max_new, eos):
        """One counted dispatch and one host sync per token (the
        ``decode_fallback`` debugging path); returns the new tokens."""
        B, S = ids.shape
        kc, vc = self._empty_cache(B)
        logits = self._prefill(ids, kc, vc)
        done = np.zeros((B,), bool)
        out = []
        for i in range(max_new):
            nxt = torch.argmax(logits, -1).cpu().numpy()
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
        """Greedy decode. input_ids: (B, S) ints. Returns a
        ``GenerateResult`` (B, S + new), trimmed after the step where
        every row has emitted ``eos_token_id`` (None or negative = no
        eos). ``chunk_size=T`` runs the chunked path (same tokens). The
        sampling arguments exist for the JAX package's signature;
        ``do_sample=True`` and a ``draft_model`` are refused as not
        ported, after the reference's own checks (``max_len``, then the
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
        if do_sample:
            raise _not_ported("sampling (do_sample=True)",
                              "threefry sampling")
        ids = self._ids(ids_np)
        if decode_fallback_active():
            level = "per_token"
            toks = self._generate_per_token(ids, max_new_tokens, eos)
        elif chunk_size is not None:
            level = "chunked"
            toks = self._generate_chunked(ids, max_new_tokens, eos,
                                          chunk_size)
        else:
            level = "fused"
            toks = self._generate_fused(ids, max_new_tokens, eos)
        if eos is not None:
            toks = _trim_after_eos(toks, eos)
        out = np.concatenate([ids_np, toks.astype(ids_np.dtype)], axis=1)
        self.last_resilience = {"level": level, "requested_level": level,
                                "retries": 0, "degradations": [],
                                "events": []}
        return GenerateResult.wrap(out, self.last_resilience)


# captured chunks a decoder keeps (each holds its own memory pool)
_CHUNK_GRAPHS = 4


def _addresses(cache) -> tuple:
    if is_quantized_kv(cache):
        return cache["q"].data_ptr(), cache["s"].data_ptr()
    return (cache.data_ptr(),)


class _ChunkGraph:
    """``_chunk_steps`` captured once as a CUDA graph over static copies
    of the small carry (logits, pos, done, eos) and the caller's KV caches
    themselves, which it updates in place as the eager chunk does (the
    serving engine writes admitted rows into them between chunks). ``run``
    copies a carry in, replays, and returns clones of the outputs, so an
    earlier ``DecodeState`` keeps its values when a later chunk
    replays."""

    def __init__(self, dec: LlamaDecoder, st: DecodeState, steps: int):
        self.inputs = dataclasses.replace(
            st, logits=st.logits.clone(), pos=st.pos.clone(),
            done=st.done.clone(), eos=st.eos.clone())
        self.graph = torch.cuda.CUDAGraph()
        before = _kernels.launch_counts()
        with torch.cuda.graph(self.graph):
            self.toks, self.out = dec._chunk_steps(self.inputs, steps)
        self.launches = _kernels.captured_launches(before)

    def run(self, st: DecodeState):
        for name in ("logits", "pos", "done", "eos"):
            getattr(self.inputs, name).copy_(getattr(st, name))
        self.graph.replay()
        _kernels.add_launches(self.launches)
        return self.toks.clone(), dataclasses.replace(
            st, logits=self.out.logits.clone(), pos=self.out.pos.clone(),
            done=self.out.done.clone())


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
