"""The functional ops the Llama training path uses.

Counterpart of the matching parts of ``paddle_tpu/nn/functional.py``:
``rms_norm``, ``scaled_dot_product_attention`` (paddle's (batch, seq,
heads, head_dim) layout) with its reference form ``_sdpa_ref``, ``silu``
and ``cross_entropy``. The routing rules are the JAX package's: RMSNorm to
its kernels when ``ops/fused_norm.py`` finds them eligible, attention to
the flash-attention kernels when the flags allow and there is no mask and
no dropout and the key length reaches ``flash_attention_min_seq``.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as _F

from paddle_tpu_torch.flags import flags
from paddle_tpu_torch.ops.fused_norm import _kernel_ok, rms_lax, rms_norm_fused
from paddle_tpu_torch.ops.kernels import flash_attention as _fa

__all__ = ["rms_norm", "scaled_dot_product_attention", "silu",
           "cross_entropy"]


def silu(x):
    return _F.silu(x)


def rms_norm(x, weight=None, epsilon=1e-6):
    """RMSNorm over the last axis; through the RMSNorm kernels
    (``ops/kernels/rms_norm.py``) when eligible, else the plain
    composition."""
    if weight is not None and _kernel_ok(x, weight, epsilon):
        return rms_norm_fused(x, weight, epsilon)
    return rms_lax(x, weight, epsilon)


def _sdpa_ref(q, k, v, attn_mask=None, causal=False, scale=None):
    """Reference attention in plain ops, (B, S, H, D) layout: f32 logits
    of the io-dtype inputs, the softmax in f32, the probabilities rounded
    to q's dtype before the product with v."""
    d = q.shape[-1]
    sq, sk = q.shape[1], k.shape[1]
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    qT, kT, vT = (t.transpose(1, 2) for t in (q, k, v))
    logits = (qT.float() @ kT.float().transpose(-1, -2)) * scale
    if causal:
        keep = torch.ones(sq, sk, dtype=torch.bool, device=q.device).tril(
            sk - sq)
        logits = logits.masked_fill(~keep, float("-inf"))
    if attn_mask is not None:
        if attn_mask.dtype == torch.bool:
            logits = logits.masked_fill(~attn_mask, float("-inf"))
        else:
            logits = logits + attn_mask
    probs = torch.softmax(logits, dim=-1).to(q.dtype)
    return (probs @ vT).transpose(1, 2)


def scaled_dot_product_attention(query, key, value, attn_mask=None,
                                 dropout_p=0.0, is_causal=False,
                                 training=True):
    """paddle's ``scaled_dot_product_attention``, layout (batch, seq,
    heads, head_dim). Flash kernels when the flags allow, there is no mask
    and no dropout, the key length is at least
    ``flash_attention_min_seq`` and the kernels take the shapes (equal
    head counts, causal with sq <= sk); else ``_sdpa_ref``."""
    if dropout_p > 0.0 and training:
        raise NotImplementedError(
            "attention dropout is not ported to paddle_tpu_torch yet "
            "(ROADMAP.md section 1, item 14: the paddle Tensor and RNG "
            "surface)")
    use_flash = (flags.use_fused_attention and attn_mask is None
                 and dropout_p == 0.0
                 and key.shape[1] >= flags.flash_attention_min_seq
                 and key.shape[2] == query.shape[2]
                 and not (is_causal and query.shape[1] > key.shape[1])
                 and _fa.supported(query, key, value))
    if use_flash:
        return _fa.flash_attention_op(query, key, value, causal=is_causal)
    return _sdpa_ref(query, key, value, attn_mask=attn_mask,
                     causal=is_causal)


def cross_entropy(input, label, ignore_index=-100, reduction="mean"):
    """Hard-label softmax cross-entropy over the last axis, statistics in
    f32. Labels equal to ``ignore_index`` add no loss and leave the mean's
    denominator; other labels outside [0, C) add no loss but count in it
    (the JAX package's one-hot semantics)."""
    if reduction not in ("mean", "sum", "none"):
        raise ValueError(f"unknown reduction {reduction!r}")
    logp = torch.log_softmax(input.float(), dim=-1)
    C = input.shape[-1]
    lbl = label
    if lbl.ndim == logp.ndim and lbl.shape[-1] == 1:
        lbl = lbl.squeeze(-1)
    lbl = lbl.long()
    in_range = (lbl >= 0) & (lbl < C)
    gold = logp.gather(-1, lbl.clamp(0, C - 1)[..., None])[..., 0]
    valid = lbl != ignore_index
    loss = torch.where(in_range & valid, -gold, 0.0)
    if reduction == "mean":
        return loss.sum() / valid.sum().clamp_min(1)
    if reduction == "sum":
        return loss.sum()
    return loss
