"""The functional ops the Llama and UNet training paths use.

Counterpart of the matching parts of ``paddle_tpu/nn/functional.py``:
``rms_norm``, ``group_norm``, ``scaled_dot_product_attention`` (paddle's
(batch, seq, heads, head_dim) layout) with its reference form
``_sdpa_ref``, ``silu``, ``softmax``, ``cross_entropy`` (with the JAX
function's ``weight``, ``soft_label``, ``axis``, ``use_softmax`` and
``label_smoothing``), and ``linear`` (paddle's (in, out) weights),
``conv2d`` (NCHW, OIHW weights) and nearest ``interpolate``. Each one
the JAX package dispatches through its op registry under a name of the
AMP lists casts its floating inputs at its top (``amp.auto_cast.amp_cast``
under that name). The routing rules are the JAX package's: RMSNorm and
GroupNorm to their kernels when ``ops/fused_norm.py`` finds them eligible,
attention to the flash-attention kernels when the flags allow and there is
no mask and no dropout and the key length reaches
``flash_attention_min_seq``. Convolutions, linears and upsampling are
XLA ops in the JAX package and torch ops here.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as _F

from paddle_tpu_torch.amp.auto_cast import _dtype, amp_cast
from paddle_tpu_torch.flags import flags
from paddle_tpu_torch.ops.fused_norm import (_gn_kernel_ok, _kernel_ok,
                                             group_norm_fused, rms_lax,
                                             rms_norm_fused)
from paddle_tpu_torch.ops.kernels import flash_attention as _fa

__all__ = ["rms_norm", "group_norm", "scaled_dot_product_attention", "silu",
           "softmax", "cross_entropy", "linear", "conv2d", "interpolate"]

_LOWP = (torch.bfloat16, torch.float16)


def _not_ported(what: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported to paddle_tpu_torch yet (ROADMAP.md section "
        f"1, item 16)")


def silu(x):
    return _F.silu(x)


def softmax(x, axis=-1, dtype=None):
    (x,) = amp_cast("softmax", x)
    if dtype is not None:
        x = x.to(_dtype(dtype))
    return torch.softmax(x, dim=axis)


def linear(x, weight, bias=None):
    """``x @ weight (+ bias)`` with paddle's (in, out) weight. Types
    promote as in JAX; a bf16 or f16 x accumulates in f32 and rounds the
    product to x's dtype before the bias add."""
    x, weight, bias = amp_cast("linear", x, weight, bias)
    dt = torch.promote_types(x.dtype, weight.dtype)
    out = torch.matmul(x.to(dt), weight.to(dt))
    if x.dtype in _LOWP:
        out = out.to(x.dtype)
    if bias is not None:
        out = out + bias
    return out


def _pair(v):
    return (v, v) if isinstance(v, int) else tuple(v)


def conv2d(x, weight, bias=None, stride=1, padding=0, dilation=1, groups=1,
           data_format="NCHW"):
    """2-D convolution, NCHW maps and OIHW weights, ``padding`` an int or
    an (h, w) pair. The bias is added after the convolution's rounding, as
    the JAX package adds it."""
    if (data_format != "NCHW" or isinstance(padding, str)
            or not (isinstance(padding, int) or len(padding) == 2)):
        raise _not_ported(f"conv2d data_format={data_format!r} "
                          f"padding={padding!r}")
    x, weight, bias = amp_cast("conv2d", x, weight, bias)
    out = _F.conv2d(x, weight, None, _pair(stride), _pair(padding),
                    _pair(dilation), groups)
    if bias is not None:
        out = out + bias.reshape(1, -1, 1, 1)
    return out


def interpolate(x, size=None, scale_factor=None, mode="nearest",
                align_corners=False, data_format="NCHW"):
    """Nearest-neighbour resize of an NCHW map to ``size`` or by
    ``scale_factor``, sampling at pixel centres as ``jax.image.resize``
    does (torch's ``nearest-exact``)."""
    if mode != "nearest" or data_format != "NCHW":
        raise _not_ported(f"interpolate mode={mode!r} "
                          f"data_format={data_format!r}")
    if size is None:
        sf = (scale_factor if isinstance(scale_factor, (list, tuple))
              else (scale_factor,) * 2)
        size = (int(x.shape[2] * sf[0]), int(x.shape[3] * sf[1]))
    return _F.interpolate(x, size=tuple(size), mode="nearest-exact")


def rms_norm(x, weight=None, epsilon=1e-6):
    """RMSNorm over the last axis; through the RMSNorm kernels
    (``ops/kernels/rms_norm.py``) when eligible, else the plain
    composition."""
    x, weight = amp_cast("rms_norm", x, weight)
    if weight is not None and _kernel_ok(x, weight, epsilon):
        return rms_norm_fused(x, weight, epsilon)
    return rms_lax(x, weight, epsilon)


def group_norm(x, num_groups, weight=None, bias=None, epsilon=1e-5,
               data_format="NCHW"):
    """GroupNorm over ``num_groups`` channel groups (axis 1). Through the
    GroupNorm kernels (``ops/kernels/group_norm.py``) when eligible, a
    missing weight or bias then standing in as ones or zeros; else the
    composition in x's dtype (the JAX package's, statistics by
    ``mean``/``var``)."""
    if (data_format == "NCHW" and x.ndim >= 3
            and _gn_kernel_ok(x, num_groups, epsilon)):
        C = x.shape[1]
        w = (weight if weight is not None
             else torch.ones(C, dtype=x.dtype, device=x.device))
        b = (bias if bias is not None
             else torch.zeros(C, dtype=x.dtype, device=x.device))
        return group_norm_fused(x, w, b, num_groups, epsilon, None)
    n_, c = x.shape[0], x.shape[1]
    r = x.reshape((n_, num_groups, c // num_groups) + tuple(x.shape[2:]))
    axes = tuple(range(2, r.ndim))
    mean = r.mean(axes, keepdim=True)
    var = r.var(axes, correction=0, keepdim=True)
    out = ((r - mean) * torch.rsqrt(var + epsilon)).reshape(x.shape)
    shape = [1, c] + [1] * (x.ndim - 2)
    if weight is not None:
        out = out * weight.reshape(shape)
    if bias is not None:
        out = out + bias.reshape(shape)
    return out


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
                 and key.shape[1] >= flags.flash_attention_min_seq)
    query, key, value, attn_mask = amp_cast(
        "flash_attention" if use_flash else "sdpa_ref", query, key, value,
        attn_mask)
    use_flash = (use_flash
                 and key.shape[2] == query.shape[2]
                 and not (is_causal and query.shape[1] > key.shape[1])
                 and _fa.supported(query, key, value))
    if use_flash:
        return _fa.flash_attention_op(query, key, value, causal=is_causal)
    return _sdpa_ref(query, key, value, attn_mask=attn_mask,
                     causal=is_causal)


def _label_index(label, ndim: int, axis: int):
    """Hard labels as int64 indices of the class axis, a size-1 class
    axis squeezed as the JAX function squeezes it."""
    if label.ndim == ndim and label.shape[axis] == 1:
        label = label.squeeze(axis)
    return label.long()


def cross_entropy(input, label, weight=None, ignore_index=-100,
                  reduction="mean", soft_label=False, axis=-1,
                  use_softmax=True, label_smoothing=0.0):
    """Softmax cross-entropy over ``axis``, statistics in f32, the JAX
    function's options. Hard labels: those equal to ``ignore_index`` add
    no loss and leave the mean's denominator; other labels outside [0, C)
    add no loss but count in it (the JAX package's one-hot semantics);
    ``weight`` (C,) scales each row's loss by its label's weight, and the
    mean divides by the weights of the rows that count. ``soft_label``:
    ``label`` is a distribution over the classes. ``use_softmax=False``:
    ``input`` holds probabilities (log of max(p, 1e-30)).
    ``label_smoothing``: the target mixes with the uniform distribution."""
    if reduction not in ("mean", "sum", "none"):
        raise ValueError(f"unknown reduction {reduction!r}")
    input, label, weight = amp_cast("cross_entropy", input, label, weight)
    axis = axis % input.ndim
    x = input.float()
    if use_softmax:
        logp = torch.log_softmax(x, dim=axis)
    else:
        logp = torch.log(torch.clamp(x, min=1e-30))
    C = input.shape[axis]
    if soft_label:
        target = label.float()
        if label_smoothing > 0.0:
            target = target * (1 - label_smoothing) + label_smoothing / C
        loss = -(target * logp).sum(axis)
        if reduction == "mean":
            return loss.mean()
        return loss.sum() if reduction == "sum" else loss
    lbl = _label_index(label, logp.ndim, axis)
    in_range = (lbl >= 0) & (lbl < C)
    idx = lbl.clamp(0, C - 1)
    if label_smoothing > 0.0:
        onehot = _F.one_hot(idx, C).to(torch.float32) * in_range[..., None]
        target = (onehot.movedim(-1, axis) * (1 - label_smoothing)
                  + label_smoothing / C)
        loss = -(target * logp).sum(axis)
    else:
        gold = logp.gather(axis, idx.unsqueeze(axis)).squeeze(axis)
        loss = torch.where(in_range, -gold, 0.0)
    valid = lbl != ignore_index
    applied = None
    if weight is not None:
        applied = torch.where(valid, weight[idx], 0.0)
        loss = loss * applied
    loss = torch.where(valid, loss, 0.0)
    if reduction == "mean":
        if applied is not None:
            return loss.sum() / applied.sum().clamp_min(1e-12)
        return loss.sum() / valid.sum().clamp_min(1)
    if reduction == "sum":
        return loss.sum()
    return loss
