"""The functional ops the Llama, UNet, GPT, BERT and MoE paths use.

Counterpart of the matching parts of ``paddle_tpu/nn/functional.py``:
``rms_norm``, ``group_norm``, ``layer_norm``, ``scaled_dot_product_attention``
(paddle's (batch, seq, heads, head_dim) layout) with its reference form
``_sdpa_ref``, ``silu``, ``gelu``, ``relu``, ``softmax``, ``one_hot``,
``cross_entropy`` (with the JAX function's ``weight``, ``soft_label``,
``axis``, ``use_softmax`` and ``label_smoothing``), ``embedding``,
``dropout`` / ``dropout2d``, and ``linear`` (paddle's (in, out) weights),
``conv2d`` (NCHW, OIHW weights) and nearest ``interpolate``. Dropout (and
attention dropout in ``_sdpa_ref``) draws its mask from
``framework.random.split_key``: ``uniform(key, shape) < 1 - p``, which is
``jax.random.bernoulli``, so the masks equal the JAX package's bit for
bit under the same seed or step key. Each one
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

import numpy as np
import torch
import torch.nn.functional as _F

from paddle_tpu_torch import random as _rnd
from paddle_tpu_torch.amp.auto_cast import _dtype, amp_cast
from paddle_tpu_torch.flags import flags
from paddle_tpu_torch.framework import random as _state
from paddle_tpu_torch.ops.fused_norm import (_gn_kernel_ok, _kernel_ok,
                                             group_norm_fused, rms_lax,
                                             rms_norm_fused)
from paddle_tpu_torch.ops.kernels import flash_attention as _fa

__all__ = ["rms_norm", "group_norm", "layer_norm",
           "scaled_dot_product_attention", "silu", "gelu", "relu",
           "softmax", "one_hot", "cross_entropy", "linear", "conv2d",
           "interpolate", "embedding", "dropout", "dropout2d"]

_LOWP = (torch.bfloat16, torch.float16)


def _not_ported(what: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported to paddle_tpu_torch yet (ROADMAP.md section "
        f"1, item 16)")


def silu(x):
    return _F.silu(x)


def gelu(x, approximate=False):
    """GELU: exact (erf) by default, the tanh form with
    ``approximate=True``, as ``jax.nn.gelu``."""
    return _F.gelu(x, approximate="tanh" if approximate else "none")


def relu(x):
    return _F.relu(x)


def one_hot(x, num_classes):
    """f32 one-hot rows of integer ``x`` (an index outside [0, C) gives a
    row of zeros, as ``jax.nn.one_hot``)."""
    classes = torch.arange(num_classes, device=x.device)
    # a comparison, not torch's one_hot: no check of the values, so no
    # host sync under a CUDA-graph capture
    return (x.long()[..., None] == classes).to(torch.float32)


def layer_norm(x, normalized_shape, weight=None, bias=None, epsilon=1e-5):
    """LayerNorm over the trailing ``normalized_shape`` axes: statistics in
    f32 for bf16 / f16 input, the normalized value rounded to x's dtype,
    then the weight and bias in that dtype (the JAX function's order)."""
    x, weight, bias = amp_cast("layer_norm", x, weight, bias)
    if isinstance(normalized_shape, int):
        normalized_shape = (normalized_shape,)
    xf = x.float() if x.dtype in _LOWP else x
    out = _F.layer_norm(xf, tuple(normalized_shape), None, None,
                        epsilon).to(x.dtype)
    if weight is not None:
        out = out * weight
    if bias is not None:
        out = out + bias
    return out


def embedding(x, weight, padding_idx=None, sparse=False):
    """Rows of ``weight`` at the indices ``x``; rows at ``padding_idx``
    are zeros (the output masked, as the JAX function masks it, so they
    pass no gradient)."""
    out = _F.embedding(x.long(), weight)
    if padding_idx is not None:
        out = out * (x != padding_idx)[..., None].to(out.dtype)
    return out


def _keep_mask(key, shape, p, device):
    """``jax.random.bernoulli(key, 1 - p, shape)``: f32 uniforms below
    f32(1 - p)."""
    u = _rnd.uniform(key.to(device), shape)
    return u < float(np.float32(1.0 - p))


def _scaled_by_keep(x, keep, p):
    """``where(keep, x / (1 - p), 0)`` in x's dtype, the divisor rounded
    to x's dtype and held in a tensor (CUDA divides by a host scalar
    through its reciprocal)."""
    div = torch.full((), 1.0 - p, dtype=x.dtype, device=x.device)
    return torch.where(keep, x / div, torch.zeros((), dtype=x.dtype,
                                                  device=x.device))


def _dropout_op(x, key, p, mode, axis=None):
    shape = tuple(x.shape)
    if axis is not None:
        axes = [axis] if isinstance(axis, int) else list(axis)
        axes = [a % x.ndim for a in axes]
        shape = tuple(s if i in axes else 1 for i, s in enumerate(x.shape))
    keep = _keep_mask(key, shape, p, x.device)
    if mode == "upscale_in_train":
        return _scaled_by_keep(x, keep, p)
    return torch.where(keep, x, torch.zeros((), dtype=x.dtype,
                                            device=x.device))


def dropout(x, p=0.5, training=True, mode="upscale_in_train", axis=None):
    """paddle's ``dropout``: in training, zero each element (or each slice
    along ``axis``) with probability ``p`` and scale the kept ones by
    1 / (1 - p) (``upscale_in_train``) or keep them as they are
    (``downscale_in_infer``, which scales by 1 - p at inference)."""
    if mode not in ("upscale_in_train", "downscale_in_infer"):
        raise ValueError(f"unknown dropout mode {mode!r}")
    if not training or p == 0.0:
        if mode == "downscale_in_infer" and not training:
            return x * (1 - p)
        return x
    return _dropout_op(x, _state.split_key(device=x.device), p, mode, axis)


def dropout2d(x, p=0.5, training=True, data_format="NCHW"):
    """Whole channels dropped: the mask spans (N, C) of an NCHW map (N, C
    of NHWC)."""
    if not training or p == 0.0:
        return x
    axis = (0, 1) if data_format == "NCHW" else (0, 3)
    return _dropout_op(x, _state.split_key(device=x.device), p,
                       "upscale_in_train", axis)


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


def _sdpa_ref(q, k, v, attn_mask=None, dropout_key=None, dropout_p=0.0,
              causal=False, scale=None):
    """Reference attention in plain ops, (B, S, H, D) layout: f32 logits
    of the io-dtype inputs, the softmax in f32, the probabilities rounded
    to q's dtype before the product with v; with ``dropout_key`` and
    ``dropout_p`` > 0 the probabilities are dropped as ``dropout`` drops
    (a (B, H, Sq, Sk) mask) before that product."""
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
    if dropout_key is not None and dropout_p > 0.0:
        keep = _keep_mask(dropout_key, tuple(probs.shape), dropout_p,
                          probs.device)
        probs = _scaled_by_keep(probs, keep, dropout_p)
    return (probs @ vT).transpose(1, 2)


def scaled_dot_product_attention(query, key, value, attn_mask=None,
                                 dropout_p=0.0, is_causal=False,
                                 training=True):
    """paddle's ``scaled_dot_product_attention``, layout (batch, seq,
    heads, head_dim). Flash kernels when the flags allow, there is no mask
    and no dropout, the key length is at least
    ``flash_attention_min_seq`` and the kernels take the shapes (equal
    head counts, causal with sq <= sk); else ``_sdpa_ref``, which drops
    attention probabilities in training when ``dropout_p`` > 0 (its key
    split off after the routing, as in the JAX function)."""
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
    dk = (_state.split_key(device=query.device)
          if (dropout_p > 0.0 and training) else None)
    return _sdpa_ref(query, key, value, attn_mask=attn_mask, dropout_key=dk,
                     dropout_p=dropout_p if training else 0.0,
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
