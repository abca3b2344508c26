"""Fused RMSNorm and GroupNorm(+SiLU), each a single differentiable unit.

Counterpart of ``paddle_tpu/ops/fused_norm.py``. ``rms_norm_fused`` and
``group_norm_fused`` run the kernels through ``torch.autograd.Function``s:
the forward saves the kernel's statistics (RMSNorm's ``inv``, GroupNorm's
f32 ``mean`` and ``rstd``) and the backward runs the backward kernel.
Otherwise the forward is the plain composition (``rms_lax``,
``group_norm_lax``); RMSNorm's backward then recomputes the cheap
statistics, GroupNorm's is autograd's. RMSNorm semantics as
``nn.functional.rms_norm``: statistics in f32, the normalized rows rounded
to x's dtype, the output in the promoted dtype of those rows and w.
GroupNorm normalizes each of ``groups`` channel groups of an NCHW map in
f32, applies the per-channel affine and an optional SiLU, and rounds once
to x's dtype.
"""

from __future__ import annotations

import torch

from paddle_tpu_torch.flags import flags
from paddle_tpu_torch.ops.kernels import group_norm as _gk
from paddle_tpu_torch.ops.kernels import rms_norm as _k

__all__ = ["rms_norm_fused", "rms_lax", "group_norm_fused",
           "group_norm_lax", "group_norm_silu_op"]


def rms_lax(x, w, eps):
    """The canonical unfused composition (``nn.functional``'s route when
    the kernels refuse)."""
    xf = x.float() if x.dtype in (torch.bfloat16, torch.float16) else x
    ms = xf.square().mean(-1, keepdim=True)
    out = (xf * torch.rsqrt(ms + eps)).to(x.dtype)
    return out * w if w is not None else out


def _kernel_ok(x, w, eps) -> bool:
    return (flags.use_fused_rms_norm and isinstance(eps, (int, float))
            and _k.supported(x, w))


class _RmsNorm(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x, w, eps):
        ctx.eps = eps
        if _kernel_ok(x, w, eps):
            x = x.contiguous()
            out, inv = _k.rms_fwd(x, w.contiguous(), eps)
            ctx.save_for_backward(x, w, inv)
            return out
        ctx.save_for_backward(x, w, None)
        return rms_lax(x, w, eps)

    @staticmethod
    def backward(ctx, g):
        x, w, inv = ctx.saved_tensors
        if inv is not None:
            dx, dw = _k.rms_bwd(x, w.contiguous(), inv, g.contiguous())
            return dx, dw, None
        xf = x.float()
        inv = torch.rsqrt(xf.square().mean(-1, keepdim=True) + ctx.eps)
        y = xf * inv
        gf = g.float()
        dy = gf * w.float()
        # d/dx of y = x * rsqrt(mean(x^2) + eps):
        #   dx = inv * (dy - y * mean(dy * y, -1))
        dx = inv * (dy - y * (dy * y).mean(-1, keepdim=True))
        # the forward rounded the normalized rows to x's dtype before the
        # w product; dw sees the same rounding
        dw = (gf * y.to(x.dtype).float()).sum(tuple(range(g.ndim - 1)))
        return dx.to(x.dtype), dw.to(w.dtype), None


def rms_norm_fused(x, w, eps):
    return _RmsNorm.apply(x, w, eps)


# -- GroupNorm (+SiLU) --------------------------------------------------------

def group_norm_lax(x, w, b, groups, eps, act=None):
    """The canonical unfused composition: f32 mean and variance (no
    pivot), the affine and the optional SiLU in f32, one rounding to x's
    dtype."""
    B, C = x.shape[0], x.shape[1]
    xf = x.float().reshape(B, groups, -1)
    m = xf.mean(-1, keepdim=True)
    var = xf.var(-1, correction=0, keepdim=True)
    xhat = ((xf - m) * torch.rsqrt(var + eps)).reshape(x.shape)
    shape = (1, C) + (1,) * (x.ndim - 2)
    y = xhat * w.reshape(shape).float() + b.reshape(shape).float()
    if act == "silu":
        y = y * torch.sigmoid(y)
    return y.to(x.dtype)


def _gn_kernel_ok(x, groups, eps) -> bool:
    """The JAX package's ``_gn_pallas_ok``: the flag, a Python eps and the
    kernels' routing rule."""
    return (flags.use_fused_group_norm and isinstance(eps, (int, float))
            and _gk.supported(tuple(x.shape), groups))


class _GroupNorm(torch.autograd.Function):
    """The kernel route: the forward saves the kernel's f32 mean and
    rstd, the backward runs the backward kernel."""

    @staticmethod
    def forward(ctx, x, w, b, groups, eps, act):
        ctx.groups, ctx.act = groups, act
        x = x.contiguous()
        out, mean, rstd = _gk.gn_fwd(x, w.contiguous(), b.contiguous(),
                                     groups, eps, act)
        ctx.save_for_backward(x, w, b, mean, rstd)
        return out

    @staticmethod
    def backward(ctx, g):
        x, w, b, mean, rstd = ctx.saved_tensors
        dx, dw, db = _gk.gn_bwd(x, w.contiguous(), b.contiguous(), mean,
                                rstd, g.contiguous(), ctx.groups, ctx.act)
        return dx, dw, db, None, None, None


def group_norm_fused(x, w, b, groups, eps, act=None):
    """GroupNorm(+SiLU) of (B, C, *spatial) x over ``groups`` groups;
    ``groups``, ``eps`` and ``act`` (None or ``"silu"``) take no
    gradient. Ineligible shapes take ``group_norm_lax``, differentiated
    by autograd (the JAX package writes that backward out by hand for its
    custom VJP; the function is the same)."""
    if _gn_kernel_ok(x, groups, eps):
        return _GroupNorm.apply(x, w, b, groups, eps, act)
    return group_norm_lax(x, w, b, groups, eps, act)


def group_norm_silu_op(x, weight, bias, groups, epsilon=1e-5, act="silu"):
    return group_norm_fused(x, weight, bias, groups, epsilon, act)
