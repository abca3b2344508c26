"""Fused RMSNorm as a single differentiable unit.

Counterpart of ``paddle_tpu/ops/fused_norm.py`` (its RMSNorm half; the
GroupNorm half comes with the UNet). ``rms_norm_fused`` is a
``torch.autograd.Function``: on the kernel path its forward saves the
kernel's ``inv`` and its backward runs the backward kernel; otherwise the
forward is the plain composition ``rms_lax`` and the backward recomputes
the cheap statistics instead of saving them. Semantics as
``nn.functional.rms_norm``: statistics in f32, the normalized rows rounded
to x's dtype, the output in the promoted dtype of those rows and w.
"""

from __future__ import annotations

import torch

from paddle_tpu_torch.flags import flags
from paddle_tpu_torch.ops.kernels import rms_norm as _k

__all__ = ["rms_norm_fused", "rms_lax"]


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
