"""Rotary position embedding: a CUDA kernel and its plain version.

Counterpart of ``paddle_tpu/ops/pallas/rope.py``; the kernel is
``paddle_tpu_torch/csrc/rope.cu``. x is (B, S, H, D), the cos and sin
tables (S, D/2), halves split at D/2 (the Llama convention). ``rope_fwd``
rotates, ``rope_bwd`` applies the inverse rotation (the same kernel with
-sin), and ``rope_fused`` is the differentiable unit: dx from
``rope_bwd``, dcos and dsin from torch reductions, as the JAX package
leaves them to XLA. ``supported`` is the JAX package's routing rule.
"""

from __future__ import annotations

import torch

from paddle_tpu_torch.ops.kernels import _build

__all__ = ["supported", "rope_fwd", "rope_bwd", "rope_ref", "rope_fused",
           "fwd_launches", "bwd_launches"]

#: kernel launches made by ``rope_fwd`` / ``rope_bwd`` (plain-version
#: calls and direct ``rope_ref`` calls do not count)
fwd_launches = 0
bwd_launches = 0

_CODES = {torch.float32: 0, torch.bfloat16: 1}


def _seq_block(s: int) -> int:
    for cand in (256, 128, 64, 32, 16, 8):
        if s % cand == 0:
            return cand
    return 0


def supported(x_shape, cos_shape, x_dtype=None, cos_dtype=None) -> bool:
    """The JAX package's rule (``rope.py supported``): x 4D with an even
    D, tables (S, D/2), one dtype for x and the tables when both are
    given (the kernel emits x's dtype, the plain form promotes with the
    tables'), and S a multiple of 8 (the TPU kernel's sequence blocks)."""
    if len(x_shape) != 4 or len(cos_shape) != 2:
        return False
    b, s, h, d = x_shape
    if d % 2 != 0 or tuple(cos_shape) != (s, d // 2):
        return False
    if x_dtype is not None and cos_dtype is not None and x_dtype != cos_dtype:
        return False
    return _seq_block(s) > 0


def rope_ref(x, cos, sin, sign: int = 1):
    """Plain version: the rotation (sign -1: by -sin) in f32, rounded once
    to x's dtype."""
    d2 = x.shape[-1] // 2
    xf = x.float()
    x1, x2 = xf[..., :d2], xf[..., d2:]
    c = cos.float()[None, :, None, :]
    s = sign * sin.float()[None, :, None, :]
    return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1).to(x.dtype)


def _launch(x, cos, sin, sign: int):
    if not supported(tuple(x.shape), tuple(cos.shape)) or not (
            x.dtype in _CODES and cos.dtype == x.dtype
            and sin.dtype == x.dtype and sin.shape == cos.shape):
        raise ValueError(
            f"rope kernel does not take x {tuple(x.shape)} {x.dtype} with "
            f"tables {tuple(cos.shape)} {cos.dtype} / {tuple(sin.shape)} "
            f"{sin.dtype}")
    for t in (x, cos, sin):
        if t.device != x.device:
            raise ValueError("all operands must be on x's device")
        if not t.is_contiguous():
            raise ValueError("the rope kernel needs contiguous operands")
    B, S, H, D = x.shape
    out = torch.empty_like(x)
    rc = _build.library().rope_launch(
        x.data_ptr(), cos.data_ptr(), sin.data_ptr(), out.data_ptr(), B, S,
        H, D, sign, _CODES[x.dtype],
        torch.cuda.current_stream(x.device).cuda_stream)
    if rc:
        raise RuntimeError(f"rope launch failed: {_build.error_string(rc)} "
                           f"({rc})")
    return out


def _on_card(x, what) -> bool:
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{what} runs on cuda or cpu, got {x.device}")
    return x.device.type == "cuda"


def rope_fwd(x, cos, sin):
    """The rotation. CPU tensors take the plain version; CUDA tensors
    launch the kernel or raise."""
    global fwd_launches
    if not _on_card(x, "rope_fwd"):
        return rope_ref(x, cos, sin)
    out = _launch(x, cos, sin, 1)
    fwd_launches += 1
    return out


def rope_bwd(g, cos, sin):
    """The inverse rotation of ``g`` (dx of the rotation). CPU tensors
    take the plain version; CUDA tensors launch the kernel or raise."""
    global bwd_launches
    if not _on_card(g, "rope_bwd"):
        return rope_ref(g, cos, sin, -1)
    out = _launch(g, cos, sin, -1)
    bwd_launches += 1
    return out


class _Rope(torch.autograd.Function):
    """The JAX package's ``rope_fused`` custom VJP: rotation matrices are
    orthogonal, so dx is the inverse rotation; the (S, D/2) table
    gradients are f32 reductions over B and H, cast to the tables'
    dtype, taken only when a table needs one."""

    @staticmethod
    def forward(ctx, x, cos, sin):
        x, cos, sin = x.contiguous(), cos.contiguous(), sin.contiguous()
        ctx.save_for_backward(x, cos, sin)
        return rope_fwd(x, cos, sin)

    @staticmethod
    def backward(ctx, g):
        x, cos, sin = ctx.saved_tensors
        g = g.contiguous()
        dx = rope_bwd(g, cos, sin) if ctx.needs_input_grad[0] else None
        dcos = dsin = None
        if ctx.needs_input_grad[1] or ctx.needs_input_grad[2]:
            d2 = x.shape[-1] // 2
            gf, xf = g.float(), x.float()
            g1, g2, x1, x2 = gf[..., :d2], gf[..., d2:], xf[..., :d2], \
                xf[..., d2:]
            dcos = (g1 * x1 + g2 * x2).sum((0, 2)).to(cos.dtype)
            dsin = (g2 * x1 - g1 * x2).sum((0, 2)).to(sin.dtype)
        return dx, dcos, dsin


def rope_fused(x, cos, sin):
    return _Rope.apply(x, cos, sin)
