"""RMSNorm forward and backward: CUDA kernels and plain versions.

Counterpart of ``paddle_tpu/ops/pallas/rms_norm.py``; the kernels are
``paddle_tpu_torch/csrc/rms_norm.cu``. The normalized axis is the last one,
leading axes flatten to rows. ``rms_fwd`` returns ``(out, inv)`` with
``inv = rsqrt(mean(x^2) + eps)`` as a (rows, 1) f32 residual; ``out`` has
the promoted dtype of x and w. ``rms_bwd`` returns ``(dx, dw)`` from that
residual. The routing rule lives in ``supported``; callers
(``ops/fused_norm.py``) take the plain composition when it refuses.
"""

from __future__ import annotations

import torch

from paddle_tpu_torch.ops.kernels import _build

__all__ = ["supported", "rms_fwd", "rms_bwd", "rms_fwd_ref", "rms_bwd_ref",
           "fwd_launches", "bwd_launches"]

#: kernel launches made by ``rms_fwd`` / ``rms_bwd`` (plain-version calls
#: and direct ``*_ref`` calls do not count)
fwd_launches = 0
bwd_launches = 0

_CODES = {torch.float32: 0, torch.bfloat16: 1}
# the card's 132 SMs, two backward blocks each
_BWD_BLOCKS = 264


def supported(x, w) -> bool:
    """What the kernels take: x (..., H) with at least two axes and w
    (H,), each f32 or bf16, H up to 4096 (the backward's per-warp dw rows
    must fit shared memory). Any row count."""
    return (x.ndim >= 2 and w.ndim == 1 and x.shape[-1] == w.shape[0]
            and 1 <= x.shape[-1] <= 4096 and x.numel() > 0
            and x.dtype in _CODES and w.dtype in _CODES)


def rms_fwd_ref(x, w, eps: float):
    """Plain version of the forward: f32 statistics, the normalized rows
    rounded to x's dtype before the f32 product with w."""
    H = x.shape[-1]
    out_dtype = torch.promote_types(x.dtype, w.dtype)
    xf = x.reshape(-1, H).float()
    inv = torch.rsqrt(xf.square().mean(-1, keepdim=True) + eps)
    y = (xf * inv).to(x.dtype).float()
    out = (y * w.float()).to(out_dtype)
    return out.reshape(x.shape), inv


def rms_bwd_ref(x, w, inv, g):
    """Plain version of the backward from the forward's ``inv``."""
    H = x.shape[-1]
    xf = x.reshape(-1, H).float()
    gf = g.reshape(-1, H).float()
    yn = xf * inv
    dy = gf * w.float()
    dx = inv * (dy - yn * (dy * yn).mean(-1, keepdim=True))
    dw = (gf * yn.to(x.dtype).float()).sum(0)
    return dx.to(x.dtype).reshape(x.shape), dw.to(w.dtype)


def _check(*ts):
    dev = ts[0].device
    for t in ts:
        if t.device != dev:
            raise ValueError("all operands must be on x's device")
        if not t.is_contiguous():
            raise ValueError("rms_norm kernels need contiguous operands")


def _device(x, what):
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{what} runs on cuda or cpu, got {x.device}")
    return x.device.type == "cuda"


def rms_fwd(x, w, eps: float):
    """(out, inv). CPU tensors take the plain version; CUDA tensors
    launch the kernel or raise."""
    global fwd_launches
    if not _device(x, "rms_fwd"):
        return rms_fwd_ref(x, w, eps)
    if not supported(x, w):
        raise ValueError(f"rms_norm kernel does not take x {tuple(x.shape)} "
                         f"{x.dtype} with w {tuple(w.shape)} {w.dtype}")
    _check(x, w)
    H = x.shape[-1]
    rows = x.numel() // H
    out = torch.empty(x.shape, dtype=torch.promote_types(x.dtype, w.dtype),
                      device=x.device)
    inv = torch.empty((rows, 1), dtype=torch.float32, device=x.device)
    rc = _build.library().rms_norm_fwd_launch(
        x.data_ptr(), w.data_ptr(), out.data_ptr(), inv.data_ptr(), rows, H,
        float(eps), _CODES[x.dtype], _CODES[w.dtype],
        torch.cuda.current_stream(x.device).cuda_stream)
    if rc:
        raise RuntimeError(f"rms_norm forward launch failed: "
                           f"{_build.error_string(rc)} ({rc})")
    fwd_launches += 1
    return out, inv


def rms_bwd(x, w, inv, g):
    """(dx, dw) given the forward's ``inv``; ``g`` is the gradient of
    ``out``. CPU tensors take the plain version; CUDA tensors launch the
    kernel or raise. The kernel's per-block dw partials land in an f32
    scratch that its second kernel sums in block order into dw."""
    global bwd_launches
    if not _device(x, "rms_bwd"):
        return rms_bwd_ref(x, w, inv, g)
    if not supported(x, w):
        raise ValueError(f"rms_norm kernel does not take x {tuple(x.shape)} "
                         f"{x.dtype} with w {tuple(w.shape)} {w.dtype}")
    H = x.shape[-1]
    rows = x.numel() // H
    if (g.shape != x.shape or g.dtype != torch.promote_types(x.dtype, w.dtype)
            or tuple(inv.shape) != (rows, 1) or inv.dtype != torch.float32):
        raise ValueError("rms_bwd: g must match out and inv be (rows, 1) f32")
    _check(x, w, inv, g)
    nb = min(_BWD_BLOCKS, rows)
    dx = torch.empty_like(x)
    dwp = torch.empty((nb, H), dtype=torch.float32, device=x.device)
    dw = torch.empty_like(w)
    rc = _build.library().rms_norm_bwd_launch(
        x.data_ptr(), w.data_ptr(), inv.data_ptr(), g.data_ptr(),
        dx.data_ptr(), dwp.data_ptr(), dw.data_ptr(), rows, H, nb,
        _CODES[x.dtype], _CODES[w.dtype],
        torch.cuda.current_stream(x.device).cuda_stream)
    if rc:
        raise RuntimeError(f"rms_norm backward launch failed: "
                           f"{_build.error_string(rc)} ({rc})")
    bwd_launches += 1
    return dx, dw
