"""GroupNorm(+SiLU) forward and backward: CUDA kernels and plain versions.

Counterpart of ``paddle_tpu/ops/pallas/group_norm.py``; the kernels are
``paddle_tpu_torch/csrc/group_norm.cu``. x is (B, C, *spatial) with C a
multiple of ``groups``; w and b are (C,). ``gn_fwd`` returns ``(out,
mean, rstd)`` with out in x's dtype and the statistics (B * groups, 1)
f32; ``gn_bwd`` returns ``(dx, dw, db)`` from them, dw and db summed over
the batch from per-(b, channel) f32 partials and cast to w's dtype.
``act`` is None or ``"silu"``. ``supported`` is the routing rule the
callers (``ops/fused_norm.py``) apply; the kernels themselves take any
C / groups and any spatial size. ``route`` picks, from the shape and
dtype alone, which of the two CUDA routes a launch takes: clusters of K
blocks sharing a slab through distributed shared memory, or the
streaming kernels for slabs too large for them.
"""

from __future__ import annotations

import torch

from paddle_tpu_torch.ops.kernels import _build

__all__ = ["supported", "route", "gn_fwd", "gn_bwd", "gn_fwd_ref",
           "gn_bwd_ref", "fwd_launches", "bwd_launches"]

#: kernel launches made by ``gn_fwd`` / ``gn_bwd`` (plain-version calls
#: and direct ``*_ref`` calls do not count)
fwd_launches = 0
bwd_launches = 0

_CODES = {torch.float32: 0, torch.bfloat16: 1}
_ACTS = (None, "silu")
# the TPU kernel's VMEM ceiling: the f32 (C/G, *spatial) slab of one
# program within 4 MB
_BUDGET = 4 * 1024 * 1024


def _padded_elems(cg: int, spatial) -> int:
    """Elements of one (cg, *spatial) f32 block in the TPU's tiled VMEM
    layout: the minor dim padded to 128 lanes, the second-minor to 8."""
    dims = (cg,) + tuple(spatial)
    minor = -(-dims[-1] // 128) * 128
    second = -(-dims[-2] // 8) * 8 if len(dims) >= 2 else 1
    rest = 1
    for d in dims[:-2]:
        rest *= d
    return rest * second * minor


def supported(x_shape, groups: int) -> bool:
    """The JAX package's routing rule on the TPU (``group_norm.py``
    ``_layout_for``), so the two packages send the same shapes to their
    kernels: rank >= 3, C a multiple of groups, and the slab within the
    TPU's VMEM budget, either 4D with lane padding ('native4d') or
    flattened with HW a multiple of 128 ('flat')."""
    if len(x_shape) < 3 or groups < 1 or x_shape[1] % groups:
        return False
    cg = x_shape[1] // groups
    hw = 1
    for d in x_shape[2:]:
        hw *= d
    if len(x_shape) == 4 and _padded_elems(cg, x_shape[2:]) * 4 <= _BUDGET:
        return True
    return hw % 128 == 0 and cg * hw * 4 <= _BUDGET


# The cluster route's limits (csrc/group_norm.cu mirrors _SMEM_MAX as
# kCSmemMax, _per as share_of, _smem as cluster_smem): blocks of 256
# threads (8 warps) with at most 110 KB of dynamic shared memory, so two
# blocks fit an SM.
_SMEM_MAX = 110 * 1024
_WARPS = 8
# the largest share the first K may give: the fastest target at the UNet's
# shapes over the K each shape admits (group_norm_routes.py on the H100)
_SMEM_TARGET = 48 * 1024
_SMS = 132                 # H100 SXM


def _per(n: int, k: int) -> int:
    """Elements of a block's share of an n-element slab split K ways:
    ceil(n / K) rounded up to 8."""
    return (-(-n // k) + 7) // 8 * 8


def _smem(per: int, esz: int, hw: int, backward: bool) -> int:
    """Dynamic shared memory of a cluster-route block: its x share and a
    table of its channels' affine constants; in the backward also the
    (dw, db) rows of its channels, one a warp and one for the block."""
    x_bytes = (per * esz + 15) // 16 * 16
    rows = _WARPS + 2 if backward else 1
    return x_bytes + rows * ((per - 1) // hw + 2) * 8


def route(x_shape, groups: int, dtype, backward: bool) -> int:
    """K, the blocks of the cluster that takes one (b, g) slab (1, 2, 4 or
    8), or 0, the streaming route, when no K gives a share within the
    shared memory of two blocks an SM. The first K whose share fits
    ``_SMEM_TARGET`` and gives the card's SMs a block each wins; else the
    largest that fits. A pure function of the shape and dtype, decided
    before the launch."""
    B, C = x_shape[0], x_shape[1]
    hw = 1
    for d in x_shape[2:]:
        hw *= d
    n = C // groups * hw
    esz = 2 if dtype == torch.bfloat16 else 4
    fits = []
    for k in (1, 2, 4, 8):
        per = _per(n, k)
        if n > 1 << 30 or per * (k - 1) >= n:
            break
        smem = _smem(per, esz, hw, backward)
        if smem <= _SMEM_MAX:
            fits.append((k, smem))
    for k, smem in fits:
        if smem <= _SMEM_TARGET and B * groups * k >= _SMS:
            return k
    return fits[-1][0] if fits else 0


def gn_fwd_ref(x, w, b, groups: int, eps: float, act=None):
    """Plain version of the forward, in f32: pivot-shifted mean,
    two-pass variance, affine, optional SiLU, one rounding to x's
    dtype."""
    B, C = x.shape[0], x.shape[1]
    xf = x.float().reshape(B * groups, -1)
    pivot = xf[:, :1]
    m = pivot + (xf - pivot).mean(-1, keepdim=True)
    d = xf - m
    r = torch.rsqrt((d * d).mean(-1, keepdim=True) + eps)
    shape = (1, C) + (1,) * (x.ndim - 2)
    y = (d * r).reshape(x.shape) * w.float().reshape(shape) \
        + b.float().reshape(shape)
    if act == "silu":
        y = y * torch.sigmoid(y)
    return y.to(x.dtype), m, r


def gn_bwd_ref(x, w, b, mean, rstd, g, groups: int, act=None):
    """Plain version of the backward from the forward's mean and rstd."""
    B, C = x.shape[0], x.shape[1]
    shape = (1, C) + (1,) * (x.ndim - 2)
    xf = x.float().reshape(B, groups, -1)
    r = rstd.reshape(B, groups, 1)
    xhat = ((xf - mean.reshape(B, groups, 1)) * r).reshape(x.shape)
    wf = w.float().reshape(shape)
    gf = g.float()
    dz = gf
    if act == "silu":
        z = xhat * wf + b.float().reshape(shape)
        s = torch.sigmoid(z)
        dz = gf * (s * (1.0 + z * (1.0 - s)))
    red = tuple(range(2, x.ndim))
    dw = (dz * xhat).sum(red).sum(0)
    db = dz.sum(red).sum(0)
    dxhat = (dz * wf).reshape(B, groups, -1)
    xh = xhat.reshape(B, groups, -1)
    mu1 = dxhat.mean(-1, keepdim=True)
    mu2 = (dxhat * xh).mean(-1, keepdim=True)
    dx = (r * (dxhat - mu1 - xh * mu2)).reshape(x.shape)
    return dx.to(x.dtype), dw.to(w.dtype), db.to(b.dtype)


def _on_card(x, what) -> bool:
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{what} runs on cuda or cpu, got {x.device}")
    return x.device.type == "cuda"


def _refuse(x, w, b, groups, act):
    """Raise on what the kernels do not take."""
    C = x.shape[1] if x.ndim >= 2 else -1
    ok = (x.ndim >= 3 and groups >= 1 and C % groups == 0
          and x.numel() > 0 and x.dtype in _CODES and w.dtype in _CODES
          and b.dtype == w.dtype and tuple(w.shape) == (C,)
          and tuple(b.shape) == (C,) and act in _ACTS)
    if not ok:
        raise ValueError(
            f"group_norm kernel does not take x {tuple(x.shape)} {x.dtype} "
            f"with w {tuple(w.shape)} {w.dtype}, b {tuple(b.shape)} "
            f"{b.dtype}, groups {groups}, act {act!r}")


def _check(*ts):
    for t in ts:
        if t.device != ts[0].device:
            raise ValueError("all operands must be on x's device")
        if not t.is_contiguous():
            raise ValueError("group_norm kernels need contiguous operands")


def _vec(hw: int, *ts) -> int:
    """1 when the kernels may read and write ``ts`` with 16-byte vector
    accesses: HW a multiple of 8 and every pointer 16-byte aligned."""
    return int(hw % 8 == 0 and all(t.data_ptr() % 16 == 0 for t in ts))


def gn_fwd(x, w, b, groups: int, eps: float, act=None):
    """(out, mean, rstd). CPU tensors take the plain version; CUDA
    tensors launch the kernel or raise."""
    global fwd_launches
    if not _on_card(x, "gn_fwd"):
        return gn_fwd_ref(x, w, b, groups, eps, act)
    _refuse(x, w, b, groups, act)
    B, C = x.shape[0], x.shape[1]
    hw = x.numel() // (B * C)
    out = torch.empty_like(x)
    mean = torch.empty((B * groups, 1), dtype=torch.float32, device=x.device)
    rstd = torch.empty_like(mean)
    _check(x, w, b)
    vec = _vec(hw, x, out)
    rc = _build.library().group_norm_fwd_launch(
        x.data_ptr(), w.data_ptr(), b.data_ptr(), out.data_ptr(),
        mean.data_ptr(), rstd.data_ptr(), B, C, groups, hw, float(eps),
        int(act == "silu"), _CODES[x.dtype], _CODES[w.dtype], vec,
        route(x.shape, groups, x.dtype, backward=False),
        torch.cuda.current_stream(x.device).cuda_stream)
    if rc:
        raise RuntimeError(f"group_norm forward launch failed: "
                           f"{_build.error_string(rc)} ({rc})")
    fwd_launches += 1
    return out, mean, rstd


def gn_bwd(x, w, b, mean, rstd, g, groups: int, act=None):
    """(dx, dw, db) given the forward's mean and rstd; ``g`` is the
    gradient of ``out``. CPU tensors take the plain version; CUDA tensors
    launch the kernel or raise. The library sums the per-(b, channel)
    partials over the batch in a second kernel, where the JAX package sums
    its kernel's partials outside the kernel."""
    global bwd_launches
    if not _on_card(x, "gn_bwd"):
        return gn_bwd_ref(x, w, b, mean, rstd, g, groups, act)
    _refuse(x, w, b, groups, act)
    B, C = x.shape[0], x.shape[1]
    if g.shape != x.shape or g.dtype != x.dtype:
        raise ValueError("gn_bwd: g must match x")
    if (mean.numel() != B * groups or rstd.numel() != B * groups
            or mean.dtype != torch.float32 or rstd.dtype != torch.float32):
        raise ValueError("gn_bwd: mean and rstd must be B * groups f32")
    hw = x.numel() // (B * C)
    dx = torch.empty_like(x)
    dwp = torch.empty((B, C), dtype=torch.float32, device=x.device)
    dbp = torch.empty_like(dwp)
    dw = torch.empty((C,), dtype=w.dtype, device=x.device)
    db = torch.empty_like(dw)
    _check(x, w, b, mean, rstd, g)
    vec = _vec(hw, x, g, dx)
    rc = _build.library().group_norm_bwd_launch(
        x.data_ptr(), w.data_ptr(), b.data_ptr(), mean.data_ptr(),
        rstd.data_ptr(), g.data_ptr(), dx.data_ptr(), dwp.data_ptr(),
        dbp.data_ptr(), dw.data_ptr(), db.data_ptr(), B, C, groups, hw, int(act == "silu"), _CODES[x.dtype], _CODES[w.dtype],
        vec, route(x.shape, groups, x.dtype, backward=True),
        torch.cuda.current_stream(x.device).cuda_stream)
    if rc:
        raise RuntimeError(f"group_norm backward launch failed: "
                           f"{_build.error_string(rc)} ({rc})")
    bwd_launches += 1
    return dx, dw, db
