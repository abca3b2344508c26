"""Flash attention forward and backward: CUDA kernels and plain versions.

Counterpart of ``paddle_tpu/ops/pallas/flash_attention.py``; the kernels
are ``paddle_tpu_torch/csrc/flash_fwd.cu`` and ``flash_bwd.cu``. Public
layout as there: paddle's (batch, seq, heads, head_dim), equal q and k/v
head counts (GQA repeats K/V before the call). ``flash_fwd`` returns
``(out, lse)`` with ``lse`` (B, H, Sq) f32; ``flash_bwd`` takes ``(q, k,
v, out, lse, do)`` and returns ``(dq, dk, dv)``. Causal attention is bottom-right aligned
(query i sees keys <= i + Sk - Sq) and needs Sk >= Sq. Where the JAX
package transposes to (B*H, S, D) for its kernels, the CUDA kernels read
the (B, S, H, D) layout with strides; the function is the same.
"""

from __future__ import annotations

import math

import torch

from paddle_tpu_torch.ops.kernels import _build

__all__ = ["supported", "flash_fwd", "flash_bwd", "flash_fwd_ref",
           "flash_bwd_ref", "flash_attention_fn", "flash_attention_op",
           "fwd_launches", "bwd_launches"]

#: kernel launches made by ``flash_fwd`` and by ``flash_bwd`` (one per
#: backward call, which runs the delta kernel, then for bf16 the one-pass
#: kernel and dq's conversion, for f32 the dq and the dk/dv kernels);
#: plain-version calls and direct ``*_ref`` calls do not count
fwd_launches = 0
bwd_launches = 0

_NEG_INF = -1e30
_CODES = {torch.float32: 0, torch.bfloat16: 1}
# bf16 D 80: the UNet's level-1 heads (640 channels over 8)
_HEAD_DIMS = {torch.float32: (16, 32, 64),
              torch.bfloat16: (16, 32, 64, 80, 128)}


def supported(q, k, v) -> bool:
    """What the kernels take: q (B, Sq, H, D) and k, v (B, Sk, H, D) of one
    dtype, bf16 with D in 16/32/64/80/128 or f32 with D in 16/32/64 (the f32
    backward's tiles must fit shared memory). Any Sq and Sk."""
    if q.ndim != 4 or k.shape != v.shape or k.ndim != 4:
        return False
    B, _, H, D = q.shape
    return (k.shape[0] == B and k.shape[2] == H and k.shape[3] == D
            and q.shape[1] >= 1 and k.shape[1] >= 1
            and q.dtype == k.dtype == v.dtype
            and D in _HEAD_DIMS.get(q.dtype, ()))


def _scores(q, k, causal: bool, scale: float):
    """f32 scores (B, H, Sq, Sk), causal positions at the -1e30 sentinel."""
    s = q.float().transpose(1, 2) @ k.float().transpose(1, 2).transpose(-1, -2)
    s = s * scale
    if causal:
        sq, sk = q.shape[1], k.shape[1]
        keep = torch.ones(sq, sk, dtype=torch.bool, device=q.device).tril(
            sk - sq)
        s = s.masked_fill(~keep, _NEG_INF)
    return s


def flash_fwd_ref(q, k, v, causal: bool, scale: float):
    """Plain version of the forward: the whole-row softmax of the TPU's
    single-block kernel, p rounded to the io dtype before the f32 product
    with v, a row that sees no key giving out 0 and lse -1e30."""
    s = _scores(q, k, causal, scale)
    m = s.amax(-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(-1, keepdim=True)
    pv = p.to(q.dtype).float() @ v.float().transpose(1, 2)
    dead = m <= _NEG_INF * 0.5
    out = torch.where(dead, 0.0, pv / l).to(q.dtype)
    lse = torch.where(dead, _NEG_INF, m + torch.log(l))[..., 0]
    return out.transpose(1, 2).contiguous(), lse


def flash_bwd_ref(q, k, v, out, lse, do, causal: bool, scale: float):
    """Plain version of the backward from the saved lse: p guarded by the
    lse sentinel, ds = p (dp - delta) scale rounded to the io dtype before
    the dq and dk products, p rounded before the dv product."""
    dt = q.dtype
    s = _scores(q, k, causal, scale)
    lse4 = lse[..., None]
    p = torch.where(lse4 <= _NEG_INF * 0.5, 0.0, torch.exp(s - lse4))
    dof = do.float().transpose(1, 2)                         # (B, H, Sq, D)
    delta = (dof * out.float().transpose(1, 2)).sum(-1, keepdim=True)
    dv = p.to(dt).float().transpose(-1, -2) @ dof
    dp = dof @ v.float().transpose(1, 2).transpose(-1, -2)
    ds = (p * (dp - delta) * scale).to(dt).float()
    dq = ds @ k.float().transpose(1, 2)
    dk = ds.transpose(-1, -2) @ q.float().transpose(1, 2)
    return tuple(t.to(dt).transpose(1, 2).contiguous() for t in (dq, dk, dv))


def _check(*ts):
    q = ts[0]
    for t in ts:
        if t.device != q.device:
            raise ValueError("all operands must be on q's device")
        if not t.is_contiguous():
            raise ValueError("flash attention kernels need contiguous "
                             "operands")
        if t.data_ptr() % 16:
            raise ValueError("flash attention operands must be 16-byte "
                             "aligned")


def _on_card(q, what) -> bool:
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{what} runs on cuda or cpu, got {q.device}")
    return q.device.type == "cuda"


def _refuse(q, k, v):
    if not supported(q, k, v):
        raise ValueError(
            f"flash attention kernel does not take q {tuple(q.shape)} and "
            f"k/v {tuple(k.shape)} {q.dtype}")


def flash_fwd(q, k, v, causal: bool, scale: float):
    """(out (B, Sq, H, D), lse (B, H, Sq) f32). CPU tensors take the
    plain version; CUDA tensors launch the kernel or raise."""
    global fwd_launches
    if not _on_card(q, "flash_fwd"):
        return flash_fwd_ref(q, k, v, causal, scale)
    _refuse(q, k, v)
    _check(q, k, v)
    B, Sq, H, D = q.shape
    out = torch.empty_like(q)
    lse = torch.empty((B, H, Sq), dtype=torch.float32, device=q.device)
    rc = _build.library().flash_attention_fwd_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        lse.data_ptr(), B, H, Sq, k.shape[1], D, float(scale), int(causal),
        _CODES[q.dtype], torch.cuda.current_stream(q.device).cuda_stream)
    if rc:
        raise RuntimeError(f"flash attention forward launch failed: "
                           f"{_build.error_string(rc)} ({rc})")
    fwd_launches += 1
    return out, lse


def flash_bwd(q, k, v, out, lse, do, causal: bool, scale: float):
    """(dq, dk, dv) from the forward's out and lse. CPU tensors take the
    plain version; CUDA tensors launch the kernels or raise. A kernel
    computes delta = sum(do * out); bf16 dq is summed in f32 into a zeroed
    (B, H, Sq rounded up to 64, D) scratch, in an order that varies from
    run to run."""
    global bwd_launches
    if not _on_card(q, "flash_bwd"):
        return flash_bwd_ref(q, k, v, out, lse, do, causal, scale)
    _refuse(q, k, v)
    B, Sq, H, D = q.shape
    if (out.shape != q.shape or do.shape != q.shape or do.dtype != q.dtype
            or out.dtype != q.dtype):
        raise ValueError("flash_bwd: out and do must match q")
    if tuple(lse.shape) != (B, H, Sq) or lse.dtype != torch.float32:
        raise ValueError("flash_bwd: lse must be (B, H, Sq) f32")
    _check(q, k, v, out, do, lse)
    sp = -(-Sq // 64) * 64
    f32 = dict(dtype=torch.float32, device=q.device)
    delta = torch.empty((B, H, sp), **f32)
    lse2 = torch.empty((B, H, sp), **f32)
    acc = (torch.zeros((B, H, sp, D), **f32) if q.dtype == torch.bfloat16
           else None)
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    rc = _build.library().flash_attention_bwd_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        do.data_ptr(), lse.data_ptr(), dq.data_ptr(), dk.data_ptr(),
        dv.data_ptr(), delta.data_ptr(), lse2.data_ptr(),
        None if acc is None else acc.data_ptr(), B, H, Sq, k.shape[1], D,
        float(scale), int(causal), _CODES[q.dtype],
        torch.cuda.current_stream(q.device).cuda_stream)
    if rc:
        raise RuntimeError(f"flash attention backward launch failed: "
                           f"{_build.error_string(rc)} ({rc})")
    bwd_launches += 1
    return dq, dk, dv


class _Flash(torch.autograd.Function):
    """The JAX package's ``_flash`` custom VJP: the forward saves (q, k,
    v, out, lse), the backward runs ``flash_bwd``."""

    @staticmethod
    def forward(ctx, q, k, v, scale, causal):
        q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
        out, lse = flash_fwd(q, k, v, causal, scale)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.scale, ctx.causal = scale, causal
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_bwd(q, k, v, out, lse, do.contiguous(),
                               ctx.causal, ctx.scale)
        return dq, dk, dv, None, None


def flash_attention_fn(q, k, v, causal: bool = False, scale=None):
    """Flash attention on paddle's (B, S, H, D) layout, differentiable.
    Raises ``ValueError`` on what the kernels refuse, on causal with
    Sq > Sk (queries that see no key) and on unequal head counts, so the
    routing layer (``nn/functional.py``) takes the reference form."""
    if k.ndim == 4 and q.ndim == 4 and k.shape[2] != q.shape[2]:
        raise ValueError("flash_attention: repeat kv heads before the kernel")
    if causal and q.shape[1] > k.shape[1]:
        raise ValueError("flash_attention: causal requires sk >= sq")
    _refuse(q, k, v)
    scale = float(scale) if scale is not None else 1.0 / math.sqrt(
        q.shape[-1])
    return _Flash.apply(q, k, v, scale, bool(causal))


def flash_attention_op(q, k, v, causal=False, scale=None):
    return flash_attention_fn(q, k, v, causal=causal, scale=scale)
