"""Single-token GQA cache attention: CUDA kernel and plain version.

Counterpart of ``paddle_tpu/ops/pallas/decode_attention.py``; the kernel
is ``paddle_tpu_torch/csrc/decode_attention.cu``. Layouts as there: q
(B, H, D) one token per sequence; kc/vc (B, KV, L, D) padded head-major
cache, f32/bf16 like q or int8 with (B, KV, L, 1) f32 scales; out
(B, H, D) in q's dtype. ``pos`` is the valid length: an int or a scalar
or (B,) int tensor (rows at different cache offsets); positions
``>= pos[b]`` are masked. Inference only. The kernel splits the cache
length over a thread-block cluster of ``split_for(B, KV, L)`` blocks.

The launch is the custom op ``torch.ops.paddle_tpu_torch.decode_attention``
(lengths always a (B,) tensor), with a fake implementation, so
``torch.export`` records the call and an exported program runs the kernel
(``inference/aot.py``).
"""

from __future__ import annotations

import math

import torch

from typing import Optional

from paddle_tpu_torch.obs import cost as _cost
from paddle_tpu_torch.ops.kernels import _build

__all__ = ["supported", "split_for", "decode_attention",
           "decode_attention_ref", "launches"]

#: kernel launches made by ``decode_attention`` (plain-version calls and
#: direct ``decode_attention_ref`` calls do not count)
launches = 0

_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}
_SMS = 132            # the H100's streaming multiprocessors
_MIN_CHUNK = 64       # cache rows a block keeps at least: one full step


def split_for(B: int, KV: int, L: int) -> int:
    """P, the blocks of a thread-block cluster that split one (b, kv-head)
    pair's cache length: doubled from 1 (up to 8) while the grid of
    B * KV * P blocks is under one wave of the card's SMs and each block
    keeps at least 64 cache rows (one step of its 16 row groups, 4 rows
    each, at D 64). A function of the shapes only: the valid lengths live
    on the device and are never read on the host."""
    P = 1
    while P < 8 and B * KV * P < _SMS and L >= 2 * P * _MIN_CHUNK:
        P *= 2
    return P


def supported(q, kc) -> bool:
    """What the CUDA kernel takes: H a multiple of KV with rep = H / KV
    up to 16, D a multiple of 8 up to 256, f32/bf16 q with a cache of
    q's dtype or int8. Any L (the TPU kernel's L % 128 rule is gone)."""
    if q.ndim != 3 or kc.ndim != 4:
        return False
    B, H, D = q.shape
    Bk, KV, _, Dk = kc.shape
    return (Bk == B and Dk == D and KV >= 1 and H % KV == 0
            and H // KV <= 16 and D % 8 == 0 and D <= 256
            and q.dtype in (torch.float32, torch.bfloat16)
            and kc.dtype in (q.dtype, torch.int8))


def _lens(pos, B: int, device) -> torch.Tensor:
    """The valid length as a contiguous (B,) int32 tensor on ``device``
    (an int becomes a device fill: no host round-trip either way)."""
    if isinstance(pos, int):
        return torch.full((B,), pos, dtype=torch.int32, device=device)
    t = pos.to(device=device, dtype=torch.int32).reshape(-1)
    return t.expand(B).contiguous() if t.numel() == 1 else t.contiguous()


def decode_attention_ref(q, kc, vc, lens, k_scale=None, v_scale=None):
    """Plain version: f32 math, masked softmax, dequantized int8 cache.
    ``lens`` is the (B,) valid length."""
    B, H, D = q.shape
    KV, L = kc.shape[1], kc.shape[2]
    rep = H // KV
    k, v = kc.float(), vc.float()
    if k_scale is not None:
        k, v = k * k_scale.float(), v * v_scale.float()
    qf = q.float().reshape(B, KV, rep, D)
    s = torch.einsum("bgrd,bgld->bgrl", qf, k) * (1.0 / math.sqrt(D))
    valid = (torch.arange(L, device=q.device)[None, :]
             < lens.to(q.device).reshape(-1, 1))               # (B, L)
    s = s.masked_fill(~valid[:, None, None, :], float("-inf"))
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bgrl,bgld->bgrd", p, v)
    return out.reshape(B, H, D).to(q.dtype)


def _check(q, kc, vc, k_scale, v_scale):
    if not supported(q, kc):
        raise ValueError(
            f"decode_attention kernel does not take q {tuple(q.shape)} "
            f"{q.dtype} with cache {tuple(kc.shape)} {kc.dtype}")
    if vc.shape != kc.shape or vc.dtype != kc.dtype:
        raise ValueError("kc and vc must share shape and dtype")
    quant = kc.dtype == torch.int8
    if quant != (k_scale is not None) or (k_scale is None) != (v_scale is None):
        raise ValueError("int8 caches need k_scale and v_scale; other "
                         "caches take none")
    ts = [q, kc, vc] + ([k_scale, v_scale] if quant else [])
    if quant:
        want = tuple(kc.shape[:3]) + (1,)
        for s in (k_scale, v_scale):
            if tuple(s.shape) != want or s.dtype != torch.float32:
                raise ValueError(f"scales must be f32 {want}, got "
                                 f"{tuple(s.shape)} {s.dtype}")
    for t in ts:
        if t.device != q.device:
            raise ValueError("all operands must be on q's device")
        if not t.is_contiguous():
            raise ValueError("decode_attention kernel needs contiguous "
                             "operands")
    for t in (kc, vc):
        # the kernel loads 8 elements at once
        if t.data_ptr() % (8 * t.element_size()):
            raise ValueError("cache buffers must be 8-element aligned")


def decode_attention(q, kc, vc, pos, k_scale=None, v_scale=None):
    """q (B, H, D) x cache (B, KV, L, D), valid length ``pos`` ->
    (B, H, D). CPU tensors take the plain version; CUDA tensors launch
    the kernel or raise."""
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"decode_attention runs on cuda or cpu, got "
                         f"{q.device}")
    return decode_attention_op(q, kc, vc, _lens(pos, q.shape[0], q.device),
                               k_scale, v_scale)


@torch.library.custom_op("paddle_tpu_torch::decode_attention",
                         mutates_args=())
def decode_attention_op(q: torch.Tensor, kc: torch.Tensor, vc: torch.Tensor,
                        lens: torch.Tensor, k_scale: Optional[torch.Tensor],
                        v_scale: Optional[torch.Tensor]) -> torch.Tensor:
    """``decode_attention`` over (B,) int32 lengths ``lens``: the plain
    version on the CPU, the kernel on a card."""
    global launches
    B, H, D = q.shape
    KV, L = kc.shape[1], kc.shape[2]
    # a custom op is opaque to FlopCounterMode, on either route: its own
    # count, QK^T and PV over the cache length, while a cost pass runs
    _cost.add_flops(4 * B * H * L * D)
    if q.device.type == "cpu":
        return decode_attention_ref(q, kc, vc, lens, k_scale, v_scale)
    _check(q, kc, vc, k_scale, v_scale)
    lens = lens.to(torch.int32).contiguous()
    out = torch.empty_like(q)
    rc = _build.library().decode_attention_launch(
        q.data_ptr(), kc.data_ptr(), vc.data_ptr(),
        k_scale.data_ptr() if k_scale is not None else None,
        v_scale.data_ptr() if v_scale is not None else None,
        lens.data_ptr(), out.data_ptr(), B, H, KV, L, D,
        split_for(B, KV, L), _CODES[q.dtype], _CODES[kc.dtype],
        torch.cuda.current_stream(q.device).cuda_stream)
    if rc:
        raise RuntimeError(f"decode_attention launch failed: "
                           f"{_build.error_string(rc)} ({rc})")
    launches += 1
    return out


@decode_attention_op.register_fake
def _(q, kc, vc, lens, k_scale, v_scale):
    return torch.empty_like(q)
