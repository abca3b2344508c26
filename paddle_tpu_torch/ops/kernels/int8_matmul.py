"""Weight-only int8 matmul: CUDA kernel and plain version.

Counterpart of ``paddle_tpu/ops/pallas/int8_matmul.py``; the kernel is
``paddle_tpu_torch/csrc/int8_matmul.cu``. x (B, K) f32/bf16, w (K, N)
int8, per-output-channel scale (N,) f32 -> out (B, N) in x's dtype,
dequantized inside the kernel (the weight streams int8). Inference only.
The launch is the custom op ``torch.ops.paddle_tpu_torch.int8_matmul``,
with a fake implementation, so ``torch.export`` records it.
"""

from __future__ import annotations

import torch

from paddle_tpu_torch.obs import cost as _cost
from paddle_tpu_torch.ops.kernels import _build

__all__ = ["supported", "int8_matmul", "int8_matmul_ref", "launches",
           "launches_by_rows"]

#: kernel launches made by ``int8_matmul`` (plain-version calls and direct
#: ``int8_matmul_ref`` calls do not count), in all and by the row count B
#: of x (a speculative verify's B (K + 1) rows apart from a draft's B)
launches = 0
launches_by_rows: dict = {}

_CODES = {torch.float32: 0, torch.bfloat16: 1}


def supported(x, w) -> bool:
    """Decode-shaped only, the JAX package's routing rule: at most 64
    rows (the weight-bandwidth-bound regime the kernel exists for; larger
    prefills stay a plain dequant matmul). The kernel itself takes any K
    and N."""
    return (x.ndim == 2 and w.ndim == 2 and w.dtype == torch.int8
            and x.shape[1] == w.shape[0] and 1 <= x.shape[0] <= 64
            and x.dtype in _CODES)


def int8_matmul_ref(x, w, scale):
    """Plain version: f32 math on the dequantized weight."""
    return ((x.float() @ w.float()) * scale.float()).to(x.dtype)


def int8_matmul(x, w, scale):
    """x (B, K) @ dequant(w (K, N) int8, scale (N,)) -> (B, N). CPU
    tensors take the plain version; CUDA tensors launch the kernel or
    raise."""
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"int8_matmul runs on cuda or cpu, got {x.device}")
    return int8_matmul_op(x, w, scale)


@torch.library.custom_op("paddle_tpu_torch::int8_matmul", mutates_args=())
def int8_matmul_op(x: torch.Tensor, w: torch.Tensor,
                   scale: torch.Tensor) -> torch.Tensor:
    """``int8_matmul``: the plain version on the CPU, the kernel on a
    card."""
    global launches
    # a custom op is opaque to FlopCounterMode, on either route: its own
    # count, while a cost pass runs
    _cost.add_flops(2 * x.shape[0] * x.shape[1] * w.shape[1])
    if x.device.type == "cpu":
        return int8_matmul_ref(x, w, scale)
    if not supported(x, w):
        raise ValueError(f"int8_matmul kernel does not take x "
                         f"{tuple(x.shape)} {x.dtype} with w "
                         f"{tuple(w.shape)} {w.dtype}")
    B, K = x.shape
    N = w.shape[1]
    if tuple(scale.shape) != (N,) or scale.dtype != torch.float32:
        raise ValueError(f"scale must be f32 ({N},), got "
                         f"{tuple(scale.shape)} {scale.dtype}")
    for t in (x, w, scale):
        if t.device != x.device:
            raise ValueError("all operands must be on x's device")
        if not t.is_contiguous():
            raise ValueError("int8_matmul kernel needs contiguous operands")
    out = torch.empty((B, N), dtype=x.dtype, device=x.device)
    rc = _build.library().int8_matmul_launch(
        x.data_ptr(), w.data_ptr(), scale.data_ptr(), out.data_ptr(),
        B, K, N, _CODES[x.dtype],
        torch.cuda.current_stream(x.device).cuda_stream)
    if rc:
        raise RuntimeError(f"int8_matmul launch failed: "
                           f"{_build.error_string(rc)} ({rc})")
    launches += 1
    launches_by_rows[B] = launches_by_rows.get(B, 0) + 1
    return out


@int8_matmul_op.register_fake
def _(x, w, scale):
    return x.new_empty((x.shape[0], w.shape[1]))
