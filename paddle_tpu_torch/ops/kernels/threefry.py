"""Threefry-2x32 counter hashing: CUDA kernel and plain version.

No Pallas kernel corresponds: the JAX package's samplers call
``jax.random``, whose ``threefry2x32_p`` XLA lowers
(``jax/_src/prng.py``). The kernel is ``paddle_tpu_torch/csrc/threefry.cu``.
``threefry_words(keys, n, base)`` hashes counters ``base .. base + n - 1``
(high word 0) under each of R keys: ``keys`` (R, 2) int32 holding the
uint32 key words, out (R, n, 2) int32 holding the uint32 output words.
``paddle_tpu_torch/random.py`` builds ``split``, ``fold_in`` and
``random_bits`` on it. Only integers cross the kernel, so kernel and plain
version agree bit for bit. The launch is the custom op
``torch.ops.paddle_tpu_torch.threefry``, with a fake implementation, so
``torch.export`` records it.
"""

from __future__ import annotations

import torch

from paddle_tpu_torch.ops.kernels import _build

__all__ = ["threefry_words", "threefry_words_ref", "launches"]

#: kernel launches made by ``threefry_words`` (plain-version calls and
#: direct ``threefry_words_ref`` calls do not count)
launches = 0

_M = 0xFFFFFFFF
_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))


def _u32(x):
    """int32 words -> their uint32 values in int64."""
    return x.to(torch.int64) & _M


def _i32(x):
    """uint32 values in int64 -> int32 words (the same bits)."""
    return (x - ((x >> 31) << 32)).to(torch.int32)


def _rotl(v, r: int):
    return ((v << r) | (v >> (32 - r))) & _M


def threefry_words_ref(keys, n: int, base: int = 0):
    """Plain version: threefry2x32 in int64 masked to 32 bits (torch's
    uint32 has no add or shift on the CPU)."""
    k0 = _u32(keys[:, 0:1])
    k1 = _u32(keys[:, 1:2])
    ks = (k0, k1, k0 ^ k1 ^ 0x1BD11BDA)
    ctr = (torch.arange(n, dtype=torch.int64, device=keys.device)
           + int(base)) & _M
    x0 = ks[0].expand(-1, n)
    x1 = (ctr[None, :] + ks[1]) & _M
    for i in range(5):
        for r in _ROT[i % 2]:
            x0 = (x0 + x1) & _M
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & _M
        x1 = (x1 + ks[(i + 2) % 3] + i + 1) & _M
    return _i32(torch.stack([x0, x1], dim=-1))


def threefry_words(keys, n: int, base: int = 0):
    """Both threefry words of counters ``base .. base + n - 1`` under each
    key: keys (R, 2) int32 -> (R, n, 2) int32. CPU tensors take the plain
    version; CUDA tensors launch the kernel or raise."""
    if keys.dim() != 2 or keys.shape[1] != 2 or keys.dtype != torch.int32:
        raise ValueError(f"keys must be (R, 2) int32, got "
                         f"{tuple(keys.shape)} {keys.dtype}")
    n = int(n)
    if not 1 <= n < 2**31:
        raise ValueError(f"counter count must be in [1, 2^31), got {n}")
    if keys.device.type not in ("cpu", "cuda"):
        raise ValueError(f"threefry runs on cuda or cpu, got {keys.device}")
    return threefry_op(keys, n, int(base) & _M)


@torch.library.custom_op("paddle_tpu_torch::threefry", mutates_args=())
def threefry_op(keys: torch.Tensor, n: int, base: int) -> torch.Tensor:
    """``threefry_words`` of checked arguments: the plain version on the
    CPU, the kernel on a card."""
    global launches
    if keys.device.type == "cpu":
        return threefry_words_ref(keys, n, base)
    R = keys.shape[0]
    if not 1 <= R <= 65535:
        raise ValueError(f"threefry kernel takes 1-65535 keys, got {R}")
    keys = keys.contiguous()
    out = torch.empty((R, n, 2), dtype=torch.int32, device=keys.device)
    rc = _build.library().threefry_launch(
        keys.data_ptr(), R, n, base, out.data_ptr(),
        torch.cuda.current_stream(keys.device).cuda_stream)
    if rc:
        raise RuntimeError(f"threefry launch failed: "
                           f"{_build.error_string(rc)} ({rc})")
    launches += 1
    return out


@threefry_op.register_fake
def _(keys, n, base):
    return keys.new_empty((keys.shape[0], n, 2))
