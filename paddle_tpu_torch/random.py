"""``jax.random`` for the port: threefry2x32 keys and samplers.

The JAX package samples with ``jax.random``; the port keeps its own copy,
bit-equal to JAX 0.9 with ``jax_threefry_partitionable`` on (its default)
and 64-bit types off, the JAX package's configuration:

- a key is two uint32 words, held here as an int32 tensor ``(..., 2)`` of
  the same bits (``key.numpy().astype(np.uint32)`` is JAX's key);
  ``PRNGKey(seed)`` is ``(0, seed mod 2^32)``, made on the card unless
  the caller passes ``device="cpu"`` (every other function works on the
  device of the key it is given);
- ``split(key, n)`` is the pair of threefry words of counters
  ``0 .. n-1`` (``_threefry_split_foldlike``), ``fold_in(key, d)`` the
  pair of counter ``d``, and 32-bit ``random_bits`` of a shape the xor of
  the two words over a row-major iota of it
  (``_threefry_random_bits_partitionable``);
- ``uniform`` keeps 23 random mantissa bits under the exponent of 1.0,
  subtracts 1, scales, shifts and clamps at ``minval`` (``_uniform``);
  ``gumbel`` is ``-log(-log(uniform(tiny, 1)))`` (mode "low");
  ``categorical`` is the argmax of gumbel noise plus the logits.

The counter hashing is ``ops/kernels/threefry.py`` (the CUDA kernel on a
card, its plain version on the CPU); everything else is torch ops on
both. The ``*_rows`` forms take one key per row, ``(R, 2)``: the
``jax.vmap`` of the single-key form that the chunk programs use.
"""

from __future__ import annotations

import math
from typing import Sequence, Union

import numpy as np
import torch

from paddle_tpu_torch.device import resolve_device
from paddle_tpu_torch.ops.kernels.threefry import threefry_words

__all__ = ["PRNGKey", "split", "fold_in", "random_bits", "uniform",
           "gumbel", "categorical", "split_rows", "uniform_rows",
           "categorical_rows"]

_TINY = float(np.finfo(np.float32).tiny)
Shape = Union[int, Sequence[int]]


def _shape(shape: Shape) -> tuple:
    return (int(shape),) if isinstance(shape, (int, np.integer)) \
        else tuple(int(s) for s in shape)


def PRNGKey(seed: int, device=None) -> torch.Tensor:
    """The key of an integer seed: ``(0, seed mod 2^32)``, as JAX makes it
    with 64-bit types off; on the card unless ``device`` says otherwise."""
    lo = int(seed) & 0xFFFFFFFF
    if lo >= 2**31:
        lo -= 2**32
    return torch.tensor([0, lo], dtype=torch.int32,
                        device=resolve_device(device))


def split(key: torch.Tensor, num: int = 2) -> torch.Tensor:
    """``num`` new keys ``(num, 2)``."""
    return threefry_words(key.reshape(1, 2), int(num))[0]


def fold_in(key: torch.Tensor, data: int) -> torch.Tensor:
    """A new key from ``key`` and a 32-bit integer."""
    return threefry_words(key.reshape(1, 2), 1,
                          base=int(data) & 0xFFFFFFFF)[0, 0]


def split_rows(keys: torch.Tensor, num: int = 2) -> torch.Tensor:
    """``split`` of each row's key: (R, 2) -> (R, num, 2)."""
    return threefry_words(keys, int(num))


def _bits_rows(keys: torch.Tensor, n: int) -> torch.Tensor:
    w = threefry_words(keys, n)
    return w[..., 0] ^ w[..., 1]


def random_bits(key: torch.Tensor, shape: Shape) -> torch.Tensor:
    """32 random bits per element, as int32 words of the uint32 values."""
    shape = _shape(shape)
    return _bits_rows(key.reshape(1, 2), max(1, math.prod(shape)))[0] \
        .reshape(shape)


def _uniform_bits(bits: torch.Tensor, minval: float,
                  maxval: float) -> torch.Tensor:
    # bits >> 9 as a logical shift on int32: the arithmetic shift, masked
    mant = ((bits >> 9) & 0x7FFFFF) | 0x3F800000
    floats = mant.view(torch.float32) - 1.0
    lo, hi = np.float32(minval), np.float32(maxval)
    scale = float(hi - lo)
    if scale == 1.0:
        # the product is exact: separate f32 ops equal XLA's fused
        # multiply-add (the samplers' case, [tiny, 1) and [0, 1))
        out = floats + float(lo)
    else:
        # XLA fuses floats * scale + lo into one rounding: the f32
        # product is exact in f64, so round the f64 sum once to f32
        out = (floats.double() * scale + float(lo)).float()
    return torch.clamp(out, min=float(lo))


def uniform(key: torch.Tensor, shape: Shape = (), minval: float = 0.0,
            maxval: float = 1.0) -> torch.Tensor:
    """f32 uniforms on ``[minval, maxval)``."""
    return _uniform_bits(random_bits(key, shape), minval, maxval)


def uniform_rows(keys: torch.Tensor, num: int) -> torch.Tensor:
    """``uniform(key, (num,))`` of each row's key: (R, 2) -> (R, num) f32
    on [0, 1)."""
    return _uniform_bits(_bits_rows(keys, int(num)), 0.0, 1.0)


def _gumbel_bits(bits: torch.Tensor) -> torch.Tensor:
    return -torch.log(-torch.log(_uniform_bits(bits, _TINY, 1.0)))


def gumbel(key: torch.Tensor, shape: Shape = ()) -> torch.Tensor:
    """f32 standard Gumbel noise."""
    return _gumbel_bits(random_bits(key, shape))


def categorical(key: torch.Tensor, logits: torch.Tensor,
                axis: int = -1) -> torch.Tensor:
    """One draw along ``axis`` of f32 ``logits`` (any leading shape): the
    argmax of Gumbel noise over the whole shape plus the logits."""
    return torch.argmax(gumbel(key, logits.shape) + logits, dim=axis)


def categorical_rows(keys: torch.Tensor,
                     logits: torch.Tensor) -> torch.Tensor:
    """Row r's draw from ``logits[r]`` (R, V) under ``keys[r]`` (R, 2)."""
    R, V = logits.shape
    return torch.argmax(_gumbel_bits(_bits_rows(keys, V)) + logits, dim=-1)
