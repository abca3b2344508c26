"""Int8 KV-cache quantization for the decode stack (the ``int8wk`` recipe).

Counterpart of ``paddle_tpu/quantization/kv_cache.py``. A quantized cache
buffer is a plain ``{"q", "s"}`` dict of tensors:

- ``q``: int8, the shape the unquantized cache buffer had;
- ``s``: f32 per-position-per-head scales with a kept last dim of 1
  (``q.shape[:-1] + (1,)``), so indexing by position lands on the same
  axis in both leaves.

Each written K/V row quantizes by its own absmax over the head dim, so a
row's codes depend only on that row's values: chunk re-entry and the
engine's admission row copy stay bit-exact with run-to-completion.
"""

from __future__ import annotations

import os
from typing import Optional

import torch

__all__ = ["QuantMismatchError", "canonical_quant", "resolve_decode_quant",
           "is_quantized_kv", "quantize_kv_rows", "dequantize_kv",
           "quant_kv_zeros", "QUANT_RECIPES"]

#: the decode dtype recipes: int8w = per-channel absmax int8 weights
#: (fp32 scales), int8wk = int8w + int8 KV cache (per-row absmax scales)
QUANT_RECIPES = ("int8w", "int8wk")

_NONE_ASKS = ("", "none", "fp32", "float32", "bf16", "bfloat16")


class QuantMismatchError(ValueError):
    """A quantization contract violation: an unknown recipe, a backend
    asked to serve a recipe it was not built with, or conflicting
    ``quant=`` / ``weight_dtype=`` arguments."""


def canonical_quant(quant) -> Optional[str]:
    """Normalize a quant ask: ``None``/``""``/``"none"``/``"fp32"`` ->
    ``None``; ``"int8w"``/``"int8wk"`` -> themselves; anything else is a
    typed refusal."""
    if quant is None:
        return None
    q = str(quant).strip().lower()
    if q in _NONE_ASKS:
        return None
    if q not in QUANT_RECIPES:
        raise QuantMismatchError(
            f"unknown decode quant recipe {quant!r}; expected one of "
            f"{QUANT_RECIPES} (or none/fp32 for the unquantized path)")
    return q


def resolve_decode_quant(quant=None, weight_dtype=None) -> Optional[str]:
    """An explicit ``quant=`` wins; the legacy ``weight_dtype="int8"``
    aliases ``"int8w"``; with neither, the ``PADDLE_TPU_DECODE_QUANT``
    env / ``FLAGS_decode_quant`` default applies (empty = unquantized)."""
    if weight_dtype not in (None, "int8"):
        raise ValueError(f"weight_dtype must be None or 'int8', "
                         f"got {weight_dtype!r}")
    alias = "int8w" if weight_dtype == "int8" else None
    if quant is not None:
        q = canonical_quant(quant)
        if alias is not None and q is None:
            raise QuantMismatchError(
                f"quant={quant!r} contradicts weight_dtype='int8' "
                f"(pass one or the other)")
        return q
    if alias is not None:
        return alias
    env = os.environ.get("PADDLE_TPU_DECODE_QUANT", "").strip()
    if env:
        return canonical_quant(env)
    from paddle_tpu_torch.flags import flags
    return canonical_quant(flags.decode_quant)


def is_quantized_kv(cache) -> bool:
    """True for one quantized cache buffer (the ``{"q", "s"}`` dict)."""
    return isinstance(cache, dict) and "q" in cache and "s" in cache


def quantize_kv_rows(t: torch.Tensor) -> dict:
    """Quantize K/V rows ``t (..., D)`` by per-row absmax over the head
    dim: ``{"q": int8 (..., D), "s": f32 (..., 1)}``."""
    x = t.float()
    s = torch.clamp_min(x.abs().amax(dim=-1, keepdim=True) / 127.0, 1e-8)
    q = torch.clamp(torch.round(x / s), -127, 127).to(torch.int8)
    return {"q": q, "s": s}


def dequantize_kv(cache, dtype):
    """Int8 rows times their per-row scales, in ``dtype``; an unquantized
    buffer passes through untouched."""
    if not is_quantized_kv(cache):
        return cache
    return cache["q"].to(dtype) * cache["s"].to(dtype)


def quant_kv_zeros(shape, device=None) -> dict:
    """An empty quantized cache buffer of the given (unquantized) shape."""
    return {"q": torch.zeros(shape, dtype=torch.int8, device=device),
            "s": torch.zeros(tuple(shape[:-1]) + (1,), dtype=torch.float32,
                             device=device)}
