"""Weight-only int8 quantization for inference.

Counterpart of ``paddle_tpu/quantization/__init__.py:weight_quantize``
(the reference's ``weight_quantize`` op): per-output-channel absmax int8
of an ``(in, out)`` weight. ``torch.round`` rounds half to even, as
``jnp.round`` does, so both packages produce the same int8 codes.
"""

from __future__ import annotations

import torch

__all__ = ["weight_quantize"]


def weight_quantize(w: torch.Tensor, algo: str = "weight_only_int8"):
    """Per-output-channel int8 quantization of a (in, out) weight matrix.
    Returns ``(int8 weight (in, out), f32 per-channel scale (out,))``."""
    if algo not in ("weight_only_int8", "llm.int8"):
        raise NotImplementedError(f"weight_quantize algo {algo!r}")
    wf = w.float()
    scale = torch.clamp_min(wf.abs().amax(dim=0) / 127.0, 1e-8)
    q = torch.clamp(torch.round(wf / scale[None, :]), -127, 127)
    return q.to(torch.int8).contiguous(), scale
