"""Device choice for the port's entry points.

The port runs on the card: ``LlamaForCausalLM``, ``LlamaDecoder`` and
everything built on them default to ``cuda`` and refuse to start when no
card is present. ``device="cpu"`` is the explicit opt-in to the CPU, where
every kernel wrapper runs its plain PyTorch version (the test suite's
route).
"""

from __future__ import annotations

import torch

__all__ = ["resolve_device"]


def resolve_device(device=None) -> torch.device:
    """``None`` means ``cuda``; a CUDA ask without a card raises."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available: paddle_tpu_torch runs on the card "
            "by default; pass device='cpu' to run the plain versions on the "
            "CPU")
    return dev
