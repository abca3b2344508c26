"""Fused functional ops (``incubate.nn.functional``)."""

from paddle_tpu_torch.incubate.nn import functional

__all__ = ["functional"]
