"""Fused functional ops (``incubate.nn.functional``) and the
Mixture-of-Experts layers (``incubate.nn.moe``)."""

from paddle_tpu_torch.incubate.nn import functional
from paddle_tpu_torch.incubate.nn.moe import MoELayer, MoEMLP

__all__ = ["functional", "MoEMLP", "MoELayer"]
