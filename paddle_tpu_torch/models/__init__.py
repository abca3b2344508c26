"""Models of the port: the Llama family and the diffusion UNet."""

from paddle_tpu_torch.models.llama import (LlamaConfig, LlamaForCausalLM,
                                           TINY_CONFIG)
from paddle_tpu_torch.models.unet import (UNET_TINY, UNet2DConditionModel,
                                          UNetConfig)

__all__ = ["LlamaConfig", "LlamaForCausalLM", "TINY_CONFIG", "UNetConfig",
           "UNet2DConditionModel", "UNET_TINY"]
