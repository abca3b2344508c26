"""Models served by the port."""

from paddle_tpu_torch.models.llama import (LlamaConfig, LlamaForCausalLM,
                                           TINY_CONFIG)

__all__ = ["LlamaConfig", "LlamaForCausalLM", "TINY_CONFIG"]
