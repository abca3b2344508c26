"""Models of the port: the Llama family, GPT, BERT and the diffusion
UNet."""

from paddle_tpu_torch.models.bert import (BERT_TINY, BertConfig,
                                          BertForMaskedLM)
from paddle_tpu_torch.models.gpt import GPT_TINY, GPTConfig, GPTForCausalLM
from paddle_tpu_torch.models.llama import (LlamaConfig, LlamaForCausalLM,
                                           TINY_CONFIG)
from paddle_tpu_torch.models.unet import (UNET_TINY, UNet2DConditionModel,
                                          UNetConfig)

__all__ = ["LlamaConfig", "LlamaForCausalLM", "TINY_CONFIG", "GPTConfig",
           "GPTForCausalLM", "GPT_TINY", "BertConfig", "BertForMaskedLM",
           "BERT_TINY", "UNetConfig", "UNet2DConditionModel", "UNET_TINY"]
