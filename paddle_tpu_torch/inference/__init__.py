"""Inference: the KV-cache decoder."""

from paddle_tpu_torch.inference.generate import DecodeState, LlamaDecoder

__all__ = ["DecodeState", "LlamaDecoder"]
