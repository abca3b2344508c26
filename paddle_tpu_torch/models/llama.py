"""Llama-family causal LM — the parameter holder the decoder serves.

Counterpart of ``paddle_tpu/models/llama.py``: the same config, the same
parameter names as the JAX model's ``state_dict()`` and paddle's
``(in, out)`` linear layout, so ``convert.from_jax_state_dict`` carries
weights across one to one. This slice serves the model; the training
forward (flash attention, the RMSNorm kernel) arrives with the training
slice, so the modules here hold parameters and ``generate`` delegates to
``inference.generate.LlamaDecoder``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch
from torch import nn

from paddle_tpu_torch.device import resolve_device

__all__ = ["LlamaConfig", "LlamaForCausalLM", "TINY_CONFIG"]


@dataclass
class LlamaConfig:
    vocab_size: int = 32000
    hidden_size: int = 4096
    intermediate_size: int = 11008
    num_hidden_layers: int = 32
    num_attention_heads: int = 32
    num_key_value_heads: int = 32
    max_position_embeddings: int = 4096
    rms_norm_eps: float = 1e-6
    rope_theta: float = 10000.0
    tie_word_embeddings: bool = False
    dtype: str = "float32"

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_attention_heads

    @property
    def torch_dtype(self) -> torch.dtype:
        return getattr(torch, self.dtype)


TINY_CONFIG = LlamaConfig(vocab_size=256, hidden_size=64,
                          intermediate_size=128, num_hidden_layers=2,
                          num_attention_heads=4, num_key_value_heads=2,
                          max_position_embeddings=128)


def _rope_tables(seq_len: int, head_dim: int, theta: float, dtype,
                 offset: int = 0, device=None):
    """cos/sin tables (seq_len, head_dim/2) for positions
    ``offset + [0..seq_len)``, computed in f32 and cast to ``dtype``."""
    inv_freq = 1.0 / (theta ** (torch.arange(
        0, head_dim, 2, dtype=torch.float32, device=device) / head_dim))
    t = offset + torch.arange(seq_len, dtype=torch.float32, device=device)
    freqs = torch.outer(t, inv_freq)
    return torch.cos(freqs).to(dtype), torch.sin(freqs).to(dtype)


class _Weight(nn.Module):
    """One ``weight`` parameter (inference only: no gradient)."""

    def __init__(self, shape, dtype, device, init, gen):
        super().__init__()
        w = torch.empty(shape, dtype=torch.float32, device=device)
        if init == "ones":
            w.fill_(1.0)
        else:
            w.normal_(0.0, 0.02, generator=gen)
        self.weight = nn.Parameter(w.to(dtype), requires_grad=False)


class LlamaAttention(nn.Module):
    def __init__(self, cfg: LlamaConfig, mk):
        super().__init__()
        h, kv, d = (cfg.num_attention_heads, cfg.num_key_value_heads,
                    cfg.head_dim)
        self.q_proj = mk((cfg.hidden_size, h * d))
        self.k_proj = mk((cfg.hidden_size, kv * d))
        self.v_proj = mk((cfg.hidden_size, kv * d))
        self.o_proj = mk((h * d, cfg.hidden_size))


class LlamaMLP(nn.Module):
    def __init__(self, cfg: LlamaConfig, mk):
        super().__init__()
        self.gate_proj = mk((cfg.hidden_size, cfg.intermediate_size))
        self.up_proj = mk((cfg.hidden_size, cfg.intermediate_size))
        self.down_proj = mk((cfg.intermediate_size, cfg.hidden_size))


class LlamaDecoderLayer(nn.Module):
    def __init__(self, cfg: LlamaConfig, mk):
        super().__init__()
        self.input_layernorm = mk((cfg.hidden_size,), "ones")
        self.self_attn = LlamaAttention(cfg, mk)
        self.post_attention_layernorm = mk((cfg.hidden_size,), "ones")
        self.mlp = LlamaMLP(cfg, mk)


class LlamaModel(nn.Module):
    def __init__(self, cfg: LlamaConfig, mk):
        super().__init__()
        self.embed_tokens = mk((cfg.vocab_size, cfg.hidden_size))
        self.layers = nn.ModuleList(LlamaDecoderLayer(cfg, mk)
                                    for _ in range(cfg.num_hidden_layers))
        self.norm = mk((cfg.hidden_size,), "ones")


class LlamaForCausalLM(nn.Module):
    """Parameters named as in the JAX model's ``state_dict()``; linear
    weights normal(0, 0.02) from a ``torch.Generator`` seeded with
    ``seed`` on ``device``, norm weights ones. ``device`` defaults to
    ``cuda`` and raises without a card (``device="cpu"`` opts in)."""

    def __init__(self, config: LlamaConfig, device=None, seed: int = 0):
        super().__init__()
        dev = resolve_device(device)
        self.config = config
        gen = torch.Generator(device=dev).manual_seed(int(seed))
        dt = config.torch_dtype

        def mk(shape, init="normal"):
            return _Weight(shape, dt, dev, init, gen)

        self.model = LlamaModel(config, mk)
        self.lm_head = (None if config.tie_word_embeddings
                        else mk((config.hidden_size, config.vocab_size)))

    @property
    def device(self) -> torch.device:
        return self.model.embed_tokens.weight.device

    def generate(self, input_ids, max_new_tokens: int = 32,
                 max_len: Optional[int] = None,
                 decode_strategy: str = "greedy_search", **kwargs):
        """Greedy decode through a ``LlamaDecoder`` cached on the model
        (rebuilt when a parameter changed or the quant recipe differs),
        on the model's device."""
        from paddle_tpu_torch.inference.generate import LlamaDecoder
        from paddle_tpu_torch.quantization.kv_cache import \
            resolve_decode_quant
        if decode_strategy != "greedy_search":
            raise NotImplementedError(
                f"decode_strategy={decode_strategy!r} is not ported yet "
                f"(ROADMAP queue 1: threefry sampling, beam search)")
        need = int(np.asarray(input_ids).shape[1]) + max_new_tokens
        if max_len is not None and max_len < need:
            raise ValueError(f"max_len {max_len} < prompt + new tokens "
                             f"({need})")
        ml = max(64, need) if max_len is None else max_len
        quant = resolve_decode_quant(kwargs.pop("quant", None))
        version = (tuple((id(p), p._version) for p in self.parameters()),
                   quant)
        dec = self.__dict__.get("_decoder")
        if (dec is None or dec.max_len < need
                or self.__dict__.get("_decoder_version") != version):
            dec = LlamaDecoder(self, max_len=ml, quant=quant,
                               device=self.device)
            self.__dict__["_decoder"] = dec
            self.__dict__["_decoder_version"] = version
        return dec.generate(input_ids, max_new_tokens=max_new_tokens,
                            **kwargs)
