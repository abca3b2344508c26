"""GPT-2-style causal LM: LayerNorm, learned positions, fused-qkv
attention, a GELU MLP, the head tied to the token embedding.

Counterpart of ``paddle_tpu/models/gpt.py`` (the LM of ``bench.py``'s
``bench_ernie``), with its config, parameter names and layouts, so
``convert.from_jax_state_dict`` carries weights across. Attention goes
through ``nn.functional.scaled_dot_product_attention`` (causal: the
flash-attention kernels at S >= ``flash_attention_min_seq``); dropout
(the config's, 0.1 by default) on the embeddings and both residual
branches draws from ``framework.random``, so a ``ShardedTrainer`` step
draws fresh masks from its step key. ``loss`` goes through the chunked
fused head + CE for V >= 4096 with ``use_fused_lm_ce``. ``generate``:
greedy and sampled through ``nn.generation.generate_tokens``, beam search
through ``nn.generation.beam_search``.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
from torch import nn

from paddle_tpu_torch.amp.auto_cast import amp_cast
from paddle_tpu_torch.flags import flags
from paddle_tpu_torch.models._common import as_ids, layer_kwargs
from paddle_tpu_torch.nn import functional as F
from paddle_tpu_torch.nn.layers import (Dropout, Embedding, LayerList,
                                        LayerNorm, Linear)

__all__ = ["GPTConfig", "GPTBlock", "GPTForCausalLM", "GPT_TINY"]


@dataclass
class GPTConfig:
    vocab_size: int = 50257
    hidden_size: int = 768
    num_hidden_layers: int = 12
    num_attention_heads: int = 12
    intermediate_size: int = 3072
    max_position_embeddings: int = 1024
    layer_norm_epsilon: float = 1e-5
    dropout: float = 0.1


GPT_TINY = GPTConfig(vocab_size=256, hidden_size=64, num_hidden_layers=2,
                     num_attention_heads=4, intermediate_size=128,
                     max_position_embeddings=128, dropout=0.0)


class GPTBlock(nn.Module):
    def __init__(self, cfg: GPTConfig, *, device=None, dtype=torch.float32,
                 generator=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype, generator=generator)
        H, eps = cfg.hidden_size, cfg.layer_norm_epsilon
        self.ln_1 = LayerNorm(H, epsilon=eps, device=device, dtype=dtype)
        self.c_attn = Linear(H, 3 * H, **kw)
        self.c_proj = Linear(H, H, **kw)
        self.ln_2 = LayerNorm(H, epsilon=eps, device=device, dtype=dtype)
        self.mlp_fc = Linear(H, cfg.intermediate_size, **kw)
        self.mlp_proj = Linear(cfg.intermediate_size, H, **kw)
        self.drop = Dropout(cfg.dropout)
        self.n_head = cfg.num_attention_heads
        self.head_dim = H // cfg.num_attention_heads

    def forward(self, x):
        B, S, H = x.shape
        qkv = self.c_attn(self.ln_1(x)).reshape(B, S, 3, self.n_head,
                                                self.head_dim)
        q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
        a = F.scaled_dot_product_attention(q, k, v, is_causal=True,
                                           training=self.training)
        a = self.c_proj(a.reshape(B, S, H))
        x = x + self.drop(a)
        m = self.mlp_proj(F.gelu(self.mlp_fc(self.ln_2(x))))
        return x + self.drop(m)


class GPTForCausalLM(nn.Module):
    """Parameters named as in the JAX model's ``state_dict()``: linear
    weights (in, out) from XavierUniform, biases zeros, embeddings
    normal(0, 1), LayerNorms ones and zeros, drawn from a
    ``torch.Generator`` seeded with ``seed`` on ``device`` (the card
    unless the caller asks for the CPU) and cast to ``dtype``."""

    def __init__(self, config: GPTConfig, device=None, seed: int = 0,
                 dtype=torch.float32):
        super().__init__()
        kw = layer_kwargs(device, dtype, seed)
        self.config = config
        H = config.hidden_size
        self.wte = Embedding(config.vocab_size, H, **kw)
        self.wpe = Embedding(config.max_position_embeddings, H, **kw)
        self.h = LayerList([GPTBlock(config, **kw)
                            for _ in range(config.num_hidden_layers)])
        self.ln_f = LayerNorm(H, epsilon=config.layer_norm_epsilon,
                              device=kw["device"], dtype=dtype)
        self.drop = Dropout(config.dropout)

    @property
    def device(self) -> torch.device:
        return self.wte.weight.device

    def hidden_states(self, input_ids):
        ids = as_ids(input_ids, self.device)
        pos = torch.arange(ids.shape[1], device=self.device)[None]
        x = self.drop(self.wte(ids) + self.wpe(pos))
        for blk in self.h:
            x = blk(x)
        return self.ln_f(x)

    def forward(self, input_ids):
        # the tied head: paddle.matmul with the transposed embedding
        return torch.matmul(*amp_cast("matmul", self.hidden_states(
            input_ids), self.wte.weight.t()))

    def loss(self, input_ids, labels):
        """Mean CE of the logits against ``labels`` (the caller shifts);
        through the chunked fused head + CE for V >= 4096 with
        ``use_fused_lm_ce``."""
        V = self.config.vocab_size
        labels = as_ids(labels, self.device)
        if flags.use_fused_lm_ce and V >= 4096:
            from paddle_tpu_torch.ops.fused_ce import fused_lm_loss
            return fused_lm_loss(self.hidden_states(input_ids),
                                 self.wte.weight.t(), labels)
        logits = self(input_ids)
        return F.cross_entropy(logits.reshape(-1, V), labels.reshape(-1))

    def num_params(self) -> int:
        return sum(p.numel() for p in self.parameters())

    def generate(self, input_ids, max_new_tokens: int = 32,
                 decode_strategy: str = "greedy_search", **kwargs):
        """Greedy, sampled or beam decode with no cache (``decode_strategy``
        ``greedy_search`` | ``sampling`` | ``beam_search``)."""
        from paddle_tpu_torch.nn.generation import (beam_search,
                                                    generate_tokens)
        if decode_strategy not in ("greedy_search", "sampling",
                                   "beam_search"):
            raise ValueError(f"unknown decode_strategy {decode_strategy!r}")
        if decode_strategy == "beam_search":
            return beam_search(self, input_ids,
                               max_new_tokens=max_new_tokens, **kwargs)
        if decode_strategy == "sampling":
            kwargs.setdefault("do_sample", True)
        return generate_tokens(self, input_ids,
                               max_new_tokens=max_new_tokens, **kwargs)
