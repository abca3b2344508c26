"""BERT encoder with the masked-LM head (BERT-base MLM pretraining).

Counterpart of ``paddle_tpu/models/bert.py`` (``bench.py``'s
``bench_bert``), with its config, parameter names and layouts, built on
``nn.TransformerEncoder`` (post-norm GELU layers). Attention without a
mask and without attention dropout reaches the flash-attention kernels
(non-causal) at S >= ``flash_attention_min_seq``. The head is tied to the
word embedding; ``loss(ignore_index=)`` goes through the chunked fused
head + CE for V >= 4096 with ``use_fused_lm_ce``.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
from torch import nn

from paddle_tpu_torch.amp.auto_cast import amp_cast
from paddle_tpu_torch.flags import flags
from paddle_tpu_torch.models._common import as_ids, layer_kwargs
from paddle_tpu_torch.nn import functional as F
from paddle_tpu_torch.nn.layers import Dropout, Embedding, LayerNorm, Linear
from paddle_tpu_torch.nn.transformer import (TransformerEncoder,
                                             TransformerEncoderLayer)

__all__ = ["BertConfig", "BertEmbeddings", "BertForMaskedLM", "BERT_TINY"]


@dataclass
class BertConfig:
    vocab_size: int = 30522
    hidden_size: int = 768
    num_hidden_layers: int = 12
    num_attention_heads: int = 12
    intermediate_size: int = 3072
    max_position_embeddings: int = 512
    type_vocab_size: int = 2
    layer_norm_eps: float = 1e-12
    dropout: float = 0.1


BERT_TINY = BertConfig(vocab_size=256, hidden_size=64, num_hidden_layers=2,
                       num_attention_heads=4, intermediate_size=128,
                       max_position_embeddings=64, dropout=0.0)


class BertEmbeddings(nn.Module):
    def __init__(self, cfg: BertConfig, *, device=None, dtype=torch.float32,
                 generator=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype, generator=generator)
        H = cfg.hidden_size
        self.word_embeddings = Embedding(cfg.vocab_size, H, **kw)
        self.position_embeddings = Embedding(cfg.max_position_embeddings, H,
                                             **kw)
        self.token_type_embeddings = Embedding(cfg.type_vocab_size, H, **kw)
        self.layer_norm = LayerNorm(H, epsilon=cfg.layer_norm_eps,
                                    device=device, dtype=dtype)
        self.dropout = Dropout(cfg.dropout)

    def forward(self, input_ids, token_type_ids=None):
        pos = torch.arange(input_ids.shape[1], device=input_ids.device)[None]
        e = self.word_embeddings(input_ids) + self.position_embeddings(pos)
        if token_type_ids is not None:
            e = e + self.token_type_embeddings(token_type_ids)
        return self.dropout(self.layer_norm(e))


class BertForMaskedLM(nn.Module):
    """Parameters named as in the JAX model's ``state_dict()``, drawn from
    a ``torch.Generator`` seeded with ``seed`` on ``device`` (the card
    unless the caller asks for the CPU) and cast to ``dtype``; the encoder
    layers are copies of the first, as in the JAX package."""

    def __init__(self, config: BertConfig, device=None, seed: int = 0,
                 dtype=torch.float32):
        super().__init__()
        kw = layer_kwargs(device, dtype, seed)
        self.config = config
        H = config.hidden_size
        self.embeddings = BertEmbeddings(config, **kw)
        layer = TransformerEncoderLayer(
            d_model=H, nhead=config.num_attention_heads,
            dim_feedforward=config.intermediate_size,
            dropout=config.dropout, activation="gelu",
            normalize_before=False, **kw)
        self.encoder = TransformerEncoder(layer, config.num_hidden_layers)
        self.transform = Linear(H, H, **kw)
        self.transform_ln = LayerNorm(H, epsilon=config.layer_norm_eps,
                                      device=kw["device"], dtype=dtype)

    @property
    def device(self) -> torch.device:
        return self.embeddings.word_embeddings.weight.device

    def hidden_states(self, input_ids, token_type_ids=None,
                      attention_mask=None):
        ids = as_ids(input_ids, self.device)
        tt = (None if token_type_ids is None
              else as_ids(token_type_ids, self.device))
        h = self.embeddings(ids, tt)
        h = self.encoder(h, src_mask=attention_mask)
        return self.transform_ln(F.gelu(self.transform(h)))

    def forward(self, input_ids, token_type_ids=None, attention_mask=None):
        h = self.hidden_states(input_ids, token_type_ids, attention_mask)
        return torch.matmul(*amp_cast(
            "matmul", h, self.embeddings.word_embeddings.weight.t()))

    def loss(self, input_ids, labels, ignore_index: int = -100, **kw):
        """Mean CE over the labels that are not ``ignore_index``."""
        V = self.config.vocab_size
        labels = as_ids(labels, self.device)
        if flags.use_fused_lm_ce and V >= 4096:
            from paddle_tpu_torch.ops.fused_ce import fused_lm_loss
            h = self.hidden_states(input_ids, **kw)
            return fused_lm_loss(
                h, self.embeddings.word_embeddings.weight.t(), labels,
                ignore_index=ignore_index)
        logits = self(input_ids, **kw)
        return F.cross_entropy(logits.reshape(-1, V), labels.reshape(-1),
                               ignore_index=ignore_index)

    def num_params(self) -> int:
        return sum(p.numel() for p in self.parameters())
