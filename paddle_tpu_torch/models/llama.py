"""Llama-family causal LM: RMSNorm, RoPE, GQA attention, SwiGLU MLP.

Counterpart of ``paddle_tpu/models/llama.py``: the same config, the same
parameter names as the JAX model's ``state_dict()`` and paddle's
``(in, out)`` linear layout, so ``convert.from_jax_state_dict`` carries
weights across one to one. ``forward`` and ``loss`` are the training path:
attention through ``nn.functional.scaled_dot_product_attention`` (the
flash-attention kernels), the norms through ``nn.functional.rms_norm``
(the RMSNorm kernels), rope through the rope kernel when
``use_fused_rope`` is on, the loss through the chunked fused head + CE.
``generate`` delegates to ``inference.generate.LlamaDecoder``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch
from torch import nn

import paddle_tpu_torch.nn.functional as F
from paddle_tpu_torch.amp.auto_cast import amp_cast
from paddle_tpu_torch.device import resolve_device
from paddle_tpu_torch.flags import flags
from paddle_tpu_torch.models._common import as_ids
from paddle_tpu_torch.ops.kernels import rope as _rope_k

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


def _rope_op(x, cos, sin):
    """Rotate (B, S, H, D) by position tables (S, D/2), halves split at
    D/2 (the Llama convention). Routes to the rope kernel
    (ops/kernels/rope.py) when ``use_fused_rope`` is on and the shapes and
    dtypes are eligible."""
    if flags.use_fused_rope and _rope_k.supported(
            tuple(x.shape), tuple(cos.shape), x.dtype, cos.dtype):
        return _rope_k.rope_fused(x, cos, sin)
    d2 = x.shape[-1] // 2
    x1, x2 = x[..., :d2], x[..., d2:]
    c = cos[None, :, None, :]
    s = sin[None, :, None, :]
    return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1)


class _Weight(nn.Module):
    """One trainable ``weight`` parameter: normal(0, 0.02) from ``gen``,
    or ones."""

    def __init__(self, shape, dtype, device, init, gen):
        super().__init__()
        w = torch.empty(shape, dtype=torch.float32, device=device)
        if init == "ones":
            w.fill_(1.0)
        else:
            w.normal_(0.0, 0.02, generator=gen)
        self.weight = nn.Parameter(w.to(dtype))


class _Linear(_Weight):
    """paddle's ``nn.Linear`` without bias: weight (in, out), ``x @ W``
    (an AMP ``linear``)."""

    def forward(self, x):
        return torch.matmul(*amp_cast("linear", x, self.weight))


class _Embedding(_Weight):
    def forward(self, ids):
        return torch.nn.functional.embedding(ids, self.weight)


class _RMSNorm(_Weight):
    def __init__(self, shape, dtype, device, init, gen, eps):
        super().__init__(shape, dtype, device, init, gen)
        self.epsilon = eps

    def forward(self, x):
        return F.rms_norm(x, self.weight, self.epsilon)


class LlamaAttention(nn.Module):
    def __init__(self, cfg: LlamaConfig, mk):
        super().__init__()
        self.config = cfg
        h, kv, d = (cfg.num_attention_heads, cfg.num_key_value_heads,
                    cfg.head_dim)
        self.q_proj = mk(_Linear, (cfg.hidden_size, h * d))
        self.k_proj = mk(_Linear, (cfg.hidden_size, kv * d))
        self.v_proj = mk(_Linear, (cfg.hidden_size, kv * d))
        self.o_proj = mk(_Linear, (h * d, cfg.hidden_size))

    def forward(self, hidden, cos, sin, attn_mask=None):
        cfg = self.config
        B, S, _ = hidden.shape
        H, KV, D = (cfg.num_attention_heads, cfg.num_key_value_heads,
                    cfg.head_dim)
        q = _rope_op(self.q_proj(hidden).reshape(B, S, H, D), cos, sin)
        k = _rope_op(self.k_proj(hidden).reshape(B, S, KV, D), cos, sin)
        v = self.v_proj(hidden).reshape(B, S, KV, D)
        rep = H // KV
        if rep > 1:
            # GQA: repeat K/V before the kernel; autograd sums dk and dv
            # back over the repeated heads
            k = k.repeat_interleave(rep, dim=2)
            v = v.repeat_interleave(rep, dim=2)
        out = F.scaled_dot_product_attention(q, k, v, attn_mask=attn_mask,
                                             is_causal=True,
                                             training=self.training)
        return self.o_proj(out.reshape(B, S, H * D))


class LlamaMLP(nn.Module):
    def __init__(self, cfg: LlamaConfig, mk):
        super().__init__()
        self.gate_proj = mk(_Linear, (cfg.hidden_size, cfg.intermediate_size))
        self.up_proj = mk(_Linear, (cfg.hidden_size, cfg.intermediate_size))
        self.down_proj = mk(_Linear, (cfg.intermediate_size, cfg.hidden_size))

    def forward(self, x):
        return self.down_proj(F.silu(self.gate_proj(x)) * self.up_proj(x))


class LlamaDecoderLayer(nn.Module):
    def __init__(self, cfg: LlamaConfig, mk):
        super().__init__()
        eps = cfg.rms_norm_eps
        self.input_layernorm = mk(_RMSNorm, (cfg.hidden_size,), "ones",
                                  eps=eps)
        self.self_attn = LlamaAttention(cfg, mk)
        self.post_attention_layernorm = mk(_RMSNorm, (cfg.hidden_size,),
                                           "ones", eps=eps)
        self.mlp = LlamaMLP(cfg, mk)

    def forward(self, hidden, cos, sin, attn_mask=None):
        hidden = hidden + self.self_attn(self.input_layernorm(hidden), cos,
                                         sin, attn_mask)
        return hidden + self.mlp(self.post_attention_layernorm(hidden))


class LlamaModel(nn.Module):
    def __init__(self, cfg: LlamaConfig, mk):
        super().__init__()
        self.config = cfg
        self.embed_tokens = mk(_Embedding, (cfg.vocab_size, cfg.hidden_size))
        self.layers = nn.ModuleList(LlamaDecoderLayer(cfg, mk)
                                    for _ in range(cfg.num_hidden_layers))
        self.norm = mk(_RMSNorm, (cfg.hidden_size,), "ones",
                       eps=cfg.rms_norm_eps)

    def forward(self, input_ids, attn_mask=None):
        cfg = self.config
        cos, sin = _rope_tables(input_ids.shape[1], cfg.head_dim,
                                cfg.rope_theta, cfg.torch_dtype,
                                device=input_ids.device)
        hidden = self.embed_tokens(input_ids)
        for layer in self.layers:
            hidden = layer(hidden, cos, sin, attn_mask)
        return self.norm(hidden)


class LlamaForCausalLM(nn.Module):
    """Parameters named as in the JAX model's ``state_dict()``, all
    trainable; linear weights normal(0, 0.02) from a ``torch.Generator``
    seeded with ``seed`` on ``device``, norm weights ones. ``device``
    defaults to ``cuda`` and raises without a card (``device="cpu"`` opts
    in)."""

    def __init__(self, config: LlamaConfig, device=None, seed: int = 0):
        super().__init__()
        dev = resolve_device(device)
        self.config = config
        gen = torch.Generator(device=dev).manual_seed(int(seed))
        dt = config.torch_dtype

        def mk(cls, shape, init="normal", **kw):
            return cls(shape, dt, dev, init, gen, **kw)

        self.model = LlamaModel(config, mk)
        self.lm_head = (None if config.tie_word_embeddings
                        else mk(_Linear, (config.hidden_size,
                                          config.vocab_size)))

    @property
    def device(self) -> torch.device:
        return self.model.embed_tokens.weight.device

    def _ids(self, ids) -> torch.Tensor:
        return as_ids(ids, self.device)

    def _head_weight(self):
        """The (H, V) lm-head matrix, for forward and the fused loss
        (tied: the transposed embedding)."""
        if self.lm_head is None:
            return self.model.embed_tokens.weight.t()
        return self.lm_head.weight

    def forward(self, input_ids, attn_mask=None):
        hidden = self.model(self._ids(input_ids), attn_mask)
        # the JAX model's head: an nn.Linear, or paddle.matmul when tied
        return torch.matmul(*amp_cast(
            "linear" if self.lm_head is not None else "matmul", hidden,
            self._head_weight()))

    def loss(self, input_ids, labels):
        """Mean next-token CE. Large vocabularies (V >= 4096, with
        ``use_fused_lm_ce``) go through the chunked fused head + CE and
        never form the (T, V) logits at once."""
        V = self.config.vocab_size
        labels = self._ids(labels)
        if flags.use_fused_lm_ce and V >= 4096:
            from paddle_tpu_torch.ops.fused_ce import fused_lm_loss
            return fused_lm_loss(self.model(self._ids(input_ids)),
                                 self._head_weight(), labels)
        logits = self(input_ids)
        return F.cross_entropy(logits.reshape(-1, V), labels.reshape(-1))

    def num_params(self) -> int:
        return sum(p.numel() for p in self.parameters())

    def flops_per_token(self, seq_len: int) -> float:
        """Train-step FLOPs per token: 6N for the matmuls (forward and
        backward) plus the attention score/value term 12·L·H·S (PaLM
        appendix B)."""
        cfg = self.config
        return (6 * self.num_params()
                + 12 * cfg.num_hidden_layers * cfg.hidden_size * seq_len)

    def generate(self, input_ids, max_new_tokens: int = 32,
                 max_len: Optional[int] = None,
                 decode_strategy: str = "greedy_search", **kwargs):
        """Decode through a ``LlamaDecoder`` cached on the model (rebuilt
        when a parameter changed or the quant recipe differs), on the
        model's device. ``decode_strategy="sampling"`` samples
        (``do_sample`` defaults to True); ``"beam_search"`` routes to the
        no-cache beam decoder (``nn/generation.py``). ``draft_model=``
        and ``num_speculative_tokens=`` decode speculatively; the cache
        then has K slots of slack (K from the
        ``decode_speculative_tokens`` flag when not given)."""
        from paddle_tpu_torch.inference.generate import LlamaDecoder
        from paddle_tpu_torch.quantization.kv_cache import \
            resolve_decode_quant
        if decode_strategy not in ("greedy_search", "sampling",
                                   "beam_search"):
            raise ValueError(f"unknown decode_strategy {decode_strategy!r}")
        need = int(np.asarray(input_ids).shape[1]) + max_new_tokens
        if kwargs.get("draft_model") is not None:
            k = kwargs.get("num_speculative_tokens")
            need += int(flags.decode_speculative_tokens if k is None
                        else k)
        if max_len is not None and max_len < need:
            raise ValueError(f"max_len {max_len} < prompt + new tokens "
                             f"({need})")
        if decode_strategy == "beam_search":
            from paddle_tpu_torch.nn.generation import beam_search
            return beam_search(self, input_ids,
                               max_new_tokens=max_new_tokens, **kwargs)
        if decode_strategy == "sampling":
            kwargs.setdefault("do_sample", True)
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
