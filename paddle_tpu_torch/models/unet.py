"""Diffusion UNet: timestep-conditioned residual blocks, self- and
cross-attention at the lower resolutions, skip connections.

Counterpart of ``paddle_tpu/models/unet.py`` (the Stable-Diffusion-2.1
UNet analog that ``bench.py``'s ``bench_unet`` trains), with its config,
module tree and parameter names, so ``convert.from_jax_state_dict``
carries a JAX model's weights across one to one. The GroupNorms reach the
GroupNorm kernels (the ResBlocks' GroupNorm + SiLU as one fused unit,
``_norm_silu``), self-attention at a key length of at least
``flash_attention_min_seq`` the flash-attention kernels; convolutions,
linears and upsampling are torch ops, as they are XLA ops in the JAX
package.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional, Tuple

import torch
from torch import nn

import paddle_tpu_torch.nn.functional as F
from paddle_tpu_torch.device import resolve_device
from paddle_tpu_torch.flags import flags
from paddle_tpu_torch.incubate.nn.functional import fused_group_norm_silu
from paddle_tpu_torch.nn.layers import (Conv2D, GroupNorm, Identity, Linear,
                                        Silu)

__all__ = ["UNetConfig", "UNet2DConditionModel", "UNET_TINY",
           "timestep_embedding"]


@dataclass
class UNetConfig:
    in_channels: int = 4
    out_channels: int = 4
    model_channels: int = 320
    channel_mult: Tuple[int, ...] = (1, 2, 4, 4)
    num_res_blocks: int = 2
    attention_levels: Tuple[int, ...] = (1, 2, 3)
    num_heads: int = 8
    context_dim: Optional[int] = 1024
    groups: int = 32


UNET_TINY = UNetConfig(in_channels=4, out_channels=4, model_channels=32,
                       channel_mult=(1, 2), num_res_blocks=1,
                       attention_levels=(1,), num_heads=4, context_dim=32,
                       groups=8)


def timestep_embedding(t, dim: int):
    """Sinusoidal timestep embedding (SD convention), f32 (B, dim)."""
    half = dim // 2
    freqs = torch.exp(-math.log(10000.0) * torch.arange(
        half, dtype=torch.float32, device=t.device) / half)
    args = t.float()[:, None] * freqs[None]
    return torch.cat([torch.cos(args), torch.sin(args)], dim=-1)


def _norm_silu(norm, x):
    """GroupNorm + SiLU as one fused unit (the GroupNorm kernels when
    eligible); the plain composition when ``use_fused_group_norm`` is
    off."""
    if (flags.use_fused_group_norm and norm.weight is not None
            and norm.bias is not None):
        return fused_group_norm_silu(x, norm.weight, norm.bias,
                                     norm.num_groups, norm.epsilon)
    return F.silu(norm(x))


class _Make:
    """Layer constructors bound to one device, dtype and generator."""

    def __init__(self, device, dtype, generator):
        self.kw = dict(device=device, dtype=dtype)
        self.gen = generator

    def linear(self, i, o, bias=True):
        return Linear(i, o, bias_attr=None if bias else False,
                      generator=self.gen, **self.kw)

    def conv(self, i, o, k, **kw):
        return Conv2D(i, o, k, generator=self.gen, **kw, **self.kw)

    def norm(self, groups, c):
        return GroupNorm(min(groups, c), c, **self.kw)


class ResBlock(nn.Module):
    def __init__(self, in_c, out_c, time_c, groups, mk: _Make):
        super().__init__()
        self.norm1 = mk.norm(groups, in_c)
        self.conv1 = mk.conv(in_c, out_c, 3, padding=1)
        self.time_proj = mk.linear(time_c, out_c)
        self.norm2 = mk.norm(groups, out_c)
        self.conv2 = mk.conv(out_c, out_c, 3, padding=1)
        self.skip = (mk.conv(in_c, out_c, 1) if in_c != out_c
                     else Identity())

    def forward(self, x, temb):
        h = self.conv1(_norm_silu(self.norm1, x))
        h = h + self.time_proj(F.silu(temb))[..., None, None]
        h = self.conv2(_norm_silu(self.norm2, h))
        return h + self.skip(x)


class AttentionBlock(nn.Module):
    """Self-attention + optional cross-attention on (B, C, H, W) maps."""

    def __init__(self, channels, num_heads, context_dim, groups, mk: _Make):
        super().__init__()
        self.norm = mk.norm(groups, channels)
        self.num_heads = num_heads
        self.head_dim = channels // num_heads
        self.to_qkv = mk.linear(channels, 3 * channels, bias=False)
        self.proj = mk.linear(channels, channels)
        self.context_dim = context_dim
        if context_dim is not None:
            self.to_q2 = mk.linear(channels, channels, bias=False)
            self.to_kv2 = mk.linear(context_dim, 2 * channels, bias=False)
            self.proj2 = mk.linear(channels, channels)

    def _attend(self, q, k, v, B, L, C):
        q, k, v = (t.reshape(B, -1, self.num_heads, self.head_dim)
                   for t in (q, k, v))
        out = F.scaled_dot_product_attention(q, k, v, is_causal=False,
                                             training=self.training)
        return out.reshape(B, L, C)

    def forward(self, x, context=None):
        B, C, H, W = x.shape
        L = H * W
        h = self.norm(x).reshape(B, C, L).transpose(1, 2)
        q, k, v = self.to_qkv(h).chunk(3, dim=-1)
        h = h + self.proj(self._attend(q, k, v, B, L, C))
        if context is not None and self.context_dim is not None:
            q2 = self.to_q2(h)
            k2, v2 = self.to_kv2(context).chunk(2, dim=-1)
            h = h + self.proj2(self._attend(q2, k2, v2, B, L, C))
        return x + h.transpose(1, 2).reshape(B, C, H, W)


class Downsample(nn.Module):
    def __init__(self, c, mk: _Make):
        super().__init__()
        self.op = mk.conv(c, c, 3, stride=2, padding=1)

    def forward(self, x):
        return self.op(x)


class Upsample(nn.Module):
    def __init__(self, c, mk: _Make):
        super().__init__()
        self.conv = mk.conv(c, c, 3, padding=1)

    def forward(self, x):
        return self.conv(F.interpolate(x, scale_factor=2, mode="nearest"))


class UNet2DConditionModel(nn.Module):
    """The JAX package's UNet. Parameters are drawn in f32 from a
    ``torch.Generator`` seeded with ``seed`` on ``device``, with the JAX
    layers' initializers, then cast to ``dtype`` (``"bfloat16"`` gives
    ``bench_unet``'s bf16 parameters). ``device`` defaults to ``cuda``
    and raises without a card (``device="cpu"`` opts in)."""

    def __init__(self, config: UNetConfig = UNET_TINY, device=None,
                 dtype="float32", seed: int = 0):
        super().__init__()
        dev = resolve_device(device)
        cfg = self.config = config
        dt = getattr(torch, dtype) if isinstance(dtype, str) else dtype
        mk = _Make(dev, dt, torch.Generator(device=dev).manual_seed(
            int(seed)))
        ch = cfg.model_channels
        time_c = ch * 4
        self.time_mlp = nn.Sequential(mk.linear(ch, time_c), Silu(),
                                      mk.linear(time_c, time_c))
        self.conv_in = mk.conv(cfg.in_channels, ch, 3, padding=1)

        self.down_blocks = nn.ModuleList()
        self.downsamplers = nn.ModuleList()
        chans = [ch]
        cur = ch
        last = len(cfg.channel_mult) - 1
        for lvl, mult in enumerate(cfg.channel_mult):
            out_c = ch * mult
            blocks = nn.ModuleList()
            for _ in range(cfg.num_res_blocks):
                entry = nn.ModuleList([ResBlock(cur, out_c, time_c,
                                                cfg.groups, mk)])
                if lvl in cfg.attention_levels:
                    entry.append(AttentionBlock(out_c, cfg.num_heads,
                                                cfg.context_dim, cfg.groups,
                                                mk))
                blocks.append(entry)
                cur = out_c
                chans.append(cur)
            self.down_blocks.append(blocks)
            if lvl != last:
                self.downsamplers.append(Downsample(cur, mk))
                chans.append(cur)
            else:
                self.downsamplers.append(Identity())

        self.mid_block1 = ResBlock(cur, cur, time_c, cfg.groups, mk)
        self.mid_attn = AttentionBlock(cur, cfg.num_heads, cfg.context_dim,
                                       cfg.groups, mk)
        self.mid_block2 = ResBlock(cur, cur, time_c, cfg.groups, mk)

        self.up_blocks = nn.ModuleList()
        self.upsamplers = nn.ModuleList()
        for lvl, mult in reversed(list(enumerate(cfg.channel_mult))):
            out_c = ch * mult
            blocks = nn.ModuleList()
            for _ in range(cfg.num_res_blocks + 1):
                skip_c = chans.pop()
                entry = nn.ModuleList([ResBlock(cur + skip_c, out_c, time_c,
                                                cfg.groups, mk)])
                if lvl in cfg.attention_levels:
                    entry.append(AttentionBlock(out_c, cfg.num_heads,
                                                cfg.context_dim, cfg.groups,
                                                mk))
                blocks.append(entry)
                cur = out_c
            self.up_blocks.append(blocks)
            self.upsamplers.append(Upsample(cur, mk) if lvl else Identity())

        self.norm_out = mk.norm(cfg.groups, cur)
        self.conv_out = mk.conv(cur, cfg.out_channels, 3, padding=1)

    @property
    def device(self) -> torch.device:
        return self.conv_in.weight.device

    def num_params(self) -> int:
        return sum(p.numel() for p in self.parameters())

    def forward(self, x, timesteps, encoder_hidden_states=None):
        cfg = self.config
        temb = self.time_mlp(timestep_embedding(timesteps,
                                                cfg.model_channels))
        # the sinusoidal embedding is f32; the residual stream stays in the
        # parameters' dtype, as in the JAX model
        temb = temb.to(self.conv_in.weight.dtype)
        h = self.conv_in(x)
        skips = [h]
        for lvl, blocks in enumerate(self.down_blocks):
            for entry in blocks:
                h = entry[0](h, temb)
                if len(entry) > 1:
                    h = entry[1](h, encoder_hidden_states)
                skips.append(h)
            if lvl != len(cfg.channel_mult) - 1:
                h = self.downsamplers[lvl](h)
                skips.append(h)
        h = self.mid_block2(self.mid_attn(self.mid_block1(h, temb),
                                          encoder_hidden_states), temb)
        for i, blocks in enumerate(self.up_blocks):
            for entry in blocks:
                h = torch.cat([h, skips.pop()], dim=1)
                h = entry[0](h, temb)
                if len(entry) > 1:
                    h = entry[1](h, encoder_hidden_states)
            h = self.upsamplers[i](h)
        return self.conv_out(_norm_silu(self.norm_out, h))
