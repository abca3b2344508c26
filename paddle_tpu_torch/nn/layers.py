"""Layer classes the UNet, GPT, BERT and MoE models are built from.

Counterparts of ``paddle_tpu/nn/layers.py``'s ``Linear``, ``Embedding``,
``Dropout``, ``LayerList``, ``Conv2D``, ``LayerNorm``, ``GroupNorm``,
``Silu`` and ``Identity`` as
``torch.nn.Module``s, with the same parameter names, layouts and
initializers: ``Linear.weight`` is (in, out) from XavierUniform and its
bias zeros; ``Embedding.weight`` is normal(0, 1), its ``padding_idx`` row
zeros; ``Conv2D.weight`` is OIHW from KaimingUniform (bound 1 /
sqrt(fan_in)) and its bias uniform in the same bound; ``LayerNorm`` and
``GroupNorm`` have weights of ones and biases of zeros. Their forwards go
through ``nn.functional``, so GroupNorm reaches the GroupNorm kernels and
dropout draws from ``framework.random``. ``LayerList`` is
``torch.nn.ModuleList``: it and ``torch.nn.Sequential`` name their
children ``0``, ``1``, ... as paddle's do. Random values come from
``generator`` (a ``torch.Generator`` on the layer's device) and are drawn
in f32, then cast to ``dtype``. ``device`` defaults to the card
(``device.resolve_device``).
"""

from __future__ import annotations

import math

import torch
from torch import nn

from paddle_tpu_torch.device import resolve_device
from paddle_tpu_torch.nn import functional as F

__all__ = ["Linear", "Embedding", "Dropout", "LayerList", "Conv2D",
           "LayerNorm", "GroupNorm", "Silu", "Identity"]

LayerList = nn.ModuleList


def _not_ported(what: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported to paddle_tpu_torch yet (ROADMAP.md section "
        f"1, item 14)")


def _param(shape, dev, dtype, fill=None, bound=None, generator=None,
           std=None):
    t = torch.empty(shape, dtype=torch.float32, device=dev)
    if bound is not None:
        t.uniform_(-bound, bound, generator=generator)
    elif std is not None:
        t.normal_(0.0, std, generator=generator)
    else:
        t.fill_(fill)
    return nn.Parameter(t.to(dtype))


def _absent(attr, what: str) -> bool:
    """paddle's ``*_attr=False`` drops the parameter; None keeps it."""
    if attr not in (None, False):
        raise _not_ported(f"a ParamAttr {what}")
    return attr is False


class Linear(nn.Module):
    """paddle's ``nn.Linear``: weight (in_features, out_features)."""

    def __init__(self, in_features: int, out_features: int,
                 weight_attr=None, bias_attr=None, name=None, *,
                 device=None, dtype=torch.float32, generator=None):
        super().__init__()
        if weight_attr is not None:
            raise _not_ported("a ParamAttr weight_attr")
        dev = resolve_device(device)
        self.in_features, self.out_features = in_features, out_features
        limit = math.sqrt(6.0 / (in_features + out_features))
        self.weight = _param((in_features, out_features), dev, dtype,
                             bound=limit, generator=generator)
        self.bias = (None if _absent(bias_attr, "bias_attr")
                     else _param((out_features,), dev, dtype, fill=0.0))

    def forward(self, x):
        return F.linear(x, self.weight, self.bias)


class Embedding(nn.Module):
    """paddle's ``nn.Embedding``: weight (num_embeddings, embedding_dim)
    from normal(0, 1), the ``padding_idx`` row zeros."""

    def __init__(self, num_embeddings: int, embedding_dim: int,
                 padding_idx=None, sparse=False, weight_attr=None, name=None,
                 *, device=None, dtype=torch.float32, generator=None):
        super().__init__()
        if weight_attr is not None:
            raise _not_ported("a ParamAttr weight_attr")
        dev = resolve_device(device)
        self.num_embeddings, self.embedding_dim = num_embeddings, \
            embedding_dim
        self.padding_idx = padding_idx
        self.weight = _param((num_embeddings, embedding_dim), dev, dtype,
                             std=1.0, generator=generator)
        if padding_idx is not None:
            with torch.no_grad():
                self.weight[padding_idx] = 0.0

    def forward(self, x):
        return F.embedding(x, self.weight, padding_idx=self.padding_idx)


class Dropout(nn.Module):
    def __init__(self, p=0.5, axis=None, mode="upscale_in_train",
                 name=None):
        super().__init__()
        self.p, self.axis, self.mode = p, axis, mode

    def forward(self, x):
        return F.dropout(x, p=self.p, training=self.training, mode=self.mode,
                         axis=self.axis)


class Conv2D(nn.Module):
    """paddle's ``nn.Conv2D`` on NCHW maps: weight (out, in / groups,
    kh, kw)."""

    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, dilation=1, groups=1, padding_mode="zeros",
                 weight_attr=None, bias_attr=None, data_format="NCHW", *,
                 device=None, dtype=torch.float32, generator=None):
        super().__init__()
        if weight_attr is not None:
            raise _not_ported("a ParamAttr weight_attr")
        if padding_mode != "zeros" or data_format != "NCHW":
            raise _not_ported(f"Conv2D padding_mode={padding_mode!r} "
                              f"data_format={data_format!r}")
        dev = resolve_device(device)
        k = ((kernel_size,) * 2 if isinstance(kernel_size, int)
             else tuple(kernel_size))
        self.in_channels, self.out_channels = in_channels, out_channels
        self.kernel_size, self.stride, self.padding = k, stride, padding
        self.dilation, self.groups = dilation, groups
        fan_in = in_channels // groups * k[0] * k[1]
        bound = 1.0 / math.sqrt(fan_in)
        self.weight = _param((out_channels, in_channels // groups) + k, dev,
                             dtype, bound=bound, generator=generator)
        self.bias = (None if _absent(bias_attr, "bias_attr")
                     else _param((out_channels,), dev, dtype, bound=bound,
                                 generator=generator))

    def forward(self, x):
        return F.conv2d(x, self.weight, self.bias, stride=self.stride,
                        padding=self.padding, dilation=self.dilation,
                        groups=self.groups)


class LayerNorm(nn.Module):
    """paddle's ``nn.LayerNorm``: weight ones and bias zeros of
    ``normalized_shape``, through ``nn.functional.layer_norm``."""

    def __init__(self, normalized_shape, epsilon=1e-5, weight_attr=None,
                 bias_attr=None, name=None, *, device=None,
                 dtype=torch.float32):
        super().__init__()
        dev = resolve_device(device)
        if isinstance(normalized_shape, int):
            normalized_shape = (normalized_shape,)
        self.normalized_shape = tuple(normalized_shape)
        self.epsilon = epsilon
        self.weight = (None if _absent(weight_attr, "weight_attr")
                       else _param(self.normalized_shape, dev, dtype,
                                   fill=1.0))
        self.bias = (None if _absent(bias_attr, "bias_attr")
                     else _param(self.normalized_shape, dev, dtype,
                                 fill=0.0))

    def forward(self, x):
        return F.layer_norm(x, self.normalized_shape, self.weight, self.bias,
                            self.epsilon)


class GroupNorm(nn.Module):
    """paddle's ``nn.GroupNorm``: (C,) weight and bias, through
    ``nn.functional.group_norm``."""

    def __init__(self, num_groups, num_channels, epsilon=1e-5,
                 weight_attr=None, bias_attr=None, data_format="NCHW",
                 name=None, *, device=None, dtype=torch.float32):
        super().__init__()
        dev = resolve_device(device)
        self.num_groups, self.epsilon = num_groups, epsilon
        self.data_format = data_format
        self.weight = (None if _absent(weight_attr, "weight_attr")
                       else _param((num_channels,), dev, dtype, fill=1.0))
        self.bias = (None if _absent(bias_attr, "bias_attr")
                     else _param((num_channels,), dev, dtype, fill=0.0))

    def forward(self, x):
        return F.group_norm(x, self.num_groups, self.weight, self.bias,
                            self.epsilon, self.data_format)


class Silu(nn.Module):
    def forward(self, x):
        return F.silu(x)


class Identity(nn.Module):
    def forward(self, x):
        return x
