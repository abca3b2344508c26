"""The fused ops the port's training paths reach.

Counterpart of the matching parts of
``paddle_tpu/incubate/nn/functional.py``: ``fused_group_norm_silu`` (the
GroupNorm + SiLU of the UNet's ResBlocks, through
``ops/fused_norm.group_norm_silu_op``) and
``fused_rotary_position_embedding`` (through the Llama rope op, which
takes the rope kernel when ``use_fused_rope`` is on).
"""

from __future__ import annotations

from paddle_tpu_torch.ops.fused_norm import group_norm_silu_op

__all__ = ["fused_rotary_position_embedding", "fused_group_norm_silu"]


def fused_rotary_position_embedding(q, k=None, v=None, sin=None, cos=None,
                                    position_ids=None,
                                    use_neox_rotary_style=True):
    """Rotate q (and k) of shape (B, S, H, D) by (S, D/2) cos/sin tables;
    v passes through. Returns q alone or the tuple of those given."""
    # imported here: models/unet.py imports this module
    from paddle_tpu_torch.models.llama import _rope_op
    if cos is None or sin is None:
        raise ValueError("pass cos/sin tables")
    outs = [_rope_op(q, cos, sin)]
    if k is not None:
        outs.append(_rope_op(k, cos, sin))
    if v is not None:
        outs.append(v)
    return tuple(outs) if len(outs) > 1 else outs[0]


def fused_group_norm_silu(x, weight, bias, groups, epsilon=1e-5,
                          activation="silu"):
    """GroupNorm + SiLU (``activation`` falsy: GroupNorm alone) as one
    fused unit, through the GroupNorm kernels when eligible."""
    act = activation if activation else None
    return group_norm_silu_op(x, weight, bias, groups=groups,
                              epsilon=epsilon, act=act)
