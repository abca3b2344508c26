"""Gradient clipping: ``ClipGradByValue``, ``ClipGradByNorm`` and
``ClipGradByGlobalNorm``.

Counterpart of ``paddle_tpu/nn/clip.py`` and of the functional form the
JAX trainer applies inside its compiled step
(``paddle_tpu/parallel/train.py`` ``_apply_grad_clip``): the same
arithmetic for both uses. Norms are f32 sums of squares (torch reductions,
as XLA computes them without a kernel of its own); a scaled gradient is
``g`` times the f32 scale, rounded back to ``g``'s dtype. Nothing here
syncs with the host, so the trainer's captured step clips inside its
graph. A class instance called on ``(param, grad)`` pairs returns new
pairs, as the JAX classes do (``Optimizer.step`` uses it so).
"""

from __future__ import annotations

from typing import List

import torch

__all__ = ["ClipGradBase", "ClipGradByValue", "ClipGradByNorm",
           "ClipGradByGlobalNorm", "clip_grads"]


class ClipGradBase:
    def __call__(self, params_grads):
        grads = clip_grads(self, [g for _, g in params_grads
                                  if g is not None])
        it = iter(grads)
        return [(p, None if g is None else next(it))
                for p, g in params_grads]


class ClipGradByValue(ClipGradBase):
    def __init__(self, max, min=None):
        self.max = float(max)
        self.min = float(min) if min is not None else -float(max)


class ClipGradByNorm(ClipGradBase):
    def __init__(self, clip_norm):
        self.clip_norm = float(clip_norm)


class ClipGradByGlobalNorm(ClipGradBase):
    def __init__(self, clip_norm, group_name="default_group"):
        self.clip_norm = float(clip_norm)
        self.group_name = group_name


def _norms(grads) -> List[torch.Tensor]:
    """Each gradient's f32 2-norm."""
    return list(torch._foreach_norm([g.float() for g in grads]))


def _scaled(g, scale):
    return (g.float() * scale).to(g.dtype)


def clip_grads(clip, grads: List[torch.Tensor]) -> List[torch.Tensor]:
    """The clipped gradients (new tensors) of ``grads`` under ``clip``
    (None: ``grads`` as they are)."""
    if clip is None or not grads:
        return list(grads)
    if isinstance(clip, ClipGradByGlobalNorm):
        gn = torch.linalg.vector_norm(torch.stack(_norms(grads)))
        scale = clip.clip_norm / torch.clamp(gn, min=clip.clip_norm)
        return [_scaled(g, scale) for g in grads]
    if isinstance(clip, ClipGradByNorm):
        return [_scaled(g, torch.clamp(
                    clip.clip_norm / torch.clamp(n, min=1e-12), max=1.0))
                for g, n in zip(grads, _norms(grads))]
    if isinstance(clip, ClipGradByValue):
        return [torch.clamp(g, clip.min, clip.max) for g in grads]
    raise NotImplementedError(
        f"grad clip {type(clip).__name__} in the training step")
