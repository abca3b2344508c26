"""The training step: model + optimizer -> one eager step on the card.

Counterpart of ``paddle_tpu/parallel/train.py`` on one device. Where the
JAX package lifts the model to a pure function and compiles forward,
``jax.grad`` and the optimizer's functional update into one SPMD program
over a mesh, the port runs the loss forward eagerly, takes the gradients
with ``torch.autograd``, and applies the same functional update
(``optimizer.update``) parameter by parameter, writing the results into
the parameters in place. The optimizer state lives on the trainer, keyed
by parameter name, as in the JAX trainer; every trainable parameter takes
``optimizer._weight_decay``. Meshes of more than one device and AMP are
not ported yet (ROADMAP.md section 1, items 13 and 14).
"""

from __future__ import annotations

import time
from typing import Callable, Dict, Optional, Sequence

import numpy as np
import torch

__all__ = ["ShardedTrainer"]


def _not_ported(what: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported to paddle_tpu_torch yet (ROADMAP.md section "
        f"1, items 13 and 14)")


def _mesh_size(mesh) -> int:
    if isinstance(mesh, int):
        return mesh
    size = getattr(mesh, "size", None)
    if size is None:
        raise TypeError(f"mesh must be None, a device count or have a "
                        f"size, got {type(mesh).__name__}")
    return int(size() if callable(size) else size)


class ShardedTrainer:
    """One-device trainer with the JAX ``ShardedTrainer``'s surface.

    ``loss_fn(model, *batch) -> scalar tensor`` drives the forward; the
    batch may be tensors or numpy arrays (ml_dtypes bfloat16 included).
    ``train_step(*batch)`` runs one step and returns the loss;
    ``train_steps(*stacked)`` runs K steps over (K, ...) inputs and
    returns the (K,) losses. Both advance ``optimizer._step_count``. The
    step runs on the model's device; batches are moved there. ``mesh``
    may be None or one device; ``plan`` (placements per parameter name)
    is then a no-op, as the JAX trainer's is on a one-device mesh."""

    def __init__(self, model: torch.nn.Module, optimizer, loss_fn: Callable,
                 mesh=None, plan: Optional[Dict[str, Sequence]] = None,
                 amp_dtype: Optional[str] = None):
        if mesh is not None and _mesh_size(mesh) > 1:
            raise _not_ported("a mesh of more than one device")
        if amp_dtype is not None:
            raise _not_ported("amp_dtype=")
        self.model = model
        self.optimizer = optimizer
        self.loss_fn = loss_fn
        self.params = {n: p for n, p in model.named_parameters()
                       if p.requires_grad}
        self.opt_state = {n: optimizer.init_state(p)
                          for n, p in self.params.items()}
        #: host seconds the last step spent issuing the optimizer update
        #: (about a dozen eager ops per parameter; the device may still be
        #: running them when the step returns)
        self.update_host_s = 0.0

    @property
    def device(self) -> torch.device:
        return next(iter(self.params.values())).device

    def _put(self, b):
        if isinstance(b, torch.Tensor):
            return b.to(self.device)
        a = np.ascontiguousarray(b)
        if a.dtype.name == "bfloat16":
            # ml_dtypes' bfloat16, which torch.as_tensor does not take:
            # carry the bits over
            return torch.from_numpy(a.view(np.uint16)).view(
                torch.bfloat16).to(self.device)
        return torch.as_tensor(a, device=self.device)

    def _step(self, batch) -> torch.Tensor:
        for p in self.params.values():
            p.grad = None
        loss = self.loss_fn(self.model, *batch)
        loss.backward()
        opt = self.optimizer
        lr = float(opt.get_lr())
        wd = getattr(opt, "_weight_decay", 0.0) or 0.0
        t0 = time.perf_counter()
        with torch.no_grad():
            for name, p in self.params.items():
                new_p, self.opt_state[name] = opt.update(
                    p.grad, self.opt_state[name], p, lr, wd)
                p.copy_(new_p)
                p.grad = None
        self.update_host_s = time.perf_counter() - t0
        opt._step_count += 1
        return loss.detach()

    def train_step(self, *batch) -> torch.Tensor:
        """One step; updates the parameters and optimizer state in place.
        Returns the loss (a 0-dim tensor on the device)."""
        return self._step([self._put(b) for b in batch])

    def train_steps(self, *stacked_batch) -> torch.Tensor:
        """K steps; input i of step k is ``stacked_batch[i][k]``. Returns
        the (K,) losses."""
        vals = [self._put(b) for b in stacked_batch]
        return torch.stack([self._step([v[k] for v in vals])
                            for k in range(vals[0].shape[0])])
