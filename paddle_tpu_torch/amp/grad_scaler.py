"""GradScaler: dynamic loss scaling for f16 training.

Counterpart of ``paddle_tpu/amp/grad_scaler.py`` over the torch
parameters' ``.grad``: the same scale, counters and rules, so a run gives
the JAX package's scale sequence. With bf16 no scaling is needed, and
``enable=False`` makes every method a passthrough. ``unscale_`` reads
whether a gradient holds an inf or a nan on the host (the JAX class does
too), so it belongs to the eager step, not to a captured one.
"""

from __future__ import annotations

import torch

__all__ = ["GradScaler", "AmpScaler"]


class GradScaler:
    def __init__(self, enable: bool = True,
                 init_loss_scaling: float = 2.0 ** 15,
                 incr_ratio: float = 2.0, decr_ratio: float = 0.5,
                 incr_every_n_steps: int = 1000,
                 decr_every_n_nan_or_inf: int = 2,
                 use_dynamic_loss_scaling: bool = True):
        self._enable = enable
        self._scale = float(init_loss_scaling)
        self._incr_ratio = incr_ratio
        self._decr_ratio = decr_ratio
        self._incr_every = incr_every_n_steps
        self._decr_every = decr_every_n_nan_or_inf
        self._dynamic = use_dynamic_loss_scaling
        self._good_steps = 0
        self._bad_steps = 0
        self._found_inf = False
        self._unscaled = False

    def is_enable(self) -> bool:
        return self._enable

    def scale(self, var):
        if not self._enable:
            return var
        return var * self._scale

    @torch.no_grad()
    def unscale_(self, optimizer) -> None:
        if not self._enable or self._unscaled:
            return
        self._unscaled = True
        inv = 1.0 / self._scale
        found = False
        for p in optimizer._params():
            if p.grad is None:
                continue
            g = p.grad * inv
            if not bool(torch.isfinite(g).all()):
                found = True
            p.grad = g
        self._found_inf = found

    def step(self, optimizer) -> None:
        if not self._enable:
            optimizer.step()
            return
        self.unscale_(optimizer)
        if not self._found_inf:
            optimizer.step()
        self.update()

    def minimize(self, optimizer, scaled_loss) -> None:
        self.step(optimizer)

    def update(self) -> None:
        if not (self._enable and self._dynamic):
            return
        if self._found_inf:
            self._bad_steps += 1
            self._good_steps = 0
            if self._bad_steps >= self._decr_every:
                self._scale = max(self._scale * self._decr_ratio, 1.0)
                self._bad_steps = 0
        else:
            self._good_steps += 1
            self._bad_steps = 0
            if self._good_steps >= self._incr_every:
                self._scale *= self._incr_ratio
                self._good_steps = 0
        self._found_inf = False
        self._unscaled = False

    def get_loss_scaling(self) -> float:
        return self._scale

    def set_init_loss_scaling(self, v: float) -> None:
        self._scale = float(v)

    def state_dict(self):
        return {"scale": self._scale, "good_steps": self._good_steps,
                "bad_steps": self._bad_steps}

    def load_state_dict(self, state):
        self._scale = state["scale"]
        self._good_steps = state["good_steps"]
        self._bad_steps = state["bad_steps"]


AmpScaler = GradScaler
