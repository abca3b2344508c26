"""Optimizer base and SGD, Momentum, Adagrad, RMSProp, Adadelta, Adamax,
ASGD and Rprop.

Counterpart of ``paddle_tpu/optimizer/optimizer.py``: a functional core,
``init_state(param)`` and ``update(grad, state, param, lr, wd) ->
(new_param, new_state)`` on plain tensors (the JAX state names, f32
arithmetic, one cast to the parameter's dtype), ``update_many`` over lists
in place (what ``ShardedTrainer`` calls, inside its captured step on a
card: torch ops only, no host sync; ``Adam`` runs it as one multi-tensor
kernel on the card), and the eager surface on top of it: ``step``,
``clear_grad``, ``get_lr`` / ``set_lr`` and ``state_dict`` /
``set_state_dict``. ``learning_rate`` is a float or an ``lr.py``
``LRScheduler`` (read at each step; ``set_lr`` then raises, as in the JAX
package); ``grad_clip`` is an ``nn.clip`` class, applied to the
gradients before the update. ``step`` writes the new values into the
parameters in place and bumps their version counters (the kernel writes
through raw pointers and bumps them itself), so a ``LlamaDecoder``
cached by ``model.generate`` rebuilds after it. ``state_dict`` returns
copies and ``set_state_dict`` takes copies: the update writes the state
tensors in place.
"""

from __future__ import annotations

from typing import Dict, List

import torch

from paddle_tpu_torch.nn.clip import clip_grads
from paddle_tpu_torch.optimizer.lr import LRScheduler

__all__ = ["Optimizer", "SGD", "Momentum", "Adagrad", "RMSProp", "Adadelta",
           "Adamax", "ASGD", "Rprop"]


class Optimizer:
    def __init__(self, learning_rate=0.001, parameters=None,
                 weight_decay=None, grad_clip=None, name=None):
        self._lr_scheduler = None
        if isinstance(learning_rate, LRScheduler):
            self._lr_scheduler = learning_rate
        else:
            self._learning_rate = float(learning_rate)
        self._grad_clip = grad_clip
        self._parameter_list = (list(parameters) if parameters is not None
                                else None)
        self._weight_decay = (0.0 if weight_decay is None
                              else float(weight_decay))
        # id(param) -> dict of state tensors
        self._accumulators: Dict[int, Dict[str, torch.Tensor]] = {}
        self._step_count = 0

    # -- lr -----------------------------------------------------------------
    def get_lr(self) -> float:
        if self._lr_scheduler is not None:
            return float(self._lr_scheduler())
        return self._learning_rate

    def set_lr(self, value: float) -> None:
        if self._lr_scheduler is not None:
            raise RuntimeError("cannot set_lr when using an LRScheduler")
        self._learning_rate = float(value)

    # -- functional core (per optimizer) -------------------------------------
    def init_state(self, param) -> Dict[str, torch.Tensor]:
        return {}

    def update(self, grad, state, param, lr, wd):
        """(grad, state, param, lr, wd) -> (new_param, new_state); pure."""
        raise NotImplementedError

    @torch.no_grad()
    def update_many(self, grads, states, params, lr, wd) -> None:
        """``update`` over lists of gradients, states and parameters, in
        place: each parameter and each of its state tensors takes its new
        value. ``lr`` is a float or an f32 0-dim tensor on the parameters'
        device (what ``ShardedTrainer`` passes)."""
        for g, st, p in zip(grads, states, params, strict=True):
            new_p, new_st = self.update(g, st, p, lr, wd)
            p.copy_(new_p)
            for k, v in new_st.items():
                st[k].copy_(v)

    # -- eager step ---------------------------------------------------------
    def _params(self) -> List[torch.nn.Parameter]:
        if self._parameter_list is None:
            raise ValueError("optimizer constructed without parameters")
        return self._parameter_list

    @torch.no_grad()
    def step(self) -> None:
        """Clip the gradients of every parameter that has one
        (``grad_clip``), then update those parameters through
        ``update_many``, with the learning rate as an f32 tensor as the
        trainer passes it; a parameter with ``_no_weight_decay`` set takes
        no decay."""
        params = [p for p in self._params()
                  if p.requires_grad and p.grad is not None]
        grads = dict(zip(map(id, params), clip_grads(
            self._grad_clip, [p.grad for p in params])))
        by_wd: Dict[float, List[torch.nn.Parameter]] = {}
        for p in params:
            wd = (0.0 if getattr(p, "_no_weight_decay", False)
                  else self._weight_decay)
            by_wd.setdefault(wd, []).append(p)
            if id(p) not in self._accumulators:
                self._accumulators[id(p)] = self.init_state(p)
        for wd, group in by_wd.items():
            lr = torch.full((), self.get_lr(), dtype=torch.float32,
                            device=group[0].device)
            self.update_many([grads[id(p)] for p in group],
                             [self._accumulators[id(p)] for p in group],
                             group, lr, wd)
        self._step_count += 1

    def clear_grad(self, set_to_zero: bool = False) -> None:
        for p in self._params():
            if set_to_zero and p.grad is not None:
                p.grad.zero_()
            else:
                p.grad = None

    clear_gradients = clear_grad

    # -- state dict ---------------------------------------------------------
    def state_dict(self) -> Dict[str, object]:
        """``param_<i>__<state name>`` tensors, ``@step`` and, with a
        scheduler, ``@lr_scheduler``. The tensors are copies: a later
        ``step`` leaves them as they were."""
        out: Dict[str, object] = {}
        for i, p in enumerate(self._params()):
            for k, v in self._accumulators.get(id(p), {}).items():
                out[f"param_{i}__{k}"] = v.clone()
        out["@step"] = self._step_count
        if self._lr_scheduler is not None:
            out["@lr_scheduler"] = self._lr_scheduler.state_dict()
        return out

    def set_state_dict(self, state: Dict[str, object]) -> None:
        self._step_count = int(state.get("@step", 0))
        if self._lr_scheduler is not None and "@lr_scheduler" in state:
            self._lr_scheduler.set_state_dict(state["@lr_scheduler"])
        for i, p in enumerate(self._params()):
            prefix = f"param_{i}__"
            # copies: the update writes the state tensors in place
            st = {k[len(prefix):]: torch.as_tensor(v, device=p.device).clone(
                      memory_format=torch.contiguous_format)
                  for k, v in state.items()
                  if isinstance(k, str) and k.startswith(prefix)}
            if st:
                self._accumulators[id(p)] = st


def _decayed(g, p, wd):
    """The f32 gradient with L2 decay folded in (the JAX optimizers' first
    line)."""
    return g.float() + wd * p.float()


class SGD(Optimizer):
    def __init__(self, learning_rate=0.001, parameters=None,
                 weight_decay=None, grad_clip=None, name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name)

    def update(self, g, st, p, lr, wd):
        g = _decayed(g, p, wd)
        return (p.float() - lr * g).to(p.dtype), st


class Momentum(Optimizer):
    def __init__(self, learning_rate=0.001, momentum=0.9, parameters=None,
                 use_nesterov=False, weight_decay=None, grad_clip=None,
                 name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name)
        self._momentum = momentum
        self._nesterov = use_nesterov

    def init_state(self, p):
        return {"velocity": torch.zeros_like(p, dtype=torch.float32)}

    def update(self, g, st, p, lr, wd):
        g = _decayed(g, p, wd)
        v = self._momentum * st["velocity"] + g
        upd = g + self._momentum * v if self._nesterov else v
        return (p.float() - lr * upd).to(p.dtype), {"velocity": v}


class Adagrad(Optimizer):
    def __init__(self, learning_rate=0.001, epsilon=1e-6, parameters=None,
                 weight_decay=None, grad_clip=None,
                 initial_accumulator_value=0.0, name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name)
        self._epsilon = epsilon
        self._init_acc = initial_accumulator_value

    def init_state(self, p):
        return {"moment": torch.full_like(p, self._init_acc,
                                          dtype=torch.float32)}

    def update(self, g, st, p, lr, wd):
        g = _decayed(g, p, wd)
        m = st["moment"] + torch.square(g)
        new_p = p.float() - lr * g / (torch.sqrt(m) + self._epsilon)
        return new_p.to(p.dtype), {"moment": m}


class RMSProp(Optimizer):
    def __init__(self, learning_rate=0.001, rho=0.95, epsilon=1e-6,
                 momentum=0.0, centered=False, parameters=None,
                 weight_decay=None, grad_clip=None, name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name)
        self._rho, self._epsilon = rho, epsilon
        self._momentum, self._centered = momentum, centered

    def init_state(self, p):
        st = {"mean_square": torch.zeros_like(p, dtype=torch.float32),
              "velocity": torch.zeros_like(p, dtype=torch.float32)}
        if self._centered:
            st["mean_grad"] = torch.zeros_like(p, dtype=torch.float32)
        return st

    def update(self, g, st, p, lr, wd):
        g = _decayed(g, p, wd)
        ms = self._rho * st["mean_square"] + (1 - self._rho) * torch.square(g)
        new_st = {"mean_square": ms}
        if self._centered:
            mg = self._rho * st["mean_grad"] + (1 - self._rho) * g
            denom = torch.sqrt(ms - torch.square(mg) + self._epsilon)
            new_st["mean_grad"] = mg
        else:
            denom = torch.sqrt(ms + self._epsilon)
        v = self._momentum * st["velocity"] + lr * g / denom
        new_st["velocity"] = v
        return (p.float() - v).to(p.dtype), new_st


class Adadelta(Optimizer):
    def __init__(self, learning_rate=0.001, epsilon=1e-6, rho=0.95,
                 parameters=None, weight_decay=None, grad_clip=None,
                 name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name)
        self._epsilon = epsilon
        self._rho = rho

    def init_state(self, p):
        return {"avg_squared_grad": torch.zeros_like(p, dtype=torch.float32),
                "avg_squared_update": torch.zeros_like(p,
                                                       dtype=torch.float32)}

    def update(self, g, st, p, lr, wd):
        g = _decayed(g, p, wd)
        rho, eps = self._rho, self._epsilon
        e_g = rho * st["avg_squared_grad"] + (1 - rho) * g * g
        upd = (g * torch.sqrt(st["avg_squared_update"] + eps)
               / torch.sqrt(e_g + eps))
        e_u = rho * st["avg_squared_update"] + (1 - rho) * upd * upd
        return (p.float() - lr * upd).to(p.dtype), \
            {"avg_squared_grad": e_g, "avg_squared_update": e_u}


class Adamax(Optimizer):
    """Infinity-norm Adam."""

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, parameters=None, weight_decay=None,
                 grad_clip=None, name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name)
        self._beta1, self._beta2, self._epsilon = beta1, beta2, epsilon

    def init_state(self, p):
        return {"moment": torch.zeros_like(p, dtype=torch.float32),
                "inf_norm": torch.zeros_like(p, dtype=torch.float32),
                "beta1_pow": torch.ones((), dtype=torch.float32,
                                        device=p.device)}

    def update(self, g, st, p, lr, wd):
        g = _decayed(g, p, wd)
        b1, b2 = self._beta1, self._beta2
        m = b1 * st["moment"] + (1 - b1) * g
        u = torch.maximum(b2 * st["inf_norm"], torch.abs(g))
        b1p = st["beta1_pow"] * b1
        upd = lr * m / ((1 - b1p) * (u + self._epsilon))
        return (p.float() - upd).to(p.dtype), \
            {"moment": m, "inf_norm": u, "beta1_pow": b1p}


class ASGD(Optimizer):
    """SGD with a Polyak average of the last ``batch_num`` iterates."""

    def __init__(self, learning_rate=0.001, batch_num=1, parameters=None,
                 weight_decay=None, grad_clip=None, name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name)
        self._batch_num = batch_num

    def init_state(self, p):
        return {"avg": p.detach().float().clone(),
                "step": torch.zeros((), dtype=torch.float32,
                                    device=p.device)}

    def update(self, g, st, p, lr, wd):
        g = _decayed(g, p, wd)
        new_p = p.float() - lr * g
        step = st["step"] + 1.0
        avg = st["avg"] + (new_p - st["avg"]) / torch.clamp(
            step, max=float(self._batch_num))
        return new_p.to(p.dtype), {"avg": avg, "step": step}

    @torch.no_grad()
    def apply_averaged(self):
        """Swap every parameter to its average; returns the values it
        replaced, for ``restore``."""
        backups = []
        for p in self._params():
            st = self._accumulators.get(id(p))
            if st is None:
                backups.append(None)
                continue
            backups.append(p.detach().clone())
            p.copy_(st["avg"].to(p.dtype))
        return backups

    @torch.no_grad()
    def restore(self, backups):
        """Undo ``apply_averaged``."""
        for p, b in zip(self._params(), backups):
            if b is not None:
                p.copy_(b)


class Rprop(Optimizer):
    """Resilient propagation: a per-element step that grows while the
    gradient keeps its sign and shrinks when it flips."""

    def __init__(self, learning_rate=0.001, learning_rate_range=(1e-5, 50.0),
                 parameters=None, etas=(0.5, 1.2), grad_clip=None,
                 name=None):
        super().__init__(learning_rate, parameters, None, grad_clip, name)
        self._lr_range = learning_rate_range
        self._etas = etas

    def init_state(self, p):
        return {"prev_grad": torch.zeros_like(p, dtype=torch.float32),
                "lr_elem": torch.full_like(p, float(self.get_lr()),
                                           dtype=torch.float32)}

    def update(self, g, st, p, lr, wd):
        g = g.float()
        eta_minus, eta_plus = self._etas
        lo, hi = self._lr_range
        sign = torch.sign(g * st["prev_grad"])
        factor = torch.where(sign > 0, eta_plus,
                             torch.where(sign < 0, eta_minus, 1.0))
        lr_e = torch.clamp(st["lr_elem"] * factor, lo, hi)
        g_eff = torch.where(sign < 0, 0.0, g)
        new_p = p.float() - lr_e * torch.sign(g_eff)
        return new_p.to(p.dtype), {"prev_grad": g_eff, "lr_elem": lr_e}
