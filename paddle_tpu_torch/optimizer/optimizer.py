"""Optimizer base.

Counterpart of ``paddle_tpu/optimizer/optimizer.py``: a functional core,
``init_state(param)`` and ``update(grad, state, param, lr, wd) ->
(new_param, new_state)`` on plain tensors, ``update_many`` over lists in
place (what ``ShardedTrainer`` calls; ``Adam`` runs it as one multi-tensor
kernel on the card), and the eager surface on top of it: ``step``,
``clear_grad``, ``get_lr`` / ``set_lr`` and ``state_dict`` /
``set_state_dict``. ``step`` writes the new values into the parameters
in place and bumps their version counters (the kernel writes through
raw pointers and bumps them itself), so a ``LlamaDecoder`` cached by
``model.generate`` rebuilds after it. ``state_dict`` returns copies and
``set_state_dict`` takes copies: the update writes the state tensors in
place. The learning rate is a float; ``lr.py`` schedulers and grad
clipping are not ported yet (ROADMAP.md section 1, item 14).
"""

from __future__ import annotations

from typing import Dict, List

import torch

__all__ = ["Optimizer"]


def _not_ported(what: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported to paddle_tpu_torch yet (ROADMAP.md section "
        f"1, item 14)")


class Optimizer:
    def __init__(self, learning_rate=0.001, parameters=None,
                 weight_decay=None, grad_clip=None, name=None):
        if not isinstance(learning_rate, (int, float)):
            raise _not_ported("an LRScheduler learning rate")
        if grad_clip is not None:
            raise _not_ported("grad_clip=")
        self._learning_rate = float(learning_rate)
        self._parameter_list = (list(parameters) if parameters is not None
                                else None)
        self._weight_decay = (0.0 if weight_decay is None
                              else float(weight_decay))
        # id(param) -> dict of state tensors
        self._accumulators: Dict[int, Dict[str, torch.Tensor]] = {}
        self._step_count = 0

    # -- lr -----------------------------------------------------------------
    def get_lr(self) -> float:
        return self._learning_rate

    def set_lr(self, value: float) -> None:
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
        """Update every parameter that has a gradient through
        ``update_many``, with the learning rate as an f32 tensor as the
        trainer passes it; a parameter with ``_no_weight_decay`` set takes
        no decay."""
        by_wd: Dict[float, List[torch.nn.Parameter]] = {}
        for p in self._params():
            if not p.requires_grad or p.grad is None:
                continue
            wd = (0.0 if getattr(p, "_no_weight_decay", False)
                  else self._weight_decay)
            by_wd.setdefault(wd, []).append(p)
            if id(p) not in self._accumulators:
                self._accumulators[id(p)] = self.init_state(p)
        for wd, group in by_wd.items():
            lr = torch.full((), self.get_lr(), dtype=torch.float32,
                            device=group[0].device)
            self.update_many([p.grad for p in group],
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
        """``param_<i>__<state name>`` tensors and ``@step``. The tensors
        are copies: a later ``step`` leaves them as they were."""
        out: Dict[str, object] = {}
        for i, p in enumerate(self._params()):
            for k, v in self._accumulators.get(id(p), {}).items():
                out[f"param_{i}__{k}"] = v.clone()
        out["@step"] = self._step_count
        return out

    def set_state_dict(self, state: Dict[str, object]) -> None:
        self._step_count = int(state.get("@step", 0))
        for i, p in enumerate(self._params()):
            prefix = f"param_{i}__"
            # copies: the update writes the state tensors in place
            st = {k[len(prefix):]: torch.as_tensor(v, device=p.device).clone(
                      memory_format=torch.contiguous_format)
                  for k, v in state.items()
                  if isinstance(k, str) and k.startswith(prefix)}
            if st:
                self._accumulators[id(p)] = st
