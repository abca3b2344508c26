"""Adam, AdamW and Lamb.

Counterpart of ``paddle_tpu/optimizer/adam.py``: the update math in f32,
then one cast to the parameter's dtype; f32 ``beta1_pow``/``beta2_pow``;
moments in f32, or in the parameter's dtype for a low-precision
parameter with ``multi_precision=False``; an f32 ``master_weight`` for a
low-precision parameter with ``multi_precision=True``. The arithmetic
lives in ``ops/kernels/adam.py``: ``update`` is its ``adam_ref`` on one
parameter, ``update_many`` its multi-tensor kernel on CUDA tensors.
``lazy_mode`` is accepted and has no effect, as in the JAX package (the
gradients are dense). ``Lamb`` is torch ops (no kernel), the JAX update
with its trust ratio from f32 norms.
"""

from __future__ import annotations

import torch

from paddle_tpu_torch.ops.kernels import adam as _adam
from paddle_tpu_torch.optimizer.optimizer import Optimizer

__all__ = ["Adam", "AdamW", "Lamb"]


class Adam(Optimizer):
    # False: L2 regularization folded into the gradient (paddle's Adam);
    # True: decoupled decay of the weight (AdamW)
    _decoupled = False

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, parameters=None, weight_decay=None,
                 grad_clip=None, lazy_mode=False, multi_precision=True,
                 name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name)
        self._beta1, self._beta2, self._epsilon = beta1, beta2, epsilon
        self._multi_precision = multi_precision

    def init_state(self, p):
        mdt = (torch.float32
               if self._multi_precision or p.dtype == torch.float32
               else p.dtype)
        one = torch.ones((), dtype=torch.float32, device=p.device)
        st = {"moment1": torch.zeros_like(p, dtype=mdt),
              "moment2": torch.zeros_like(p, dtype=mdt),
              "beta1_pow": one, "beta2_pow": one.clone()}
        if self._multi_precision and p.dtype != torch.float32:
            st["master_weight"] = p.detach().float().clone()
        return st

    def update(self, g, st, p, lr, wd):
        new_p, m1, m2, w, b1p, b2p = _adam.adam_ref(
            p, g, st["moment1"], st["moment2"], st.get("master_weight"),
            st["beta1_pow"], st["beta2_pow"], lr, self._beta1, self._beta2,
            self._epsilon, wd, self._decoupled)
        new_st = {"moment1": m1, "moment2": m2, "beta1_pow": b1p,
                  "beta2_pow": b2p}
        if w is not None:
            new_st["master_weight"] = w
        return new_p, new_st

    @torch.no_grad()
    def update_many(self, grads, states, params, lr, wd) -> None:
        """``update`` over lists, in place, as ``ops/kernels/adam.py``
        ``adam_update``: one multi-tensor kernel pass for CUDA tensors, the
        per-parameter update for CPU tensors."""
        _adam.adam_update(
            list(params), list(grads), [st["moment1"] for st in states],
            [st["moment2"] for st in states],
            [st.get("master_weight") for st in states],
            [st["beta1_pow"] for st in states],
            [st["beta2_pow"] for st in states], lr, self._beta1,
            self._beta2, self._epsilon, wd, self._decoupled)


class AdamW(Adam):
    """Decoupled weight decay."""

    _decoupled = True


class Lamb(Optimizer):
    def __init__(self, learning_rate=0.001, lamb_weight_decay=0.01,
                 beta1=0.9, beta2=0.999, epsilon=1e-6, parameters=None,
                 grad_clip=None, exclude_from_weight_decay_fn=None,
                 name=None):
        super().__init__(learning_rate, parameters, lamb_weight_decay,
                         grad_clip, name)
        self._beta1, self._beta2, self._epsilon = beta1, beta2, epsilon

    def init_state(self, p):
        one = torch.ones((), dtype=torch.float32, device=p.device)
        return {"moment1": torch.zeros_like(p, dtype=torch.float32),
                "moment2": torch.zeros_like(p, dtype=torch.float32),
                "beta1_pow": one, "beta2_pow": one.clone()}

    def update(self, g, st, p, lr, wd):
        g = g.float()
        p32 = p.float()
        b1, b2 = self._beta1, self._beta2
        b1p = st["beta1_pow"] * b1
        b2p = st["beta2_pow"] * b2
        m1 = b1 * st["moment1"] + (1 - b1) * g
        m2 = b2 * st["moment2"] + (1 - b2) * torch.square(g)
        m1_hat = m1 / (1 - b1p)
        m2_hat = m2 / (1 - b2p)
        r = m1_hat / (torch.sqrt(m2_hat) + self._epsilon) + wd * p32
        w_norm = torch.linalg.vector_norm(p32)
        r_norm = torch.linalg.vector_norm(r)
        trust = torch.where((w_norm > 0) & (r_norm > 0), w_norm / r_norm,
                            1.0)
        new_p = p32 - lr * trust * r
        return new_p.to(p.dtype), {"moment1": m1, "moment2": m2,
                                   "beta1_pow": b1p, "beta2_pow": b2p}
