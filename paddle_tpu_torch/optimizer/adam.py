"""Adam and AdamW.

Counterpart of ``paddle_tpu/optimizer/adam.py``: the update math in f32,
then one cast to the parameter's dtype; f32 ``beta1_pow``/``beta2_pow``;
moments in f32, or in the parameter's dtype for a low-precision
parameter with ``multi_precision=False``; an f32 ``master_weight`` for a
low-precision parameter with ``multi_precision=True``.
"""

from __future__ import annotations

import torch

from paddle_tpu_torch.optimizer.optimizer import Optimizer, _not_ported

__all__ = ["Adam", "AdamW"]


class Adam(Optimizer):
    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, parameters=None, weight_decay=None,
                 grad_clip=None, lazy_mode=False, multi_precision=True,
                 name=None):
        if lazy_mode:
            raise _not_ported("lazy_mode=True")
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

    def _decayed_grad(self, g, p32, wd):
        # Adam: L2 regularization folded into the gradient (paddle)
        return g + wd * p32

    def _apply_decay(self, p32, lr, wd):
        return p32

    def update(self, g, st, p, lr, wd):
        p32 = st.get("master_weight")
        if p32 is None:
            p32 = p.float()
        g = self._decayed_grad(g.float(), p32, wd)
        b1, b2 = self._beta1, self._beta2
        b1p = st["beta1_pow"] * b1
        b2p = st["beta2_pow"] * b2
        mdt = st["moment1"].dtype
        m1 = b1 * st["moment1"].float() + (1 - b1) * g
        m2 = b2 * st["moment2"].float() + (1 - b2) * g.square()
        m1_hat = m1 / (1 - b1p)
        m2_hat = m2 / (1 - b2p)
        p32 = self._apply_decay(p32, lr, wd)
        new_p32 = p32 - lr * m1_hat / (m2_hat.sqrt() + self._epsilon)
        new_st = {"moment1": m1.to(mdt), "moment2": m2.to(mdt),
                  "beta1_pow": b1p, "beta2_pow": b2p}
        if "master_weight" in st:
            new_st["master_weight"] = new_p32
        return new_p32.to(p.dtype), new_st


class AdamW(Adam):
    """Decoupled weight decay."""

    def _decayed_grad(self, g, p32, wd):
        return g

    def _apply_decay(self, p32, lr, wd):
        return p32 * (1.0 - lr * wd)
