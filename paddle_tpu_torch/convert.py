"""Carry a JAX model's parameters into the port's model, and back out.

The JAX package's ``LlamaForCausalLM`` and ``UNet2DConditionModel``
``state_dict()`` and the port's ``named_parameters()`` share names and
layouts (linear weights ``(in, out)``, convolutions OIHW), so the transfer
is a checked one-to-one copy. The caller hands
the JAX side over as numpy arrays (``{name: np.asarray(t.value)}``); this
module imports nothing of JAX.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

__all__ = ["from_jax_state_dict", "to_numpy_state_dict"]


def from_jax_state_dict(np_state: Dict[str, np.ndarray], model):
    """Copy every parameter of ``model`` from ``np_state`` (same names,
    same shapes; cast to the parameter's dtype on its device). Missing,
    extra or misshapen entries raise ``ValueError``. Returns ``model``."""
    params = dict(model.named_parameters())
    missing = sorted(set(params) - set(np_state))
    extra = sorted(set(np_state) - set(params))
    if missing or extra:
        raise ValueError(f"state dict mismatch: missing {missing}, "
                         f"unexpected {extra}")
    with torch.no_grad():
        for name, p in params.items():
            src = np.asarray(np_state[name])
            if tuple(src.shape) != tuple(p.shape):
                raise ValueError(f"{name}: shape {tuple(src.shape)} does "
                                 f"not match {tuple(p.shape)}")
            p.copy_(torch.from_numpy(np.array(src, np.float32)).to(p.dtype))
    return model


def to_numpy_state_dict(model) -> Dict[str, np.ndarray]:
    """``{name: float32 numpy array}`` of every parameter of ``model``
    (numpy has no bf16; bf16 values are exact in f32), for comparing
    with the JAX package's ``{name: np.asarray(t.value)}``."""
    return {name: p.detach().float().cpu().numpy()
            for name, p in model.named_parameters()}
