"""Carry a JAX model's parameters into the port's model, and back out.

The JAX package's models and layers (``LlamaForCausalLM``,
``UNet2DConditionModel``, ``GPTForCausalLM``, ``BertForMaskedLM``, the
``nn.transformer`` layers, ``MoEMLP`` and ``MoELayer``) and the port's
share parameter names and layouts (linear weights ``(in, out)``,
convolutions OIHW, stacked experts ``(E, in, out)``): their
``state_dict()`` and the port's ``named_parameters()`` match name for
name, so the transfer is a checked one-to-one copy of any of them. The caller hands
the JAX side over as numpy arrays (``{name: np.asarray(t.value)}``); this
module imports nothing of JAX.

``save_state_npz`` / ``load_state_npz`` stage a model's weights as one
npz under the same names, as the JAX package's cluster launcher stages
``weights_v<n>.npz``: an f32 model writes exactly the JAX file's arrays,
so a JAX-staged file loads into the port's model; bf16 parameters go
through the storage tags of ``distributed/checkpoint.py`` (their
``uint16`` bits, tagged in one ``__dtype_tags__`` JSON entry), so a bf16
model crosses bit for bit.
"""

from __future__ import annotations

from typing import Dict

import json
import os

import numpy as np
import torch

from paddle_tpu_torch.distributed.checkpoint import _np_restore, _np_storable

__all__ = ["from_jax_state_dict", "to_numpy_state_dict", "save_state_npz",
           "load_state_npz"]

_TAGS = "__dtype_tags__"


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


def save_state_npz(model, path: str) -> str:
    """Write every parameter of ``model`` to the npz ``path`` (a temporary
    file moved into place, so a reader never sees half a file): numpy
    dtypes as they are, bf16 as tagged ``uint16`` bits. Returns ``path``."""
    arrays, tags = {}, {}
    for name, p in model.named_parameters():
        a, tag = _np_storable(p)
        arrays[name] = a
        if tag != str(a.dtype):
            tags[name] = tag
    if tags:
        arrays[_TAGS] = np.asarray(json.dumps(tags, sort_keys=True))
    tmp = f"{path}.tmp.{os.getpid()}.npz"
    np.savez(tmp, **arrays)
    os.replace(tmp, path)
    return path


def load_state_npz(path: str, model):
    """Copy every parameter of ``model`` from the npz ``path`` that
    :func:`save_state_npz` or the JAX package's launcher wrote (tagged
    bf16 bits restore exactly; other arrays cast to the parameter's
    dtype). Missing, extra or misshapen entries raise ``ValueError``.
    Returns ``model``."""
    with np.load(path) as data:
        tags = json.loads(str(data[_TAGS])) if _TAGS in data.files else {}
        state = {k: _np_restore(data[k], tags.get(k, str(data[k].dtype)))
                 for k in data.files if k != _TAGS}
    params = dict(model.named_parameters())
    missing = sorted(set(params) - set(state))
    extra = sorted(set(state) - set(params))
    if missing or extra:
        raise ValueError(f"{path}: state dict mismatch: missing "
                         f"{missing[:3]}, unexpected {extra[:3]}")
    with torch.no_grad():
        for name, p in params.items():
            t = state[name]
            if tuple(t.shape) != tuple(p.shape):
                raise ValueError(f"{name}: shape {tuple(t.shape)} does "
                                 f"not match {tuple(p.shape)}")
            p.copy_(t.to(p.device).to(p.dtype))
    return model
