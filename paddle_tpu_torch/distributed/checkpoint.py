"""The numpy storage of tensors in checkpoints and serving payloads.

Counterpart of ``paddle_tpu/distributed/checkpoint.py:69-80``: a tensor
goes into an npz as a numpy-native array plus a dtype tag, and the same
tags cross in both directions, so a payload one package writes the other
reads. bf16 has no numpy dtype: it is stored as its ``uint16`` bits
tagged ``"bfloat16"``, and comes back as a bf16 tensor through torch's
own view of the bits (no ``ml_dtypes``). The distributed checkpoint
format itself comes with ROADMAP.md queue 1, item [14.7].
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

__all__ = ["_np_storable", "_np_restore"]


def _np_storable(t) -> Tuple[np.ndarray, str]:
    """A tensor (or numpy array) -> ``(numpy-native array, dtype tag)`` on
    the host: bf16 becomes its ``uint16`` bits tagged ``"bfloat16"``; any
    other dtype keeps its numpy name as the tag."""
    if isinstance(t, torch.Tensor):
        t = t.detach().cpu()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16), "bfloat16"
        a = t.numpy()
    else:
        a = np.asarray(t)
    return a, str(a.dtype)


def _np_restore(arr: np.ndarray, dtype_tag: str) -> torch.Tensor:
    """The inverse of :func:`_np_storable`, as a CPU tensor: a ``uint16``
    array tagged ``"bfloat16"`` becomes a bf16 tensor of the same bits.
    torch computes on no unsigned type wider than 8 bits, so a ``uint16``
    / ``uint32`` / ``uint64`` array comes back as the signed tensor of the
    same width and bits (the port holds threefry key words so)."""
    a = np.ascontiguousarray(arr)
    if dtype_tag == "bfloat16" and a.dtype == np.uint16:
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    if a.dtype.kind == "u" and a.dtype.itemsize > 1:
        a = a.view(np.dtype(f"i{a.dtype.itemsize}"))
    return torch.from_numpy(a.copy())
