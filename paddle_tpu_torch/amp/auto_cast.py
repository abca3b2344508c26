"""auto_cast: the white and black lists and the cast at an op's entry.

Counterpart of ``paddle_tpu/amp/auto_cast.py``: the same lists, the same
thread-local state and the same rule (``amp_dtype_for_op``). The JAX
package applies the rule in its op registry, to every floating input of
every op it dispatches. The port has no registry: each port function that
the JAX package dispatches under a listed name calls ``amp_cast`` with
that name on its floating inputs at its top (``linear`` and the Llama's
projections, the head ``matmul``, ``flash_attention`` / ``sdpa_ref``,
``rms_norm``, ``softmax``, ``cross_entropy``, ``conv2d``). Ops the lists
leave out take no cast and promote as they would (torch and ``jnp``
promote f32 with bf16 to f32 alike).
"""

from __future__ import annotations

import contextlib
import threading
from typing import Optional, Set

import torch

__all__ = ["auto_cast", "amp_guard", "is_auto_cast_enabled", "amp_state",
           "white_list", "black_list", "decorate", "amp_dtype_for_op",
           "amp_cast"]

# ops that benefit from low precision (tensor-core ops)
WHITE_LIST: Set[str] = {
    "matmul", "mm", "bmm", "mv", "linear", "conv1d", "conv2d", "conv3d",
    "conv1d_transpose", "conv2d_transpose", "conv3d_transpose", "einsum",
    "sdpa_ref", "flash_attention",
}
# numerically sensitive ops kept in f32
BLACK_LIST: Set[str] = {
    "exp", "log", "log2", "log10", "log1p", "pow", "square", "sqrt", "rsqrt",
    "softmax", "log_softmax", "cross_entropy", "layer_norm", "rms_norm",
    "batch_norm_train", "batch_norm_infer", "mean", "sum", "logsumexp",
    "cosine_similarity", "norm",
}

_DTYPES = {"bfloat16": torch.bfloat16, "float16": torch.float16,
           "float32": torch.float32}


def _dtype(d) -> torch.dtype:
    if isinstance(d, torch.dtype):
        return d
    try:
        return _DTYPES[str(d)]
    except KeyError:
        raise ValueError(f"unknown dtype {d!r}") from None


def white_list():
    return set(WHITE_LIST)


def black_list():
    return set(BLACK_LIST)


class _AmpState(threading.local):
    def __init__(self):
        self.enabled = False
        self.dtype = torch.bfloat16
        self.level = "O1"
        self.custom_white: Set[str] = set()
        self.custom_black: Set[str] = set()


_state = _AmpState()


def amp_state() -> _AmpState:
    return _state


def is_auto_cast_enabled() -> bool:
    return _state.enabled


@contextlib.contextmanager
def auto_cast(enable: bool = True, custom_white_list=None,
              custom_black_list=None, level: str = "O1",
              dtype: str = "bfloat16"):
    prev = (_state.enabled, _state.dtype, _state.level,
            _state.custom_white, _state.custom_black)
    _state.enabled = enable
    _state.dtype = _dtype(dtype)
    _state.level = level
    _state.custom_white = set(custom_white_list or ())
    _state.custom_black = set(custom_black_list or ())
    try:
        yield
    finally:
        (_state.enabled, _state.dtype, _state.level,
         _state.custom_white, _state.custom_black) = prev


amp_guard = auto_cast


def amp_dtype_for_op(op_name: str) -> Optional[torch.dtype]:
    """The dtype an op's floating inputs are cast to, or None (no cast)."""
    if not _state.enabled:
        return None
    if op_name in _state.custom_black or (
            op_name in BLACK_LIST and op_name not in _state.custom_white):
        return torch.float32
    if op_name in WHITE_LIST or op_name in _state.custom_white:
        return _state.dtype
    if _state.level == "O2":
        return _state.dtype
    return None


def amp_cast(op_name: str, *tensors):
    """``tensors`` as the op ``op_name`` takes them under the current
    auto_cast state: each floating tensor of another dtype cast to
    ``amp_dtype_for_op(op_name)``; anything else (None, integer tensors,
    Python numbers) as it is. Returns a tuple."""
    dt = amp_dtype_for_op(op_name)
    if dt is None:
        return tensors
    return tuple(t.to(dt) if isinstance(t, torch.Tensor)
                 and t.is_floating_point() and t.dtype != dt else t
                 for t in tensors)


def decorate(models, optimizers=None, level="O2", dtype="bfloat16",
             master_weight=None, save_dtype=None):
    """O2: cast the models' parameters to ``dtype`` (``Module.to``). An
    ``Adam`` / ``AdamW`` with ``multi_precision=True`` keeps f32 master
    weights of them."""
    d = _dtype(dtype)
    single = not isinstance(models, (list, tuple))
    model_list = [models] if single else list(models)
    if level == "O2":
        for m in model_list:
            m.to(dtype=d)
    if optimizers is None:
        return models
    return models, optimizers
