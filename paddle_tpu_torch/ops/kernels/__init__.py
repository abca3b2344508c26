"""Hand-written CUDA kernels of the port, each beside its plain PyTorch
version. A wrapper given CPU tensors runs the plain version; given CUDA
tensors it launches its kernel (built from ``paddle_tpu_torch/csrc`` on
first use, see ``_build``) or raises.

Each wrapper module counts its kernel launches in plain integers
(``launches``, ``fwd_launches``, ``bwd_launches``). A CUDA graph replays
its launches without running Python, so the code that captures one takes
``launch_counts()`` before the capture, ``captured_launches(before)``
after it (which also undoes the capture's own counts: nothing ran), and
``add_launches(captured)`` at each replay."""

from __future__ import annotations

import importlib
from typing import Dict, Tuple

__all__ = ["launch_counts", "captured_launches", "add_launches"]

_WRAPPERS = ("adam", "decode_attention", "flash_attention", "group_norm",
             "int8_matmul", "rms_norm", "rope", "threefry")
_COUNTERS = ("launches", "fwd_launches", "bwd_launches")

Counts = Dict[Tuple[str, str], int]


def _counters():
    for name in _WRAPPERS:
        mod = importlib.import_module(f"{__name__}.{name}")
        for attr in _COUNTERS:
            if hasattr(mod, attr):
                yield mod, (name, attr)


def launch_counts() -> Counts:
    """Every wrapper's launch counters, by (module, counter)."""
    return {key: getattr(mod, key[1]) for mod, key in _counters()}


def captured_launches(before: Counts) -> Counts:
    """The launches counted since ``before`` (a capture's); the counters
    are set back to ``before``."""
    delta = {}
    for mod, key in _counters():
        delta[key] = getattr(mod, key[1]) - before[key]
        setattr(mod, key[1], before[key])
    return {k: n for k, n in delta.items() if n}


def add_launches(captured: Counts) -> None:
    """Count one replay of a graph that captured ``captured``."""
    for name, attr in captured:
        mod = importlib.import_module(f"{__name__}.{name}")
        setattr(mod, attr, getattr(mod, attr) + captured[name, attr])
