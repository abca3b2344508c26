"""Hand-written CUDA kernels of the port, each beside its plain PyTorch
version. A wrapper given CPU tensors runs the plain version; given CUDA
tensors it launches its kernel (built from ``paddle_tpu_torch/csrc`` on
first use, see ``_build``) or raises.

Each wrapper module counts its kernel launches in plain integers
(``launches``, ``fwd_launches``, ``bwd_launches``), and the int8 matmul
also by row count (``launches_by_rows``, a dict). A CUDA graph replays
its launches without running Python, so the code that captures one takes
``launch_counts()`` before the capture, ``captured_launches(before)``
after it (which also undoes the capture's own counts: nothing ran), and
``add_launches(captured)`` at each replay. ``_CAPTURE_MODE`` is the
capture error mode every decoder and bundle graph is captured in;
``capture`` is the capture every graph of the port runs under."""

from __future__ import annotations

import contextlib
import gc
import importlib
from typing import Dict

import torch

__all__ = ["launch_counts", "captured_launches", "add_launches",
           "reset_launches", "capture"]

_WRAPPERS = ("adam", "decode_attention", "flash_attention", "group_norm",
             "int8_matmul", "rms_norm", "rope", "threefry")
_COUNTERS = ("launches", "fwd_launches", "bwd_launches", "launches_by_rows")

# the port's serving graphs capture in "thread_local" mode: a serving
# process has other threads beside the one that captures (the HTTP pump
# and its GET handlers, a cluster worker's RPC serve thread and its
# heartbeat), and in the default "global" mode any CUDA call one of them
# makes during a capture (a sync, a copy, an allocation) fails that capture
_CAPTURE_MODE = "thread_local"

@contextlib.contextmanager
def capture(graph, **kw):
    """``torch.cuda.graph(graph, **kw)`` with Python's cyclic garbage
    collector run once before and paused until the capture ends. torch no
    longer collects at a capture's start, and a cycle that dies with a
    CUDA graph in it (an earlier decoder or trainer) can be collected at
    any allocation: its graph's pool is then freed through ``cudaFree``,
    which is illegal during a capture and invalidates it."""
    gc.collect()
    enabled = gc.isenabled()
    gc.disable()
    try:
        with torch.cuda.graph(graph, **kw):
            yield
    finally:
        if enabled:
            gc.enable()


# (module, counter) for an integer counter, (module, counter, sub-key) for
# an entry of a dict counter
Counts = Dict[tuple, int]


def _counters():
    for name in _WRAPPERS:
        mod = importlib.import_module(f"{__name__}.{name}")
        for attr in _COUNTERS:
            if hasattr(mod, attr):
                yield mod, (name, attr)


def launch_counts() -> Counts:
    """Every wrapper's launch counters, by (module, counter) or, for a
    dict counter, by (module, counter, sub-key)."""
    counts = {}
    for mod, key in _counters():
        val = getattr(mod, key[1])
        if isinstance(val, dict):
            counts.update({key + (k,): n for k, n in val.items()})
        else:
            counts[key] = val
    return counts


def reset_launches() -> None:
    """Set every wrapper's launch counters to 0 (a measurement's start)."""
    for mod, key in _counters():
        if isinstance(getattr(mod, key[1]), dict):
            getattr(mod, key[1]).clear()
        else:
            setattr(mod, key[1], 0)


def captured_launches(before: Counts) -> Counts:
    """The launches counted since ``before`` (a capture's); the counters
    are set back to ``before``."""
    now = launch_counts()
    for mod, key in _counters():
        if isinstance(getattr(mod, key[1]), dict):
            d = getattr(mod, key[1])
            d.clear()
            d.update({k[2]: n for k, n in before.items()
                      if k[:2] == key})
        else:
            setattr(mod, key[1], before[key])
    delta = {k: n - before.get(k, 0) for k, n in now.items()}
    return {k: n for k, n in delta.items() if n}


def add_launches(captured: Counts) -> None:
    """Count one replay of a graph that captured ``captured``."""
    for key, n in captured.items():
        mod = importlib.import_module(f"{__name__}.{key[0]}")
        if len(key) == 3:
            d = getattr(mod, key[1])
            d[key[2]] = d.get(key[2], 0) + n
        else:
            setattr(mod, key[1], getattr(mod, key[1]) + n)
