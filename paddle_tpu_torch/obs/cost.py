"""Dispatch cost records: FLOPs, bytes and peak bytes of a dispatch.

Counterpart of ``paddle_tpu/obs/cost.py``. The JAX package reads XLA's
``cost_analysis()`` / ``memory_analysis()`` of the compiled program; torch
has no compiled program to ask, so a record is derived from one EAGER run
of the dispatch, once per (site, input signature), and cached:

- ``flops``: ``torch.utils.flop_counter.FlopCounterMode`` over the eager
  run (the warm-up that precedes a key's capture on the card, or the
  dispatch itself where nothing is captured; a graph replay runs no
  Python and is never measured). It counts aten matmuls and attention;
  the hand-written kernels are custom ops, opaque to ``FlopCounterMode``
  (``ops/kernels``), and add their own count through ``add_flops``
  (decode attention 4·B·H·L·D, the int8 matmul 2·M·K·N) on the card and
  on the CPU alike, which counts only while a pass runs. XLA also counts
  elementwise operations; this count does not.
- ``argument_bytes`` / ``output_bytes`` / ``bytes_per_dispatch``: the
  bytes of the dispatch's input tensors (the weights included) and of its
  outputs, each tensor storage once (the JAX fallback when XLA reports no
  "bytes accessed").
- ``peak_bytes``: on the card only, the eager run's peak of allocated
  bytes above what was allocated when it began. The allocator's peak is
  process-wide and other readers own it, so it is read, never reset:
  when the run does not raise the process's peak, its own peak is hidden
  under the earlier one, and the record holds ``peak_bytes_at_most``
  (that earlier peak above the run's base) instead.

Telemetry never breaks the dispatch it measures: every failure here
leaves the record out.
"""

from __future__ import annotations

import contextlib
import dataclasses
import threading
from typing import Any, Dict, Optional, Tuple

import torch

__all__ = ["dispatch_cost", "site_costs", "clear_cost_cache",
           "device_peak_flops", "mfu", "add_flops", "cost_pass",
           "eager_pass", "cost_cache_info"]

_CACHE: Dict[Tuple, Optional[dict]] = {}
_BY_SITE: Dict[str, dict] = {}      # latest record per site
_LOCK = threading.Lock()
_STATS = {"hits": 0, "misses": 0}
# the armed pass of this thread: .armed, .flops, .eager (an eager run was
# measured), .counting (inside eager_pass), .peak (bytes, exact)
_PASS = threading.local()


def _walk(obj, out: list) -> None:
    """Flatten tensors and static leaves of nested args (tuples, lists,
    dicts, dataclasses)."""
    if isinstance(obj, torch.Tensor):
        out.append(obj)
    elif isinstance(obj, (list, tuple)):
        for v in obj:
            _walk(v, out)
    elif isinstance(obj, dict):
        for k in sorted(obj, key=str):
            _walk(obj[k], out)
    elif dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        for f in dataclasses.fields(obj):
            _walk(getattr(obj, f.name), out)
    elif callable(obj):
        out.append("<fn>")
    else:
        out.append(obj)


def _sig(args, kwargs) -> Tuple:
    flat: list = []
    _walk((args, kwargs or {}), flat)
    return tuple((tuple(x.shape), str(x.dtype))
                 if isinstance(x, torch.Tensor) else x for x in flat)


def _nbytes(*objs) -> int:
    flat: list = []
    _walk(objs, flat)
    seen, n = set(), 0
    for x in flat:
        if isinstance(x, torch.Tensor):
            key = (x.device, x.data_ptr())
            if key not in seen:
                seen.add(key)
                n += x.numel() * x.element_size()
    return n


def dispatch_cost(site: str, args=(), kwargs=None) -> Optional[dict]:
    """The cached record of ``site`` at these arguments' signature, or
    None when none has been derived yet."""
    try:
        key = (site, _sig(args, kwargs))
    except Exception:
        return None
    with _LOCK:
        return _CACHE.get(key)


class _Pass:
    """One armed cost pass over a dispatch (see ``cost_pass``)."""

    def __init__(self, site, args, kwargs, weights):
        self.site, self.args, self.kwargs = site, args, kwargs
        self.weights = weights
        self.key = None
        self.record: Optional[dict] = None

    def finish(self, out) -> Optional[dict]:
        """The dispatch's record: the cached one, or a new one when this
        run was eager. Never raises."""
        try:
            if self.record is not None or self.key is None:
                return self.record
            if not getattr(_PASS, "eager", False):
                return None          # a replay: wait for an eager run
            rec: Dict[str, Any] = {}
            flops = float(getattr(_PASS, "flops", 0.0))
            if flops > 0:
                rec["flops"] = flops
            rec["argument_bytes"] = _nbytes(self.args, self.kwargs,
                                            self.weights)
            rec["output_bytes"] = _nbytes(out)
            rec["bytes_per_dispatch"] = (rec["argument_bytes"]
                                         + rec["output_bytes"])
            peak = getattr(_PASS, "peak", None)
            if peak is not None:
                rec["peak_bytes" if peak[1] else "peak_bytes_at_most"] = \
                    int(peak[0])
            with _LOCK:
                _CACHE[self.key] = rec
                _BY_SITE[self.site] = dict(rec)
            return rec
        except Exception:
            return None


@contextlib.contextmanager
def cost_pass(site: str, args=(), kwargs=None, weights=()):
    """Arm a cost pass over one dispatch: yields a handle whose
    ``finish(out)`` gives the record. A cached (site, signature) is a hit
    and arms nothing; otherwise the eager parts of the dispatch (entered
    through ``eager_pass``) are counted."""
    p = _Pass(site, args, kwargs, weights)
    try:
        p.key = (site, _sig(args, kwargs))
        with _LOCK:
            if p.key in _CACHE:
                _STATS["hits"] += 1
                p.record = _CACHE[p.key]
            else:
                _STATS["misses"] += 1
    except Exception:
        p.key = None
    armed = p.key is not None and p.record is None
    if armed:
        _PASS.armed, _PASS.flops, _PASS.eager, _PASS.peak = \
            True, 0.0, False, None
    try:
        yield p
    finally:
        if armed:
            _PASS.armed = False


@contextlib.contextmanager
def eager_pass(device=None):
    """Count the FLOPs of an eager dispatch body while a pass is armed
    (``FlopCounterMode`` plus the kernels' ``add_flops``), and on a card
    the run's peak of allocated bytes (read, never reset); a plain no-op
    otherwise."""
    if not getattr(_PASS, "armed", False) or getattr(_PASS, "counting",
                                                     False):
        yield
        return
    from torch.utils.flop_counter import FlopCounterMode
    cuda = device is not None and torch.device(device).type == "cuda"
    if cuda:
        torch.cuda.synchronize(device)
        base = torch.cuda.memory_allocated(device)
        before = torch.cuda.max_memory_allocated(device)
    _PASS.eager = _PASS.counting = True
    counter = FlopCounterMode(display=False)
    try:
        with counter:
            yield
    finally:
        _PASS.counting = False
    _PASS.flops += float(counter.get_total_flops())
    if cuda:
        torch.cuda.synchronize(device)
        after = torch.cuda.max_memory_allocated(device)
        # (bytes, exact): a new process peak is the run's own
        _PASS.peak = (after - base, True) if after > before else (
            max(0, before - base), False)


def add_flops(n: float) -> None:
    """A hand-written kernel's own count, added where it launches, while
    an eager pass runs (FlopCounterMode cannot see inside a custom op)."""
    if getattr(_PASS, "counting", False):
        _PASS.flops += float(n)


def site_costs() -> Dict[str, dict]:
    """The latest record per dispatch site."""
    with _LOCK:
        return {k: dict(v) for k, v in _BY_SITE.items()}


def cost_cache_info() -> Dict[str, int]:
    """Cache hits and misses of ``cost_pass`` since the last clear."""
    with _LOCK:
        return dict(_STATS, entries=len(_CACHE))


def clear_cost_cache() -> None:
    with _LOCK:
        _CACHE.clear()
        _BY_SITE.clear()
        _STATS.update(hits=0, misses=0)


def device_peak_flops() -> float:
    """Dense bf16 peak FLOP/s of device 0: 989e12 on an H100; the CPU,
    and any other device, gets a nominal 1e12 so MFU stays a defined
    ratio."""
    try:
        if torch.cuda.is_available() and \
                "H100" in torch.cuda.get_device_name(0):
            return 989e12
    except Exception:
        pass
    return 1e12


def mfu(flops: float, seconds: float,
        peak: Optional[float] = None) -> float:
    """Model-FLOPs utilisation of ``flops`` done in ``seconds``."""
    if seconds <= 0 or flops <= 0:
        return 0.0
    return flops / seconds / (peak if peak is not None
                              else device_peak_flops())
