"""Device-time span attribution from a ``torch.profiler`` capture.

Counterpart of ``paddle_tpu/obs/device.py``. Spans measure host intervals
(``trace.py``) and the cost record says what a dispatch should cost
(``cost.py``); this module adds the device time each span's work took:

- a :class:`DeviceTraceSession` runs ``torch.profiler`` (CPU and CUDA
  activities) over an obs window and, while it is active, plugs a span
  hook into the tracer that opens ``record_function("obs#<span_id>")``,
  so the profiler timeline carries one host region per obs span;
- on ``stop()`` the profiler's chrome trace is parsed. On a GPU a kernel
  runs after its launch returns, often after the dispatch span has
  closed, and a CUDA graph's kernels run after ``cudaGraphLaunch``
  returns, so a kernel's own device window says little about which span
  issued it. Each device op (kernel, memcpy, memset) is therefore given
  to the span that encloses its LAUNCH: the runtime call
  (``cudaLaunchKernel``, ``cudaGraphLaunch``, ``cuLaunchKernel``, ...)
  that carries the same correlation id. ``merge_device_events`` (the JAX
  function) takes the launch's host window in place of the op's device
  window, and the op's device duration as its weight; an op whose launch
  is not in the trace keeps its device window (the JAX rule);
- the summed device time lands on the owning spans as ``device_ms`` /
  ``device_occupancy`` attrs, and the session reports the attribution
  coverage (attributed over captured device time), so work outside every
  span is visible instead of silently missing.

Everything degrades to "no device attribution" on failure, and a session
needs obs on (without spans there is nothing to merge onto). A session
is opened only by its caller, around the window it wants traced: a
profiler session is far too heavy for the serving hot path.
"""

from __future__ import annotations

import bisect
import json
import os
import shutil
import tempfile
import threading
from typing import Dict, List, Optional, Tuple

from paddle_tpu_torch.obs import trace as _trace

__all__ = ["DeviceTraceSession", "merge_device_events"]

_ACTIVE_LOCK = threading.Lock()
_ACTIVE: Optional["DeviceTraceSession"] = None

# chrome-trace categories of device work, and of the host calls that
# launch it
_DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
_LAUNCH_CATS = ("cuda_runtime", "cuda_driver")


def _split_events(data: dict) -> Tuple[List[dict], List[dict]]:
    """Partition a torch profiler chrome trace into (obs annotation
    regions, device ops placed at their launch's host window with their
    device duration as ``weight``)."""
    annotations, device, launches = [], [], {}
    for e in data.get("traceEvents", []):
        if e.get("ph") != "X":
            continue
        name = str(e.get("name", ""))
        cat = e.get("cat")
        corr = (e.get("args") or {}).get("correlation")
        if name.startswith("obs#"):
            if cat != "gpu_user_annotation":
                annotations.append(e)
        elif cat in _DEVICE_CATS:
            device.append(e)
        elif cat in _LAUNCH_CATS and corr is not None:
            launches[corr] = e
    placed = []
    for e in device:
        la = launches.get((e.get("args") or {}).get("correlation"))
        if la is None:
            placed.append(e)
        else:
            placed.append({"ts": la.get("ts", 0.0),
                           "dur": la.get("dur", 0.0),
                           "weight": e.get("dur", 0.0)})
    return annotations, placed


def merge_device_events(annotations: List[dict],
                        device_events: List[dict]) -> dict:
    """Attribute each device-op event to the ``obs#<span_id>`` region it
    overlaps most (innermost wins on ties). The JAX package's function,
    with one addition: an event may carry ``weight``, the time it adds
    to its span and to the totals, where its ``ts`` / ``dur`` give the
    window that is matched (the launch's host window on a GPU); without
    ``weight`` the event's own ``dur`` is both. Returns::

        {"attributed_us": {span_id: us}, "device_total_us": float,
         "attributed_total_us": float, "coverage": float,
         "device_ops": int}
    """
    windows = []                       # (start, end, dur, span_id)
    for a in annotations:
        try:
            sid = int(str(a["name"]).split("#", 1)[1])
        except (ValueError, KeyError, IndexError):
            continue
        s = float(a.get("ts", 0.0))
        d = float(a.get("dur", 0.0))
        windows.append((s, s + d, d, sid))
    windows.sort()
    starts = [w[0] for w in windows]
    max_dur = max((w[2] for w in windows), default=0.0)
    attributed: Dict[int, float] = {}
    total = attributed_total = 0.0
    n_ops = 0
    for e in device_events:
        s = float(e.get("ts", 0.0))
        d = float(e.get("dur", 0.0))
        w = float(e.get("weight", d))
        if w <= 0:
            continue
        n_ops += 1
        total += w
        best_sid, best_ov, best_len = None, 0.0, 0.0
        # only windows starting before this op ends can overlap it, and
        # none starting more than max_dur before it begins still can
        hi = bisect.bisect_right(starts, s + d)
        for i in range(hi - 1, -1, -1):
            ws, we, wd, sid = windows[i]
            if ws < s - max_dur:
                break
            ov = min(we, s + d) - max(ws, s)
            if ov > best_ov or (ov == best_ov and ov > 0
                                and wd < best_len):
                best_sid, best_ov, best_len = sid, ov, wd
        if best_sid is not None and best_ov > 0:
            attributed[best_sid] = attributed.get(best_sid, 0.0) + w
            attributed_total += w
    return {"attributed_us": attributed, "device_total_us": total,
            "attributed_total_us": attributed_total,
            "coverage": (attributed_total / total) if total else 0.0,
            "device_ops": n_ops}


class DeviceTraceSession:
    """One profiler capture merged back onto the obs spans it covers::

        sess = DeviceTraceSession().start()
        ... obs-instrumented work ...
        summary = sess.stop()

    After ``stop()`` every span recorded during the session whose
    launches issued device work carries ``attrs["device_ms"]`` and
    ``attrs["device_occupancy"]`` (device_ms over the span's host
    interval). ``summary`` (also ``self.summary``)::

        {"active": True, "merged_spans": n, "coverage": 0.97,
         "device_total_ms": ..., "attributed_ms": ..., "device_ops": n,
         "by_site": {"decode.chunk": {"device_ms": ..., "spans": n,
                                      "device_ms_mean": ...}, ...}}

    Sessions don't nest (the profiler is process-global): starting while
    another session is active, or with obs off, yields an inactive
    session whose summary is ``{"active": False}``."""

    def __init__(self, log_dir: Optional[str] = None):
        self._log_dir = log_dir
        self._own_dir = log_dir is None
        self._mark: Optional[int] = None
        self._prof = None
        self.active = False
        self.summary: dict = {"active": False}

    def __enter__(self) -> "DeviceTraceSession":
        return self.start()

    def __exit__(self, *exc) -> bool:
        self.stop()
        return False

    def start(self) -> "DeviceTraceSession":
        global _ACTIVE
        if not _trace.obs_enabled():
            return self
        with _ACTIVE_LOCK:
            if _ACTIVE is not None:
                return self
            _ACTIVE = self
        try:
            import torch
            import torch.profiler as tp
            acts = [tp.ProfilerActivity.CPU]
            if torch.cuda.is_available():
                acts.append(tp.ProfilerActivity.CUDA)
            if self._own_dir:
                self._log_dir = tempfile.mkdtemp(prefix="obs_devtrace_")
            self._mark = _trace.tracer.mark()
            self._prof = tp.profile(activities=acts)
            self._prof.__enter__()
        except Exception:
            with _ACTIVE_LOCK:
                _ACTIVE = None
            return self
        self.active = True

        def _annotate(name, span_id):
            return torch.profiler.record_function(f"obs#{span_id}")

        _trace.set_span_hook(_annotate)
        return self

    def stop(self) -> dict:
        global _ACTIVE
        if not self.active:
            return self.summary
        self.active = False
        _trace.set_span_hook(None)
        try:
            self._prof.__exit__(None, None, None)
            path = os.path.join(self._log_dir, "trace.json")
            self._prof.export_chrome_trace(path)
            with open(path) as f:
                data = json.load(f)
            self.summary = self._merge(data)
        except Exception:
            pass
        finally:
            self._prof = None
            with _ACTIVE_LOCK:
                _ACTIVE = None
            if self._own_dir:
                shutil.rmtree(self._log_dir, ignore_errors=True)
        return self.summary

    def _merge(self, data: dict) -> dict:
        annotations, device_events = _split_events(data)
        merged = merge_device_events(annotations, device_events)
        spans = {s.span_id: s
                 for s in _trace.tracer.spans_since(self._mark or 0)}
        by_site: Dict[str, dict] = {}
        merged_spans = 0
        for sid, us in merged["attributed_us"].items():
            sp = spans.get(sid)
            if sp is None:           # evicted from the ring before merge
                continue
            ms = us / 1e3
            sp.attrs["device_ms"] = round(ms, 6)
            if sp.dur_ms > 0:
                sp.attrs["device_occupancy"] = round(ms / sp.dur_ms, 4)
            agg = by_site.setdefault(sp.name,
                                     {"device_ms": 0.0, "spans": 0})
            agg["device_ms"] += ms
            agg["spans"] += 1
            merged_spans += 1
        for agg in by_site.values():
            agg["device_ms"] = round(agg["device_ms"], 6)
            agg["device_ms_mean"] = round(
                agg["device_ms"] / agg["spans"], 6)
        return {"active": True, "merged_spans": merged_spans,
                "coverage": round(merged["coverage"], 4),
                "device_total_ms": round(
                    merged["device_total_us"] / 1e3, 6),
                "attributed_ms": round(
                    merged["attributed_total_us"] / 1e3, 6),
                "device_ops": merged["device_ops"],
                "by_site": dict(sorted(by_site.items()))}
