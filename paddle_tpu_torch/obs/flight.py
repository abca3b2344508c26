"""Crash flight recorder: the last N spans + resilience timeline +
metrics, dumped atomically when decode dies.

Counterpart of ``paddle_tpu/obs/flight.py`` (its own copy; the same
postmortem, ``"kind": "paddle_tpu.postmortem"``, with the same keys).

A failed run's most valuable telemetry is the part that never got
exported: the trace ring and metrics registries live in the process
that just raised. The flight recorder turns an exhausted degradation
ladder / ``DecodeFailedError`` into a bounded postmortem JSON on disk —
written BEFORE the exception propagates, so the evidence survives the
process — with:

- the newest ``FLAGS_obs_flight_spans`` spans from the tracer ring
  (plus the ring's drop count — saturation is part of the record),
- the typed resilience event timeline (retries, degradations, injected
  faults — ``runtime/resilience.recent_events``),
- the process-global metrics snapshot and every attached registry
  (ServingEngines attach theirs, by weakref),
- the crash reason, error class/message and site.

Dumps are atomic (private tmp+rename — deliberately NOT
``atomic_write_bytes``: the fault injector hooks that path, and a
torn-write fault plan must never be able to tear the postmortem that
documents it). Active only while obs is enabled and
``FLAGS_obs_flight_recorder`` is on; every failure inside the recorder
is swallowed — a crash dump must never mask the crash.
"""

from __future__ import annotations

import json
import os
import threading
import time
import weakref
from typing import Any, Dict, List, Optional

from paddle_tpu_torch.flags import flags
from paddle_tpu_torch.obs.metrics import metrics as _global_metrics
from paddle_tpu_torch.obs.trace import obs_enabled as _obs_enabled
from paddle_tpu_torch.obs.trace import tracer as _tracer

__all__ = ["FlightRecorder", "flight_recorder", "record_crash"]


class FlightRecorder:
    """Bounded postmortem dumper. One process-global instance
    (:data:`flight_recorder`) serves every crash site; engines attach
    their private registries via :meth:`add_registry` (weakref — the
    recorder never extends an engine's lifetime)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._registries: List[tuple] = []     # (name, weakref)
        self._states: List[tuple] = []         # (name, weakref) — any
        #                                        object with .snapshot()
        self._seq = 0
        self.last_path: Optional[str] = None

    def add_registry(self, name: str, registry) -> None:
        """Re-attaching a name REPLACES the old entry (a rebuilt engine
        or unfenced replica must not leave a stale twin in the dump)."""
        with self._lock:
            self._registries = [
                (n, r) for n, r in self._registries
                if r() is not None and n != name]
            self._registries.append((name, weakref.ref(registry)))

    def add_state(self, name: str, provider) -> None:
        """Attach any stateful component exposing ``snapshot()`` (e.g. a
        serving prefix cache, a replica router's health table) so its
        live state lands in the postmortem — weakref, like registries,
        so the recorder never extends a component's lifetime; same
        name-replacement rule as :meth:`add_registry`."""
        with self._lock:
            self._states = [
                (n, r) for n, r in self._states
                if r() is not None and n != name]
            self._states.append((name, weakref.ref(provider)))

    def enabled(self) -> bool:
        return _obs_enabled() and bool(
            flags.obs_flight_recorder)

    def dump(self, reason: str, error: Optional[BaseException] = None,
             extra: Optional[dict] = None,
             path: Optional[str] = None) -> Optional[str]:
        """Write the postmortem; returns its path, or None when the
        recorder is disabled. Never raises."""
        try:
            if path is None and not self.enabled():
                return None
            n_spans = max(1, int(flags.obs_flight_spans))
            spans = _tracer.spans()
            from paddle_tpu_torch.runtime.resilience import recent_events
            record: Dict[str, Any] = {
                "kind": "paddle_tpu.postmortem",
                "reason": reason,
                "error": None if error is None else {
                    "class": type(error).__name__,
                    "message": str(error)[:2000],
                },
                "pid": os.getpid(),
                "time_unix": time.time(),
                "monotonic_ns": time.monotonic_ns(),
                "spans": [s.as_dict() for s in spans[-n_spans:]],
                "spans_in_ring": len(spans),
                "spans_dropped": _tracer.dropped,
                "resilience_events": [
                    e.as_dict() if hasattr(e, "as_dict") else str(e)
                    for e in recent_events()],
                "metrics": _global_metrics.snapshot(),
            }
            with self._lock:
                regs = list(self._registries)
                states = list(self._states)
            registries = {}
            for name, ref in regs:
                reg = ref()
                if reg is not None:
                    try:
                        registries[name] = reg.snapshot()
                    except Exception:
                        pass
            record["registries"] = registries
            state = {}
            for name, ref in states:
                prov = ref()
                if prov is not None:
                    try:
                        state[name] = prov.snapshot()
                    except Exception:
                        pass
            if state:
                record["state"] = state
            if extra:
                record["extra"] = extra
            if path is None:
                with self._lock:
                    self._seq += 1
                    seq = self._seq
                d = str(flags.obs_flight_dir) or "."
                os.makedirs(d, exist_ok=True)
                path = os.path.join(
                    d, f"postmortem_{os.getpid()}_{seq}.json")
            # NaN-safe strict JSON (histogram quantiles may be None
            # already; allow_nan=False catches anything else)
            from paddle_tpu_torch.obs.exporter import json_safe
            data = json.dumps(json_safe(record), indent=1,
                              default=str, allow_nan=False).encode()
            tmp = f"{path}.tmp.{os.getpid()}"
            with open(tmp, "wb") as f:
                f.write(data)
                f.flush()
                os.fsync(f.fileno())
            os.replace(tmp, path)
            self.last_path = path
            return path
        except Exception:
            return None


flight_recorder = FlightRecorder()


def record_crash(reason: str, error: Optional[BaseException] = None,
                 extra: Optional[dict] = None) -> Optional[str]:
    """The one-line hook the decode ladder / serving chunk path calls
    right before raising ``DecodeFailedError``. Never raises; returns
    the postmortem path (None when disabled) and stderr-notes it so an
    operator tailing a dead run sees where the evidence went."""
    path = flight_recorder.dump(reason, error=error, extra=extra)
    if path is not None:
        import sys
        print(f"flight recorder: postmortem -> {path} ({reason})",
              file=sys.stderr)
    return path
