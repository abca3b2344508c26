"""Structured span tracer: the timing spine of the obs package.

Counterpart of ``paddle_tpu/obs/trace.py`` (its own copy). One
thread-safe tracer serves every layer (the decoder's dispatch guard, the
serving engine's request timeline): ``with span("decode.chunk"):``
records a nested span on the monotonic clock into a bounded ring. Spans
measure HOST intervals around dispatches; on a card a dispatch's kernels
run after its launch returns, so the device time of a span comes from
``obs/device.py``, which gives each kernel to the span that enclosed its
launch. The cost record of a dispatch (``obs/cost.py``) rides in as span
attributes.

All timestamps are ``time.monotonic_ns()``, the clock the serving engine
stamps requests with, so request lifetime spans and dispatch spans share
one axis in an exported trace.

Off (the default, ``FLAGS_obs_enabled``), ``span()`` returns a shared
no-op context manager: one flag read a call.

Exports: ``export_chrome_trace`` (chrome://tracing / Perfetto) and
``export_jsonl`` (one span dict per line, the input of
``tools/trace_report.py``, which also reads the chrome form).
"""

from __future__ import annotations

import json
import os
import threading
import time
from typing import Any, Callable, Dict, List, Optional

from paddle_tpu_torch.flags import flags

__all__ = ["Span", "Tracer", "tracer", "span", "obs_enabled",
           "set_span_hook"]

# Optional per-span hook: a callable ``(name, span_id) -> context
# manager or None`` entered for the lifetime of every ACTIVE span.
# obs/device.py plugs a ``torch.profiler.record_function`` factory in here
# for the duration of a device trace, so the profiler timeline carries one
# ``obs#<span_id>`` region per obs span, and each kernel's device time can
# be given to the span that enclosed its launch. None (the default) costs
# one global read per enabled span; the disabled span path never consults
# it.
_SPAN_HOOK: Optional[Callable[[str, int], Any]] = None


def set_span_hook(hook: Optional[Callable[[str, int], Any]]) -> None:
    global _SPAN_HOOK
    _SPAN_HOOK = hook


def obs_enabled() -> bool:
    """The obs master switch, ``FLAGS_obs_enabled`` (``set_flags`` at
    run time), read live: tests and scripts toggle it around measurement
    windows."""
    return bool(flags.obs_enabled)


class Span:
    """One recorded interval. ``parent_id`` encodes nesting (same-thread
    enclosing span); ``seq`` is the tracer-wide admission order (marks /
    windowed counting); ``attrs`` carries site metadata and the attached
    compiled-program cost record."""

    __slots__ = ("name", "span_id", "parent_id", "start_ns", "end_ns",
                 "tid", "attrs", "seq", "kind")

    def __init__(self, name, span_id, parent_id, start_ns, end_ns, tid,
                 attrs, seq, kind="span"):
        self.name = name
        self.span_id = span_id
        self.parent_id = parent_id
        self.start_ns = start_ns
        self.end_ns = end_ns
        self.tid = tid
        self.attrs = attrs
        self.seq = seq
        self.kind = kind              # "span" | "event" (instant)

    @property
    def dur_ms(self) -> float:
        return (self.end_ns - self.start_ns) / 1e6

    def ok(self) -> bool:
        """True unless the spanned body raised (error spans are excluded
        from dispatch-count accounting — a failed dispatch never ran)."""
        return "error" not in self.attrs

    def as_dict(self) -> dict:
        return {"name": self.name, "span_id": self.span_id,
                "parent_id": self.parent_id, "start_ns": self.start_ns,
                "end_ns": self.end_ns, "dur_ms": self.dur_ms,
                "tid": self.tid, "kind": self.kind, "attrs": self.attrs}

    def as_chrome(self) -> dict:
        ev = {"name": self.name, "pid": os.getpid(), "tid": self.tid,
              "ts": self.start_ns / 1e3, "cat": self.kind,
              "args": dict(self.attrs)}
        if self.kind == "event":
            ev.update(ph="i", s="t")
        else:
            ev.update(ph="X", dur=(self.end_ns - self.start_ns) / 1e3)
        return ev


class _ActiveSpan:
    """The context manager handed out by ``Tracer.span`` when enabled.
    Records on exit; ``annotate()`` attaches attrs mid-flight (the cost
    telemetry hook)."""

    __slots__ = ("_tracer", "name", "attrs", "_start", "_parent",
                 "span_id", "_hook_cm")

    def __init__(self, tracer_, name, attrs):
        self._tracer = tracer_
        self.name = name
        self.attrs = attrs

    def annotate(self, **attrs) -> None:
        self.attrs.update(attrs)

    def __enter__(self):
        t = self._tracer
        self.span_id = t._next_id()
        stack = t._stack()
        self._parent = stack[-1] if stack else None
        stack.append(self.span_id)
        self._hook_cm = None
        hook = _SPAN_HOOK
        if hook is not None:
            # telemetry must never break the spanned body
            try:
                cm = hook(self.name, self.span_id)
                if cm is not None:
                    cm.__enter__()
                    self._hook_cm = cm
            except Exception:
                self._hook_cm = None
        self._start = time.monotonic_ns()
        return self

    def __exit__(self, etype, exc, tb):
        if self._hook_cm is not None:
            try:
                self._hook_cm.__exit__(None, None, None)
            except Exception:
                pass
            self._hook_cm = None
        end = time.monotonic_ns()
        stack = self._tracer._stack()
        if stack and stack[-1] == self.span_id:
            stack.pop()
        if etype is not None:
            self.attrs["error"] = f"{etype.__name__}: {str(exc)[:200]}"
        self._tracer._record(Span(
            self.name, self.span_id, self._parent, self._start, end,
            threading.get_ident() & 0xFFFF, self.attrs,
            self._tracer._next_seq()))
        return False


class _NullSpan:
    """Shared no-op for the disabled path — zero allocation per call."""

    __slots__ = ()

    def annotate(self, **attrs) -> None:
        pass

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NULL = _NullSpan()


class Tracer:
    """Thread-safe bounded span recorder.

    ``enabled``: ``None`` follows the global obs switch
    (:func:`obs_enabled`); a callable is consulted per call (the legacy
    profiler facade plugs its own recording state in here). The buffer
    is a ring: the newest ``capacity`` spans win, and ``dropped`` counts
    what the ring evicted so reports never silently claim completeness.
    ``mark()``/``spans_since(mark)`` give windowed views keyed by a
    monotonic admission counter — how the benches count dispatch spans
    for exactly the timed window."""

    def __init__(self, capacity: Optional[int] = None,
                 enabled: Optional[Callable[[], bool]] = None):
        self._cap = capacity
        self._enabled = enabled
        self._lock = threading.Lock()
        self._spans: List[Span] = []
        self._ids = 0
        self._seq = 0
        self.dropped = 0
        self._local = threading.local()

    # -- internals ----------------------------------------------------------
    def _capacity(self) -> int:
        if self._cap is not None:
            return self._cap
        return int(flags.obs_buffer_size)

    def _stack(self) -> list:
        st = getattr(self._local, "stack", None)
        if st is None:
            st = self._local.stack = []
        return st

    def _next_id(self) -> int:
        with self._lock:
            self._ids += 1
            return self._ids

    def _next_seq(self) -> int:
        with self._lock:
            self._seq += 1
            return self._seq

    def _record(self, sp: Span) -> None:
        with self._lock:
            self._spans.append(sp)
            cap = self._capacity()
            if len(self._spans) > cap:
                drop = len(self._spans) - cap
                del self._spans[:drop]
                self.dropped += drop

    def enabled(self) -> bool:
        return self._enabled() if self._enabled is not None \
            else obs_enabled()

    # -- recording API ------------------------------------------------------
    def span(self, name: str, **attrs):
        """Context manager timing a nested interval. No-op (shared
        singleton, no allocation) when disabled."""
        if not self.enabled():
            return _NULL
        return _ActiveSpan(self, name, attrs)

    def event(self, name: str, **attrs) -> None:
        """Instant event (Chrome 'i' phase) — serving request phase
        markers (queued/admitted/finished) and resilience events."""
        if not self.enabled():
            return
        now = time.monotonic_ns()
        self._record(Span(name, self._next_id(), None, now, now,
                          threading.get_ident() & 0xFFFF, attrs,
                          self._next_seq(), kind="event"))

    def add_span(self, name: str, start_ns: int, end_ns: int,
                 **attrs) -> None:
        """Retroactive span from caller-supplied ``time.monotonic_ns``
        stamps — the serving engine builds each request's lifetime span
        (submit -> finish) this way at finish time."""
        if not self.enabled():
            return
        self._record(Span(name, self._next_id(), None, int(start_ns),
                          int(end_ns), threading.get_ident() & 0xFFFF,
                          attrs, self._next_seq()))

    # -- views --------------------------------------------------------------
    def spans(self) -> List[Span]:
        with self._lock:
            return list(self._spans)

    def mark(self) -> int:
        """Current admission counter; pair with :meth:`spans_since`."""
        with self._lock:
            return self._seq

    def spans_since(self, mark: int) -> List[Span]:
        with self._lock:
            return [s for s in self._spans if s.seq > mark]

    def counts(self, since: int = 0, ok_only: bool = True
               ) -> Dict[str, int]:
        """Span count per name admitted after ``since`` (a ``mark()``
        value). ``ok_only`` drops error spans — the dispatch-accounting
        comparison counts only dispatches that ran."""
        out: Dict[str, int] = {}
        for s in self.spans_since(since):
            if s.kind != "span" or (ok_only and not s.ok()):
                continue
            out[s.name] = out.get(s.name, 0) + 1
        return out

    def clear(self) -> None:
        with self._lock:
            self._spans.clear()
            self.dropped = 0

    def drain(self) -> List[Span]:
        with self._lock:
            out, self._spans = self._spans, []
            return out

    # -- exporters ----------------------------------------------------------
    def chrome_events(self, since: int = 0) -> List[dict]:
        return [s.as_chrome() for s in self.spans_since(since)]

    def export_chrome_trace(self, path: str, since: int = 0,
                            extra_events: Optional[List[dict]] = None
                            ) -> str:
        """Write a chrome://tracing-loadable JSON trace; returns the
        path. Crash-safe write (atomic rename) — a trace artifact is
        evidence, and half a JSON is none."""
        from paddle_tpu_torch.runtime.resilience import atomic_write_bytes
        events = self.chrome_events(since) + list(extra_events or [])
        atomic_write_bytes(path, json.dumps(
            {"traceEvents": events, "displayTimeUnit": "ms"}).encode())
        return path

    def export_jsonl(self, path: str, since: int = 0) -> str:
        from paddle_tpu_torch.runtime.resilience import atomic_write_bytes
        lines = "".join(json.dumps(s.as_dict()) + "\n"
                        for s in self.spans_since(since))
        atomic_write_bytes(path, lines.encode())
        return path


tracer = Tracer()


def span(name: str, **attrs):
    """``with obs.span("decode.chunk", batch=8):`` on the global tracer."""
    return tracer.span(name, **attrs)
