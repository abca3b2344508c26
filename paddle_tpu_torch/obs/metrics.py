"""Typed metrics registry: counters, gauges, histograms.

Counterpart of ``paddle_tpu/obs/metrics.py`` (its own copy, the same
arithmetic and the same exposition text). Instruments are get-or-create
by name (a name never changes type) and thread-safe. A histogram keeps
explicit cumulative buckets (Prometheus ``le`` semantics) and a bounded
reservoir of its newest 4096 raw samples, which answers ``percentile``.

Two kinds of registry: the process-global :data:`metrics`, which the
dispatch guard and the resilience events write into only with obs on,
and each ``ServingEngine``'s own, always on, which holds the engine's
accounting and feeds its ``metrics()``.
"""

from __future__ import annotations

import collections
import threading
from typing import Any, Dict, List, Optional, Sequence

__all__ = ["Counter", "Gauge", "Histogram", "MetricsRegistry", "metrics",
           "DEFAULT_BUCKETS"]

# latency-shaped default buckets (seconds): spans ~100µs host scatters to
# multi-second drain waits
DEFAULT_BUCKETS = (0.0001, 0.00025, 0.0005, 0.001, 0.0025, 0.005, 0.01,
                   0.025, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0)

_SAMPLE_CAP = 4096   # per-histogram raw-sample reservoir (newest wins)


class Counter:
    """Monotonic counter (``inc`` only)."""

    __slots__ = ("name", "help", "_value", "_lock")

    def __init__(self, name: str, help_: str = ""):
        self.name = name
        self.help = help_
        self._value = 0.0
        self._lock = threading.Lock()

    def inc(self, n: float = 1.0) -> None:
        if n < 0:
            raise ValueError(f"counter {self.name} cannot decrease ({n})")
        with self._lock:
            self._value += n

    @property
    def value(self) -> float:
        return self._value

    def snapshot(self) -> dict:
        return {"type": "counter", "value": self._value}


class Gauge:
    """Point-in-time value (``set``/``inc``/``dec``); tracks its max."""

    __slots__ = ("name", "help", "_value", "_max", "_lock")

    def __init__(self, name: str, help_: str = ""):
        self.name = name
        self.help = help_
        self._value = 0.0
        self._max = 0.0
        self._lock = threading.Lock()

    def set(self, v: float) -> None:
        with self._lock:
            self._value = float(v)
            self._max = max(self._max, self._value)

    def inc(self, n: float = 1.0) -> None:
        with self._lock:
            self._value += n
            self._max = max(self._max, self._value)

    def dec(self, n: float = 1.0) -> None:
        self.inc(-n)

    @property
    def value(self) -> float:
        return self._value

    @property
    def max(self) -> float:
        return self._max

    def snapshot(self) -> dict:
        return {"type": "gauge", "value": self._value, "max": self._max}


class Histogram:
    """Explicit-bucket histogram + bounded raw-sample reservoir.

    Buckets are upper bounds (Prometheus ``le`` semantics, cumulative at
    export); ``percentile(q)`` answers from the newest ``_SAMPLE_CAP``
    raw observations — exact for the test/bench scales that assert on
    it, honest-best-effort beyond (``samples_dropped`` says when)."""

    __slots__ = ("name", "help", "buckets", "_counts", "_sum", "_count",
                 "_samples", "samples_dropped", "_lock")

    def __init__(self, name: str, help_: str = "",
                 buckets: Optional[Sequence[float]] = None):
        self.name = name
        self.help = help_
        bs = tuple(sorted(float(b) for b in (buckets or DEFAULT_BUCKETS)))
        if not bs:
            raise ValueError(f"histogram {name} needs at least one bucket")
        self.buckets = bs
        self._counts = [0] * (len(bs) + 1)   # +inf tail
        self._sum = 0.0
        self._count = 0
        self._samples: collections.deque = collections.deque(
            maxlen=_SAMPLE_CAP)
        self.samples_dropped = 0
        self._lock = threading.Lock()

    def observe(self, v: float) -> None:
        v = float(v)
        with self._lock:
            i = 0
            for i, b in enumerate(self.buckets):
                if v <= b:
                    break
            else:
                i = len(self.buckets)
            self._counts[i] += 1
            self._sum += v
            self._count += 1
            if len(self._samples) == _SAMPLE_CAP:
                self.samples_dropped += 1
            self._samples.append(v)

    @property
    def count(self) -> int:
        return self._count

    @property
    def sum(self) -> float:
        return self._sum

    @property
    def mean(self) -> float:
        return self._sum / self._count if self._count else 0.0

    def percentile(self, q: float) -> float:
        """q in [0, 100] over the raw-sample reservoir. An EMPTY
        reservoir answers NaN, never 0.0 — a dashboard must be able to
        tell "no data" from "genuinely 0 ms" (the silent-zero p99 was a
        real misread class)."""
        with self._lock:
            if not self._samples:
                return float("nan")
            s = sorted(self._samples)
        k = (len(s) - 1) * (q / 100.0)
        lo, hi = int(k), min(int(k) + 1, len(s) - 1)
        return s[lo] + (s[hi] - s[lo]) * (k - lo)

    def snapshot(self) -> dict:
        with self._lock:
            cum, acc = [], 0
            for c in self._counts:
                acc += c
                cum.append(acc)
        empty = self._count == 0
        return {"type": "histogram", "count": self._count,
                "sum": self._sum, "mean": None if empty else self.mean,
                "p50": None if empty else self.percentile(50),
                "p99": None if empty else self.percentile(99),
                "buckets": {("+Inf" if i == len(self.buckets)
                             else repr(self.buckets[i])): cum[i]
                            for i in range(len(cum))},
                "samples_dropped": self.samples_dropped}


def _prom_name(name: str) -> str:
    out = "".join(c if (c.isalnum() or c == "_") else "_" for c in name)
    return out if not out[:1].isdigit() else "_" + out


class MetricsRegistry:
    """Get-or-create instrument registry with snapshot + Prometheus
    text exposition."""

    def __init__(self):
        self._lock = threading.Lock()
        self._by_name: Dict[str, Any] = {}

    def _get(self, name: str, cls, *args, **kwargs):
        with self._lock:
            m = self._by_name.get(name)
            if m is None:
                m = self._by_name[name] = cls(name, *args, **kwargs)
            elif not isinstance(m, cls):
                raise TypeError(
                    f"metric {name!r} is a {type(m).__name__}, asked for "
                    f"{cls.__name__}")
            return m

    def counter(self, name: str, help_: str = "") -> Counter:
        return self._get(name, Counter, help_)

    def gauge(self, name: str, help_: str = "") -> Gauge:
        return self._get(name, Gauge, help_)

    def histogram(self, name: str, help_: str = "",
                  buckets: Optional[Sequence[float]] = None) -> Histogram:
        return self._get(name, Histogram, help_, buckets)

    def names(self) -> List[str]:
        with self._lock:
            return sorted(self._by_name)

    def get(self, name: str):
        with self._lock:
            return self._by_name.get(name)

    def snapshot(self) -> Dict[str, dict]:
        """``{name: instrument.snapshot()}`` — the bench ``obs`` block /
        JSON artifact form."""
        with self._lock:
            items = list(self._by_name.items())
        return {name: m.snapshot() for name, m in sorted(items)}

    def to_prometheus(self, labels: Optional[Dict[str, str]] = None
                      ) -> str:
        """Prometheus text exposition format 0.0.4 (the scrape surface a
        real deployment would mount behind ``/metrics``). ``labels``
        attach to every sample line (e.g. ``{"replica": "replica0"}``)
        — how N same-shaped replica registries share one scrape without
        colliding metric names."""
        lab = ""
        if labels:
            lab = ",".join(f'{_prom_name(k)}="{v}"'
                           for k, v in sorted(labels.items()))
        with self._lock:
            items = sorted(self._by_name.items())
        lines: List[str] = []

        def sample(pn: str, value, extra: str = "") -> str:
            parts = ",".join(p for p in (extra, lab) if p)
            return f"{pn}{{{parts}}} {value}" if parts \
                else f"{pn} {value}"

        for name, m in items:
            pn = _prom_name(name)
            if m.help:
                lines.append(f"# HELP {pn} {m.help}")
            if isinstance(m, Counter):
                lines.append(f"# TYPE {pn} counter")
                lines.append(sample(pn, f"{m.value:g}"))
            elif isinstance(m, Gauge):
                lines.append(f"# TYPE {pn} gauge")
                lines.append(sample(pn, f"{m.value:g}"))
            else:
                lines.append(f"# TYPE {pn} histogram")
                snap = m.snapshot()
                for le, c in snap["buckets"].items():
                    lines.append(sample(f"{pn}_bucket", c,
                                        extra=f'le="{le}"'))
                lines.append(sample(f"{pn}_sum", f"{snap['sum']:g}"))
                lines.append(sample(f"{pn}_count", snap["count"]))
                # reservoir quantiles ride as plain gauges — and are
                # OMITTED for an empty histogram, so a scrape can never
                # read "no data yet" as "0 ms p99"
                if snap["count"]:
                    lines.append(sample(f"{pn}_p50", f"{snap['p50']:g}"))
                    lines.append(sample(f"{pn}_p99", f"{snap['p99']:g}"))
                # telemetry saturation is itself telemetry: a clipped
                # reservoir means the quantiles above are best-effort
                lines.append(sample(f"{pn}_samples_dropped",
                                    snap["samples_dropped"]))
        return "\n".join(lines) + ("\n" if lines else "")

    def reset(self) -> None:
        with self._lock:
            self._by_name.clear()


metrics = MetricsRegistry()
