"""Live telemetry plane: /metrics, /statusz, /tracez over stdlib HTTP.

Counterpart of ``paddle_tpu/obs/exporter.py`` (its own copy; the backend
block reports torch's device).

The obs spine's pull surface — what turns the tracer ring and metrics
registries from post-hoc trace files into something a running serving
process exposes, the deferred ROADMAP rung ("the /metrics endpoint over
MetricsRegistry.to_prometheus()"):

- ``/metrics`` — Prometheus text exposition 0.0.4: the process-global
  obs registry plus every attached registry (a ServingEngine's private
  registry attaches under its name). Telemetry saturation is exported
  first-class: the tracer's ring-buffer drop count syncs into the
  ``obs.tracer.dropped_spans`` gauge on every scrape, and histograms
  carry ``_samples_dropped`` lines — silent span/sample loss is a
  metric, not a mystery.
- ``/statusz`` — one JSON document: process/build info, backend, obs
  switches, and every attached status provider (the engine contributes
  its slot table, occupancy, queue depth, in-flight requests and
  resilience-ladder rung). NaN/Inf are sanitized to null — strict JSON
  for dashboards.
- ``/tracez`` — the newest completed spans from the tracer ring as JSON
  (``?limit=N``, default 256, plus the drop count), the "what just
  happened" debugging view.
- ``/healthz`` — the fleet prober's liveness/readiness verdict: 200
  with the attached health provider's JSON when it answers ``ok``,
  503 when it answers not-ok or raises (a broken health check IS the
  unhealthy signal).

One daemon ``ThreadingHTTPServer`` thread; ``start()`` binds (port 0 =
ephemeral, the test mode) and returns the actual port, ``stop()`` shuts
the server down and releases it. Wired from
``ServingEngine.start_exporter`` via ``FLAGS_obs_export_port``.
"""

from __future__ import annotations

import json
import math
import os
import threading
import time
import weakref
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Callable, Dict, Optional
from urllib.parse import parse_qs, urlparse

from paddle_tpu_torch.flags import flags
from paddle_tpu_torch.obs.metrics import metrics as _global_metrics
from paddle_tpu_torch.obs.trace import obs_enabled as _obs_enabled
from paddle_tpu_torch.obs.trace import tracer as _tracer

__all__ = ["ObsExporter", "resolve_export_port", "json_safe"]

_START_MONOTONIC = time.monotonic()


def resolve_export_port() -> int:
    """The configured exporter port, ``FLAGS_obs_export_port`` (0 = no
    exporter)."""
    return int(flags.obs_export_port)


def json_safe(obj: Any) -> Any:
    """Recursively replace NaN/Inf floats with None: /statusz and
    /tracez promise STRICT JSON (Python's json.dumps would happily emit
    the non-standard ``NaN`` literal and break consumers)."""
    if isinstance(obj, float):
        return obj if math.isfinite(obj) else None
    if isinstance(obj, dict):
        return {k: json_safe(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [json_safe(v) for v in obj]
    return obj


def _backend_info() -> dict:
    try:
        import torch
        if torch.cuda.is_available():
            return {"platform": "gpu",
                    "device_kind": torch.cuda.get_device_name(0),
                    "device_count": torch.cuda.device_count()}
        return {"platform": "cpu", "device_kind": "cpu",
                "device_count": 1}
    except Exception as e:
        return {"platform": None, "error": str(e)[:200]}


class ObsExporter:
    """The start/stoppable telemetry endpoint bundle."""

    def __init__(self, port: Optional[int] = None,
                 host: str = "127.0.0.1"):
        self._port = resolve_export_port() if port is None else int(port)
        self._host = host
        self._server: Optional[ThreadingHTTPServer] = None
        self._thread: Optional[threading.Thread] = None
        self._lock = threading.Lock()
        self._registries: Dict[str, Any] = {}
        self._status: Dict[str, Callable[[], dict]] = {}
        self._text: Dict[str, Callable[[], str]] = {}
        self._health: Optional[Callable[[], dict]] = None

    # -- composition --------------------------------------------------------
    def add_registry(self, name: str, registry,
                     labels: Optional[Dict[str, str]] = None
                     ) -> "ObsExporter":
        """Attach a MetricsRegistry whose instruments join the /metrics
        scrape (after the process-global registry). ``labels`` attach to
        every sample line — how N replica registries with identical
        metric names share one exposition (``{replica="replica0"}``)."""
        with self._lock:
            self._registries[name] = (registry, dict(labels or {}))
        return self

    def add_status_provider(self, name: str,
                            fn: Callable[[], dict]) -> "ObsExporter":
        """Attach a callable whose dict lands under ``name`` in
        /statusz. Provider errors are reported in-band, never a 500."""
        with self._lock:
            self._status[name] = fn
        return self

    def add_text_provider(self, name: str,
                          fn: Callable[[], str]) -> "ObsExporter":
        """Attach a callable returning raw Prometheus exposition text,
        appended verbatim to every /metrics scrape — how a cluster
        frontend folds its workers' live (already per-worker-labelled)
        /metrics into ONE fleet exposition. A provider that raises
        contributes a comment line, never a failed scrape."""
        with self._lock:
            self._text[name] = fn
        return self

    def set_health_provider(self, fn: Callable[[], dict]
                            ) -> "ObsExporter":
        """Attach the /healthz verdict callable: its dict must carry a
        truthy ``"ok"`` for a 200; a falsy ``"ok"`` — or the provider
        raising — answers 503 (an unreachable or broken health check IS
        the unhealthy signal a fleet prober wants). Without a provider
        /healthz answers ``{"ok": true}`` while the server runs."""
        with self._lock:
            self._health = fn
        return self

    def add_engine(self, engine, name: str = "serving",
                   labels: Optional[Dict[str, str]] = None
                   ) -> "ObsExporter":
        """Attach a ServingEngine: its private registry joins /metrics
        (optionally labelled — a replicated router attaches each replica
        with ``labels={"replica": name}``) and its live status (slot
        table, queue, occupancy, ladder rung) joins /statusz. Held by
        weakref — an exporter never keeps a dead engine (and its device
        carry) alive."""
        ref = weakref.ref(engine)
        self.add_registry(name, engine.registry, labels=labels)

        def status():
            eng = ref()
            if eng is None:
                return {"gone": True}
            return eng.status()
        return self.add_status_provider(name, status)

    # -- lifecycle ----------------------------------------------------------
    @property
    def port(self) -> int:
        return self._port

    def running(self) -> bool:
        return self._server is not None

    def start(self) -> int:
        """Bind and serve on a daemon thread; returns the actual port
        (meaningful with port 0). Idempotent while running."""
        if self._server is not None:
            return self._port
        exporter = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):   # quiet: telemetry, not access logs
                pass

            def do_GET(self):
                try:
                    exporter._handle(self)
                except BrokenPipeError:
                    pass
                except Exception as e:
                    try:
                        self.send_error(500, str(e)[:200])
                    except Exception:
                        pass

        self._server = ThreadingHTTPServer((self._host, self._port),
                                           Handler)
        self._server.daemon_threads = True
        self._port = self._server.server_address[1]
        self._thread = threading.Thread(
            target=self._server.serve_forever, name="obs-exporter",
            daemon=True)
        self._thread.start()
        return self._port

    def stop(self) -> None:
        """Shut down and release the port (join bounded — stop() must
        never hang a drain path)."""
        server, thread = self._server, self._thread
        self._server = self._thread = None
        if server is not None:
            server.shutdown()
            server.server_close()
        if thread is not None:
            thread.join(timeout=5.0)

    # -- request handling ---------------------------------------------------
    def _handle(self, req: BaseHTTPRequestHandler) -> None:
        url = urlparse(req.path)
        if url.path == "/metrics":
            body = self.metrics_text().encode()
            ctype = "text/plain; version=0.0.4; charset=utf-8"
        elif url.path == "/statusz":
            body = json.dumps(json_safe(self.statusz()), indent=1,
                              default=str).encode()
            ctype = "application/json"
        elif url.path == "/healthz":
            ok, payload = self.healthz()
            body = json.dumps(json_safe(payload), default=str).encode()
            req.send_response(200 if ok else 503)
            req.send_header("Content-Type", "application/json")
            req.send_header("Content-Length", str(len(body)))
            req.end_headers()
            req.wfile.write(body)
            return
        elif url.path == "/tracez":
            q = parse_qs(url.query)
            try:
                limit = int(q.get("limit", ["256"])[0])
            except ValueError:
                limit = 256
            body = json.dumps(json_safe(self.tracez(limit)),
                              default=str).encode()
            ctype = "application/json"
        else:
            req.send_error(
                404, "unknown path (serving /metrics /statusz /tracez "
                     "/healthz)")
            return
        req.send_response(200)
        req.send_header("Content-Type", ctype)
        req.send_header("Content-Length", str(len(body)))
        req.end_headers()
        req.wfile.write(body)

    # -- payload builders (public: tests and bench reuse them) --------------
    def metrics_text(self) -> str:
        # saturation sync: the ring's drop counter becomes a scrapeable
        # gauge the moment anyone looks
        _global_metrics.gauge(
            "obs.tracer.dropped_spans",
            "spans evicted from the tracer ring buffer (telemetry "
            "saturation — raise FLAGS_obs_buffer_size if nonzero)"
        ).set(_tracer.dropped)
        parts = [_global_metrics.to_prometheus()]
        with self._lock:
            regs = list(self._registries.items())
        for _, (reg, labels) in regs:
            try:
                parts.append(reg.to_prometheus(labels=labels or None))
            except Exception:
                pass
        with self._lock:
            texts = list(self._text.items())
        for name, fn in texts:
            try:
                parts.append(fn())
            except Exception as e:
                parts.append(f"# text provider {name} unavailable: "
                             f"{type(e).__name__}\n")
        return "".join(p for p in parts if p)

    def statusz(self) -> dict:
        out = {
            "pid": os.getpid(),
            "time_unix": time.time(),
            "uptime_s": round(time.monotonic() - _START_MONOTONIC, 3),
            "backend": _backend_info(),
            "obs": {
                "enabled": _obs_enabled(),
                "tracer_spans": len(_tracer.spans()),
                "tracer_dropped_spans": _tracer.dropped,
            },
            "flags": self._flag_block(),
        }
        with self._lock:
            providers = list(self._status.items())
        for name, fn in providers:
            try:
                out[name] = fn()
            except Exception as e:
                out[name] = {"error": f"{type(e).__name__}: "
                                      f"{str(e)[:200]}"}
        return out

    def healthz(self):
        """The /healthz verdict as ``(ok, payload)`` — public so tests
        and the cluster frontend can probe without HTTP."""
        with self._lock:
            fn = self._health
        if fn is None:
            return True, {"ok": True}
        try:
            payload = dict(fn())
        except Exception as e:
            return False, {"ok": False,
                           "error": f"{type(e).__name__}: "
                                    f"{str(e)[:200]}"}
        return bool(payload.get("ok")), payload

    def tracez(self, limit: int = 256) -> dict:
        spans = _tracer.spans()
        limit = max(1, min(int(limit), 4096))
        return {"count": len(spans),
                "dropped": _tracer.dropped,
                "spans": [s.as_dict() for s in spans[-limit:]]}

    @staticmethod
    def _flag_block() -> dict:
        return {n: flags.get(n) for n in flags.names()
                if n.startswith(("obs_", "resilience_", "decode_"))}
