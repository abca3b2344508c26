"""Streaming HTTP front-end over one or more ServingEngines.

Counterpart of ``paddle_tpu/serving/http/server.py``
(the port's own copy: it imports nothing of the JAX package).

The missing process boundary: everything below (engine, router,
cluster) talks Python; this module puts the serving loop behind a
socket so tenants talk HTTP. Design:

- **One pump thread per frontend.** A ServingEngine is NOT
  thread-safe; every ``submit()`` and every ``step()`` runs under one
  lock, and only the pump calls ``step()``. Handler threads (stdlib
  ``ThreadingHTTPServer``, one per connection) do a locked submit and
  then WAIT on a per-request queue — the pump feeds it from the
  engine's streaming callback and step results. The fused-dispatch
  batching property is untouched: N concurrent HTTP requests still
  decode as rows of ONE chunk program per engine.
- **Chunk-boundary streaming.** ``POST /v1/generate`` with
  ``"stream": true`` answers HTTP/1.1 chunked transfer encoding; every
  chunk harvest that grew the row becomes one JSON-line body chunk
  (``{"tokens": [...]}``), and the finish flush closes the stream with
  ``{"tokens": [...], "final": true, ...}``. Flush cadence IS the
  engine's chunk cadence — per-token streaming without per-token
  dispatches.
- **Multi-bundle routing.** Construct with ``{name: engine}`` and the
  request's ``"model"`` field picks the bundle — one process serves
  several model/draft/adapter combos, each its own engine + slot table.
- **Typed sheds map to status codes.** Unknown adapter -> 400, unknown
  model -> 404, deadline/backpressure shed at submit -> 429, draining
  -> 503, deadline expired mid-flight (non-streaming) -> 504; a stream
  that already sent 200 reports the typed error in its final chunk.
- **Telemetry is delegated, not reimplemented.** ``GET /metrics``
  ``/statusz`` ``/healthz`` ``/tracez`` call the same
  :class:`~paddle_tpu_torch.obs.exporter.ObsExporter` payload builders the
  standalone exporter serves; each engine attaches under its bundle
  name. ``/healthz`` flips not-ok the moment a drain starts —
  load-balancer-visible before the 503s begin.
"""

from __future__ import annotations

import json
import queue
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Dict, Optional, Union
from urllib.parse import parse_qs, urlparse

import numpy as np

from paddle_tpu_torch.obs.exporter import ObsExporter, json_safe
from paddle_tpu_torch.obs.metrics import metrics as _metrics

__all__ = ["HttpFrontend", "DrainingError"]


class DrainingError(RuntimeError):
    """Submit refused because the frontend is draining (503)."""


class _HttpError(Exception):
    def __init__(self, code: int, message: str, kind: str):
        super().__init__(message)
        self.code = code
        self.kind = kind


def _classify(exc: Exception) -> "_HttpError":
    """Map a typed engine refusal to its HTTP status."""
    from paddle_tpu_torch.runtime.resilience import DeadlineExceededError
    from paddle_tpu_torch.serving.lora import UnknownAdapterError
    if isinstance(exc, UnknownAdapterError):
        return _HttpError(400, str(exc), "unknown_adapter")
    if isinstance(exc, DeadlineExceededError):
        return _HttpError(429, str(exc), "shed")
    if isinstance(exc, DrainingError):
        return _HttpError(503, str(exc), "draining")
    if isinstance(exc, (ValueError, TypeError, KeyError)):
        return _HttpError(400, str(exc), "bad_request")
    return _HttpError(500, f"{type(exc).__name__}: {exc}", "internal")


class HttpFrontend:
    """The start/stoppable HTTP serving process face.

    ``engines`` is a single :class:`ServingEngine` (served as bundle
    ``"default"``) or a ``{name: engine}`` dict. ``port=0`` binds an
    ephemeral port (the test mode); ``start()`` returns the actual
    one. ``exporter=`` shares an existing ObsExporter's payload
    builders; by default the frontend builds a private (never-bound)
    one and attaches every engine to it.
    """

    def __init__(self, engines, port: int = 0, host: str = "127.0.0.1",
                 exporter: Optional[ObsExporter] = None,
                 step_idle_s: float = 0.002,
                 default_bundle: Optional[str] = None):
        if not isinstance(engines, dict):
            engines = {"default": engines}
        if not engines:
            raise ValueError("HttpFrontend needs at least one engine")
        self.engines: Dict[str, Any] = dict(engines)
        self.default_bundle = (default_bundle if default_bundle is not None
                               else next(iter(self.engines)))
        if self.default_bundle not in self.engines:
            raise ValueError(
                f"default_bundle {self.default_bundle!r} is not a "
                f"bundle (have {sorted(self.engines)})")
        self._host = host
        self._port = int(port)
        self._idle = float(step_idle_s)
        self._lock = threading.Lock()        # guards submit() AND step()
        self._waiters: Dict[tuple, queue.Queue] = {}
        self._draining = False
        self._stop = threading.Event()
        self._server: Optional[ThreadingHTTPServer] = None
        self._pump: Optional[threading.Thread] = None
        self._httpd_thread: Optional[threading.Thread] = None
        if exporter is None:
            exporter = ObsExporter(port=0)
            for name, eng in self.engines.items():
                exporter.add_engine(eng, name=name)
        self.exporter = exporter
        exporter.set_health_provider(self._health)
        self._c_req = _metrics.counter(
            "serving.http.requests",
            "POST /v1/generate requests accepted by the HTTP front-end")
        self._c_stream = _metrics.counter(
            "serving.http.streams",
            "accepted requests served as chunked token streams")
        self._c_err = _metrics.counter(
            "serving.http.errors",
            "POST /v1/generate requests answered with a 4xx/5xx "
            "(typed sheds included — a refusal is an answer)")

    # -- health / status -----------------------------------------------------
    def _health(self) -> dict:
        return {"ok": not self._draining and not self._stop.is_set(),
                "draining": self._draining,
                "bundles": sorted(self.engines)}

    def _busy(self, eng) -> bool:
        return bool(len(eng.scheduler)) \
            or bool(eng.scheduler.slots.occupied())

    # -- lifecycle -----------------------------------------------------------
    @property
    def port(self) -> int:
        return self._port

    def start(self) -> int:
        """Bind, start the pump + server threads; returns the port."""
        if self._server is not None:
            return self._port
        frontend = self

        class Handler(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"

            def log_message(self, *a):
                pass

            def do_GET(self):
                try:
                    frontend._handle_get(self)
                except BrokenPipeError:
                    pass

            def do_POST(self):
                try:
                    frontend._handle_post(self)
                except BrokenPipeError:
                    pass

        self._server = ThreadingHTTPServer((self._host, self._port),
                                           Handler)
        self._server.daemon_threads = True
        self._port = self._server.server_address[1]
        self._stop.clear()
        self._pump = threading.Thread(target=self._pump_loop,
                                      name="http-frontend-pump",
                                      daemon=True)
        self._pump.start()
        self._httpd_thread = threading.Thread(
            target=self._server.serve_forever, name="http-frontend",
            daemon=True)
        self._httpd_thread.start()
        return self._port

    def drain(self, timeout_s: float = 60.0) -> bool:
        """Graceful drain: stop taking generate work (503 +
        not-ok /healthz) but keep pumping until every in-flight row
        finishes and every handler got its answer. Returns True when
        the frontend went idle inside the budget."""
        self._draining = True
        t0 = time.monotonic()
        while time.monotonic() - t0 < timeout_s:
            with self._lock:
                busy = any(self._busy(e) for e in self.engines.values())
            if not busy and not self._waiters:
                return True
            time.sleep(self._idle)
        return False

    def stop(self, drain_timeout_s: float = 0.0) -> None:
        """Stop serving; ``drain_timeout_s > 0`` drains first."""
        if drain_timeout_s > 0:
            self.drain(drain_timeout_s)
        self._draining = True
        self._stop.set()
        server, self._server = self._server, None
        if server is not None:
            server.shutdown()
            server.server_close()
        if self._httpd_thread is not None:
            self._httpd_thread.join(timeout=5.0)
            self._httpd_thread = None
        if self._pump is not None:
            self._pump.join(timeout=5.0)
            self._pump = None

    # -- the pump ------------------------------------------------------------
    def _pump_loop(self) -> None:
        """The ONLY caller of ``engine.step()``. Streaming callbacks
        fire inside step (under the lock) and enqueue straight into the
        owning handler's queue; results route after step returns — a
        handler therefore always sees its token flushes BEFORE its
        result, finals included."""
        while not self._stop.is_set():
            did = False
            for name, eng in self.engines.items():
                with self._lock:
                    if not self._busy(eng):
                        continue
                    try:
                        finished = eng.step()
                    except Exception as e:   # engine died: fail waiters
                        finished = [(rid, e) for (b, rid) in
                                    list(self._waiters) if b == name]
                    did = True
                for rid, res in finished:
                    q = self._waiters.pop((name, rid), None)
                    if q is not None:
                        q.put(("result", res))
            if not did:
                time.sleep(self._idle)

    # -- request handling ----------------------------------------------------
    def _handle_get(self, req: BaseHTTPRequestHandler) -> None:
        url = urlparse(req.path)
        if url.path == "/metrics":
            body = self.exporter.metrics_text().encode()
            code, ctype = 200, "text/plain; version=0.0.4; charset=utf-8"
        elif url.path == "/statusz":
            doc = self.exporter.statusz()
            doc["http_frontend"] = {
                "bundles": sorted(self.engines),
                "default_bundle": self.default_bundle,
                "draining": self._draining,
                "in_flight_requests": len(self._waiters),
            }
            body = json.dumps(json_safe(doc), indent=1,
                              default=str).encode()
            code, ctype = 200, "application/json"
        elif url.path == "/healthz":
            ok, payload = self.exporter.healthz()
            body = json.dumps(json_safe(payload), default=str).encode()
            code, ctype = (200 if ok else 503), "application/json"
        elif url.path == "/tracez":
            q = parse_qs(url.query)
            try:
                limit = int(q.get("limit", ["256"])[0])
            except ValueError:
                limit = 256
            body = json.dumps(json_safe(self.exporter.tracez(limit)),
                              default=str).encode()
            code, ctype = 200, "application/json"
        else:
            self._json_reply(req, 404, {"error": "unknown path",
                                        "kind": "not_found"})
            return
        req.send_response(code)
        req.send_header("Content-Type", ctype)
        req.send_header("Content-Length", str(len(body)))
        req.end_headers()
        req.wfile.write(body)

    def _json_reply(self, req, code: int, payload: dict) -> None:
        body = json.dumps(json_safe(payload), default=str).encode()
        req.send_response(code)
        req.send_header("Content-Type", "application/json")
        req.send_header("Content-Length", str(len(body)))
        req.end_headers()
        req.wfile.write(body)

    def _submit(self, spec: dict):
        """Parse + locked submit; returns (bundle, rid, engine, queue,
        stream?, prompt_len)."""
        if self._draining:
            raise DrainingError(
                "frontend is draining; submit refused (resubmit to "
                "another replica)")
        if not isinstance(spec, dict):
            raise ValueError("request body must be a JSON object")
        bundle = spec.get("model", self.default_bundle)
        eng = self.engines.get(bundle)
        if eng is None:
            raise _HttpError(
                404, f"unknown model bundle {bundle!r} (serving "
                     f"{sorted(self.engines)})", "unknown_model")
        prompt = spec.get("prompt")
        if prompt is None:
            raise ValueError("request needs a 'prompt' (token id list)")
        prompt = np.asarray(prompt, np.int64)
        kw = dict(
            max_new_tokens=int(spec.get("max_new_tokens", 16)),
            temperature=float(spec.get("temperature", 1.0)),
            seed=int(spec.get("seed", 0)),
            priority=int(spec.get("priority", 0)),
            latency_class=str(spec.get("latency_class", "default")),
            adapter=spec.get("adapter"),
        )
        if spec.get("eos_token_id") is not None:
            kw["eos_token_id"] = spec["eos_token_id"]
        if spec.get("deadline_s") is not None:
            kw["deadline_s"] = float(spec["deadline_s"])
        if spec.get("speculative") is not None:
            kw["speculative"] = bool(spec["speculative"])
        stream = bool(spec.get("stream", False))
        q: queue.Queue = queue.Queue()

        def on_tokens(rid, toks, final):
            q.put(("tokens", np.asarray(toks), bool(final)))

        with self._lock:
            if self._draining:
                raise DrainingError("frontend is draining")
            rid = eng.submit(prompt, on_tokens=on_tokens, **kw)
            self._waiters[(bundle, rid)] = q
        return bundle, rid, eng, q, stream, int(prompt.shape[-1])

    def _handle_post(self, req: BaseHTTPRequestHandler) -> None:
        url = urlparse(req.path)
        if url.path != "/v1/generate":
            self._json_reply(req, 404, {"error": "unknown path",
                                        "kind": "not_found"})
            return
        try:
            n = int(req.headers.get("Content-Length", "0"))
            spec = json.loads(req.rfile.read(n) or b"{}")
            bundle, rid, eng, q, stream, plen = self._submit(spec)
        except _HttpError as e:
            self._c_err.inc()
            self._json_reply(req, e.code, {"error": str(e),
                                           "kind": e.kind})
            return
        except Exception as e:
            he = _classify(e)
            self._c_err.inc()
            self._json_reply(req, he.code, {"error": str(he),
                                            "kind": he.kind})
            return
        self._c_req.inc()
        try:
            if stream:
                self._c_stream.inc()
                self._stream_reply(req, bundle, rid, q)
            else:
                self._unary_reply(req, bundle, rid, q, plen)
        finally:
            self._waiters.pop((bundle, rid), None)

    def _await(self, q: queue.Queue, timeout_s: float = 600.0):
        try:
            return q.get(timeout=timeout_s)
        except queue.Empty:
            raise TimeoutError("timed out waiting on the serving pump")

    def _unary_reply(self, req, bundle: str, rid: int, q: queue.Queue,
                     plen: int) -> None:
        """Block until the pump routes the result; one JSON document."""
        res = None
        while True:
            kind, *rest = self._await(q)
            if kind == "result":
                res = rest[0]
                break
        if isinstance(res, Exception):
            he = _classify(res)
            code = 504 if he.code == 429 else he.code   # expired in-flight
            self._c_err.inc()
            self._json_reply(req, code, {"error": str(res),
                                         "kind": he.kind,
                                         "request_id": rid,
                                         "model": bundle})
            return
        seq = np.asarray(res).reshape(-1)
        self._json_reply(req, 200, {
            "request_id": rid, "model": bundle,
            "prompt_tokens": plen,
            "tokens": [int(t) for t in seq],
            "generated": [int(t) for t in seq[plen:]]})

    def _stream_reply(self, req, bundle: str, rid: int,
                      q: queue.Queue) -> None:
        """Chunked transfer encoding, one JSON line per engine flush.
        The 200 is committed before the first token exists — a typed
        mid-flight shed travels in the final chunk's ``error``."""
        req.send_response(200)
        req.send_header("Content-Type", "application/jsonl")
        req.send_header("Transfer-Encoding", "chunked")
        req.send_header("Connection", "close")
        req.end_headers()
        req.close_connection = True

        def chunk(payload: dict) -> None:
            data = json.dumps(json_safe(payload), default=str).encode() \
                + b"\n"
            req.wfile.write(b"%X\r\n" % len(data) + data + b"\r\n")

        final_toks = None
        while final_toks is None:
            kind, *rest = self._await(q)
            if kind == "tokens":
                toks, fin = rest
                if fin:
                    final_toks = toks
                elif len(toks):
                    chunk({"tokens": [int(t) for t in toks]})
        # the result follows the final flush in queue order (pump
        # routes it after step returns); it carries the typed error, if
        # any, for the trailer chunk
        err = None
        while True:
            kind, *rest = self._await(q, timeout_s=30.0)
            if kind == "result":
                if isinstance(rest[0], Exception):
                    err = rest[0]
                break
        trailer = {"tokens": [int(t) for t in final_toks],
                   "final": True, "request_id": rid, "model": bundle}
        if err is not None:
            trailer["error"] = str(err)
            trailer["kind"] = _classify(err).kind
        chunk(trailer)
        req.wfile.write(b"0\r\n\r\n")
