"""paddle_tpu_torch.serving.http — streaming HTTP front-end.

Counterpart of ``paddle_tpu/serving/http``.

``HttpFrontend`` wraps one or more :class:`ServingEngine` bundles
behind a stdlib ``ThreadingHTTPServer``: ``POST /v1/generate`` with
per-token streaming (chunk-boundary harvests are the flush points,
delivered as HTTP/1.1 chunked transfer encoding), request fields
mapped onto the engine's priority heap + deadline shedding, and
``/metrics`` ``/statusz`` ``/healthz`` ``/tracez`` delegated to the
obs exporter. See server.py for the threading contract.
"""

from paddle_tpu_torch.serving.http.server import (  # noqa: F401
    DrainingError,
    HttpFrontend,
)

__all__ = ["HttpFrontend", "DrainingError"]
