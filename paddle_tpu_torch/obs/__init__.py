"""paddle_tpu_torch.obs: the observability spine of the port.

Counterpart of ``paddle_tpu/obs`` (its own copies; nothing of the JAX
package is imported):

- :mod:`~paddle_tpu_torch.obs.trace`: the span tracer (nested spans,
  monotonic clock, bounded ring) with Chrome trace and JSONL exports;
- :mod:`~paddle_tpu_torch.obs.metrics`: counters, gauges and
  histograms in a registry with snapshot and Prometheus text;
- :mod:`~paddle_tpu_torch.obs.cost`: dispatch cost records (FLOPs from
  ``FlopCounterMode`` over an eager run plus the hand-written kernels'
  own counts, input and output bytes, peak bytes) on the dispatch spans;
- :mod:`~paddle_tpu_torch.obs.device`: device time per span from a
  ``torch.profiler`` capture, each kernel given to the span of its
  launch;
- :mod:`~paddle_tpu_torch.obs.exporter`: ``/metrics``, ``/statusz``,
  ``/healthz`` and ``/tracez`` on a stdlib HTTP thread;
- :mod:`~paddle_tpu_torch.obs.flight`: the crash flight recorder, a
  postmortem JSON when the ladder exhausts.

Off by default: ``set_flags({"obs_enabled": True})`` or
``FLAGS_obs_enabled=1``. Off, each instrumented call pays one flag read.
``tools/trace_report.py`` renders an exported trace.
"""

from paddle_tpu_torch.obs.trace import (  # noqa: F401
    Span, Tracer, obs_enabled, set_span_hook, span, tracer,
)
from paddle_tpu_torch.obs.metrics import (  # noqa: F401
    Counter, Gauge, Histogram, MetricsRegistry, metrics,
)
from paddle_tpu_torch.obs.cost import (  # noqa: F401
    clear_cost_cache, device_peak_flops, dispatch_cost, mfu, site_costs,
)
from paddle_tpu_torch.obs.device import (  # noqa: F401
    DeviceTraceSession,
)
from paddle_tpu_torch.obs.exporter import (  # noqa: F401
    ObsExporter, resolve_export_port,
)
from paddle_tpu_torch.obs.flight import (  # noqa: F401
    FlightRecorder, flight_recorder, record_crash,
)

__all__ = [
    "Span", "Tracer", "tracer", "span", "obs_enabled", "set_span_hook",
    "Counter", "Gauge", "Histogram", "MetricsRegistry", "metrics",
    "dispatch_cost", "site_costs", "clear_cost_cache",
    "device_peak_flops", "mfu",
    "DeviceTraceSession",
    "ObsExporter", "resolve_export_port",
    "FlightRecorder", "flight_recorder", "record_crash",
    "enabled",
]

# the short form call sites use: ``if obs.enabled():``
enabled = obs_enabled
