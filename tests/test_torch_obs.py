"""The port's observability spine (paddle_tpu_torch/obs) against the JAX
package's, on the CPU in f32 at a tiny GQA size.

The counterparts of tests/test_obs.py:57-190 and :261-360 (the tracer,
the registry with its Prometheus text byte-equal to the JAX registry's
for the same observations, histograms, the disabled path at the JAX
test's own bound, the serving timeline with the JAX engine's span counts,
``tools/trace_report.py`` on the port's export, the resilience mirror)
and of tests/test_obs_plane.py:69-130 and :157-340 (the exporter,
``merge_device_events`` on the JAX test's own input, the device session
refusing without obs, TTFT/TPOT and SLO counters, the flight recorder on
and off, NaN before the first sample), plus the port's dispatch cost
record: the tiny decoder's prefill FLOPs equal the matmul-plus-attention
count written out here, and a second call hits the cache. The JAX
imports live inside the fixtures and tests, so the card's test run
(``-m gpu``) imports this file without JAX.
"""

import json
import math
import os
import sys
import time
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from paddle_tpu_torch import obs
from paddle_tpu_torch.convert import from_jax_state_dict
from paddle_tpu_torch.flags import set_flags
from paddle_tpu_torch.inference.generate import LlamaDecoder
from paddle_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM
from paddle_tpu_torch.obs.cost import cost_cache_info
from paddle_tpu_torch.obs.device import merge_device_events
from paddle_tpu_torch.obs.exporter import json_safe
from paddle_tpu_torch.obs.metrics import MetricsRegistry
from paddle_tpu_torch.runtime.resilience import (DecodeFailedError,
                                                 fault_injector)
from paddle_tpu_torch.serving import ServingEngine

pytestmark = pytest.mark.obs

CFG = dict(vocab_size=64, hidden_size=32, intermediate_size=64,
           num_hidden_layers=2, num_attention_heads=4,
           num_key_value_heads=2, max_position_embeddings=64)
MAX_LEN = 64


@pytest.fixture()
def obs_on():
    set_flags({"obs_enabled": True})
    try:
        yield obs.tracer.mark()
    finally:
        set_flags({"obs_enabled": False})


@pytest.fixture(scope="module")
def models():
    import paddle_tpu as paddle
    from paddle_tpu.models.llama import LlamaConfig as JaxConfig
    from paddle_tpu.models.llama import LlamaForCausalLM as JaxModel

    paddle.seed(0)
    jm = JaxModel(JaxConfig(**CFG))
    state = {k: np.asarray(v.value) for k, v in jm.state_dict().items()}
    tm = from_jax_state_dict(
        state, LlamaForCausalLM(LlamaConfig(**CFG), device="cpu"))
    return jm, tm


@pytest.fixture(scope="module")
def dec(models):
    return LlamaDecoder(models[1], max_len=MAX_LEN, device="cpu")


def _trace_report():
    sys.path.insert(0, "tools")
    try:
        import trace_report
    finally:
        sys.path.pop(0)
    return trace_report


# -- tracer ------------------------------------------------------------------

def test_span_nesting_and_export_roundtrip(obs_on, tmp_path):
    m0 = obs_on
    with obs.span("outer", site="t"):
        with obs.span("inner") as sp:
            sp.annotate(flops=42.0)
            time.sleep(0.002)
    obs.tracer.event("phase.mark", request=7)
    spans = {s.name: s for s in obs.tracer.spans_since(m0)}
    assert spans["inner"].parent_id == spans["outer"].span_id
    assert spans["outer"].parent_id is None
    assert spans["inner"].attrs["flops"] == 42.0
    assert spans["inner"].dur_ms >= 2.0
    assert spans["outer"].dur_ms >= spans["inner"].dur_ms
    chrome = tmp_path / "t.json"
    obs.tracer.export_chrome_trace(str(chrome), since=m0)
    by_name = {e["name"]: e
               for e in json.loads(chrome.read_text())["traceEvents"]}
    assert by_name["inner"]["ph"] == "X"
    assert by_name["inner"]["args"]["flops"] == 42.0
    assert by_name["phase.mark"]["ph"] == "i"
    assert by_name["inner"]["dur"] == pytest.approx(
        spans["inner"].dur_ms * 1e3)
    jsonl = tmp_path / "t.jsonl"
    obs.tracer.export_jsonl(str(jsonl), since=m0)
    lines = [json.loads(x) for x in jsonl.read_text().splitlines()]
    assert {d["name"] for d in lines} == {"outer", "inner", "phase.mark"}
    inner = next(d for d in lines if d["name"] == "inner")
    assert inner["parent_id"] == spans["outer"].span_id


def test_span_errors_and_ring_bounds(obs_on):
    m0 = obs_on
    with pytest.raises(RuntimeError):
        with obs.span("boom"):
            raise RuntimeError("UNAVAILABLE: nope")
    [sp] = obs.tracer.spans_since(m0)
    assert not sp.ok() and "UNAVAILABLE" in sp.attrs["error"]
    assert obs.tracer.counts(m0) == {}
    assert obs.tracer.counts(m0, ok_only=False) == {"boom": 1}
    t = obs.Tracer(capacity=8, enabled=lambda: True)
    for i in range(20):
        with t.span(f"s{i}"):
            pass
    assert len(t.spans()) == 8 and t.dropped == 12
    assert t.spans()[-1].name == "s19"


def test_disabled_path_near_zero_overhead():
    """Off, a span is one flag read and a shared no-op context, under
    the JAX test's own bound of 20 µs a call."""
    set_flags({"obs_enabled": False})
    assert not obs.enabled()
    n = 20000
    for _ in range(100):
        with obs.span("x"):
            pass
    t0 = time.perf_counter()
    for _ in range(n):
        pass
    base = time.perf_counter() - t0
    t0 = time.perf_counter()
    for _ in range(n):
        with obs.span("x"):
            pass
    per_call = (time.perf_counter() - t0 - base) / n
    assert per_call < 20e-6, f"disabled span() costs {per_call*1e6:.2f}µs"
    m = obs.tracer.mark()
    with obs.span("x"):
        pass
    assert obs.tracer.spans_since(m) == []


# -- metrics -----------------------------------------------------------------

def _fill(reg_cls):
    r = reg_cls()
    c = r.counter("decode.dispatches", "help text")
    c.inc()
    c.inc(2)
    g = r.gauge("queue.depth")
    g.set(5)
    g.set(2)
    h = r.histogram("lat_s", buckets=[0.01, 0.1, 1.0])
    for v in (0.005, 0.05, 0.5, 2.0):
        h.observe(v)
    r.histogram("empty_s", buckets=[0.1])
    r.counter("serving.slo.strict.requests", "x").inc(3)
    return r


def test_registry_matches_jax_byte_for_byte():
    from paddle_tpu.obs.metrics import MetricsRegistry as JaxRegistry
    r, j = _fill(MetricsRegistry), _fill(JaxRegistry)
    assert r.to_prometheus() == j.to_prometheus()
    assert r.to_prometheus(labels={"replica": "r0"}) == \
        j.to_prometheus(labels={"replica": "r0"})
    assert r.snapshot() == j.snapshot()
    c = r.counter("decode.dispatches")
    assert r.counter("decode.dispatches") is c
    with pytest.raises(TypeError):
        r.gauge("decode.dispatches")
    with pytest.raises(ValueError):
        c.inc(-1)
    txt = r.to_prometheus()
    assert 'lat_s_bucket{le="+Inf"} 4' in txt and "lat_s_sum 2.555" in txt
    assert "empty_s_p50" not in txt and "empty_s_samples_dropped 0" in txt
    snap = r.snapshot()["lat_s"]
    assert snap["buckets"] == {"0.01": 1, "0.1": 2, "1.0": 3, "+Inf": 4}


def test_histogram_reservoir_matches_jax_over_5000_samples():
    """The bounded reservoir: 5000 observations keep the newest 4096, and
    the percentiles and snapshot equal the JAX histogram's."""
    from paddle_tpu.obs.metrics import MetricsRegistry as JaxRegistry
    vals = np.random.default_rng(0).lognormal(-3.0, 1.0, 5000)
    h = MetricsRegistry().histogram("lat_s")
    jh = JaxRegistry().histogram("lat_s")
    for v in vals:
        h.observe(float(v))
        jh.observe(float(v))
    for q in (50, 99):
        assert h.percentile(q) == jh.percentile(q)
    assert h.snapshot() == jh.snapshot()
    assert h.samples_dropped == 5000 - 4096
    s = np.sort(vals[-4096:])
    assert h.percentile(50) == pytest.approx(np.percentile(s, 50))


def test_empty_histogram_nan_and_engine_metrics_before_first_sample(dec):
    h = MetricsRegistry().histogram("lat_s", buckets=[0.1, 1.0])
    assert math.isnan(h.percentile(50))
    snap = h.snapshot()
    assert snap["p50"] is None and snap["mean"] is None
    h.observe(0.05)
    assert h.snapshot()["p50"] == 0.05
    m = ServingEngine(dec, num_slots=2, chunk_size=4).metrics()
    assert math.isnan(m["request_latency_p50_s"])
    assert math.isnan(m["ttft_p99_s"])
    safe = json_safe(m)
    assert safe["request_latency_p50_s"] is None
    json.dumps(safe, allow_nan=False)


# -- the dispatch cost record ------------------------------------------------

def test_prefill_cost_counts_matmuls_and_attention(obs_on, dec):
    """The prefill's FLOPs: per layer the qkv, output, gate/up and down
    projections, and the masked dense attention over the whole cache
    (QK^T and PV, each 2*B*H*S*L*D), then the head at the last position;
    the same signature again is a cache hit."""
    obs.clear_cost_cache()
    B, S = 2, 8
    hid, I, V = CFG["hidden_size"], CFG["intermediate_size"], \
        CFG["vocab_size"]
    H, KV = CFG["num_attention_heads"], CFG["num_key_value_heads"]
    D, L = hid // H, MAX_LEN
    per_layer = (2 * B * S * hid * (H + 2 * KV) * D
                 + 2 * 2 * B * H * S * L * D
                 + 2 * B * S * H * D * hid
                 + 2 * B * S * hid * 2 * I
                 + 2 * B * S * I * hid)
    want = CFG["num_hidden_layers"] * per_layer + 2 * B * hid * V
    ids = np.random.default_rng(0).integers(0, 64, (B, S))
    m0 = obs.tracer.mark()
    dec.generate(ids, max_new_tokens=3)
    cost = obs.site_costs()["decode.prefill"]
    assert cost["flops"] == want
    assert cost["bytes_per_dispatch"] == (cost["argument_bytes"]
                                          + cost["output_bytes"]) > 0
    spans = {s.name: s for s in obs.tracer.spans_since(m0)}
    assert spans["decode.prefill"].attrs["flops"] == want
    assert spans["decode.fused"].attrs["flops"] > 0
    info = cost_cache_info()
    dec.generate(ids, max_new_tokens=3)
    after = cost_cache_info()
    assert after["hits"] == info["hits"] + 2
    assert after["misses"] == info["misses"]
    assert obs.mfu(want, 0.001, peak=1e12) > 0
    if not torch.cuda.is_available():
        assert obs.device_peak_flops() == 1e12


# -- the serving timeline ----------------------------------------------------

def _timeline(d, engine_cls, o):
    m0 = o.tracer.mark()
    eng = engine_cls(d, num_slots=2, chunk_size=4)
    rng = np.random.default_rng(11)
    ids = [eng.submit(rng.integers(0, 64, (int(rng.integers(2, 8)),)),
                      int(rng.integers(2, 9)), seed=i) for i in range(5)]
    out = eng.drain()
    spans = o.tracer.spans_since(m0)
    events = {(s.name, s.attrs.get("request"))
              for s in spans if s.kind == "event"}
    return eng, ids, out, o.tracer.counts(m0), events


def test_serving_timeline_matches_jax(obs_on, models, dec, tmp_path):
    import paddle_tpu.obs as jobs
    from paddle_tpu.flags import set_flags as jax_set_flags
    from paddle_tpu.inference.generate import LlamaDecoder as JaxDecoder
    from paddle_tpu.serving import ServingEngine as JaxEngine

    jax_set_flags({"obs_enabled": True})
    try:
        _, jids, _, jcounts, jevents = _timeline(
            JaxDecoder(models[0], max_len=MAX_LEN), JaxEngine, jobs)
    finally:
        jax_set_flags({"obs_enabled": False})
    m0 = obs.tracer.mark()
    eng, ids, out, counts, events = _timeline(dec, ServingEngine, obs)
    assert counts == jcounts and ids == jids
    m = eng.metrics()
    assert counts["decode.admit_prefill"] == m["prefill_dispatches"] == 5
    assert counts["decode.chunk"] == m["chunk_dispatches"]
    assert counts["serving.request"] == 5
    assert {e for e in events if e[0].startswith("serving.request.")} == \
        {e for e in jevents if e[0].startswith("serving.request.")}
    for rid in ids:
        for phase in ("queued", "admitted", "finished"):
            assert (f"serving.request.{phase}", rid) in events
    assert m["request_latency_p99_s"] >= m["request_latency_p50_s"] > 0
    assert m["queue_depth_now"] == 0
    txt = eng.registry.to_prometheus()
    assert "serving_prefill_dispatches 5" in txt
    assert "serving_request_latency_s_count 5" in txt
    # tools/trace_report.py renders the port's export unchanged
    trace_report = _trace_report()
    path = tmp_path / "trace.json"
    obs.tracer.export_chrome_trace(str(path), since=m0)
    assert trace_report.main([str(path)]) == 0
    spans, evs = trace_report._load(str(path))
    rows, completeness = trace_report.request_table(spans, evs)
    assert len(rows) == 5 and completeness["incomplete"] == []
    phases = {r["phase"] for r in trace_report.phase_table(spans)}
    assert {"decode.admit_prefill", "decode.chunk",
            "serving.request"} <= phases


def test_resilience_events_mirror_into_obs(obs_on, dec):
    r0 = obs.metrics.counter("resilience.retries").value
    set_flags({"resilience_backoff_s": 0.0})
    fault_injector.configure([{"kind": "dispatch_error",
                               "site": "decode.fused", "call": 1}])
    try:
        dec.generate(np.arange(4)[None] % 64, max_new_tokens=4)
    finally:
        fault_injector.clear()
        set_flags({"resilience_backoff_s": 0.5})
    assert obs.metrics.counter("resilience.retries").value == r0 + 1
    ev = [s for s in obs.tracer.spans()
          if s.kind == "event" and s.name == "resilience.retry"]
    assert ev and ev[-1].attrs["site"] == "decode.fused"


# -- the exporter ------------------------------------------------------------

def _get(port, path):
    return urllib.request.urlopen(
        f"http://127.0.0.1:{port}{path}", timeout=5).read()


def test_exporter_endpoints_and_port_release(obs_on, dec):
    eng = ServingEngine(dec, num_slots=2, chunk_size=4)
    for i in range(3):
        eng.submit(np.arange(3 + i) % 64, 4, seed=i)
    eng.drain()
    port = eng.start_exporter(port=0)
    try:
        assert port > 0 and eng.start_exporter(port=0) == port
        txt = _get(port, "/metrics").decode()
        assert "# TYPE obs_tracer_dropped_spans gauge" in txt
        assert "serving_prefill_dispatches 3" in txt
        assert "serving_chunk_dispatches" in txt
        raw = _get(port, "/statusz").decode()
        st = json.loads(raw)
        assert "NaN" not in raw and st["pid"] == os.getpid()
        assert st["obs"]["enabled"] is True
        assert st["backend"]["platform"] == "cpu"
        sv = st["serving"]
        assert sv["num_slots"] == 2 and sv["queue_depth"] == 0
        assert sv["resilience"]["ladder_rung"] == "chunked"
        assert json.loads(_get(port, "/healthz")) == {"ok": True}
        tz = json.loads(_get(port, "/tracez?limit=500"))
        assert {"decode.admit_prefill", "decode.chunk"} <= \
            {s["name"] for s in tz["spans"]}
        assert len(json.loads(_get(port, "/tracez?limit=1"))["spans"]) == 1
        with pytest.raises(urllib.error.HTTPError):
            _get(port, "/nope")
    finally:
        eng.stop_exporter()
    with pytest.raises(OSError):
        _get(port, "/metrics")
    exp = obs.ObsExporter(port=0)
    exp.add_status_provider("boomy", lambda: 1 / 0)
    exp.set_health_provider(lambda: {"ok": False})
    p2 = exp.start()
    try:
        assert "ZeroDivisionError" in json.loads(
            _get(p2, "/statusz"))["boomy"]["error"]
        with pytest.raises(urllib.error.HTTPError) as ei:
            _get(p2, "/healthz")
        assert ei.value.code == 503
    finally:
        exp.stop()


# -- device-time attribution -------------------------------------------------

def test_device_merge_attribution_rules():
    """tests/test_obs_plane.py's pure-merge input, unchanged; then the
    port's weighted form: an op matched by its launch's host window adds
    its own device time."""
    ann = [{"name": "obs#1", "ts": 0.0, "dur": 100.0},
           {"name": "obs#2", "ts": 200.0, "dur": 50.0},
           {"name": "obs#3", "ts": 10.0, "dur": 20.0}]
    ops = [{"name": "dot", "ts": 5.0, "dur": 4.0, "args": {"hlo_op": "dot"}},
           {"name": "mul", "ts": 12.0, "dur": 10.0,
            "args": {"hlo_op": "mul"}},
           {"name": "add", "ts": 210.0, "dur": 30.0,
            "args": {"hlo_op": "add"}},
           {"name": "orphan", "ts": 500.0, "dur": 10.0,
            "args": {"hlo_op": "orphan"}}]
    from paddle_tpu.obs.device import merge_device_events as jax_merge
    out = merge_device_events(ann, ops)
    assert out == jax_merge(ann, ops)
    assert out["attributed_us"] == {1: 4.0, 3: 10.0, 2: 30.0}
    assert out["coverage"] == pytest.approx(44.0 / 54.0)
    # a graph launch at 95-99 inside span 1 whose kernels ran for 500 us
    # after the span closed
    w = merge_device_events(ann, [{"ts": 95.0, "dur": 4.0,
                                   "weight": 500.0}])
    assert w["attributed_us"] == {1: 500.0} and w["coverage"] == 1.0


def test_device_session_requires_obs():
    set_flags({"obs_enabled": False})
    sess = obs.DeviceTraceSession().start()
    assert not sess.active
    assert sess.stop() == {"active": False}


def test_obs_flags_key_no_decoder_graph(dec, monkeypatch):
    """The obs and resilience flags act around a dispatch, so the
    decoder's graph keys (``flags.route_snapshot()``) leave them out: one
    engine's chunks key the same with obs on or off and with another
    retry budget, and a route flag still moves the key."""
    from paddle_tpu_torch.flags import _DEFAULTS, flags
    assert [n for n, _ in flags.route_snapshot()] == [
        n for n in _DEFAULTS if not n.startswith(("obs_", "resilience_"))]
    keys = []

    def graphed(key, st, body, fields, outs):
        keys.append(key)
        return body(st)

    monkeypatch.setattr(dec, "_graphed_chunk", graphed)
    eng = ServingEngine(dec, num_slots=2, chunk_size=2)
    eng.submit(np.arange(1, 6), 20)
    routes = [{"obs_enabled": False}, {"obs_enabled": True},
              {"obs_enabled": False, "resilience_retries": 1},
              {"resilience_retries": 3, "use_decode_attention": False},
              {"use_decode_attention": True}]
    old = {k: flags.get(k) for f in routes for k in f}
    try:
        for f in routes:
            set_flags(f)
            eng.step()
    finally:
        set_flags(old)
    assert len(keys) == len(routes)
    assert keys[0] == keys[1] == keys[2] == keys[4] != keys[3]


# -- SLO instruments ---------------------------------------------------------

def test_ttft_tpot_and_slo_counters(dec):
    eng = ServingEngine(
        dec, num_slots=2, chunk_size=4,
        slo_targets={"strict": {"ttft_s": 0.0, "latency_s": 0.0},
                     "loose": {"ttft_s": 3600.0, "latency_s": 3600.0}})
    rng = np.random.default_rng(3)
    strict = [eng.submit(rng.integers(0, 64, (4,)), 6, seed=i,
                         latency_class="strict") for i in range(2)]
    loose = [eng.submit(rng.integers(0, 64, (4,)), 6, seed=9,
                        latency_class="loose")]
    single = [eng.submit(rng.integers(0, 64, (4,)), 1, seed=7)]
    res = eng.drain()
    r = eng.registry
    assert r.get("serving.ttft_s").count == 4
    assert r.get("serving.tpot_s").count == 3
    for rid in strict + loose:
        rec = res[rid].resilience["serving"]
        assert 0 < rec["ttft_s"] <= rec["latency_s"] and rec["tpot_s"] > 0
    assert r.get("serving.slo.strict.requests").value == 2
    assert r.get("serving.slo.strict.ttft_violations").value == 2
    assert r.get("serving.slo.strict.latency_violations").value == 2
    assert r.get("serving.slo.loose.requests").value == 1
    assert r.get("serving.slo.loose.ttft_violations") is None
    assert res[single[0]].resilience["serving"]["slo"] is None
    assert eng.slo_counters() == {
        "serving.slo.loose.requests": 1,
        "serving.slo.strict.latency_violations": 2,
        "serving.slo.strict.requests": 2,
        "serving.slo.strict.ttft_violations": 2}
    m = eng.metrics()
    assert m["slo_violations"] == 4
    assert m["ttft_p50_s"] > 0 and m["tpot_mean_s"] > 0


# -- the flight recorder -----------------------------------------------------

def test_flight_recorder_on_ladder_exhaustion_and_off(obs_on, dec,
                                                      tmp_path):
    set_flags({"obs_flight_dir": str(tmp_path / "pm"),
               "resilience_retries": 0, "resilience_backoff_s": 0.0})
    fault_injector.configure([{"kind": "dispatch_error",
                               "site": "decode.*", "call": 1,
                               "times": 999}])
    try:
        with pytest.raises(DecodeFailedError):
            dec.generate(np.arange(4)[None] % 64, max_new_tokens=4)
    finally:
        fault_injector.clear()
        set_flags({"obs_flight_dir": "", "resilience_retries": 3,
                   "resilience_backoff_s": 0.5})
    dumps = sorted((tmp_path / "pm").glob("postmortem_*.json"))
    assert dumps
    pm = json.loads(dumps[-1].read_text())
    assert pm["kind"] == "paddle_tpu.postmortem"
    assert pm["reason"] == "decode.ladder_exhausted"
    assert pm["error"]["class"] == "InjectedFault"
    assert pm["extra"]["site"] == "decode.generate"
    assert pm["extra"]["failed_level"] == "per_token"
    assert pm["spans_in_ring"] >= len(pm["spans"])
    kinds = {e.get("kind") for e in pm["resilience_events"]}
    assert {"fault", "degradation"} <= kinds
    assert "resilience.faults_injected" in pm["metrics"]
    assert set(pm) == {"kind", "reason", "error", "pid", "time_unix",
                       "monotonic_ns", "spans", "spans_in_ring",
                       "spans_dropped", "resilience_events", "metrics",
                       "registries", "extra"} | ({"state"} & set(pm))
    set_flags({"obs_enabled": False})
    assert obs.flight_recorder.dump("nope") is None
    p = obs.flight_recorder.dump("forced", path=str(tmp_path / "f.json"))
    assert json.loads(open(p).read())["reason"] == "forced"


# -- on the card -------------------------------------------------------------

@pytest.mark.gpu
def test_device_trace_over_graphed_drain_on_card():
    """A drain of graphed chunks inside a DeviceTraceSession: every
    'decode.chunk' span gets the device time of the kernels its graph
    launch ran, and the coverage is above 0."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    model = LlamaForCausalLM(LlamaConfig(
        vocab_size=512, hidden_size=256, intermediate_size=512,
        num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
        max_position_embeddings=256, dtype="bfloat16"), seed=0)
    d = LlamaDecoder(model, max_len=64)
    rng = np.random.default_rng(0)
    reqs = [(rng.integers(0, 512, (8,)), 16) for _ in range(4)]

    def drain():
        eng = ServingEngine(d, num_slots=4, chunk_size=4)
        for p, n in reqs:
            eng.submit(p, n)
        return eng.drain()

    set_flags({"obs_enabled": True})
    try:
        for _ in range(2):              # eager warm-up, then capture
            drain()
        m0 = obs.tracer.mark()
        sess = obs.DeviceTraceSession().start()
        assert sess.active
        drain()
        torch.cuda.synchronize()
        summary = sess.stop()
        chunks = [s for s in obs.tracer.spans_since(m0)
                  if s.name == "decode.chunk"]
    finally:
        set_flags({"obs_enabled": False})
    assert summary["active"] and summary["coverage"] > 0
    assert chunks and all(s.attrs.get("device_ms", 0) > 0 for s in chunks)
    assert summary["by_site"]["decode.chunk"]["spans"] == len(chunks)
