"""The port's resilience layer (paddle_tpu_torch/runtime/resilience.py, the
decoder's and the serving engine's degradation ladders) against the JAX
package's, on the CPU in f32 at a tiny GQA size.

Every drill configures BOTH packages' fault injectors with the same plan
and runs the same call sequence through each: the fired events, the
exception classes and messages, the retry schedules (under a fake
``sleep``), the tokens, the ``.resilience`` records, the dispatch, step
and degradation counts and the postmortem's ``extra`` must be equal. The
counterparts of tests/test_resilience.py:52-270, tests/test_serving.py:
384-440 and tests/test_serving_router.py:387-435. The JAX imports live
inside the fixtures, so the card's test run (``-m gpu``) imports this
file without JAX.
"""

import json
import types

import numpy as np
import pytest
import torch

from paddle_tpu_torch import obs
from paddle_tpu_torch.convert import from_jax_state_dict
from paddle_tpu_torch.flags import set_flags
from paddle_tpu_torch.inference.generate import LlamaDecoder
from paddle_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM
from paddle_tpu_torch.runtime import resilience as res
from paddle_tpu_torch.serving import ServingEngine

pytestmark = pytest.mark.faults

CFG = dict(vocab_size=64, hidden_size=32, intermediate_size=64,
           num_hidden_layers=2, num_attention_heads=4,
           num_key_value_heads=2, max_position_embeddings=64)
MAX_LEN = 64
FLAG_DEFAULTS = {"resilience_backoff_s": 0.5, "resilience_retries": 3,
                 "resilience_auto_degrade": True, "obs_enabled": False,
                 "obs_flight_dir": ""}


@pytest.fixture(autouse=True)
def _clean():
    """The port's side: no real sleeps, the injector and event log empty,
    every flag a drill moves back at its default afterwards."""
    set_flags({"resilience_backoff_s": 0.0})
    res.fault_injector.clear()
    res.drain_events()
    try:
        yield
    finally:
        res.fault_injector.clear()
        set_flags(FLAG_DEFAULTS)


@pytest.fixture()
def jx():
    """The JAX package's side, cleaned the same way; ``jx.flags(d)`` sets
    a flag in both packages."""
    import paddle_tpu.obs as jobs
    from paddle_tpu.flags import set_flags as jax_set_flags
    from paddle_tpu.runtime import resilience as jres
    from paddle_tpu.serving import ServingEngine as JaxEngine

    def both(d):
        jax_set_flags(d)
        set_flags(d)

    jax_set_flags({"resilience_backoff_s": 0.0})
    jres.fault_injector.clear()
    jres.drain_events()
    try:
        yield types.SimpleNamespace(res=jres, obs=jobs, Engine=JaxEngine,
                                    flags=both)
    finally:
        jres.fault_injector.clear()
        jax_set_flags(FLAG_DEFAULTS)


@pytest.fixture(scope="module")
def decs():
    """One JAX and one port decoder over the same weights, built once."""
    import paddle_tpu as paddle
    from paddle_tpu.inference.generate import LlamaDecoder as JaxDecoder
    from paddle_tpu.models.llama import LlamaConfig as JaxConfig
    from paddle_tpu.models.llama import LlamaForCausalLM as JaxModel

    paddle.seed(0)
    jm = JaxModel(JaxConfig(**CFG))
    state = {k: np.asarray(v.value) for k, v in jm.state_dict().items()}
    tm = from_jax_state_dict(
        state, LlamaForCausalLM(LlamaConfig(**CFG), device="cpu"))
    return (JaxDecoder(jm, max_len=MAX_LEN),
            LlamaDecoder(tm, max_len=MAX_LEN, device="cpu"))


# -- classification, the retry loop and the injector -----------------------

def test_markers_and_classification_match_jax(jx):
    jres = jx.res
    assert res.TRANSIENT_MARKERS == jres.TRANSIENT_MARKERS
    assert res.SETUP_TRANSIENT_MARKERS == jres.SETUP_TRANSIENT_MARKERS
    msgs = ["UNAVAILABLE: backend", "DEADLINE_EXCEEDED: rpc",
            "ABORTED: retry", "INTERNAL: Socket closed by peer",
            "RESOURCE_EXHAUSTED: out of HBM",
            "CUDA out of memory. Tried to allocate 2.00 GiB",
            "CUDA error: an illegal memory access was encountered",
            "bad shape"]
    for m in msgs:
        for phase in ("setup", "steady"):
            assert res.classify_error(RuntimeError(m), phase) == \
                jres.classify_error(RuntimeError(m), phase), (m, phase)


def _retry_case(mod, case):
    """One retry-loop scenario through ``mod.resilient_call``: (outcome,
    sleeps, events as dicts)."""
    sleeps, seen, calls = [], [], {"n": 0}

    def flaky():
        calls["n"] += 1
        if case == "fatal":
            raise ValueError("vocab mismatch")
        if case == "flaky" and calls["n"] >= 3:
            return 41
        raise RuntimeError("UNAVAILABLE: down")

    kw = dict(retries=3, backoff=2.0, site="t.flaky",
              on_event=seen.append, sleep=sleeps.append)
    if case == "deadline":
        kw.update(retries=5, backoff=100.0, deadline_s=0.05)
    try:
        out = mod.resilient_call(flaky, **kw)
    except Exception as e:
        out = (type(e).__name__, str(e))
    return out, sleeps, [e.as_dict() for e in seen], calls["n"]


@pytest.mark.parametrize("case", ["flaky", "fatal", "exhausted",
                                  "deadline"])
def test_resilient_call_matches_jax(jx, case):
    assert _retry_case(res, case) == _retry_case(jx.res, case)


def _inject(mod, calls):
    inj = mod.FaultInjector().configure(
        [{"kind": "dispatch_error", "site": "x.*", "call": 2, "times": 2},
         {"kind": "oom", "site": "decode.*", "above_batch": 8},
         {"kind": "dispatch_error", "site": "decode.chunk", "call": 1,
          "code": "INTERNAL"}])
    out = []
    for site, batch in calls:
        try:
            inj.on_call(site, batch=batch)
            out.append("ok")
        except mod.InjectedFault as e:
            out.append((e.code, str(e)))
    return out, [e.as_dict() for e in inj.fired]


def test_fault_injector_schedules_match_jax(jx):
    calls = [("x.a", None), ("x.a", None), ("x.b", None), ("x.a", None),
             ("unmatched.site", None), ("decode.prefill", 8),
             ("decode.prefill", 9), ("decode.fused", 16),
             ("decode.chunk", None), ("decode.chunk", None)]
    assert _inject(res, calls) == _inject(jx.res, calls)


# -- the decoder's ladder ----------------------------------------------------

_FOREVER = 10000
DECODE_DRILLS = {
    "retry": ([{"kind": "dispatch_error", "site": "decode.fused",
                "call": 1}], {}),
    "fused_to_per_token": ([{"kind": "dispatch_error",
                             "site": "decode.fused", "call": 1,
                             "times": _FOREVER}], {"eos_token_id": 63}),
    "speculative_to_fused": ([{"kind": "dispatch_error",
                               "site": "spec.decode", "call": 1,
                               "times": _FOREVER}],
                             {"draft_model": "skip:1",
                              "num_speculative_tokens": 2}),
    "chunk_retry": ([{"kind": "dispatch_error", "site": "decode.chunk",
                      "call": 2}], {"chunk_size": 3}),
    "spec_chunk_to_fused": ([{"kind": "dispatch_error",
                              "site": "decode.chunk", "call": 1,
                              "times": _FOREVER}],
                            {"chunk_size": 3, "draft_model": "skip:1",
                             "num_speculative_tokens": 2}),
    "all_rungs_dead": ([{"kind": "dispatch_error", "site": "decode.*",
                         "call": 1, "times": _FOREVER}], {}),
    "auto_degrade_off": ([{"kind": "dispatch_error",
                           "site": "decode.fused", "call": 1,
                           "times": _FOREVER}], {}),
    "fatal_unwrapped": ([{"kind": "oom", "site": "decode.generate",
                          "above_batch": 0}], {}),
}


def _decode(dec, mod, plan, kw, prompt):
    """One generate under ``plan``: what came out (tokens and record, or
    the error), the dispatch delta and the fired events."""
    mod.fault_injector.configure(plan)
    d0 = dec.dispatch_count
    try:
        out = dec.generate(prompt, max_new_tokens=6, **kw)
        r = out.resilience
        got = ("ok", np.asarray(out).tolist(), {
            "level": r["level"], "requested_level": r["requested_level"],
            "retries": r["retries"], "degradations": r["degradations"],
            "events": r["events"]})
    except Exception as e:
        got = ("raised", type(e).__name__, str(e),
               [x.as_dict() for x in getattr(e, "events", [])])
    fired = [e.as_dict() for e in mod.fault_injector.fired]
    mod.fault_injector.clear()
    return got, dec.dispatch_count - d0, fired


@pytest.mark.parametrize("drill", list(DECODE_DRILLS))
def test_decode_ladder_matches_jax(jx, decs, drill):
    jdec, dec = decs
    plan, kw = DECODE_DRILLS[drill]
    prompt = np.random.default_rng(1).integers(0, 64, (2, 8))
    if drill == "auto_degrade_off":
        jx.flags({"resilience_auto_degrade": False})
    want = _decode(jdec, jx.res, plan, kw, prompt)
    got = _decode(dec, res, plan, kw, prompt)
    assert got == want
    if drill in ("retry", "fused_to_per_token", "speculative_to_fused",
                 "spec_chunk_to_fused"):
        # every rung gives the undisturbed greedy tokens
        ref = dec.generate(prompt, max_new_tokens=6,
                           eos_token_id=kw.get("eos_token_id"))
        assert got[0][1] == np.asarray(ref).tolist()
    if drill == "speculative_to_fused":
        assert dec.last_spec_stats is None
    if drill == "all_rungs_dead":
        assert got[0][0] == "raised" and got[0][1] == "DecodeFailedError"


# -- the serving ladder ------------------------------------------------------

def _serve(dec, mod, plan, reqs, **kw):
    """Submit ``reqs`` to a fresh engine of ``mod``'s package (``res`` or
    the JAX ``jx``) and drain under ``plan``: tokens, records and counts,
    comparable across packages."""
    if mod is res:
        eng = ServingEngine(dec, **kw)
    else:
        eng, mod = mod.Engine(dec, **kw), mod.res
    d0 = dec.dispatch_count
    ids = [eng.submit(p, n, eos_token_id=e) for p, n, e in reqs]
    mod.fault_injector.configure(plan)
    try:
        out = eng.drain()
    finally:
        fired = [e.as_dict() for e in mod.fault_injector.fired]
        mod.fault_injector.clear()
    m = eng.metrics()
    recs = []
    for i in ids:
        r = out[i].resilience
        recs.append((np.asarray(out[i]).tolist(), r["level"], r["retries"],
                     [(d["from_level"], d["to_level"])
                      for d in r["degradations"]]))
    counts = {k: m[k] for k in ("prefill_dispatches", "chunk_dispatches",
                                "step_dispatches", "degradations")}
    counts["dispatches"] = dec.dispatch_count - d0
    return eng, recs, counts, fired


def _reqs(seed, n=5):
    rng = np.random.default_rng(seed)
    return [(rng.integers(0, 64, (int(rng.integers(2, 8)),)),
             int(rng.integers(3, 9)), None) for _ in range(n)]


@pytest.mark.parametrize("route", ["ring", "host_scatter"])
def test_chunk_rung_matches_jax(jx, decs, route):
    """tests/test_serving.py:384: every 'decode.chunk' dispatch dies from
    call 2 on; the engine serves on the per-token rung on the same carry,
    every request completes with its solo greedy tokens."""
    jdec, dec = decs
    reqs = _reqs(7)
    plan = [{"kind": "dispatch_error", "site": "decode.chunk", "call": 2,
             "times": _FOREVER}]
    kw = dict(num_slots=2, chunk_size=4)
    if route == "host_scatter":
        kw["prefix_cache"] = True
    _, want, wc, wf = _serve(jdec, jx, plan, reqs, **kw)
    eng, got, gc, gf = _serve(dec, res, plan, reqs, **kw)
    assert got == want and gc == wc and gf == wf
    assert gc["degradations"] >= 1
    assert gc["step_dispatches"] == kw["chunk_size"] * gc["degradations"]
    assert gc["dispatches"] == (gc["prefill_dispatches"]
                                + gc["chunk_dispatches"]
                                + gc["step_dispatches"])
    assert eng.status()["resilience"] == {
        "ladder_rung": "per_token", "degradations": gc["degradations"],
        "step_dispatches": gc["step_dispatches"]}
    for (p, n, _), (toks, level, _, degr) in zip(reqs, got):
        solo = dec.generate(p[None], n)
        assert toks == np.asarray(solo).tolist()
    assert got[-1][1] == "per_token" and got[-1][3]


def test_chunk_retry_matches_jax(jx, decs):
    """A transient on the third chunk dispatch, absorbed by one retry:
    the rows that rode it record ``retries == 1``, counts unchanged."""
    jdec, dec = decs
    reqs = _reqs(9, n=6)
    plan = [{"kind": "dispatch_error", "site": "decode.chunk", "call": 3}]
    _, want, wc, wf = _serve(jdec, jx, plan, reqs, num_slots=3,
                             chunk_size=3)
    _, got, gc, gf = _serve(dec, res, plan, reqs, num_slots=3,
                            chunk_size=3)
    _, clean, cc, _ = _serve(dec, res, [], reqs, num_slots=3,
                             chunk_size=3)
    assert got == want and gc == wc and gf == wf
    assert [r[0] for r in got] == [r[0] for r in clean] and gc == cc
    assert sorted({r[2] for r in got}) == [0, 1]


def test_chunked_generate_resilience_across_dispatches(jx, decs):
    """tests/test_serving.py:424: a transient absorbed on chunk 2 of 3
    lands in the one record; a chunk rung that fails for good degrades
    to fused, with no stale speculative counts."""
    jdec, dec = decs
    prompt = np.random.default_rng(8).integers(0, 64, (1, 4))
    for d in (jdec, dec):
        d.generate(prompt, 6, draft_model="skip:1")
        assert d.last_spec_stats is not None
    for times in (1, _FOREVER):
        plan = [{"kind": "dispatch_error", "site": "decode.chunk",
                 "call": 2, "times": times}]
        want = _decode(jdec, jx.res, plan, {"chunk_size": 3}, prompt)
        got = _decode(dec, res, plan, {"chunk_size": 3}, prompt)
        assert got == want
        assert got[0][2]["level"] == ("chunked" if times == 1 else "fused")
        assert dec.last_spec_stats is None


def _exhaust(dec, side, **kw):
    """tests/test_serving_router.py:387: the chunks die transiently, the
    rung survives 2 steps, then dies with INTERNAL: the request those 2
    steps finish is harvested, the other is in the postmortem. ``side``:
    ``res`` (the port) or ``jx``."""
    if side is res:
        mod, o, eng = res, obs, ServingEngine(dec, num_slots=2,
                                              chunk_size=4, **kw)
    else:
        mod, o = side.res, side.obs
        eng = side.Engine(dec, num_slots=2, chunk_size=4, **kw)
    pa, pb = np.arange(4) % 64, (np.arange(5) + 3) % 64
    rid_a = eng.submit(pa, 2)
    rid_b = eng.submit(pb, 12)
    mod.fault_injector.configure([
        {"kind": "dispatch_error", "site": "decode.chunk", "call": 1,
         "times": _FOREVER},
        {"kind": "dispatch_error", "site": "decode.chunk_step", "call": 3,
         "times": _FOREVER, "code": "INTERNAL"}])
    try:
        with pytest.raises(mod.DecodeFailedError, match="per-token rung"):
            eng.drain()
    finally:
        mod.fault_injector.clear()
    pm = json.load(open(o.flight_recorder.last_path))
    assert pm["kind"] == "paddle_tpu.postmortem"
    assert pm["reason"] == "serving.ladder_exhausted"
    got = eng.result(rid_a)
    return (eng, np.asarray(got).tolist(), eng.result(rid_b), pm["extra"],
            got.resilience["level"])


def test_ladder_exhaustion_harvest_and_postmortem_match_jax(jx, decs,
                                                            tmp_path):
    jdec, dec = decs
    jx.flags({"obs_enabled": True, "obs_flight_dir": str(tmp_path)})
    want = _exhaust(jdec, jx)[1:]
    got = _exhaust(dec, res)[1:]
    assert got == want
    solo = dec.generate((np.arange(4) % 64)[None], 2)
    assert got[0] == np.asarray(solo).tolist()
    assert got[1] is None
    assert got[2]["site"] == "serve.chunk" and got[2]["replica"] is None
    assert [e["tokens_generated"] for e in got[2]["lost_requests"]] == [2]


def test_prefix_cache_exhaustion_leaves_no_pinned_slab(jx, decs,
                                                       tmp_path):
    """Full prefix hits pin their slabs; a ladder that exhausts after the
    rung's completed steps finished every row harvests them all and
    unpins every slab (the JAX engine does the same)."""
    jdec, dec = decs
    jx.flags({"obs_enabled": True, "obs_flight_dir": str(tmp_path)})
    reqs = [((np.arange(6) + 5 * j) % 64, 2, None) for j in range(2)]
    plan = [{"kind": "dispatch_error", "site": "decode.chunk", "call": 1,
             "times": _FOREVER},
            {"kind": "dispatch_error", "site": "decode.chunk_step",
             "call": 3, "times": _FOREVER, "code": "INTERNAL"}]
    outs = []
    for d, cls, mod in ((jdec, jx.Engine, jx.res),
                        (dec, ServingEngine, res)):
        eng = cls(d, num_slots=2, chunk_size=4, prefix_cache=True)
        for p, n, _ in reqs:                  # populate the cache
            eng.submit(p, n)
        eng.drain()
        ids = [eng.submit(p, n) for p, n, _ in reqs]
        mod.fault_injector.configure(plan)
        try:
            with pytest.raises(mod.DecodeFailedError):
                eng.drain()
        finally:
            mod.fault_injector.clear()
        outs.append(([np.asarray(eng.result(i)).tolist() for i in ids],
                     [eng.result(i).resilience["serving"]["prefix_hit"]
                      for i in ids],
                     eng.prefix_cache.stats()["pinned"]))
    assert outs[1] == outs[0]
    assert outs[1][1] == ["full", "full"] and outs[1][2] == 0


def test_speculative_demotion_matches_jax(jx, decs):
    """A speculative engine whose chunk site fails past its retries from
    its second call demotes once (one 'decode.spec_demote' dispatch) and
    serves the same carry on the plain ring chunk: tokens and counts
    equal the JAX engine's, and equal the plain engine's tokens."""
    jdec, dec = decs
    reqs = _reqs(11, n=5)
    plan = [{"kind": "dispatch_error", "site": "decode.chunk", "call": 2,
             "times": 4}]
    kw = dict(num_slots=2, chunk_size=3, draft_model="skip:1",
              num_speculative_tokens=2)
    jx.flags({"obs_enabled": True})
    m0 = obs.tracer.mark()
    jeng, want, wc, wf = _serve(jdec, jx, plan, reqs, **kw)
    eng, got, gc, gf = _serve(dec, res, plan, reqs, **kw)
    assert got == want and gc == wc and gf == wf
    assert obs.tracer.counts(m0).get("decode.spec_demote") == 1
    assert eng.status()["speculative"]["active"] is False
    assert eng.metrics()["speculative"] == jeng.metrics()["speculative"]
    _, plain, _, _ = _serve(dec, res, [], reqs, num_slots=2,
                            chunk_size=3)
    assert [r[0] for r in got] == [r[0] for r in plain]


# -- on the card -------------------------------------------------------------

@pytest.mark.gpu
def test_rung_and_demotion_on_graphed_chunks_on_card():
    """On the card, with captured chunk and prefill graphs: the per-token
    rung (one-step chunk graphs of their own) and a speculative demotion
    (then the plain ring chunk over the same carry) give the tokens of an
    undisturbed engine. f32 weights, so the verify's and the decode
    step's roundings cannot flip a greedy pick."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    model = LlamaForCausalLM(LlamaConfig(
        vocab_size=512, hidden_size=256, intermediate_size=512,
        num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
        max_position_embeddings=256), seed=0)
    dec = LlamaDecoder(model, max_len=96)
    rng = np.random.default_rng(0)
    reqs = [(rng.integers(0, 512, (int(rng.integers(4, 12)),)),
             int(rng.integers(12, 24))) for _ in range(8)]

    def serve(plan, **kw):
        eng = ServingEngine(dec, num_slots=4, chunk_size=4, **kw)
        ids = [eng.submit(p, b) for p, b in reqs]
        res.fault_injector.configure(plan)
        try:
            out = eng.drain()
        finally:
            res.fault_injector.clear()
        return eng, [np.asarray(out[i]).tolist() for i in ids]

    for _ in range(3):              # eager warm-up, capture, replay
        _, want = serve([])
    plan = [{"kind": "dispatch_error", "site": "decode.chunk", "call": 3,
             "times": _FOREVER}]
    for _ in range(2):              # the rung's key: warm-up, then graphs
        eng, got = serve(plan)
        assert got == want
        assert eng.step_dispatches == 4 * eng.metrics()["degradations"] > 0
    spec = dict(draft_model="skip:1", num_speculative_tokens=2)
    for _ in range(3):
        eng, got = serve([{"kind": "dispatch_error", "site": "decode.chunk",
                           "call": 2, "times": 4}], **spec)
        assert eng.status()["speculative"]["active"] is False
        assert got == want
