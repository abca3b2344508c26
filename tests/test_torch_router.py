"""The port's replicated serving (paddle_tpu_torch/serving/router.py, the
engine's ``replica_tag`` / ``request_keyed_rng`` / ``on_tokens``) against
the JAX package's, on the CPU in f32 at the JAX router tests' tiny size.

Every drill configures BOTH packages' fault injectors with the same plan
and drives the same calls through the JAX ``Router`` and the port's: the
tokens, the outcome types, the router's counts and replica states, the
``router`` audit records and the typed errors must be equal. The
counterparts of tests/test_serving_router.py:273-703, plus
``derive_row_key`` bit for bit against the JAX function and the
streaming callback's cadence. The JAX imports live inside the fixtures,
so the card's run (``-m gpu``) imports this file without JAX.
"""

import types

import numpy as np
import pytest
import torch

from paddle_tpu_torch.convert import from_jax_state_dict
from paddle_tpu_torch.flags import set_flags
from paddle_tpu_torch.inference.generate import LlamaDecoder
from paddle_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM
from paddle_tpu_torch.runtime import resilience as res
from paddle_tpu_torch.serving import ReplicaSet, Router, ServingEngine
from paddle_tpu_torch.serving.engine import derive_row_key

pytestmark = pytest.mark.serving

CFG = dict(vocab_size=64, hidden_size=32, intermediate_size=64,
           num_hidden_layers=2, num_attention_heads=4,
           num_key_value_heads=4, max_position_embeddings=64)
MAX_LEN = 64
KILL1 = [{"kind": "dispatch_error", "site": "serving.replica1.chunk",
          "call": 2, "times": 10**6, "code": "INTERNAL"},
         {"kind": "dispatch_error", "site": "serving.replica1.step",
          "call": 1, "times": 10**6, "code": "INTERNAL"}]


@pytest.fixture(scope="module")
def sides():
    """Three JAX and three port decoders over the same weights (a pool
    serves one model), each package's Router, ReplicaSet, engine,
    injector and typed errors, and ``both(plan)`` to configure both
    injectors."""
    import paddle_tpu as paddle
    from paddle_tpu.inference.generate import LlamaDecoder as JaxDecoder
    from paddle_tpu.models.llama import LlamaConfig as JaxConfig
    from paddle_tpu.models.llama import LlamaForCausalLM as JaxModel
    from paddle_tpu.runtime import resilience as jres
    from paddle_tpu.serving import ReplicaSet as JaxSet
    from paddle_tpu.serving import Router as JaxRouter
    from paddle_tpu.serving import ServingEngine as JaxEngine

    paddle.seed(0)
    jm = JaxModel(JaxConfig(**CFG))
    state = {k: np.asarray(v.value) for k, v in jm.state_dict().items()}
    tm = from_jax_state_dict(
        state, LlamaForCausalLM(LlamaConfig(**CFG), device="cpu"))
    jx = types.SimpleNamespace(
        decs=[JaxDecoder(jm, max_len=MAX_LEN) for _ in range(3)],
        Router=JaxRouter, Set=JaxSet, Engine=JaxEngine, res=jres)
    pt = types.SimpleNamespace(
        decs=[LlamaDecoder(tm, max_len=MAX_LEN, device="cpu")
              for _ in range(3)],
        Router=Router, Set=ReplicaSet, Engine=ServingEngine, res=res)
    return jx, pt


@pytest.fixture(autouse=True)
def _clean():
    """No real backoff sleeps and empty injectors, in both packages where
    the JAX package is installed (the card's run has no JAX)."""
    injectors, setters = [res.fault_injector], [set_flags]
    try:
        from paddle_tpu.flags import set_flags as jax_set_flags
        from paddle_tpu.runtime import resilience as jres
        injectors.append(jres.fault_injector)
        setters.append(jax_set_flags)
    except ImportError:
        pass
    for f in setters:
        f({"resilience_backoff_s": 0.0})
    try:
        yield
    finally:
        for inj in injectors:
            inj.clear()
        for f in setters:
            f({"resilience_backoff_s": 0.5})


def _workload(n, seed, budgets=(6, 14)):
    rng = np.random.default_rng(seed)
    return [(rng.integers(0, 64, (int(rng.integers(2, 10)),)),
             int(rng.integers(*budgets))) for _ in range(n)]


def _router(side, n, **kw):
    rkw = {k: kw.pop(k) for k in ("breaker_threshold",
                                  "heartbeat_miss_threshold") if k in kw}
    return side.Router(side.Set.from_backends(
        side.decs[:n], num_slots=kw.pop("num_slots", 2),
        chunk_size=kw.pop("chunk_size", 4), **kw), **rkw)


def _outcome(out):
    """A comparable form of one outcome: tokens and the router record, or
    the typed error's class."""
    if isinstance(out, BaseException):
        return ("error", type(out).__name__)
    rec = getattr(out, "resilience", None) or {}
    return ("tokens", np.asarray(out).tolist(), rec.get("router"))


def _both(sides, drill):
    """Run ``drill(side, inj)`` on each package; return both results."""
    jx, pt = sides
    return drill(jx, jx.res.fault_injector), drill(pt, pt.res.fault_injector)


def test_derive_row_key_bit_equal_to_jax():
    """``derive_row_key`` over a grid of (seed, request id, tokens
    emitted) equals the JAX function's key word for word."""
    from paddle_tpu.serving.engine import derive_row_key as jax_key
    for seed in (0, 5, 2**31 + 7):
        for rid in (0, 42, 2**32 - 1):
            for emitted in (0, 1, 7):
                want = np.asarray(jax_key(seed, rid, emitted), np.uint32)
                got = derive_row_key(seed, rid, emitted, device="cpu")
                np.testing.assert_array_equal(
                    got.numpy().view(np.uint32), want,
                    err_msg=f"seed {seed} id {rid} emitted {emitted}")


def test_router_replica_kill_requeue_matches_jax(sides):
    """One replica's chunks die fatally mid-serve: its breaker opens after
    two strikes and its work requeues; every request's tokens and router
    record, and the router's counts, equal the JAX router's."""
    reqs = _workload(8, 21)

    def drill(side, inj):
        router = _router(side, 3, breaker_threshold=2)
        inj.configure(KILL1)
        rids = [router.submit(p, b) for p, b in reqs]
        outs = router.drain()
        return [_outcome(outs[r]) for r in rids], router.metrics()

    (jo, jm), (po, pm) = _both(sides, drill)
    assert po == jo and pm == jm
    assert pm["states"]["replica1"] == "dead" and pm["requeued"] >= 1
    assert any(o[2]["requeues"] for o in po if o[0] == "tokens")


def test_router_breaker_trip_fence_unfence_matches_jax(sides):
    """Breaker lifecycle: K fatals fence replica0, new submits route to
    the survivor, an all-excluded submit is the typed refusal; each step
    as the JAX router. Then unfence serves again with the tokens of the
    JAX decoder's own ``generate``. The JAX router is not driven past the
    unfence: its fenced engine keeps the dead chunk's staged ring rows,
    so no admission lands and its drain never ends (ROADMAP.md section 3,
    entry 31); the port's fence drops them."""
    reqs = _workload(4, 22)
    kill0 = [dict(r, site=r["site"].replace("replica1", "replica0"),
                  call=1) for r in KILL1]

    def drill(side, inj):
        router = _router(side, 2, breaker_threshold=2)
        inj.configure(kill0)
        rids = [router.submit(p, b) for p, b in reqs]
        outs = router.drain()
        log = [[_outcome(outs[r]) for r in rids], router.metrics()]
        rid = router.submit(*reqs[0])
        log.append(router._tracked[rid].replica)
        router.drain()
        try:
            router.submit(*reqs[0], excluded_replicas=[1])
        except Exception as e:
            log.append((type(e).__name__, "no routable" in str(e)))
        inj.clear()
        return log, router

    jx, pt = sides
    jlog, _ = drill(jx, jx.res.fault_injector)
    plog, router = drill(pt, pt.res.fault_injector)
    assert plog == jlog
    assert plog[3] == ("ReplicaDeadError", True)
    router.unfence(0)
    assert router.metrics()["states"]["replica0"] == "healthy"
    rid = router.submit(*reqs[1], excluded_replicas=[1])
    assert router._tracked[rid].replica == 0
    want = np.asarray(jx.decs[0].generate(reqs[1][0][None], reqs[1][1]))
    np.testing.assert_array_equal(np.asarray(router.drain(
        max_steps=50)[rid]), want)
    with pytest.raises(ValueError, match="not fenced"):
        router.unfence(0)


def test_router_requeue_deadline_and_all_dead_match_jax(sides):
    """A request whose deadline lapsed before requeue resolves to the
    typed ``DeadlineExceededError``; a request that runs out of replicas
    to the typed ``ReplicaDeadError``; counts as the JAX router's."""
    p = np.arange(6) % 64
    kill0 = [dict(r, site=r["site"].replace("replica1", "replica0"),
                  call=1) for r in KILL1]
    kill_all = [dict(r, site=r["site"].replace("replica1", "replica*"),
                     call=1) for r in KILL1]

    def drill(side, inj):
        router = _router(side, 2, num_slots=1, breaker_threshold=1)
        inj.configure(kill0)
        rid = router.submit(p, 12, deadline_s=3600.0,
                            excluded_replicas=[1])
        router._tracked[rid].deadline_at = 0.0      # force expiry
        log = [_outcome(router.drain()[rid]),
               _outcome(router.outcome(rid)), router.metrics()]
        router = _router(side, 2, num_slots=1, breaker_threshold=1)
        inj.configure(kill_all)
        rid = router.submit(p[:4], 8)
        log += [_outcome(router.drain()[rid]), router.metrics()]
        try:
            router.submit(p[:4], 8)
        except Exception as e:
            log.append(type(e).__name__)
        return log

    jlog, plog = _both(sides, drill)
    assert plog == jlog
    assert plog[0] == ("error", "DeadlineExceededError")
    assert plog[3] == ("error", "ReplicaDeadError")
    assert plog[-1] == "ReplicaDeadError"


def test_router_hung_replica_suspect_and_recovery_match_jax(sides):
    """Delayed heartbeats (``delay_heartbeat`` through the injector's
    ``heartbeat_action``) mark replica1 suspect, new submits route around
    it, and clean beats recover it; the state trace, routing and tokens
    equal the JAX router's."""
    reqs = _workload(6, 23)

    def drill(side, inj):
        router = _router(side, 2, heartbeat_miss_threshold=2)
        inj.configure([{"kind": "delay_heartbeat", "node": "replica1",
                        "after_beats": 1, "skip_beats": 4}])
        rids = [router.submit(p, b) for p, b in reqs]
        outs, trace = {}, []
        while any(r.has_work() for r in router.replicas.live()):
            for rid, r in router.step():
                outs[rid] = r
            state = router.replicas.replicas[1].state
            trace.append(state)
            if state == "suspect":
                extra = router.submit(np.arange(3), 4)
                trace.append(router._tracked[extra].replica)
        for _ in range(8):
            router.step()
        trace.append(router.replicas.replicas[1].state)
        fired = [(e.site, e.fault) for e in inj.fired]
        return ([_outcome(outs[r]) for r in rids], trace, fired,
                router.metrics())

    jlog, plog = _both(sides, drill)
    assert plog == jlog
    assert "suspect" in plog[1] and plog[1][-1] == "healthy"
    assert plog[2] == [("replica1", "delay_heartbeat")]


def test_router_full_drill_zero_loss_matches_jax(sides):
    """The acceptance drill: three replicas, replica1 killed mid-chunk,
    replica2's heartbeat delayed, a doomed submit and one that expires in
    flight: every outcome and count as the JAX router's, none lost."""
    reqs = _workload(9, 24)
    plan = KILL1 + [{"kind": "delay_heartbeat", "node": "replica2",
                     "after_beats": 2, "skip_beats": 3}]

    def drill(side, inj):
        router = _router(side, 3, breaker_threshold=2)
        inj.configure(plan)
        rids = [router.submit(p, b) for p, b in reqs]
        try:
            router.submit(reqs[0][0], 4, deadline_s=0.0)
        except Exception as e:
            shed = type(e).__name__
        doomed = router.submit(reqs[0][0], reqs[0][1], deadline_s=1e-9)
        outs = router.drain()
        return ([_outcome(outs[r]) for r in rids], shed,
                _outcome(outs[doomed]), router.metrics())

    jlog, plog = _both(sides, drill)
    assert plog == jlog
    assert plog[1] == "DeadlineExceededError"
    assert len(plog[0]) == len(reqs)
    assert plog[3]["states"]["replica1"] == "dead"


def test_router_cache_affinity_matches_jax(sides):
    """A prompt whose prefix digest is cached in replica1 routes there
    over an idle or less-loaded replica0; an uncached prompt goes to the
    least loaded; placements and tokens as the JAX router's."""
    p = np.arange(8) % 64

    def drill(side, inj):
        router = _router(side, 2, prefix_cache=True)
        rids = [router.submit(p, 4, excluded_replicas=[0])]
        router.drain()
        rids.append(router.submit(p, 4))
        rids.append(router.submit(np.arange(5) + 1, 10,
                                  excluded_replicas=[0]))
        rids.append(router.submit(p, 4))
        rids.append(router.submit(np.arange(7) + 9, 4))
        placed = [router._tracked[r].replica for r in rids]
        outs = router.drain()
        return placed, [_outcome(router.outcome(r)) for r in rids[:1]] + \
            [_outcome(outs[r]) for r in rids[1:]]

    jlog, plog = _both(sides, drill)
    assert plog == jlog
    assert plog[0] == [1, 1, 1, 1, 0]


def test_router_exporter_blocks_and_status_match_jax(sides):
    """One attach per replica: ``/metrics`` carries each replica's
    registry labelled ``{replica=...}`` plus the router's, ``/statusz`` a
    block per replica and the router's health table; ``status()`` and
    the flight recorder's ``snapshot`` share a shape. The port's names,
    label sets and status keys equal the JAX router's."""

    def drill(side, inj):
        router = _router(side, 2)
        rid = router.submit(np.arange(4) % 64, 4)
        router.drain()
        port = router.start_exporter(port=0)
        try:
            exp = router._exporter
            text = exp.metrics_text()
            st = exp.statusz()
        finally:
            router.stop_exporter()
        names = sorted({ln.split("{")[0].split(" ")[0]
                        for ln in text.splitlines()
                        if ln.startswith("serving_")
                        and 'replica="replica' in ln})
        status = router.status()
        return dict(
            port_bound=port > 0, names=names,
            labelled=[f'replica="replica{i}"' in text for i in (0, 1)],
            submitted_line="serving_router_submitted 1" in text,
            prefill_blocks=text.count("serving_prefill_dispatches{"),
            tags=[st[f"replica{i}"]["replica_tag"] for i in (0, 1)],
            health=[(h["name"], h["state"])
                    for h in st["router"]["replicas"]],
            requests=st["router"]["requests"],
            status_keys=sorted(status),
            replica_keys=sorted(status["replicas"][0]),
            snap_keys=sorted(router.snapshot()),
            outcome=_outcome(router.outcome(rid)))

    jlog, plog = _both(sides, drill)
    assert plog == jlog
    assert plog["prefill_blocks"] == 2 and all(plog["labelled"])


def test_request_keyed_rng_sampled_requeue_matches_jax(sides):
    """Sampled requeue under ``request_keyed_rng``: an undisturbed row, a
    row interrupted after one chunk and replayed on another engine as
    ``prompt + emitted`` with ``rng_tokens_emitted``, and the negative
    control without the offset; all three as the JAX engine's, and the
    replay equal to the undisturbed row."""
    ekw = dict(num_slots=2, chunk_size=4, do_sample=True, top_k=8,
               request_keyed_rng=True)
    rng = np.random.default_rng(13)
    prompt = rng.integers(0, 64, (6,))
    budget, rid_key, seed, temp = 10, 42, 5, 0.8

    def drill(side, inj):
        dec = side.decs[0]
        sk = dict(temperature=temp, seed=seed, rng_request_id=rid_key)
        a = side.Engine(dec, **ekw)
        ra = a.submit(prompt, budget, **sk)
        ref = np.asarray(a.drain()[ra])
        b = side.Engine(dec, **ekw)
        rb = b.submit(prompt, budget, **sk)
        b.step()
        emitted = {int(r.id): np.asarray(t)
                   for r, t, _ in b.export_inflight()}[rb]
        grown = np.concatenate([prompt, emitted.astype(prompt.dtype)])
        outs = []
        for off in (int(emitted.size), 0):
            c = side.Engine(dec, **ekw)
            rc = c.submit(grown, budget - emitted.size,
                          rng_tokens_emitted=off, **sk)
            outs.append(np.asarray(c.drain()[rc]).tolist())
        return ref.tolist(), emitted.tolist(), outs

    (jref, jem, jouts), (pref, pem, pouts) = _both(sides, drill)
    assert (pref, pem, pouts) == (jref, jem, jouts)
    assert pouts[0] == pref and pouts[1] != pref


def test_streaming_on_tokens_and_replica_tag_match_jax(sides):
    """``submit(on_tokens=)`` fires at every chunk harvest with the
    tokens gained and once more with ``final=True``; the flushes
    concatenate to the result. ``replica_tag`` names the engine in its
    status and arms ``serving.<tag>.chunk``. Flush for flush as the JAX
    engine."""
    reqs = _workload(3, 31, budgets=(5, 12))

    def drill(side, inj):
        eng = side.Engine(side.decs[0], num_slots=2, chunk_size=4,
                          replica_tag="r7")
        flushes = {}
        rids = [eng.submit(p, b, eos_token_id=3,
                           on_tokens=lambda rid, t, fin: flushes
                           .setdefault(rid, []).append(
                               (np.asarray(t).tolist(), bool(fin))))
                for p, b in reqs]
        outs = eng.drain()
        inj.configure([{"kind": "dispatch_error",
                        "site": "serving.r7.chunk", "code": "INTERNAL"}])
        eng.submit(reqs[0][0], 4)
        try:
            eng.step()
        except Exception as e:
            fault = (type(e).__name__, [x.site for x in inj.fired])
        m = eng.metrics()
        return ([flushes[r] for r in rids],
                [np.asarray(outs[r]).reshape(-1).tolist() for r in rids],
                eng.status()["replica_tag"], fault,
                sorted(m["stream_ttft_p50_s"]))

    jlog, plog = _both(sides, drill)
    assert plog == jlog
    for (p, _), fl, out in zip(reqs, plog[0], plog[1]):
        assert fl[-1][1] and not any(f for _, f in fl[:-1])
        assert sum((t for t, _ in fl), []) == out[len(p):]
    assert plog[2] == "r7" and plog[3][1] == ["serving.r7.chunk"]


@pytest.mark.gpu
def test_metrics_scrape_during_first_capture_on_card():
    """A replica's first chunks capture CUDA graphs while another thread
    scrapes ``/metrics`` and ``/statusz`` in a loop: the captures (in
    thread-local mode) and the scrapes both succeed, and the replica's
    tokens equal an undisturbed engine's."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    import threading
    import urllib.request
    cfg = LlamaConfig(**dict(CFG, dtype="bfloat16"))
    model = LlamaForCausalLM(cfg, seed=3)
    reqs = _workload(6, 41)

    def run(scrape):
        router = Router(ReplicaSet.from_backends(
            [LlamaDecoder(model, max_len=MAX_LEN)], num_slots=4,
            chunk_size=4))
        port = router.start_exporter(port=0)
        stop, errs, n = threading.Event(), [], [0]

        def loop():
            while not stop.is_set():
                for path in ("/metrics", "/statusz"):
                    try:
                        urllib.request.urlopen(
                            f"http://127.0.0.1:{port}{path}",
                            timeout=10).read()
                        n[0] += 1
                    except Exception as e:   # noqa: BLE001
                        errs.append(repr(e))
        t = threading.Thread(target=loop, daemon=True)
        if scrape:
            t.start()
        try:
            rids = [router.submit(p, b) for p, b in reqs]
            outs = router.drain()
        finally:
            stop.set()
            if scrape:
                t.join(timeout=30)
            router.stop_exporter()
        return [np.asarray(outs[r]).tolist() for r in rids], errs, n[0]

    want, _, _ = run(False)
    got, errs, scrapes = run(True)
    assert not errs and scrapes > 0
    assert got == want
