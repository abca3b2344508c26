"""Snapshot/restore, live row migration and deadlines of the port's
ServingEngine (paddle_tpu_torch/serving/engine.py) against the JAX
package's, on the CPU in f32 at the tiny size of tests/test_serving_router.py
(MHA), plus a GQA case, whose head-major cache layout differs.

Each scenario is one script run on the JAX engine and on the port's over
the same weights (through ``convert.py``): tokens are equal bit for bit,
the typed errors have the same classes and messages, and the counters
agree. Contracts are tests/test_serving_router.py's (restore round trip in
fp32 and int8wk, refusals, row remap, torn write, graceful drain, cadence,
the shed at submit, the backpressure shed, the shed in the queue, the
in-flight partial return) and tests/test_fleet_ops.py's (greedy and
sampled migration, the queued move, unknown ids, corrupt payloads, the
quant mismatch, capacity). A snapshot or migration payload written by one
package is read by the other and continues with the same tokens. No test
waits on the wall clock: a deadline lapses on a clock patched into each
engine module. The JAX imports live inside the fixtures and tests, so the
card's run (``pytest --noconftest -m gpu``, no JAX) collects this file;
its ``gpu`` test decides inside its body whether a card is present.
"""

import json
import os
import re
import shutil

import numpy as np
import pytest
import torch

from paddle_tpu_torch.convert import from_jax_state_dict
from paddle_tpu_torch.inference.generate import LlamaDecoder
from paddle_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM
from paddle_tpu_torch.runtime.resilience import (CorruptCheckpointError,
                                                 DeadlineExceededError,
                                                 InjectedFault,
                                                 SlabTransferError,
                                                 fault_injector)
from paddle_tpu_torch.serving import ServingEngine
from paddle_tpu_torch.serving import engine as port_engine

CFG = dict(vocab_size=64, hidden_size=32, intermediate_size=64,
           num_hidden_layers=2, num_attention_heads=4,
           num_key_value_heads=4, max_position_embeddings=64)
GQA = dict(CFG, num_key_value_heads=2)


def _jax_model(cfg, seed=0):
    """A JAX model with numpy-drawn weights (normal(0, 0.02) matrices,
    unit norms); its initializers are bypassed while it is built, as in
    tests/test_torch_prefix_cache.py (each compiles a sampler a shape)."""
    import jax.numpy as jnp

    from paddle_tpu.models.llama import LlamaConfig as JaxConfig
    from paddle_tpu.models.llama import LlamaForCausalLM as JaxModel
    from paddle_tpu.nn import initializer as init

    zeros = lambda self, shape, dtype="float32": jnp.zeros(  # noqa: E731
        shape, jnp.float32)
    with pytest.MonkeyPatch.context() as mp:
        for cls in (init.XavierUniform, init.Normal, init.Constant):
            mp.setattr(cls, "__call__", zeros)
        jm = JaxModel(JaxConfig(**cfg))
    rng = np.random.default_rng(seed)
    for p in jm.state_dict().values():
        shape = tuple(p.shape)
        p._set_value(jnp.asarray(
            np.ones(shape, np.float32) if len(shape) == 1
            else rng.normal(0, 0.02, shape).astype(np.float32)))
    return jm


@pytest.fixture(scope="module")
def sides():
    """``sides(cfg, quant)`` -> (make_jax, make_port): engine factories
    over one JAX decoder and one port decoder of the same weights, built
    once per (cfg, quant) for the module (each JAX decoder compiles its
    programs once)."""
    from paddle_tpu.inference.generate import LlamaDecoder as JaxDecoder
    from paddle_tpu.serving import ServingEngine as JaxEngine
    models, decs = {}, {}

    def get(cfg="mha", quant=None):
        if cfg not in models:
            c = CFG if cfg == "mha" else GQA
            jm = _jax_model(c)
            state = {k: np.asarray(v.value)
                     for k, v in jm.state_dict().items()}
            models[cfg] = (jm, from_jax_state_dict(
                state, LlamaForCausalLM(LlamaConfig(**c), device="cpu")))
        if (cfg, quant) not in decs:
            jm, tm = models[cfg]
            decs[cfg, quant] = (
                JaxDecoder(jm, max_len=64, quant=quant),
                LlamaDecoder(tm, max_len=64, quant=quant, device="cpu"))
        jd, pd = decs[cfg, quant]
        return (lambda **kw: JaxEngine(jd, **kw),
                lambda **kw: ServingEngine(pd, **kw))
    return get


class _Clock:
    """A monotonic clock patched in as an engine module's ``time``: it
    starts at 1000 s and advances ``tick`` s a reading (0 = frozen);
    tests move it with ``advance``."""

    def __init__(self, tick=0.0):
        self.t, self.tick = 1000.0, tick
        self.time = __import__("time").time

    def monotonic(self):
        self.t += self.tick
        return self.t

    def advance(self, s):
        self.t += s


@pytest.fixture
def clocks(monkeypatch):
    """``clocks(tick)`` -> (jax clock, port clock), patched into the two
    engine modules for the test."""
    import paddle_tpu.serving.engine as jax_engine

    def make(tick=0.0):
        cj, cp = _Clock(tick), _Clock(tick)
        monkeypatch.setattr(jax_engine, "time", cj)
        monkeypatch.setattr(port_engine, "time", cp)
        return cj, cp
    return make


def _workload(n, seed, budgets):
    """tests/test_serving_router.py's ``_workload`` prompts and budgets."""
    rng = np.random.default_rng(seed)
    return [(rng.integers(0, 64, (int(rng.integers(2, 10)),)),
             int(rng.integers(*budgets))) for _ in range(n)]


def _err(fn):
    """``(class name, message with paths, digests and times masked)`` of
    what ``fn()`` raises, or None."""
    try:
        fn()
    except Exception as e:                      # noqa: BLE001
        msg = re.sub(r"/\S+", "<path>", str(e))
        msg = re.sub(r"[0-9a-f]{16}…", "<sha>…", msg)
        return type(e).__name__, re.sub(r"\d+\.\d+", "<f>", msg)
    return None


def _arr(res):
    return (type(res).__name__ if isinstance(res, BaseException)
            else np.asarray(res))


def _same(a, b):
    """Two runs' outputs, each a dict or list of results / typed error
    class names, are equal."""
    if isinstance(a, dict):
        assert list(a) == list(b)
        a, b = list(a.values()), list(b.values())
    assert len(a) == len(b)
    for j, (x, y) in enumerate(zip(a, b)):
        if isinstance(x, np.ndarray):
            np.testing.assert_array_equal(x, y, err_msg=f"output {j}")
        else:
            assert x == y, (j, x, y)


def _both(sides, script, *args, cfg="mha", quant=None):
    """Run ``script(make_engine, *args)`` on the JAX engine and the
    port's; the outputs must be equal. Returns the port's."""
    make_j, make_p = sides(cfg, quant)
    want, got = script(make_j, *args), script(make_p, *args)
    _same(want, got)
    return got


# -- snapshot / restore ----------------------------------------------------

def _roundtrip(make, sdir):
    """Five requests over 2 slots, two steps, a snapshot, a restore on a
    fresh engine of the same shape, the drain."""
    reqs = _workload(5, 11, (10, 16))
    eng = make(num_slots=2, chunk_size=4)
    ids = [eng.submit(p, b) for p, b in reqs]
    got = {}
    for _ in range(2):
        got.update(eng.step())
    eng.snapshot(sdir)
    assert eng.metrics()["snapshots"] == 1
    assert eng.status()["snapshot"]["count"] == 1
    assert eng.status()["snapshot"]["age_s"] >= 0.0
    fresh = make(num_slots=2, chunk_size=4)
    info = fresh.restore(sdir)
    assert info["in_flight"] >= 1
    assert info["in_flight"] + info["queued"] + len(got) == len(reqs)
    got.update(fresh.drain())
    return [info] + [_arr(got[r]) for r in ids]


@pytest.mark.parametrize("cfg,quant", [("mha", None), ("gqa", "int8wk")])
def test_snapshot_restore_matches_jax(sides, tmp_path, cfg, quant):
    """The crash-recovery round trip: a mid-flight snapshot restored on a
    fresh engine finishes every request with the JAX engine's tokens
    (in-flight rows and queued requests), and the snapshot's npz holds the
    JAX engine's arrays, names, shapes and dtypes in its order, under a
    manifest with the same keys and leaf tags."""
    make_j, make_p = sides(cfg, quant)
    _same(_roundtrip(make_j, str(tmp_path / "j")),
          _roundtrip(make_p, str(tmp_path / "p")))
    (mj, zj), (mp_, zp) = [
        (json.load(open(tmp_path / d / "manifest.json")),
         np.load(tmp_path / d / "state.npz", allow_pickle=False))
        for d in ("j", "p")]
    assert set(mj) == set(mp_) and set(mj["meta"]) == set(mp_["meta"])
    for k in ("kind", "version", "num_slots", "chunk_size", "quant",
              "mesh_axes", "steps_done", "next_id", "leaves"):
        assert mj["meta"][k] == mp_["meta"][k], k
    assert [s["request"] for s in mj["meta"]["slots"]] == \
        [s["request"] for s in mp_["meta"]["slots"]]
    assert zj.files == zp.files
    for name in zj.files:
        assert (zj[name].shape, zj[name].dtype) == \
            (zp[name].shape, zp[name].dtype), name


def test_snapshot_typed_refusals_match_jax(sides, tmp_path):
    """Larger snapshot, quant recipe, a used engine, a recorded mesh, a
    carry layout that does not fit, a flipped byte and a missing snapshot
    refuse with the same classes and messages."""
    def script(make, qmake, tag):
        sdir = str(tmp_path / tag)
        eng = make(num_slots=2, chunk_size=4)
        eng.submit(np.arange(5), 8)
        eng.step()
        eng.snapshot(sdir)
        out = [_err(lambda: make(num_slots=1, chunk_size=4).restore(sdir)),
               _err(lambda: qmake(num_slots=2, chunk_size=4).restore(sdir)),
               _err(lambda: eng.restore(sdir))]
        # a recorded mesh, and a carry layout with a leaf missing
        manifest = json.load(open(os.path.join(sdir, "manifest.json")))
        for edit in ({"mesh_axes": {"dp": 2}},
                     {"leaves": manifest["meta"]["leaves"][:-1]}):
            edited = str(tmp_path / f"{tag}_edited")
            shutil.copytree(sdir, edited, dirs_exist_ok=True)
            with open(os.path.join(edited, "manifest.json"), "w") as f:
                json.dump(dict(manifest, meta={**manifest["meta"], **edit}),
                          f)
            out.append(_err(lambda: make(num_slots=2,
                                         chunk_size=4).restore(edited)))
        data = os.path.join(sdir, "state.npz")
        blob = bytearray(open(data, "rb").read())
        blob[len(blob) // 2] ^= 0x01
        with open(data, "wb") as f:
            f.write(bytes(blob))
        out.append(_err(lambda: make(num_slots=2,
                                     chunk_size=4).restore(sdir)))
        out.append(_err(lambda: make(num_slots=2, chunk_size=4).restore(
            str(tmp_path / "nope"))))
        return out
    mj, mp = sides()
    qj, qp = sides("mha", "int8wk")
    got = script(mp, qp, "p")
    _same(script(mj, qj, "j"), got)
    assert [g[0] for g in got] == [
        "ValueError", "QuantMismatchError", "RuntimeError",
        "MeshMismatchError", "CorruptCheckpointError",
        "CorruptCheckpointError", "CorruptCheckpointError"]
    assert "layout mismatch" in got[4][1]
    assert "sha256" in got[5][1] and "manifest" in got[6][1]


def test_snapshot_row_remap_into_larger_matches_jax(sides, tmp_path):
    """A 2-slot snapshot restores into a 4-slot engine: its rows land in
    [0:2], the rest admit new work, and every request (the extra one
    too) has the JAX engine's tokens."""
    def script(make, tag):
        reqs = _workload(4, 11, (6, 14))
        eng = make(num_slots=2, chunk_size=4)
        rids = [eng.submit(p, b) for p, b in reqs]
        got = {}
        for _ in range(2):
            got.update(eng.step())
        sdir = str(tmp_path / tag)
        eng.snapshot(sdir)
        big = make(num_slots=4, chunk_size=4)
        info = big.restore(sdir)
        assert info["in_flight"] >= 1 and info["remapped_rows"] == 2
        extra = big.submit(np.arange(5) % 64, 6)
        got.update(big.drain())
        return [info] + [_arr(got[r]) for r in rids + [extra]]
    mj, mp = sides()
    _same(script(mj, "j"), script(mp, "p"))


def test_snapshot_torn_write_refused_then_recovers(sides, tmp_path):
    """A torn write of ``state.npz`` raises ``InjectedFault`` at snapshot
    time and the restore refuses it typed; the engine is still up, a
    clean snapshot restores, and the tokens equal the JAX engine's run
    of the same drill."""
    from paddle_tpu.runtime.resilience import fault_injector as jax_fi

    def script(make, fi, tag):
        reqs = _workload(3, 12, (10, 14))
        eng = make(num_slots=2, chunk_size=4)
        ids = [eng.submit(p, b) for p, b in reqs]
        got = dict(eng.step())
        sdir = str(tmp_path / tag)
        fi.configure([{"kind": "torn_write", "path": "*state.npz",
                       "at_byte": 80}])
        try:
            torn = _err(lambda: eng.snapshot(sdir))
            fired = [e.fault for e in fi.fired]
        finally:
            fi.clear()
        refused = _err(lambda: make(num_slots=2,
                                    chunk_size=4).restore(sdir))
        eng.snapshot(sdir)
        fresh = make(num_slots=2, chunk_size=4)
        fresh.restore(sdir)
        got.update(fresh.drain())
        return [torn, fired, refused] + [_arr(got[r]) for r in ids]
    mj, mp = sides()
    got = script(mp, fault_injector, "p")
    _same(script(mj, jax_fi, "j"), got)
    assert got[0][0] == InjectedFault.__name__
    assert got[2][0] == CorruptCheckpointError.__name__


def test_graceful_drain_and_cadence_match_jax(sides, tmp_path, clocks):
    """``drain(deadline_s=0.0, snapshot_path=)`` snapshots instead of
    discarding and a fresh engine finishes the work; no destination is a
    ``ValueError`` before any work. ``snapshot_every_chunks=2`` snapshots
    on its cadence, and the cadence snapshot restores."""
    clocks(tick=1e-3)

    def script(make, tag):
        reqs = _workload(4, 13, (10, 16))
        eng = make(num_slots=2, chunk_size=4)
        ids = [eng.submit(p, b) for p, b in reqs]
        eng.step()
        sdir = str(tmp_path / f"drain_{tag}")
        got = eng.drain(deadline_s=0.0, snapshot_path=sdir)
        left = (len(eng.scheduler.slots.occupied()), len(eng.scheduler))
        fresh = make(num_slots=2, chunk_size=4)
        fresh.restore(sdir)
        got.update(fresh.drain())
        out = [left, _err(lambda: make(num_slots=2, chunk_size=4)
                          .drain(deadline_s=1.0))]
        cdir = str(tmp_path / f"cadence_{tag}")
        eng = make(num_slots=2, chunk_size=4, snapshot_dir=cdir,
                   snapshot_every_chunks=2)
        eng.submit(np.arange(5), 16)
        eng.drain()
        m = eng.metrics()
        assert m["snapshot_age_s"] >= 0.0
        out += [m["snapshots"], m["chunk_dispatches"],
                eng.status()["snapshot"]["every_chunks"],
                make(num_slots=2, chunk_size=4).restore(cdir),
                _err(lambda: make(num_slots=2, chunk_size=4,
                                  snapshot_every_chunks=2))]
        return out + [_arr(got[r]) for r in ids]
    mj, mp = sides()
    got = script(mp, "p")
    _same(script(mj, "j"), got)
    assert sum(got[0]) >= 1 and got[1][0] == "ValueError"
    assert got[2] >= 2 and got[4] == 2 and got[6][0] == "ValueError"


# -- deadlines and SLOs ----------------------------------------------------

def _deadlines(sides, clocks, script):
    """Run a deadline ``script(make, clock)`` on both engines, each on its
    own clock ticking 1 ms a reading; the outputs must be equal."""
    cj, cp = clocks(tick=1e-3)
    mj, mp = sides()
    want, got = script(mj, cj), script(mp, cp)
    _same(want, got)
    return got


def test_deadline_shed_at_submit_matches_jax(sides, clocks):
    """An expired budget is refused typed at submit, before any prefill
    and without queueing; a generous one is served and not flagged."""
    def script(make, clock):
        eng = make(num_slots=2, chunk_size=4)
        out = [_err(lambda: eng.submit(np.arange(4), 4, deadline_s=0.0)),
               _err(lambda: eng.submit(np.arange(4), 4, deadline_s=-1.5)),
               eng.metrics()["shed_deadline"], eng.prefill_dispatches,
               len(eng.scheduler)]
        rid = eng.submit(np.arange(4), 4, deadline_s=60.0)
        res = eng.drain()[rid]
        return out + [_arr(res),
                      res.resilience["serving"]["deadline_expired"]]
    got = _deadlines(sides, clocks, script)
    assert got[0][0] == DeadlineExceededError.__name__ and got[2] == 2


def test_deadline_backpressure_shed_matches_jax(sides, clocks):
    """Once the engine has latency evidence and a deep queue, a budget
    below the estimated queue delay is refused typed at submit; a budget
    well above it is served."""
    def script(make, clock):
        eng = make(num_slots=1, chunk_size=4)
        p = np.arange(4) % 64
        eng.submit(p, 8)
        eng.drain()
        out = [eng.estimated_queue_delay_s()]    # an empty queue: 0.0
        for i in range(6):
            eng.submit(p, 8, seed=i)
        est = eng.estimated_queue_delay_s()
        assert est > 0.0
        out.append(_err(lambda: eng.submit(p, 8, deadline_s=est / 1e3)))
        eng.submit(p, 8, deadline_s=est * 1e3 + 60.0)
        eng.drain()
        m = eng.metrics()
        return out + [m["shed_backpressure"], m["requests_completed"]]
    got = _deadlines(sides, clocks, script)
    assert got[0] == 0.0 and "queue delay" in got[1][1] and got[2] == 1


def test_deadline_expired_in_queue_sheds_at_admission_matches_jax(
        sides, clocks):
    """A request that expires while queued resolves as a typed error
    value in the drain's output and ``result()``, never costing a
    prefill."""
    def script(make, clock):
        eng = make(num_slots=1, chunk_size=4)
        blocker = eng.submit(np.arange(4), 12)
        doomed = eng.submit(np.arange(5), 8, deadline_s=1.0)
        d0 = eng.prefill_dispatches
        clock.advance(5.0)
        got = eng.drain()
        return [_arr(got[blocker]), _arr(got[doomed]),
                type(eng.result(doomed)).__name__, got[doomed].request_id,
                eng.metrics()["shed_queue_deadline"],
                eng.prefill_dispatches - d0, eng.status()["shed"]]
    got = _deadlines(sides, clocks, script)
    assert got[1] == "DeadlineExceededError" and got[5] == 1


def test_deadline_expired_in_flight_returns_partial_matches_jax(
        sides, clocks):
    """An in-flight row past its deadline is frozen like eos at the next
    chunk boundary: partial, flagged, its tokens a prefix of the
    undisturbed run's, and its slot admits the next request."""
    def script(make, clock):
        full = make(num_slots=2, chunk_size=4)
        r = full.submit(np.arange(6) % 64, 16)
        ref = np.asarray(full.drain()[r])
        eng = make(num_slots=2, chunk_size=4)
        rid = eng.submit(np.arange(6) % 64, 16, deadline_s=10.0)
        assert rid not in dict(eng.step())
        clock.advance(20.0)
        res = dict(eng.step())[rid]
        out = np.asarray(res)
        assert out.shape[1] < ref.shape[1]
        np.testing.assert_array_equal(out[0], ref[0, :out.shape[1]])
        rid2 = eng.submit(np.arange(6) % 64, 4)
        return [out, res.resilience["serving"]["deadline_expired"],
                eng.metrics()["deadline_expired_rows"],
                _arr(eng.drain()[rid2]), eng.status()["shed"]]
    got = _deadlines(sides, clocks, script)
    assert got[1] is True and got[2] == 1


def test_slo_accounting_matches_jax(sides, clocks):
    """Per-class targets and per-request overrides: each record's
    ``latency_class`` and ``slo`` block, the per-class counts (the JAX
    registry's ``serving.slo.*`` counters) and ``slo_violations`` are the
    JAX engine's, on a frozen clock (every latency 0)."""
    clocks(tick=0.0)
    targets = {"batch": {"ttft_s": 1.0, "latency_s": 2.0},
               "tight": {"latency_s": -1.0}}

    def script(make):
        eng = make(num_slots=2, chunk_size=4, slo_targets=targets)
        kws = [dict(latency_class="batch"), dict(latency_class="tight"),
               dict(latency_class="batch", slo_ttft_s=-1.0),
               dict(), dict(latency_class="other", slo_latency_s=5.0)]
        ids = [eng.submit(np.arange(3 + j) % 64, 5, **kw)
               for j, kw in enumerate(kws)]
        got = eng.drain()
        recs = [(got[r].resilience["serving"]["latency_class"],
                 got[r].resilience["serving"]["slo"]) for r in ids]
        return recs + [eng.metrics()["slo_violations"],
                       eng.status()["slo_targets"]]
    mj, mp = sides()
    _same(script(mj), script(mp))
    eng_j, eng_p = mj(num_slots=2, chunk_size=4, slo_targets=targets), \
        mp(num_slots=2, chunk_size=4, slo_targets=targets)
    for eng in (eng_j, eng_p):
        eng.submit(np.arange(4), 5, latency_class="tight")
        eng.submit(np.arange(4), 5, latency_class="batch", slo_ttft_s=-1.0)
        eng.drain()
    want = {n: int(eng_j.registry.get(n).value)
            for n in eng_j.registry.names() if ".slo." in n}
    assert eng_p.slo_counters() == dict(sorted(want.items()))


def test_snapshot_carries_deadlines_as_remaining_budget(sides, tmp_path,
                                                        clocks):
    """A deadline crosses a snapshot as the remaining budget: a request
    with budget left finishes on the restored engine, one whose remainder
    is already negative is shed on the first step after the restore (in
    flight: partial and flagged; queued: a typed value)."""
    cj, cp = clocks(tick=0.0)

    def script(make, clock, tag):
        eng = make(num_slots=1, chunk_size=4)
        live = eng.submit(np.arange(4), 12, deadline_s=100.0)
        queued = eng.submit(np.arange(5), 6, deadline_s=30.0)
        eng.step()
        sdir = str(tmp_path / tag)
        eng.snapshot(sdir)
        meta = json.load(open(os.path.join(sdir, "manifest.json")))["meta"]
        rems = [s["request"]["deadline_remaining_s"] for s in meta["slots"]
                ] + [q["deadline_remaining_s"] for q in meta["queue"]]
        fresh = make(num_slots=1, chunk_size=4)
        fresh.restore(sdir)
        clock.advance(50.0)
        got = fresh.drain()
        return [rems, _arr(got[live]),
                got[live].resilience["serving"]["deadline_expired"],
                _arr(got[queued]), fresh.metrics()["shed_queue_deadline"]]
    mj, mp = sides()
    got = script(mp, cp, "p")
    _same(script(mj, cj, "j"), got)
    assert got[0] == [100.0, 30.0] and got[2] is False
    assert got[3] == "DeadlineExceededError"


# -- live row migration ----------------------------------------------------

def _migrate(make, kw, sub_kw):
    """Three prompts on a 4-slot engine, one step, the middle request
    moved to a second engine; both drained."""
    rng = np.random.default_rng(5)
    prompts = [rng.integers(1, 64, (int(rng.integers(3, 7)),))
               for _ in range(3)]
    src, dst = make(num_slots=4, chunk_size=4, **kw), \
        make(num_slots=4, chunk_size=4, **kw)
    rids = [src.submit(p, 10, **sub_kw(i)) for i, p in enumerate(prompts)]
    done = dict(src.step())
    victim = rids[1]
    assert victim not in done
    payload = src.extract_rows([victim])
    again = _err(lambda: src.extract_rows([victim]))
    mapping = dst.absorb_rows(payload)
    done.update(src.drain())
    done2 = dst.drain()
    out = [payload["meta"]["rows"], again, len(mapping),
           src.metrics()["rows_migrated_out"],
           dst.metrics()["rows_migrated_in"]]
    return out + [_arr(done2[mapping[r]] if r == victim else done[r])
                  for r in rids]


def test_migration_greedy_and_sampled_match_jax(sides):
    """A request moved mid-flight decodes the JAX engine's tokens, greedy
    and sampled (the shipped row keeps its live key: per-row seed keys);
    a second extract of the
    moved id is refused before anything is touched."""
    got = _both(sides, _migrate, {}, lambda i: {})
    assert got[0] == 1 and got[1][0] == "ValueError"
    _both(sides, _migrate, dict(do_sample=True, top_k=8),
          lambda i: dict(temperature=0.8, seed=7 + i))


def test_migration_queued_unknown_corrupt_capacity_match_jax(sides):
    """A queued request moves as prompt and record; unknown ids, a
    flipped payload byte, another quant recipe and too few free slots
    are refused typed, before anything is scattered."""
    def script(make, qmake):
        out = []
        rng = np.random.default_rng(3)
        prompts = [rng.integers(1, 64, (5,)) for _ in range(6)]
        src = make(num_slots=4, chunk_size=4)
        dst = make(num_slots=4, chunk_size=4)
        rids = [src.submit(p, 8) for p in prompts]
        src.step()
        out.append(_err(lambda: src.extract_rows([rids[5], 999])))
        payload = src.extract_rows([rids[5]])
        out += [payload["meta"]["rows"], len(payload["meta"]["queue"]),
                len(src.scheduler)]
        mapping = dst.absorb_rows(payload)
        got = dst.drain()
        out.append(_arr(got[mapping[rids[5]]]))
        bad = src.extract_rows([rids[0]])
        flipped = dict(bad, data=bytes(
            b ^ (0xFF if i == len(bad["data"]) // 2 else 0)
            for i, b in enumerate(bad["data"])))
        out.append(_err(lambda: dst.absorb_rows(flipped)))
        out.append(len(dst.scheduler.slots.occupied()))
        out.append(_err(lambda: qmake(num_slots=4, chunk_size=4,
                                      quant="int8wk").absorb_rows(bad)))
        small = make(num_slots=1, chunk_size=4)
        small.submit(prompts[0], 8)
        small.step()
        out.append(_err(lambda: small.absorb_rows(
            src.extract_rows(rids[1:3]))))
        return out
    mj, mp = sides()
    qj, qp = sides("mha", "int8wk")
    got = script(mp, qp)
    _same(script(mj, qj), got)
    assert got[0][0] == "ValueError"
    assert got[5][0] == SlabTransferError.__name__
    assert got[7][0] == "QuantMismatchError"
    assert got[8][0] == "RuntimeError" and "free slots" in got[8][1]


def test_replica_plumbing_matches_jax(sides):
    """The dead-replica export: ``export_inflight`` gives each occupied
    slot's request, tokens so far and piece count; ``take_queued`` empties
    the queue in admission order (priority policy, so order is not submit
    order); ``clear_inflight`` releases the slots and unpins the prefix
    slabs their admissions hit; after ``reset_state`` the requeued requests decode as on an
    uninterrupted engine."""
    def script(make):
        kw = dict(num_slots=2, chunk_size=4, policy="priority",
                  prefix_cache=True, prefix_cache_bytes=1 << 30,
                  prefix_block_tokens=4)
        reqs = _workload(6, 17, (6, 12))
        ref = make(**kw)
        rids = [ref.submit(p, b, priority=i % 3)
                for i, (p, b) in enumerate(reqs)]
        full = ref.drain()
        eng = make(**kw)
        for p, b in reqs:            # warm the cache: the rows then pin
            eng.submit(p, b)
        eng.drain()
        ids = [eng.submit(p, b, priority=i % 3)
               for i, (p, b) in enumerate(reqs)]
        eng.step()
        out = []
        inflight = eng.export_inflight()
        out.append(len(inflight))
        for req, toks, pieces in inflight:
            out += [req.id, req.max_new_tokens, req.priority,
                    np.asarray(req.prompt), np.asarray(toks), pieces]
        pinned = eng.prefix_cache.stats()["pinned"]
        queued = eng.take_queued()
        out += [[r.id for r in queued], len(eng.scheduler), pinned]
        eng.clear_inflight()
        out += [eng.prefix_cache.stats()["pinned"],
                len(eng.scheduler.slots.occupied())]
        eng.reset_state()
        again = [eng.submit(r.prompt, r.max_new_tokens, priority=r.priority)
                 for r in [q for q, _, _ in inflight] + queued]
        got = eng.drain()
        back = {r.id: got[n] for r, n in zip(
            [q for q, _, _ in inflight] + queued, again)}
        for i, r in zip(ids, rids):
            np.testing.assert_array_equal(np.asarray(back[i]),
                                          np.asarray(full[r]))
        return out + [_arr(back[i]) for i in ids]
    got = _both(sides, script)[:-6]
    # two in flight, the queue emptied, pins 2 -> 0, no slot occupied
    assert got[0] == 2 and got[-4:] == [0, 2, 0, 0]
    assert len(got[-5]) == 4


def test_fault_injector_refuses_unported_kinds(monkeypatch):
    """Every JAX fault kind is ported now: the heartbeat and RPC rules
    install and fire as the JAX injector's (the same actions and events
    for the same calls), while the port still refuses the JAX package's
    environment plan, ``PADDLE_TPU_FAULT_PLAN``: only ``configure``
    installs one."""
    from paddle_tpu.runtime.resilience import fault_injector as jinj
    monkeypatch.setenv("PADDLE_TPU_FAULT_PLAN",
                       '[{"kind": "rpc_partition"}]')
    assert not fault_injector.active()
    assert fault_injector.rpc_action("0", "1") == ("ok", 0.0)
    plan = [{"kind": "rpc_partition", "src": "0", "dst": "1", "times": 1},
            {"kind": "rpc_delay", "src": "1", "dst": "0", "delay_s": 0.1},
            {"kind": "rpc_duplicate", "src": "2", "dst": "*"},
            {"kind": "dead_heartbeat", "node": "a", "after_beats": 1},
            {"kind": "delay_heartbeat", "node": "b", "skip_beats": 2}]
    calls = [("0", "1"), ("0", "1"), ("1", "0"), ("2", "5"), ("3", "4")]

    def run(inj):
        inj.configure(plan)
        acts = [inj.rpc_action(*c) for c in calls]
        beats = [inj.heartbeat_action(n) for n in "aaabbbc"]
        fired = [(e.site, e.fault, e.detail) for e in inj.fired]
        inj.clear()
        return acts, beats, fired

    try:
        want = run(jinj)
    finally:
        jinj.clear()
    got = run(fault_injector)
    assert got == want
    assert got[1] == ["ok", "dead", "dead", "skip", "skip", "ok", "ok"]
    assert not fault_injector.active()


# -- format parity, both directions ----------------------------------------

@pytest.mark.parametrize("cfg,quant", [("mha", None), ("gqa", None),
                                       ("gqa", "int8wk")])
def test_snapshot_crosses_packages(sides, tmp_path, cfg, quant):
    """A snapshot the JAX engine writes mid-drain restores into the
    port's engine, which finishes with the JAX engine's tokens; one the
    port writes restores into the JAX engine, likewise."""
    mj, mp = sides(cfg, quant)
    reqs = _workload(5, 11, (10, 16))

    def start(make, tag):
        eng = make(num_slots=2, chunk_size=4)
        ids = [eng.submit(p, b) for p, b in reqs]
        got = {}
        for _ in range(2):
            got.update(eng.step())
        sdir = str(tmp_path / tag)
        eng.snapshot(sdir)
        return eng, ids, got, sdir

    ej, ids, got_j, sdir_j = start(mj, "j")
    ep, _, got_p, sdir_p = start(mp, "p")
    done = {**got_j, **ej.drain()}
    want = [np.asarray(done[i]) for i in ids]
    for make, sdir, got in ((mp, sdir_j, got_j), (mj, sdir_p, got_p)):
        fresh = make(num_slots=2, chunk_size=4)
        assert fresh.restore(sdir)["in_flight"] >= 1
        out = {**got, **fresh.drain()}
        _same(want, [np.asarray(out[i]) for i in ids])


@pytest.mark.parametrize("cfg,quant", [("mha", None), ("gqa", "int8wk")])
def test_migration_payload_crosses_packages(sides, cfg, quant):
    """A migration payload extracted by the JAX engine is absorbed by the
    port's and the other way round; both continue with the undisturbed
    JAX run's tokens."""
    mj, mp = sides(cfg, quant)
    rng = np.random.default_rng(9)
    prompts = [rng.integers(1, 64, (int(rng.integers(3, 7)),))
               for _ in range(3)]
    ref = mj(num_slots=2, chunk_size=4)
    rids = [ref.submit(p, 10) for p in prompts]
    ref_out = ref.drain()
    want = [np.asarray(ref_out[r]) for r in rids]
    for src_make, dst_make in ((mj, mp), (mp, mj)):
        # two slots: the payload ships one in-flight row and one queued
        # request
        src, dst = src_make(num_slots=2, chunk_size=4), \
            dst_make(num_slots=2, chunk_size=4)
        ids = [src.submit(p, 10) for p in prompts]
        done = dict(src.step())
        payload = src.extract_rows(ids[1:])
        assert (payload["meta"]["rows"], len(payload["meta"]["queue"])) \
            == (1, 1)
        mapping = dst.absorb_rows(payload)
        done.update(src.drain())
        moved = dst.drain()
        _same(want, [np.asarray(moved[mapping[r]] if r in mapping
                                else done[r]) for r in ids])


# -- the port alone ----------------------------------------------------------

def test_restore_and_absorb_write_the_carry_in_place(sides, tmp_path):
    """Restore, absorb and ``reset_state`` keep the engine's carry caches
    (the ring splices into them and the chunk graphs hold their
    addresses): the cache tensors' storage is the same before and after,
    and requests admitted through the ring afterwards still get the
    uninterrupted engine's tokens. The refused-later arguments name their
    ROADMAP item."""
    _, mp = sides("gqa")
    reqs = _workload(5, 11, (10, 16))
    ref = mp(num_slots=4, chunk_size=4)
    ids = [ref.submit(p, b) for p, b in reqs]
    out = ref.drain()
    want = [np.asarray(out[i]) for i in ids]
    eng = mp(num_slots=2, chunk_size=4)
    for p, b in reqs[:3]:
        eng.submit(p, b)
    eng.step()
    eng.snapshot(str(tmp_path / "s"))
    fresh = mp(num_slots=4, chunk_size=4)
    ptr = fresh.state.kc.data_ptr()
    fresh.restore(str(tmp_path / "s"))
    src = mp(num_slots=2, chunk_size=4)
    moved = src.submit(*reqs[3])
    src.step()
    fresh.absorb_rows(src.extract_rows([moved]))
    late = fresh.submit(*reqs[4])
    got = fresh.drain()
    assert fresh.state.kc.data_ptr() == ptr
    assert fresh._b.ring.carry_kc.data_ptr() == ptr
    np.testing.assert_array_equal(np.asarray(got[late]), want[4])
    fresh.reset_state()
    assert fresh.state.kc.data_ptr() == ptr
    assert not fresh.state.kc.any() and bool(fresh.state.done.all())
    rid = fresh.submit(*reqs[0])
    np.testing.assert_array_equal(np.asarray(fresh.drain()[rid]), want[0])
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        mp(mesh="dp:2")
    # the router's engine and submit arguments are ported
    assert mp(request_keyed_rng=True, replica_tag="r1").replica_tag == "r1"
    fresh.submit(np.arange(3), 2, on_tokens=lambda *a: None,
                 rng_request_id=3)
    with pytest.raises(ValueError, match="snapshot"):
        mp(draft_model="skip:1", snapshot_dir=str(tmp_path))


def test_storage_tags_cross_both_ways():
    """bf16 goes out as tagged uint16 bits and comes back bit-equal
    through torch; the JAX package's storage of the same bits restores
    to the same tensor."""
    from paddle_tpu.distributed.checkpoint import _np_restore as jax_restore
    from paddle_tpu.distributed.checkpoint import \
        _np_storable as jax_storable

    from paddle_tpu_torch.distributed.checkpoint import (_np_restore,
                                                         _np_storable)
    t = torch.randn(3, 5).to(torch.bfloat16)
    arr, tag = _np_storable(t)
    assert (arr.dtype, tag) == (np.uint16, "bfloat16")
    assert torch.equal(_np_restore(arr, tag), t)
    jarr, jtag = jax_storable(jax_restore(arr, tag))
    assert jtag == tag and np.array_equal(jarr, arr)
    for a in (np.arange(4, dtype=np.int32), np.ones(3, np.bool_),
              np.arange(6, dtype=np.uint32)):
        s, tg = _np_storable(a)
        assert tg == jax_storable(a)[1]
        np.testing.assert_array_equal(
            _np_restore(s, tg).numpy().view(a.dtype), a)


# -- on the card ---------------------------------------------------------------

@pytest.mark.gpu
def test_restore_and_absorb_keep_the_ring_on_card(tmp_path):
    """On the card, with the ring and captured chunk and prefill graphs: a
    snapshot restored into a fresh engine and a row absorbed into a live
    one finish with the uninterrupted engine's tokens, and requests
    admitted through the ring AFTER the restore and the absorb still get
    them: the ring splices into, and the graphs read, the restored
    carry."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    model = LlamaForCausalLM(LlamaConfig(
        vocab_size=512, hidden_size=256, intermediate_size=512,
        num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
        max_position_embeddings=256, dtype="bfloat16"), seed=0)
    dec = LlamaDecoder(model, max_len=64)
    rng = np.random.default_rng(0)
    reqs = [(rng.integers(0, 512, (int(rng.integers(4, 12)),)),
             int(rng.integers(12, 24))) for _ in range(8)]

    def serve(eng, rs):
        ids = [eng.submit(p, b) for p, b in rs]
        out = eng.drain()
        return [np.asarray(out[i]) for i in ids]

    ref = ServingEngine(dec, num_slots=4, chunk_size=4)
    for _ in range(3):              # eager warm-up, capture, replay
        want = serve(ref, reqs)
    eng = ServingEngine(dec, num_slots=4, chunk_size=4)
    ids = [eng.submit(p, b) for p, b in reqs[:6]]
    got = {}
    for _ in range(2):
        got.update(eng.step())
    eng.snapshot(str(tmp_path / "s"))
    # a new decoder stands in for a restarted process
    fresh = ServingEngine(LlamaDecoder(model, max_len=64), num_slots=4,
                          chunk_size=4)
    fresh.restore(str(tmp_path / "s"))
    got.update(fresh.drain())
    for j, rid in enumerate(ids):
        np.testing.assert_array_equal(np.asarray(got[rid]), want[j])
    np.testing.assert_array_equal(serve(fresh, reqs[6:])[0], want[6])
    src = ServingEngine(dec, num_slots=4, chunk_size=4)
    moved = [src.submit(p, b) for p, b in reqs[:2]]
    src.step()
    live = [fresh.submit(p, b) for p, b in reqs[6:]]
    fresh.step()
    mapping = fresh.absorb_rows(src.extract_rows(moved))
    late = fresh.submit(*reqs[5])
    out = fresh.drain()
    for j, rid in enumerate(moved):
        np.testing.assert_array_equal(np.asarray(out[mapping[rid]]),
                                      want[j])
    for j, rid in enumerate(live):
        np.testing.assert_array_equal(np.asarray(out[rid]), want[6 + j])
    np.testing.assert_array_equal(np.asarray(out[late]), want[5])
    assert sum(g is not None for g in
               fresh._b.dec._chunk_graphs.values()) == 1
