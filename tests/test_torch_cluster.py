"""The port's control plane and cluster (paddle_tpu_torch/native,
distributed/{rpc,elastic}.py, serving/cluster/*) against the JAX
package's, on the CPU.

- The store: the port's ``TCPStore`` client against the JAX package's
  server and the other way round (the wire protocol byte for byte).
- RPC: round trips, ordered async calls, remote exceptions, numpy
  payloads, worker infos, chunked parts with one sha retry and the typed
  refusal, and the ``resume`` rules (tests/test_rpc.py,
  tests/test_cluster.py:89-150, tests/test_fleet_ops.py:274).
- ``ElasticManager.beat_age`` (tests/test_fleet_ops.py:350).
- The WAL: round trip with rotation, torn tail, mid-file corruption, bad
  magic (tests/test_frontend_failover.py:51-125), and a log written by
  either package replayed by the other, byte for byte.
- The in-process ``ClusterRouter`` recovery over a fake fleet
  (tests/test_frontend_failover.py:158-392), held to the JAX
  ``ClusterRouter`` over the same fake fleet.
- A JAX-staged f32 ``weights_v1.npz`` served by a port ``WorkerHost``,
  and a worker asked for a card it does not have failing its
  registration typed.

The spawned multi-process drills carry the ``slow`` marker where the
JAX package's do (``--runslow``).
"""

import json
import os
import subprocess
import sys
import time
import types

import numpy as np
import pytest

from paddle_tpu_torch.convert import from_jax_state_dict
from paddle_tpu_torch.distributed.elastic import ElasticManager
from paddle_tpu_torch.distributed.rpc import _CHUNK_BYTES, RpcAgent
from paddle_tpu_torch.inference.generate import LlamaDecoder
from paddle_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM
from paddle_tpu_torch.native import TCPStore
from paddle_tpu_torch.runtime import resilience as res
from paddle_tpu_torch.serving import launch_cluster, parse_cluster_spec
from paddle_tpu_torch.serving.cluster.frontend import (ClusterRouter,
                                                       WorkerHandle)
from paddle_tpu_torch.serving.cluster.wal import WriteAheadLog

pytestmark = pytest.mark.serving

CFG = dict(vocab_size=64, hidden_size=32, intermediate_size=64,
           num_hidden_layers=2, num_attention_heads=4,
           num_key_value_heads=4, max_position_embeddings=64)


@pytest.fixture(autouse=True)
def _clear_faults():
    res.fault_injector.clear()
    yield
    res.fault_injector.clear()


def _jax_model(seed=0):
    import paddle_tpu as paddle
    from paddle_tpu.models.llama import LlamaConfig as JaxConfig
    from paddle_tpu.models.llama import LlamaForCausalLM as JaxModel
    paddle.seed(seed)
    return JaxModel(JaxConfig(**CFG))


def _port_model(jm):
    state = {k: np.asarray(v.value) for k, v in jm.state_dict().items()}
    return from_jax_state_dict(
        state, LlamaForCausalLM(LlamaConfig(**CFG), device="cpu"))


# -- the store, across the packages ---------------------------------------

@pytest.mark.parametrize("server", ["jax", "port"])
def test_store_interoperates_across_packages(server):
    """One package's store server, the other's client: set/get, a 1 MiB
    value boundary, add, wait, delete and the barrier behave alike."""
    from paddle_tpu.native.tcp_store import TCPStore as JaxStore
    Server, Client = ((JaxStore, TCPStore) if server == "jax"
                      else (TCPStore, JaxStore))
    srv = Server(is_master=True, world_size=2)
    cli = Client(srv.host, srv.port, world_size=2)
    cli.set("k", b"v" * 1000)
    assert srv.get("k") == b"v" * 1000
    srv.set("s", "text")
    assert cli.get("s") == b"text" and cli.get("missing") is None
    assert cli.add("n", 3) == 3 and srv.add("n", 4) == 7
    assert cli.wait("k", timeout=2.0) == b"v" * 1000
    big = os.urandom((1 << 20) - 16)
    srv.set("big", big)
    assert cli.get("big") == big
    cli.delete_key("k")
    assert srv.get("k") is None
    with pytest.raises(TimeoutError):
        cli.wait("never", timeout=0.2)
    import threading
    t = threading.Thread(target=srv.barrier, args=("b",))
    t.start()
    cli.barrier("b", timeout=5.0)
    t.join(timeout=5.0)
    assert not t.is_alive()


# -- RPC -------------------------------------------------------------------

def _add(a, b):
    return a + b


def _boom():
    raise ValueError("remote failure")


def _echo_sum(arr):
    a = np.asarray(arr)
    return a, float(a.sum())


@pytest.fixture
def agents():
    a0 = RpcAgent("worker0", 0, 2)
    a1 = RpcAgent("worker1", 1, 2, host=a0.store.host, port=a0.store.port,
                  is_master=False)
    yield a0, a1
    a0.shutdown()
    a1.shutdown()


def test_rpc_round_trips_and_worker_infos(agents):
    a0, a1 = agents
    assert a0.call("worker1", _add, (2, 3)).wait() == 5
    assert a1.call("worker0", _add, (10, 30)).wait() == 40
    futs = [a0.call(1, _add, (i, i)) for i in range(8)]
    assert [f.wait() for f in futs] == [2 * i for i in range(8)]
    with pytest.raises(ValueError, match="remote failure"):
        a0.call("worker1", _boom).wait()
    assert a0.call("worker1", _add, (1, 1)).wait() == 2
    arr = np.arange(12.0).reshape(3, 4)
    back, total = a1.call("worker0", _echo_sum, (arr,)).wait()
    np.testing.assert_array_equal(back, arr)
    assert total == arr.sum()
    assert a0.worker_info("worker1") == type(a0.worker_info(1))("worker1",
                                                                1)
    assert [w.name for w in a0.all_worker_info()] == ["worker0", "worker1"]


def test_rpc_module_api():
    import paddle_tpu_torch.distributed.rpc as rpc
    rpc.init_rpc("solo", rank=0, world_size=1, master_endpoint=None)
    try:
        assert rpc.rpc_sync("solo", _add, (4, 5)) == 9
        assert rpc.rpc_async(0, _add, (6, 7)).wait() == 13
        assert rpc.get_current_worker_info().name == "solo"
    finally:
        rpc.shutdown()


def test_store_wait_blocks_per_thread_and_rpc_round_trip_is_short():
    """ROADMAP.md section 3, entry 42: each waiting thread has a store
    connection of its own and hands the server's WAIT the whole timeout,
    so one ``rpc_sync`` on a local store takes well under the JAX
    client's first 50 ms poll (the median of 20 must be under 25 ms), and
    a ``get`` issued while another thread sits in a 5 s wait returns at
    once (under 50 ms) where it used to queue behind the wait's lock."""
    import threading

    import paddle_tpu_torch.distributed.rpc as rpc
    rpc.init_rpc("solo", rank=0, world_size=1, master_endpoint=None)
    try:
        assert rpc.rpc_sync("solo", _add, (1, 2)) == 3
        trips = []
        for i in range(20):
            t0 = time.perf_counter()
            assert rpc.rpc_sync("solo", _add, (i, 1)) == i + 1
            trips.append(time.perf_counter() - t0)
        assert float(np.median(trips)) < 0.025, trips
    finally:
        rpc.shutdown()

    store = TCPStore(is_master=True)
    store.set("here", b"x")
    got = {}
    waiter = threading.Thread(
        target=lambda: got.update(v=store.wait("late", timeout=5.0)))
    waiter.start()
    time.sleep(0.1)
    assert waiter.is_alive()
    t0 = time.perf_counter()
    assert store.get("here") == b"x"
    assert time.perf_counter() - t0 < 0.05
    t0 = time.perf_counter()
    store.set("late", b"y")
    waiter.join(timeout=5.0)
    assert not waiter.is_alive() and got["v"] == b"y"
    assert time.perf_counter() - t0 < 0.05


def test_rpc_chunked_parts_sha_retry_and_typed_refusal(agents):
    """A payload past the store's 1 MiB client buffer rides sha256-checked
    ``{key}/part{i}`` keys both ways; a torn read heals on the one retry
    (``transfer_retries``), real corruption is ``SlabTransferError``
    naming the key and part."""
    a0, a1 = agents
    big = np.arange(400_000, dtype=np.float64)
    back, total = a0.call(1, _echo_sum, (big,)).wait(30)
    np.testing.assert_array_equal(np.asarray(back), big)
    assert total == big.sum()
    payload = os.urandom(2 * _CHUNK_BYTES + 1024)
    a0._put("blob/heal", payload)
    clean_get, state = a0.store.get, {"fired": False}

    def flaky_get(key):
        v = clean_get(key)
        if key == "blob/heal/part1" and not state["fired"]:
            state["fired"] = True
            return b"\x00" * len(v)
        return v

    a0.store.get = flaky_get
    try:
        before = a0.transfer_retries
        assert a0._fetch("blob/heal", 10) == payload
        assert a0.transfer_retries == before + 1
    finally:
        a0.store.get = clean_get
    a0._put("blob/bad", payload)
    part = payload[_CHUNK_BYTES:2 * _CHUNK_BYTES]
    a0.store.set("blob/bad/part1", b"\xff" + part[1:])
    with pytest.raises(res.SlabTransferError) as ei:
        a0._fetch("blob/bad", 10)
    assert (ei.value.key, ei.value.part) == ("blob/bad", 1)


def test_rpc_resume_skips_dead_incarnations_calls():
    """A resumed rank starts at the store's counters: a call addressed to
    the dead incarnation is never served, fresh calls are."""
    a0 = RpcAgent("res0", 0, 2)
    a1 = RpcAgent("res1", 1, 2, host=a0.store.host, port=a0.store.port,
                  is_master=False)
    try:
        assert a0.call(1, _add, (1, 2)).wait(10) == 3
        a1.shutdown()
        orphan = a0.call(1, _add, (5, 6))
        a1b = RpcAgent("res1", 1, 2, host=a0.store.host,
                       port=a0.store.port, is_master=False, resume=True)
        try:
            with pytest.raises(TimeoutError):
                orphan.wait(1.0)
            assert a0.call(1, _add, (8, 9)).wait(10) == 17
        finally:
            a1b.shutdown()
    finally:
        a0.shutdown()


def test_rpc_fault_rules_fire_as_in_jax():
    """The five heartbeat and RPC fault kinds: each package's injector
    answers the same plan with the same actions and fired events."""
    from paddle_tpu.runtime.resilience import fault_injector as jinj
    plan = [{"kind": "rpc_partition", "src": "0", "dst": "2"},
            {"kind": "rpc_duplicate", "src": "0", "dst": "1", "times": 1},
            {"kind": "rpc_delay", "src": "1", "dst": "*", "delay_s": 0.05},
            {"kind": "dead_heartbeat", "node": "n1", "after_beats": 2},
            {"kind": "delay_heartbeat", "node": "n2", "after_beats": 1,
             "skip_beats": 2}]
    calls = [("rpc", "0", "2"), ("rpc", "2", "0"), ("rpc", "0", "1"),
             ("rpc", "0", "1"), ("rpc", "1", "3")] + \
        [("hb", n) for n in ("n1", "n2") for _ in range(5)]

    def run(inj):
        inj.configure(plan)
        out = [inj.rpc_action(c[1], c[2]) if c[0] == "rpc"
               else inj.heartbeat_action(c[1]) for c in calls]
        fired = [e.as_dict() for e in inj.fired]
        inj.clear()
        return out, fired

    try:
        got, want = run(res.fault_injector), run(jinj)
    finally:
        jinj.clear()
    assert got == want
    assert {f["fault"] for f in got[1]} == {
        "rpc_partition", "rpc_duplicate", "rpc_delay", "dead_heartbeat",
        "delay_heartbeat"}


# -- the elastic manager ----------------------------------------------------

class _DictStore:
    def __init__(self):
        self.d = {}

    def get(self, k):
        return self.d.get(k)

    def set(self, k, v):
        self.d[k] = v.encode() if isinstance(v, str) else v


def test_elastic_beat_age_tracks_staleness():
    em = ElasticManager(_DictStore(), node_id="n0", heartbeat_s=30.0,
                        ttl_s=60.0)
    assert em.beat_age("ghost") is None
    em._beat()
    assert em.beat_age("n0") < 0.5
    time.sleep(0.2)
    assert em.beat_age("n0") >= 0.2
    em._beat()
    assert em.beat_age("n0") < 0.2
    # a dead heartbeat (the injector's heartbeat_action) writes no beat
    res.fault_injector.configure([{"kind": "dead_heartbeat",
                                   "node": "n0"}])
    before = em.store.get("__elastic__/node/n0")
    em._beat()
    assert em.store.get("__elastic__/node/n0") == before
    assert [e.fault for e in res.fault_injector.fired] == [
        "dead_heartbeat"]


# -- the WAL ----------------------------------------------------------------

def _wal_records():
    return [{"t": "submit", "rid": i, "prompt": np.arange(3)}
            for i in range(10)]


def test_wal_round_trip_rotation_and_torn_tail(tmp_path):
    d = str(tmp_path / "wal")
    w = WriteAheadLog(d, segment_bytes=200)
    for i, rec in enumerate(_wal_records()):
        w.append(rec, sync=(i % 2 == 0))
    st = w.stats()
    assert st["segments"] > 1 and st["fsyncs"] >= 5
    w.close()
    w2 = WriteAheadLog(d)
    assert [r["rid"] for r in w2.recovered] == list(range(10))
    assert w2.recovered[3]["prompt"] == [0, 1, 2]
    w2.append({"t": "finish", "rid": 10})
    w2.close()
    seg = os.path.join(d, sorted(os.listdir(d))[-1])
    os.truncate(seg, os.path.getsize(seg) - 7)
    w3 = WriteAheadLog(d)
    assert [r["rid"] for r in w3.recovered] == list(range(10))
    w3.append({"t": "submit", "rid": 99})
    w3.close()
    assert WriteAheadLog(d).recovered[-1]["rid"] == 99


@pytest.mark.parametrize("damage", ["body", "magic"])
def test_wal_corruption_refused_typed(tmp_path, damage):
    d = str(tmp_path / "wal")
    w = WriteAheadLog(d, segment_bytes=200)
    for rec in _wal_records():
        w.append(rec)
    w.close()
    first = os.path.join(d, sorted(os.listdir(d))[0])
    with open(first, "rb+") as f:
        if damage == "magic":
            f.write(b"XXXX")
        else:
            f.seek(44)
            b = f.read(1)
            f.seek(44)
            f.write(bytes([b[0] ^ 0xFF]))
    with pytest.raises(res.CorruptCheckpointError):
        WriteAheadLog(d)


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_wal_crosses_packages(tmp_path, writer):
    """A log one package writes (rotated segments, the same records) is
    byte for byte the log the other writes, and each replays the
    other's."""
    from paddle_tpu.serving.cluster.wal import WriteAheadLog as JaxWal
    W, R = (JaxWal, WriteAheadLog) if writer == "jax" \
        else (WriteAheadLog, JaxWal)
    recs = _wal_records() + [{"t": "tokens", "rid": 1, "off": 0,
                              "toks": [7, 8], "deadline_rem": 4.5}]
    dirs = {}
    for name, cls in (("a", W), ("b", R)):
        dirs[name] = str(tmp_path / name)
        w = cls(dirs[name], segment_bytes=200)
        for rec in recs:
            w.append(rec)
        w.close()
    for seg in sorted(os.listdir(dirs["a"])):
        a = open(os.path.join(dirs["a"], seg), "rb").read()
        assert a == open(os.path.join(dirs["b"], seg), "rb").read(), seg
    assert R(dirs["a"]).recovered == W(dirs["a"]).recovered


# -- the ClusterRouter's recovery over a fake fleet -------------------------

class _FakeStore:
    def __init__(self):
        self.kv, self.counters = {}, {}

    def add(self, key, delta):
        self.counters[key] = self.counters.get(key, 0) + int(delta)
        return self.counters[key]

    def get(self, key):
        return self.kv.get(key)

    def set(self, key, value):
        self.kv[key] = value


class _FakeFuture:
    def __init__(self, value=None, error=None):
        self._value, self._error = value, error

    def wait(self, timeout=None):
        if self._error is not None:
            raise self._error
        return self._value


class _FakeWorker:
    def __init__(self, known=(), results=None):
        self.known = set(known)
        self.results = dict(results or {})
        self.submits = []
        self._next_erid = 1000

    def handle(self, op, *args, **kwargs):
        kwargs.pop("_epoch", None)
        if op == "adopt":
            return {"known": sorted(self.known), "queued": 0,
                    "occupied": len(self.known)}
        if op == "result":
            return self.results.get(int(args[0]))
        if op == "submit":
            self.submits.append((np.asarray(args[0]).tolist(), kwargs))
            erid = self._next_erid
            self._next_erid += 1
            self.known.add(erid)
            return erid
        if op == "step":
            return {"finished": [], "inflight": {}, "queued": 0,
                    "occupied": len(self.known)}
        raise ValueError(f"fake worker: unexpected op {op!r}")


class _FakeAgent:
    def __init__(self, workers):
        self.store = _FakeStore()
        self.workers = workers
        self.transfer_retries = 0

    def call(self, rank, fn, args, kwargs):
        try:
            return _FakeFuture(
                value=self.workers[rank].handle(*args, **kwargs))
        except BaseException as e:
            return _FakeFuture(error=e)


class _FakeElastic:
    def __init__(self, names):
        self._names = list(names)

    @property
    def members(self):
        return list(self._names)

    def beat_age(self, node_id):
        return 0.0

    def wait_for(self, node_ids, timeout_s=10.0):
        return sorted(self._names)


def _submit(rid, prompt, budget, seed=0, rem=None, erid=100, tag="a"):
    return {"t": "submit", "rid": rid, "tag": tag, "prompt": prompt,
            "max_new_tokens": budget, "eos_token_id": None,
            "temperature": 1.0, "seed": seed, "priority": 0,
            "latency_class": "default", "deadline_rem": rem, "worker": 1,
            "engine_rid": erid}


_CASES = {
    "resume": ([_submit(0, [1, 2, 3], 8, rem=5.0),
                {"t": "tokens", "rid": 0, "off": 0, "toks": [7, 8],
                 "deadline_rem": 4.5}], {100}),
    "replay": ([_submit(0, [1, 2, 3], 8, seed=3),
                {"t": "tokens", "rid": 0, "off": 0, "toks": [7, 8, 9],
                 "deadline_rem": None}], set()),
    "shed": ([_submit(0, [1, 2], 4, rem=0.0)], set()),
    "finished": ([_submit(0, [1], 2),
                  {"t": "finish", "rid": 0, "tokens": [1, 5, 6],
                   "resil": None},
                  _submit(1, [2], 2, erid=101, tag="b"),
                  {"t": "finish", "rid": 1, "etype": "ReplicaDeadError",
                   "error": "no surviving decode worker"}], set()),
}


def _recover(ns, wal, known):
    """Recover a ClusterRouter of package ``ns`` from ``wal`` over a one
    worker fake fleet; a comparable summary."""
    worker = _FakeWorker(known=known)
    h = ns.Handle(name="decode0", rank=1, role="decode", pid=1)
    router = ns.Router(_FakeAgent({1: worker}), [h],
                       _FakeElastic(["decode0"]), resume_wal=wal)
    try:
        outs = {}
        for rid in sorted(router._tracked):
            t = router._tracked[rid]
            oc = router.outcome(rid)
            outs[rid] = dict(
                ledger=np.asarray(t.ledger).tolist(),
                deadline=(None if t.deadline_at is None else
                          round(t.deadline_at - time.monotonic())),
                outcome=(None if oc is None else
                         type(oc).__name__ if isinstance(oc, BaseException)
                         else np.asarray(oc).tolist()))
        return dict(report=router.recovery_report,
                    by_engine={k: dict(v)
                               for k, v in router._by_engine.items()},
                    submits=worker.submits, outs=outs,
                    in_flight=router.in_flight(), next_id=router._next_id,
                    metrics={k: ({kk: vv for kk, vv in v.items()
                                  if kk not in ("dir", "last_fsync_s")}
                                 if k == "wal" else v)
                             for k, v in router.metrics().items()
                             if not isinstance(v, float)})
    finally:
        router.close_wal()


@pytest.mark.parametrize("case", sorted(_CASES))
def test_cluster_router_recovery_matches_jax(tmp_path, case):
    """``ClusterRouter(resume_wal=)`` over a fake fleet: resume in place
    with the deadline rebased, ledger replay with the folded prompt and
    the request-keyed offsets, the shed of a spent budget, the restored
    finished outcomes; the report, the submits, the ledgers, the
    outcomes and the counts equal the JAX router's over the same WAL,
    which the JAX package wrote."""
    from paddle_tpu.serving.cluster.frontend import \
        ClusterRouter as JaxRouter
    from paddle_tpu.serving.cluster.frontend import \
        WorkerHandle as JaxHandle
    from paddle_tpu.serving.cluster.wal import WriteAheadLog as JaxWal
    import shutil
    records, known = _CASES[case]
    wal = str(tmp_path / "wal")
    w = JaxWal(wal)
    for rec in records:
        w.append(rec)
    w.close()
    # each incarnation appends to the log it recovers: one copy each
    shutil.copytree(wal, str(tmp_path / "wal_port"))
    want = _recover(types.SimpleNamespace(Router=JaxRouter,
                                          Handle=JaxHandle), wal, known)
    got = _recover(types.SimpleNamespace(Router=ClusterRouter,
                                         Handle=WorkerHandle),
                   str(tmp_path / "wal_port"), known)
    assert got == want
    if case == "resume":
        assert got["report"]["resumed"] == 1 and got["submits"] == []
    if case == "replay":
        (prompt, kw), = got["submits"]
        assert prompt == [1, 2, 3, 7, 8, 9]
        assert (kw["rng_request_id"], kw["rng_tokens_emitted"]) == (0, 3)


def test_cluster_router_validation_health_and_wal_guard(tmp_path):
    with pytest.raises(ValueError, match="recover"):
        ClusterRouter(None, [], None, recover="bogus")
    with pytest.raises(ValueError, match="decode or unified"):
        ClusterRouter(None, [WorkerHandle(name="prefill0", rank=1,
                                          role="prefill", pid=1)], None)
    assert parse_cluster_spec("decode,decode,prefill") == {
        "prefill": 1, "decode": 2, "unified": 0}
    with pytest.raises(ValueError, match="no decode or unified"):
        parse_cluster_spec("prefill:2")
    agent = _FakeAgent({1: _FakeWorker(), 2: _FakeWorker()})
    hs = [WorkerHandle(name=f"decode{i}", rank=i + 1, role="decode",
                       pid=i + 1) for i in range(2)]
    router = ClusterRouter(agent, hs, _FakeElastic(["decode0", "decode1"]),
                           wal_dir=str(tmp_path / "wal"))
    assert router._health()["ok"]
    for h in hs:
        h.state = "dead"
    assert not router._health()["ok"]
    for h in hs:
        h.state = "healthy"
    router.submit(np.arange(3), 4)
    router.close_wal()
    assert not router._health()["ok"]
    with pytest.raises(ValueError, match="resume_wal"):
        ClusterRouter(agent, hs, _FakeElastic(["decode0"]),
                      wal_dir=str(tmp_path / "wal"))


# -- a port worker over a JAX-staged weights file --------------------------

def test_port_worker_serves_jax_staged_weights(tmp_path):
    """The JAX launcher's ``weights_v1.npz`` (its own expression) loads
    into a port ``WorkerHost`` on the CPU, whose submit/step ops serve
    the JAX decoder's greedy tokens; ``status`` carries the launch
    counters and the device."""
    from paddle_tpu.inference.generate import LlamaDecoder as JaxDecoder
    from paddle_tpu_torch.serving.cluster import worker as wmod
    jm = _jax_model(3)
    weights = str(tmp_path / "weights_v1.npz")
    np.savez(weights, **{k: np.asarray(v.numpy())
                         for k, v in jm.state_dict().items()})
    store = TCPStore(is_master=True)
    cfg = {"name": "decode0", "rank": 1, "world_size": 2,
           "master_host": store.host, "master_port": store.port,
           "role": "decode", "model": dict(CFG, rms_norm_eps=1e-6,
                                           rope_theta=10000.0,
                                           tie_word_embeddings=False,
                                           dtype="float32"),
           "weights": weights, "max_len": 48, "quant": None,
           "engine": {"num_slots": 2, "chunk_size": 4},
           "heartbeat_s": 0.5, "ttl_s": 3.0, "obs_port": 0,
           "device": "cpu",
           "fault_plan": [{"kind": "rpc_delay", "src": "9", "dst": "9"}]}
    host = wmod.WorkerHost(cfg)
    try:
        # the heartbeat beats on a store connection of its own, never
        # queued behind the RPC threads' native waits on the agent's
        assert host.elastic.store is not host.agent.store
        # the worker's plan arrives in its config, not the environment
        assert res.fault_injector.active()
        res.fault_injector.clear()
        reg = json.loads(store.get("cluster/worker/1"))
        assert reg["device"] == "cpu" and reg["name"] == "decode0"
        rng = np.random.default_rng(4)
        reqs = [(rng.integers(0, 64, (6,)), 7) for _ in range(3)]
        erids = [host.handle("submit", p, max_new_tokens=b)
                 for p, b in reqs]
        outs = {}
        for _ in range(20):
            for erid, kind, val, _ in host.handle("step")["finished"]:
                outs[erid] = val
            if len(outs) == len(reqs):
                break
        dec = JaxDecoder(jm, max_len=48)
        for erid, (p, b) in zip(erids, reqs):
            np.testing.assert_array_equal(
                outs[erid], np.asarray(dec.generate(p[None], b)))
        st = host.handle("status")
        assert st["device"] == "cpu"
        assert isinstance(st["launches"], dict)
        assert st["engine"]["replica_tag"] == "decode0"
    finally:
        host.handle("shutdown")
        host.elastic.stop()
        host.exporter.stop()
        host.agent.shutdown()


def test_worker_without_a_card_fails_registration_typed(tmp_path):
    """A worker asked for ``cuda`` where there is no card publishes its
    failure under its registration key and exits; the launcher's wait
    raises it as ``WorkerStartError``, never serving on the CPU."""
    import torch
    from paddle_tpu_torch.convert import save_state_npz
    from paddle_tpu_torch.serving.cluster.launch import (WorkerStartError,
                                                         _spawn_worker,
                                                         _wait_registered)
    if torch.cuda.is_available():
        pytest.skip("this host has a card")
    model = LlamaForCausalLM(LlamaConfig(**CFG), device="cpu")
    weights = save_state_npz(model, str(tmp_path / "weights_v1.npz"))
    store = TCPStore(is_master=True)
    cfg = {"name": "decode0", "rank": 1, "world_size": 2,
           "master_host": store.host, "master_port": store.port,
           "role": "decode", "model": CFG, "weights": weights,
           "max_len": 48, "engine": {}, "device": "cuda"}
    proc = _spawn_worker(cfg)
    try:
        with pytest.raises(WorkerStartError, match="no CUDA device") as ei:
            _wait_registered(store, 1, 120.0, proc)
        assert ei.value.rank == 1 and ei.value.error == "RuntimeError"
        assert proc.wait(timeout=60) != 0
    finally:
        if proc.poll() is None:
            proc.kill()


def test_store_daemon_never_imports_torch(tmp_path):
    """The store daemon runs by file path with the package stubbed: it
    serves the control plane without ``import torch`` (``-X
    importtime`` lists every module it imported)."""
    from paddle_tpu_torch.serving.cluster import store_daemon
    port_file = str(tmp_path / "port.json")
    env = dict(os.environ)
    env[store_daemon.ENV_CFG] = json.dumps({"port_file": port_file,
                                            "host": "127.0.0.1"})
    proc = subprocess.Popen(
        [sys.executable, "-X", "importtime", store_daemon.__file__],
        env=env, cwd=str(tmp_path), stderr=subprocess.PIPE, text=True)
    try:
        for _ in range(600):
            if os.path.exists(port_file) or proc.poll() is not None:
                break
            time.sleep(0.02)
        info = json.load(open(port_file))
        c = TCPStore(info["host"], int(info["port"]))
        c.set("x", b"1")
        assert c.get("x") == b"1"
    finally:
        proc.terminate()
        _, err = proc.communicate(timeout=30)
    mods = {ln.rsplit("|", 1)[-1].strip() for ln in err.splitlines()
            if ln.startswith("import time:")}
    assert "paddle_tpu_torch.native.tcp_store" in mods
    assert not any(m == "torch" or m.startswith("torch.")
                   or m == "paddle_tpu" or m.startswith("paddle_tpu.")
                   for m in mods)


# -- slow: real worker processes -------------------------------------------

def _cluster_reqs(n, seed, budgets=(6, 12)):
    rng = np.random.default_rng(seed)
    return [(rng.integers(0, 64, (6,)), int(rng.integers(*budgets)))
            for _ in range(n)]


def _solo(jm, reqs, max_len=48):
    from paddle_tpu.inference.generate import LlamaDecoder as JaxDecoder
    dec = JaxDecoder(jm, max_len=max_len)
    return [np.asarray(dec.generate(p[None], b)) for p, b in reqs]


@pytest.mark.slow
def test_cluster_disaggregated_parity_and_sigkill_replay(tmp_path):
    """prefill:1,decode:2 on the CPU: prefill dispatches only on the
    prefill worker, a real SIGKILL of decode0, its work replayed onto
    the survivor; every request equals the JAX decoder's tokens, and the
    decode-attention launches are counted per worker (0 on the CPU)."""
    jm = _jax_model(1)
    model = _port_model(jm)
    reqs = _cluster_reqs(6, 8)
    solo = _solo(jm, reqs)
    with launch_cluster(model, str(tmp_path / "cluster"), prefill=1,
                        decode=2, max_len=48, device="cpu",
                        engine_kw={"num_slots": 2, "chunk_size": 4},
                        heartbeat_s=0.3, ttl_s=2.0,
                        heartbeat_miss_threshold=1,
                        rpc_timeout_s=60.0) as cl:
        router = cl.router
        assert os.getpid() not in {h.pid for h in router.workers}
        assert len({h.pid for h in router.workers}) == 3
        rids = [router.submit(p, b) for p, b in reqs]
        outs = {}
        for _ in range(2):
            outs.update(router.step())
        cl.kill("decode0")
        time.sleep(2.5)
        outs.update(router.drain())
        m = router.metrics()
        wm = router.worker_metrics()
        text = router._scrape_worker_metrics()
    for i, rid in enumerate(rids):
        np.testing.assert_array_equal(np.asarray(outs[rid]), solo[i])
    assert m["states"]["decode0"] == "dead"
    assert m["worker_deaths"] >= 1 and m["requeued"] >= 1
    assert wm["prefill0"]["chunk_dispatches"] == 0
    assert wm["prefill0"]["prefill_dispatches"] > 0
    assert wm["decode1"]["prefill_dispatches"] == 0
    assert 'worker="decode1"' in text and 'worker="prefill0"' in text


@pytest.mark.slow
def test_cluster_restart_from_snapshot(tmp_path):
    """recover="restart": the SIGKILLed rank respawns, restores its last
    snapshot and resumes; every request equals the JAX decoder's."""
    jm = _jax_model(2)
    model = _port_model(jm)
    reqs = _cluster_reqs(4, 9)
    solo = _solo(jm, reqs)
    with launch_cluster(model, str(tmp_path / "cluster"), prefill=0,
                        decode=1, max_len=48, device="cpu",
                        engine_kw={"num_slots": 2, "chunk_size": 4},
                        snapshot_every_chunks=1, recover="restart",
                        heartbeat_s=0.3, ttl_s=2.0,
                        heartbeat_miss_threshold=1,
                        rpc_timeout_s=60.0) as cl:
        router = cl.router
        rids = [router.submit(p, b) for p, b in reqs]
        outs = {}
        for _ in range(3):
            outs.update(router.step())
        cl.kill("decode0")
        time.sleep(2.5)
        outs.update(router.drain())
        m = router.metrics()
    for i, rid in enumerate(rids):
        np.testing.assert_array_equal(np.asarray(outs[rid]), solo[i])
    assert m["worker_deaths"] >= 1 and m["worker_restarts"] >= 1
    assert m["states"]["decode0"] == "healthy"


@pytest.mark.slow
def test_cluster_rolling_restart_and_hot_reload(tmp_path):
    """Rolling restart under load loses nothing; a staged weights file
    (the port's, bf16-safe) hot-reloads through a second one."""
    jm = _jax_model(0)
    model = _port_model(jm)
    reqs = _cluster_reqs(4, 13)
    solo = _solo(jm, reqs)
    with launch_cluster(model, str(tmp_path / "roll"), prefill=0,
                        decode=2, max_len=48, device="cpu",
                        engine_kw={"num_slots": 8, "chunk_size": 4},
                        heartbeat_s=0.3, ttl_s=6.0) as cl:
        router = cl.router
        rids = [router.submit(p, b) for p, b in reqs]
        for _ in range(2):
            router.step()
        report = router.rolling_restart()
        assert len(report["restarted"]) == 2
        router.drain(max_steps=500)
        for i, rid in enumerate(rids):
            np.testing.assert_array_equal(
                np.asarray(router.outcome(rid)), solo[i])
        jm2 = _jax_model(1)
        cl.stage_weights(_port_model(jm2))
        versions_v1 = [h.weights_version for h in router.workers]
        router.rolling_restart()
        assert all(h.weights_version not in versions_v1
                   for h in router.workers)
        p, b = reqs[0]
        rid2 = router.submit(p, b)
        router.drain(max_steps=500)
        np.testing.assert_array_equal(np.asarray(router.outcome(rid2)),
                                      _solo(jm2, [(p, b)])[0])


@pytest.mark.slow
def test_frontend_sigkill_failover_parity(tmp_path):
    """SIGKILL the frontend process mid-serve (>=2 in flight, >=2
    queued); its successor recovers every accepted request as an
    undisturbed run does, both give the JAX decoder's greedy tokens, and
    the dead incarnation's epoch is refused typed."""
    from paddle_tpu_torch.serving.cluster.frontend_proc import (
        _drill_requests, run_frontend_failover_drill)
    jm = _jax_model(0)
    model = _port_model(jm)
    base = run_frontend_failover_drill(model, str(tmp_path / "base"),
                                       kill=False, max_len=48,
                                       device="cpu")
    killed = run_frontend_failover_drill(model, str(tmp_path / "kill"),
                                         kill=True, max_len=48,
                                         device="cpu")
    assert killed["ready"]["occupied"] >= 2
    assert killed["ready"]["queued"] >= 2
    assert killed["zombie_error"] == "StaleEpochError"
    rep = killed["recovery"]
    assert rep["finished_in_wal"] + rep["finished_in_gap"] \
        + rep["resumed"] + rep["replayed"] == len(base["outcomes"])
    assert rep["resumed"] >= 1      # workers survive a frontend kill
    assert killed["epoch"] > killed["ready"]["epoch"]
    for tag, out in base["outcomes"].items():
        assert killed["outcomes"][tag] == out, tag
    assert not any("unresolved" in o
                   for o in killed["outcomes"].values())
    dreqs = _drill_requests(model, len(base["outcomes"]), temperature=1.0)
    solo = _solo(jm, [(np.asarray(r["prompt"]), r["max_new_tokens"])
                      for r in dreqs])
    for r, want in zip(dreqs, solo):
        np.testing.assert_array_equal(
            np.asarray(base["outcomes"][r["tag"]]["tokens"]), want)
