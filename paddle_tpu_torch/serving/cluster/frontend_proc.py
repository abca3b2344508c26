"""Frontend-as-a-process: the control-plane failover drill harness.

Counterpart of ``paddle_tpu/serving/cluster/frontend_proc.py``. The
worker pool runs on the card unless the caller passes ``device="cpu"``;
the frontend children never touch a device.

``launch_cluster`` keeps the ClusterRouter in the CALLER's process —
convenient for benches, useless for drilling the frontend's own death
(you cannot SIGKILL yourself and then assert on the corpse). This
module runs the frontend as its own OS process against a worker pool
it did not spawn:

- :func:`launch_worker_pool` — store daemon + worker processes, NO
  frontend. The parent holds only a plain ``TCPStore`` client (never a
  rank-0 ``RpcAgent``: two rank-0 collectors would steal each other's
  replies);
- :func:`main` — the frontend child. Builds a ``ClusterRouter`` from
  the ``PADDLE_TPU_TORCH_FRONTEND_CFG`` env JSON, submits the configured
  (tagged) requests, and either serves to completion (undisturbed /
  resume runs) or pauses mid-serve: it steps until the fleet holds the
  configured in-flight + queued depth, publishes a ready file, and
  sleeps — the window in which the parent SIGKILLs it;
- :func:`run_frontend_failover_drill` — the whole drill: spawn
  incarnation 1 (WAL-armed), SIGKILL it at the ready barrier with work
  in flight AND queued, spawn incarnation 2 with ``resume=True`` (the
  router replays the WAL, re-adopts the live workers, resumes /
  replays every accepted request) and collect its outcomes; finally
  probe a worker with incarnation 1's epoch and assert the typed
  ``StaleEpochError`` refusal (the zombie fence). ``kill=False`` runs
  the identical request list undisturbed — the parity baseline.

Request lists derive from a fixed seed, so the undisturbed and killed
runs are bit-comparable tag by tag.
"""

from __future__ import annotations

import json
import os
import signal
import subprocess
import sys
import time
from typing import Any, Dict, List, Optional

import numpy as np

__all__ = ["launch_worker_pool", "WorkerPool",
           "run_frontend_failover_drill", "main"]

ENV_CFG = "PADDLE_TPU_TORCH_FRONTEND_CFG"


def _atomic_json(path: str, payload: Dict[str, Any]) -> None:
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(payload, f)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)


def build_frontend(cfg: Dict[str, Any]):
    """Construct the (router, agent, elastic) triple from a frontend
    config dict — the child process's whole boot path. ``resume=True``
    reconnects with resumed RPC counters and recovers the WAL."""
    from paddle_tpu_torch.distributed.elastic import ElasticManager
    from paddle_tpu_torch.distributed.rpc import RpcAgent
    from paddle_tpu_torch.serving.cluster.frontend import ClusterRouter
    from paddle_tpu_torch.serving.cluster.launch import adopt_worker_handles

    world = int(cfg["world_size"])
    resume = bool(cfg.get("resume"))
    agent = RpcAgent("frontend", 0, world,
                     host=str(cfg["master_host"]),
                     port=int(cfg["master_port"]),
                     is_master=False, resume=resume)
    elastic = ElasticManager(
        agent.store, node_id="frontend", np_range=f"1:{world}",
        heartbeat_s=float(cfg.get("heartbeat_s", 0.5)),
        ttl_s=float(cfg.get("ttl_s", 3.0))).start()
    handles = adopt_worker_handles(agent.store, cfg["worker_ranks"])
    kw = dict(
        rpc_timeout_s=float(cfg.get("rpc_timeout_s", 60.0)),
        breaker_threshold=int(cfg.get("breaker_threshold", 1)),
        heartbeat_miss_threshold=int(
            cfg.get("heartbeat_miss_threshold", 3)))
    wal_dir = cfg.get("wal_dir")
    if resume:
        router = ClusterRouter(agent, handles, elastic,
                               resume_wal=wal_dir, **kw)
    else:
        router = ClusterRouter(agent, handles, elastic,
                               wal_dir=wal_dir, **kw)
    return router, agent, elastic


def main(argv=None) -> int:
    raw = os.environ.get(ENV_CFG, "")
    if not raw:
        print("PADDLE_TPU_TORCH_FRONTEND_CFG is not set (the drill passes "
              "the frontend config JSON through it)", file=sys.stderr)
        return 2
    cfg = json.loads(raw)
    router, agent, elastic = build_frontend(cfg)
    try:
        for req in cfg.get("requests", []):
            router.submit(
                np.asarray(req["prompt"], np.int64),
                int(req["max_new_tokens"]),
                eos_token_id=req.get("eos_token_id"),
                temperature=float(req.get("temperature", 1.0)),
                seed=int(req.get("seed", 0)),
                deadline_s=req.get("deadline_s"),
                tag=str(req["tag"]))
        if cfg.get("ready_file"):
            # step until the fleet holds the configured depth, then
            # freeze and advertise — the parent's SIGKILL window
            min_inf = int(cfg.get("min_inflight", 2))
            min_q = int(cfg.get("min_queued", 2))
            occ = qd = 0
            for _ in range(int(cfg.get("ready_steps", 500))):
                router.step()
                occ = sum(h.occupied for h in router.workers)
                qd = sum(h.queued for h in router.workers)
                if occ >= min_inf and qd >= min_q:
                    break
            else:
                raise RuntimeError(
                    f"never reached the ready depth (occupied={occ}, "
                    f"queued={qd}, want {min_inf}/{min_q})")
            _atomic_json(cfg["ready_file"],
                         {"pid": os.getpid(), "epoch": router.epoch,
                          "occupied": occ, "queued": qd,
                          "in_flight": router.in_flight()})
            time.sleep(float(cfg.get("hold_s", 30.0)))
        router.drain(max_steps=int(cfg.get("max_steps", 5000)))
        outcomes: Dict[str, Any] = {}
        for rid, t in router._tracked.items():
            tag = t.tag if t.tag is not None else str(rid)
            oc = router.outcome(rid)
            if oc is None:
                outcomes[tag] = {"unresolved": True}
            elif isinstance(oc, BaseException):
                outcomes[tag] = {"error": type(oc).__name__,
                                 "msg": str(oc)[:300]}
            else:
                outcomes[tag] = {"tokens": np.asarray(oc).tolist()}
        _atomic_json(cfg["result_file"],
                     {"pid": os.getpid(), "epoch": router.epoch,
                      "recovery": router.recovery_report,
                      "metrics": router.metrics(),
                      "outcomes": outcomes})
        return 0
    finally:
        router.close_wal()
        elastic.stop()
        agent.shutdown()


class WorkerPool:
    """A store daemon + worker processes with NO frontend attached —
    the substrate frontends are spawned against (and SIGKILLed over)."""

    def __init__(self, store, store_proc, procs, configs, registrations,
                 host: str, port: int, world: int, workdir: str,
                 heartbeat_s: float, ttl_s: float):
        self.store = store
        self.store_proc = store_proc
        self.procs = procs
        self.configs = configs
        self.registrations = registrations
        self.host = host
        self.port = port
        self.world = world
        self.workdir = workdir
        self.heartbeat_s = heartbeat_s
        self.ttl_s = ttl_s

    @property
    def worker_ranks(self) -> List[int]:
        return sorted(self.procs)

    def frontend_cfg(self, *, resume: bool, result_file: str,
                     wal_dir: str,
                     requests: Optional[List[dict]] = None,
                     ready_file: Optional[str] = None,
                     hold_s: float = 30.0,
                     rpc_timeout_s: float = 30.0,
                     min_inflight: int = 2,
                     min_queued: int = 2) -> Dict[str, Any]:
        return {"world_size": self.world, "master_host": self.host,
                "master_port": self.port,
                "worker_ranks": self.worker_ranks,
                "heartbeat_s": self.heartbeat_s, "ttl_s": self.ttl_s,
                "rpc_timeout_s": rpc_timeout_s,
                "resume": bool(resume), "wal_dir": wal_dir,
                "requests": requests or [],
                "ready_file": ready_file, "hold_s": hold_s,
                "min_inflight": min_inflight, "min_queued": min_queued,
                "result_file": result_file}

    def spawn_frontend(self, cfg: Dict[str, Any]) -> subprocess.Popen:
        from paddle_tpu_torch.serving.cluster.launch import child_env
        env = child_env()
        env[ENV_CFG] = json.dumps(cfg)
        # -c entry for the same canonical-module reason as the workers
        return subprocess.Popen(
            [sys.executable, "-c",
             "import sys; from paddle_tpu_torch.serving.cluster."
             "frontend_proc import main; sys.exit(main())"],
            env=env, cwd=os.getcwd())

    @staticmethod
    def wait_file(path: str, timeout_s: float,
                  proc: subprocess.Popen) -> Dict[str, Any]:
        deadline = time.monotonic() + timeout_s
        while time.monotonic() < deadline:
            if os.path.exists(path):
                with open(path) as f:
                    return json.load(f)
            if proc.poll() is not None:
                raise RuntimeError(
                    f"frontend process exited with code "
                    f"{proc.returncode} before writing {path}")
            time.sleep(0.05)
        raise TimeoutError(
            f"frontend did not write {path} within {timeout_s:.0f}s")

    def probe_stale_epoch(self, stale_epoch: int,
                          rank: Optional[int] = None) -> str:
        """Impersonate the dead incarnation: issue one op stamped with
        its (now stale) epoch and return the refusal's type name —
        callers assert it is ``StaleEpochError``. Must only run while
        NO frontend child is alive (rank 0 is single-occupancy)."""
        from paddle_tpu_torch.distributed.rpc import RpcAgent
        from paddle_tpu_torch.serving.cluster.worker import worker_op
        agent = RpcAgent("frontend", 0, self.world, host=self.host,
                         port=self.port, is_master=False, resume=True)
        try:
            fut = agent.call(rank or self.worker_ranks[0], worker_op,
                             ("ping",), {"_epoch": int(stale_epoch)})
            try:
                fut.wait(20.0)
                return "NO_ERROR"
            except Exception as e:
                return type(e).__name__
        finally:
            agent.shutdown()

    def shutdown(self) -> None:
        for p in self.procs.values():
            if p.poll() is None:
                p.terminate()
        deadline = time.monotonic() + 10.0
        for p in self.procs.values():
            while p.poll() is None and time.monotonic() < deadline:
                time.sleep(0.05)
            if p.poll() is None:
                p.kill()
        if self.store_proc.poll() is None:
            self.store_proc.terminate()
            try:
                self.store_proc.wait(timeout=10)
            except subprocess.TimeoutExpired:
                self.store_proc.kill()


def launch_worker_pool(model, workdir: str, prefill: int = 1,
                       decode: int = 2, max_len: int = 256,
                       engine_kw: Optional[Dict[str, Any]] = None,
                       request_keyed_rng: bool = False,
                       heartbeat_s: float = 0.5, ttl_s: float = 3.0,
                       spawn_timeout_s: float = 180.0,
                       device: str = "cuda") -> WorkerPool:
    """``launch_cluster`` minus the router: store daemon + workers,
    parented by a process that will never serve — frontends come and
    go as separate children. ``device`` is every worker's (the card
    unless ``"cpu"``)."""
    import dataclasses as _dc

    from paddle_tpu_torch.convert import save_state_npz
    from paddle_tpu_torch.device import resolve_device

    from paddle_tpu_torch.native.tcp_store import TCPStore
    from paddle_tpu_torch.serving.cluster.launch import (
        _spawn_store_daemon, _spawn_worker, _wait_registered)

    os.makedirs(workdir, exist_ok=True)
    device = str(resolve_device(device))
    if device.startswith("cuda"):
        from paddle_tpu_torch.ops.kernels._build import library
        library()       # one build before the spawn, as launch_cluster
    weights = os.path.join(workdir, "weights_v1.npz")
    save_state_npz(model, weights)
    model_cfg = _dc.asdict(model.config)

    roles = ["prefill"] * int(prefill) + ["decode"] * int(decode)
    if prefill + decode < 1:
        raise ValueError("launch_worker_pool needs at least one worker")
    world = 1 + len(roles)
    store_proc, host, port = _spawn_store_daemon(workdir)
    store = TCPStore(host=host, port=port, is_master=False)

    counts: Dict[str, int] = {}
    procs: Dict[int, subprocess.Popen] = {}
    configs: Dict[int, dict] = {}
    for i, role in enumerate(roles):
        rank = i + 1
        counts[role] = counts.get(role, 0)
        name = f"{role}{counts[role]}"
        counts[role] += 1
        ekw = dict(engine_kw or {})
        if role == "prefill":
            ekw = {"num_slots": 1, "chunk_size": ekw.get("chunk_size", 8)}
        else:
            ekw.setdefault("prefix_cache", True)
            ekw["request_keyed_rng"] = bool(request_keyed_rng)
        cfg = {"name": name, "rank": rank, "world_size": world,
               "master_host": host, "master_port": port,
               "role": role, "model": model_cfg, "weights": weights,
               "max_len": int(max_len), "quant": None, "engine": ekw,
               "heartbeat_s": heartbeat_s, "ttl_s": ttl_s,
               "obs_port": 0, "device": device}
        configs[rank] = cfg
        procs[rank] = _spawn_worker(cfg)

    registrations: Dict[int, dict] = {}
    try:
        for rank in sorted(procs):
            registrations[rank] = _wait_registered(
                store, rank, spawn_timeout_s, procs[rank])
    except Exception:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
        if store_proc.poll() is None:
            store_proc.kill()
        raise
    return WorkerPool(store, store_proc, procs, configs, registrations,
                      host, port, world, workdir, heartbeat_s, ttl_s)


def _drill_requests(model, n: int, temperature: float,
                    max_new_tokens: int = 12,
                    prompt_len: int = 6) -> List[dict]:
    """Deterministic tagged request list (fixed generator seed): the
    undisturbed and killed runs submit bit-identical work."""
    vocab = int(model.config.vocab_size)
    rng = np.random.default_rng(20180807)
    return [{"tag": f"req{i}",
             "prompt": rng.integers(1, vocab, size=prompt_len).tolist(),
             "max_new_tokens": int(max_new_tokens),
             "temperature": float(temperature), "seed": int(i)}
            for i in range(n)]


def run_frontend_failover_drill(
        model, workdir: str, *, prefill: int = 1, decode: int = 2,
        n_requests: int = 8, kill: bool = True, sampled: bool = False,
        max_new_tokens: int = 12, num_slots: int = 2,
        chunk_size: int = 4, max_len: int = 256,
        requests: Optional[List[dict]] = None,
        rpc_timeout_s: float = 30.0, heartbeat_s: float = 0.5,
        ttl_s: float = 3.0, hold_s: float = 30.0,
        spawn_timeout_s: float = 180.0,
        wait_timeout_s: float = 240.0,
        device: str = "cuda") -> Dict[str, Any]:
    """The full control-plane failover drill. ``kill=True``: frontend
    incarnation 1 is SIGKILLed at the ready barrier (≥2 in flight, ≥2
    queued), incarnation 2 recovers from the WAL and serves to
    completion, then a stale-epoch zombie op is probed. ``kill=False``:
    one frontend serves the identical request list undisturbed.
    ``requests`` replaces the drill's own ``n_requests`` prompts with
    tagged request dicts (``tag``, ``prompt``, ``max_new_tokens`` and
    optionally ``eos_token_id``, ``temperature``, ``seed``).
    Returns ``{"outcomes", "recovery", "ready", "zombie_error",
    "metrics", "epoch"}`` (ready/zombie None when kill=False)."""
    ekw: Dict[str, Any] = {"num_slots": int(num_slots),
                           "chunk_size": int(chunk_size)}
    if sampled:
        ekw["do_sample"] = True
    pool = launch_worker_pool(
        model, workdir, prefill=prefill, decode=decode, max_len=max_len,
        engine_kw=ekw, request_keyed_rng=sampled,
        heartbeat_s=heartbeat_s, ttl_s=ttl_s,
        spawn_timeout_s=spawn_timeout_s, device=device)
    try:
        if requests is None:
            requests = _drill_requests(
                model, n_requests, temperature=0.8 if sampled else 1.0,
                max_new_tokens=max_new_tokens)
        wal_dir = os.path.join(workdir, "frontend_wal")
        if not kill:
            res_file = os.path.join(workdir, "result_undisturbed.json")
            cfg = pool.frontend_cfg(
                resume=False, result_file=res_file, wal_dir=wal_dir,
                requests=requests, rpc_timeout_s=rpc_timeout_s)
            p = pool.spawn_frontend(cfg)
            result = pool.wait_file(res_file, wait_timeout_s, p)
            p.wait(timeout=30)
            return {"outcomes": result["outcomes"], "recovery": None,
                    "ready": None, "zombie_error": None,
                    "metrics": result["metrics"],
                    "epoch": result["epoch"]}
        ready_file = os.path.join(workdir, "ready.json")
        res_file = os.path.join(workdir, "result_recovered.json")
        cfg1 = pool.frontend_cfg(
            resume=False, result_file=os.path.join(workdir, "_unused"),
            wal_dir=wal_dir, requests=requests, ready_file=ready_file,
            hold_s=hold_s, rpc_timeout_s=rpc_timeout_s)
        p1 = pool.spawn_frontend(cfg1)
        ready = pool.wait_file(ready_file, wait_timeout_s, p1)
        # the crash: a REAL SIGKILL mid-serve, work in flight AND queued
        os.kill(p1.pid, signal.SIGKILL)
        p1.wait(timeout=30)
        cfg2 = pool.frontend_cfg(
            resume=True, result_file=res_file, wal_dir=wal_dir,
            rpc_timeout_s=rpc_timeout_s)
        p2 = pool.spawn_frontend(cfg2)
        result = pool.wait_file(res_file, wait_timeout_s, p2)
        p2.wait(timeout=30)
        # the fence: impersonate the dead incarnation
        zombie = pool.probe_stale_epoch(int(ready["epoch"]))
        return {"outcomes": result["outcomes"],
                "recovery": result["recovery"], "ready": ready,
                "zombie_error": zombie, "metrics": result["metrics"],
                "epoch": result["epoch"]}
    finally:
        pool.shutdown()
