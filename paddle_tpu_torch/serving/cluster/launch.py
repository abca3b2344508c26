"""Cluster launcher: spawn the worker pool, return the routed handle.

Counterpart of ``paddle_tpu/serving/cluster/launch.py``. The workers run
on the card (``device="cuda"``) unless the caller passes
``device="cpu"``; on a card the launcher builds the kernel library once
before it spawns them, so N workers do not each run nvcc. A worker that
cannot start (no card, no loadable kernel library) publishes its failure
under its registration key, and the launcher raises it as a typed
:class:`WorkerStartError`. The port reads none of the JAX package's
environment: a worker's config rides ``PADDLE_TPU_TORCH_CLUSTER_CFG``
and its fault plan rides the config's ``fault_plan`` key.

``launch_cluster(model, workdir, prefill=1, decode=2)`` is the whole
zero-to-cluster path:

1. the model's weights are saved ONCE as ``workdir/weights.npz`` —
   every worker rebuilds the identical parameters from it (and the
   caller's in-process reference decodes the same ones: the greedy-
   parity precondition);
2. a tiny store DAEMON process (``store_daemon.py``) hosts the
   TCPStore the whole cluster shares — RPC streams, elastic
   heartbeats and registration all ride it, no second control plane.
   The frontend's rank-0 ``RpcAgent`` connects as a plain client, so
   frontend SIGKILL no longer kills the rendezvous: workers keep
   heartbeating and a respawned ``ClusterRouter(resume_wal=...)``
   re-adopts them (see ``frontend_proc.py``);
3. one OS process per worker (stdlib ``subprocess.Popen`` of
   ``python -m paddle_tpu_torch.serving.cluster.worker``) with its whole
   config in the ``PADDLE_TPU_TORCH_CLUSTER_CFG`` env JSON; the launcher
   blocks on each worker's ``cluster/worker/<rank>`` registration key;
4. a :class:`ClusterRouter` over the registered handles, wired with
   the launcher's ``respawn`` hook so ``recover="restart"`` can bring
   a SIGKILLed rank back from its snapshot.

The :class:`Cluster` handle keeps the process table for the fault
drills (``kill(name)`` is a REAL ``SIGKILL``) and tears everything
down in ``shutdown()`` (graceful RPC shutdown, then SIGTERM, then
SIGKILL — bounded, never hangs a bench).

Weights are staged VERSIONED (``weights_v1.npz``, ``weights_v2.npz``,
…): every worker config points at a staged file, and
``Cluster.stage_weights(model)`` writes the next version and repoints
the configs — the next respawn (a ``rolling_restart`` leg, or a crash
restart) rebuilds from the new file. That is the whole hot-weight-
reload mechanism: no push protocol, the worker lifecycle IS the reload.
Each worker reports a content-derived ``weights_version`` at
registration, which the router uses to refuse mixed-version migration.
"""

from __future__ import annotations

import json
import os
import signal
import subprocess
import sys
import time
from typing import Any, Dict, List, Optional

from paddle_tpu_torch.convert import save_state_npz
from paddle_tpu_torch.device import resolve_device
from paddle_tpu_torch.serving.cluster.frontend import (ClusterRouter,
                                                      WorkerHandle)

__all__ = ["Cluster", "launch_cluster", "parse_cluster_spec",
           "adopt_worker_handles", "WorkerStartError"]


class WorkerStartError(RuntimeError):
    """A cluster worker failed before it registered (no card, a kernel
    library that does not build or load, weights that do not fit the
    model): carries the worker's rank and its own error."""

    def __init__(self, message: str, rank: Optional[int] = None,
                 error: Optional[str] = None):
        super().__init__(message)
        self.rank = rank
        self.error = error


def parse_cluster_spec(spec: str) -> Dict[str, int]:
    """``"prefill:1,decode:2"`` -> ``{"prefill": 1, "decode": 2}``
    (roles: prefill/decode/unified; omitted roles default to 0)."""
    out = {"prefill": 0, "decode": 0, "unified": 0}
    for part in str(spec).split(","):
        part = part.strip()
        if not part:
            continue
        role, _, n = part.partition(":")
        role = role.strip()
        if role not in out:
            raise ValueError(
                f"unknown cluster role {role!r} in {spec!r} "
                f"(prefill|decode|unified)")
        out[role] += int(n or 1)
    if out["decode"] + out["unified"] < 1:
        raise ValueError(
            f"cluster spec {spec!r} has no decode or unified worker")
    return out


class Cluster:
    """A running worker pool + its router. Context-manager friendly."""

    def __init__(self, router: ClusterRouter, agent, elastic,
                 procs: Dict[int, subprocess.Popen],
                 configs: Dict[int, dict], spawn_timeout_s: float,
                 workdir: Optional[str] = None, weights_seq: int = 1,
                 store_proc: Optional[subprocess.Popen] = None):
        self.router = router
        self.agent = agent
        self.elastic = elastic
        self.procs = procs
        self.configs = configs
        self._spawn_timeout_s = float(spawn_timeout_s)
        self.workdir = workdir
        self._weights_seq = int(weights_seq)
        self.store_proc = store_proc

    # -- fault drills ------------------------------------------------------
    def handle(self, name: str) -> WorkerHandle:
        for h in self.router.workers:
            if h.name == name:
                return h
        raise ValueError(f"no worker named {name!r}")

    def kill(self, name: str) -> int:
        """SIGKILL a worker process — the REAL crash drill (no flag,
        no injected exception: the OS process is gone). Returns the
        killed pid."""
        h = self.handle(name)
        pid = h.pid
        os.kill(pid, signal.SIGKILL)
        self.procs[h.rank].wait(timeout=30)
        return pid

    def respawn(self, h: WorkerHandle) -> dict:
        """Restart a dead worker's rank (the ClusterRouter's
        ``recover="restart"`` hook): same config + ``resume=True`` RPC
        counters, blocking on the fresh registration."""
        cfg = dict(self.configs[h.rank])
        cfg["resume"] = True
        old = self.procs.get(h.rank)
        if old is not None and old.poll() is None:
            old.kill()
            old.wait(timeout=30)
        # the dead incarnation's registration must not satisfy the wait
        self.agent.store.set(f"cluster/worker/{h.rank}", b"")
        self.procs[h.rank] = _spawn_worker(cfg)
        info = _wait_registered(self.agent.store, h.rank,
                                self._spawn_timeout_s,
                                self.procs[h.rank])
        return info

    def stage_weights(self, model) -> str:
        """Write the model's parameters as the NEXT versioned weights
        file and repoint every worker config at it. Nothing restarts
        here: each worker picks the staged file up on its next respawn
        — ``router.rolling_restart()`` right after this call IS the
        zero-downtime hot weight reload. Returns the staged path."""
        if self.workdir is None:
            raise RuntimeError(
                "stage_weights needs the launch workdir (clusters built "
                "by launch_cluster have it)")
        self._weights_seq += 1
        path = os.path.join(self.workdir,
                            f"weights_v{self._weights_seq}.npz")
        save_state_npz(model, path)
        for cfg in self.configs.values():
            cfg["weights"] = path
        return path

    # -- lifecycle ---------------------------------------------------------
    def shutdown(self) -> None:
        for h in self.router.workers:
            if h.state == "dead":
                continue
            try:
                self.router._call(h, "shutdown", timeout=5.0)
            except Exception:
                pass
        deadline = time.monotonic() + 10.0
        for p in self.procs.values():
            if p.poll() is None:
                try:
                    p.terminate()
                except Exception:
                    pass
        for p in self.procs.values():
            while p.poll() is None and time.monotonic() < deadline:
                time.sleep(0.05)
            if p.poll() is None:
                p.kill()
        self.router.stop_exporter()
        self.router.close_wal()
        self.elastic.stop()
        self.agent.shutdown()
        # the rendezvous dies LAST: everything above still rides it
        if self.store_proc is not None and self.store_proc.poll() is None:
            self.store_proc.terminate()
            try:
                self.store_proc.wait(timeout=10)
            except subprocess.TimeoutExpired:
                self.store_proc.kill()

    def __enter__(self) -> "Cluster":
        return self

    def __exit__(self, *exc) -> None:
        self.shutdown()


def child_env() -> Dict[str, str]:
    """The environment of a spawned worker or frontend: this one, with
    the directory that holds this ``paddle_tpu_torch`` first on
    ``PYTHONPATH``, so the child imports the same package from any
    working directory."""
    root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.dirname(os.path.abspath(__file__)))))
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in (root, env.get("PYTHONPATH")) if p)
    return env


def _spawn_worker(cfg: dict) -> subprocess.Popen:
    env = child_env()
    env["PADDLE_TPU_TORCH_CLUSTER_CFG"] = json.dumps(cfg)
    # -c entry (not -m): the worker module must run as its CANONICAL
    # import so the RPC stream's unpickled worker_op sees the singleton
    return subprocess.Popen(
        [sys.executable, "-c",
         "import sys; from paddle_tpu_torch.serving.cluster.worker import "
         "main; sys.exit(main())"],
        env=env, cwd=os.getcwd())


def _wait_registered(store, rank: int, timeout_s: float,
                     proc: subprocess.Popen) -> dict:
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        if proc.poll() is not None:
            raise RuntimeError(
                f"cluster worker rank {rank} exited with code "
                f"{proc.returncode} before registering")
        raw = store.get(f"cluster/worker/{rank}")
        if raw:
            info = json.loads(raw.decode())
            if "error" in info:
                raise WorkerStartError(
                    f"cluster worker rank {rank} ({info.get('name')}) "
                    f"failed to start: {info['error']}: "
                    f"{info.get('message', '')}", rank=rank,
                    error=info["error"])
            return info
        time.sleep(0.05)
    raise TimeoutError(
        f"cluster worker rank {rank} did not register within "
        f"{timeout_s:.0f}s")


def _spawn_store_daemon(workdir: str, timeout_s: float = 30.0):
    """Start the standalone TCPStore rendezvous process and block until
    it publishes its port file. Returns ``(proc, host, port)``."""
    from paddle_tpu_torch.serving.cluster import store_daemon

    port_file = os.path.join(workdir, "store_daemon.json")
    try:
        os.remove(port_file)
    except FileNotFoundError:
        pass
    env = dict(os.environ)
    env[store_daemon.ENV_CFG] = json.dumps(
        {"port_file": port_file, "host": "127.0.0.1"})
    proc = subprocess.Popen([sys.executable, store_daemon.__file__],
                            env=env, cwd=os.getcwd())
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        if proc.poll() is not None:
            raise RuntimeError(
                f"store daemon exited with code {proc.returncode} "
                f"before publishing its port")
        if os.path.exists(port_file):
            info = json.load(open(port_file))
            return proc, info["host"], int(info["port"])
        time.sleep(0.02)
    proc.kill()
    raise TimeoutError(
        f"store daemon did not publish {port_file} within "
        f"{timeout_s:.0f}s")


def adopt_worker_handles(store, ranks) -> List[WorkerHandle]:
    """Rebuild :class:`WorkerHandle`\\ s from the live registration keys
    — the respawned frontend's view of the fleet it did not spawn.
    Ranks whose registration is missing/blank are skipped (the caller
    reconciles against the WAL's worker set)."""
    handles: List[WorkerHandle] = []
    for rank in sorted(int(r) for r in ranks):
        raw = store.get(f"cluster/worker/{rank}")
        if not raw:
            continue
        info = json.loads(raw.decode())
        handles.append(WorkerHandle(
            name=info["name"], rank=rank, role=info["role"],
            pid=int(info["pid"]),
            obs_port=int(info.get("obs_port", 0)),
            weights_version=info.get("weights_version")))
    return handles


def launch_cluster(model, workdir: str, prefill: int = 1,
                   decode: int = 2, unified: int = 0,
                   max_len: int = 256, quant: Optional[str] = None,
                   engine_kw: Optional[Dict[str, Any]] = None,
                   request_keyed_rng: bool = False,
                   snapshot_every_chunks: int = 0,
                   recover: str = "replay",
                   heartbeat_s: float = 0.5, ttl_s: float = 3.0,
                   rpc_timeout_s: float = 60.0,
                   breaker_threshold: int = 1,
                   heartbeat_miss_threshold: int = 3,
                   suspect_after_s: Optional[float] = None,
                   spawn_timeout_s: float = 180.0,
                   device: str = "cuda") -> Cluster:
    """Spawn ``prefill + decode + unified`` worker processes serving
    ``model`` and return the routed :class:`Cluster`.

    ``engine_kw`` applies to the decode/unified engines (num_slots,
    chunk_size, do_sample, …); prefill workers run a minimal engine
    (they only ever ``prefill_extract``). ``snapshot_every_chunks > 0``
    arms per-decode-worker snapshot cadence under
    ``workdir/snap_<name>`` — the ``recover="restart"`` substrate.
    ``suspect_after_s`` arms proactive evacuation: a worker whose
    heartbeat goes stale past it (but is not yet TTL-dead) is marked
    suspect and its in-flight work migrated to peers. ``device`` is every
    worker's (``"cuda"`` unless the caller asks for ``"cpu"``).
    """
    import dataclasses as _dc

    from paddle_tpu_torch.distributed.elastic import ElasticManager
    from paddle_tpu_torch.distributed.rpc import RpcAgent

    os.makedirs(workdir, exist_ok=True)
    device = str(resolve_device(device))
    if device.startswith("cuda"):
        # one build before the spawn: N workers then load it, none
        # compiles (a failed build raises here, before any worker)
        from paddle_tpu_torch.ops.kernels._build import library
        library()
    weights = os.path.join(workdir, "weights_v1.npz")
    save_state_npz(model, weights)
    model_cfg = _dc.asdict(model.config)

    roles: List[str] = (["prefill"] * int(prefill)
                        + ["decode"] * int(decode)
                        + ["unified"] * int(unified))
    if not roles:
        raise ValueError("launch_cluster needs at least one worker")
    world = 1 + len(roles)
    store_proc, store_host, store_port = _spawn_store_daemon(workdir)
    agent = RpcAgent("frontend", 0, world, host=store_host,
                     port=store_port, is_master=False)
    elastic = ElasticManager(agent.store, node_id="frontend",
                             np_range=f"1:{world}",
                             heartbeat_s=heartbeat_s,
                             ttl_s=ttl_s).start()

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
            if snapshot_every_chunks:
                ekw["snapshot_every_chunks"] = int(snapshot_every_chunks)
                ekw["snapshot_dir"] = os.path.join(workdir,
                                                   f"snap_{name}")
        cfg = {"name": name, "rank": rank, "world_size": world,
               "master_host": store_host,
               "master_port": store_port,
               "role": role, "model": model_cfg, "weights": weights,
               "max_len": int(max_len), "quant": quant, "engine": ekw,
               "heartbeat_s": heartbeat_s, "ttl_s": ttl_s,
               "obs_port": 0, "device": device}
        configs[rank] = cfg
        procs[rank] = _spawn_worker(cfg)

    handles: List[WorkerHandle] = []
    try:
        for rank in sorted(procs):
            info = _wait_registered(agent.store, rank, spawn_timeout_s,
                                    procs[rank])
            handles.append(WorkerHandle(
                name=info["name"], rank=rank, role=info["role"],
                pid=int(info["pid"]),
                obs_port=int(info.get("obs_port", 0)),
                snapshot_dir=configs[rank]["engine"].get("snapshot_dir"),
                weights_version=info.get("weights_version")))
    except Exception:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
        elastic.stop()
        agent.shutdown()
        if store_proc.poll() is None:
            store_proc.kill()
        raise

    router = ClusterRouter(
        agent, handles, elastic, rpc_timeout_s=rpc_timeout_s,
        breaker_threshold=breaker_threshold,
        heartbeat_miss_threshold=heartbeat_miss_threshold,
        recover=recover, suspect_after_s=suspect_after_s,
        wal_dir=os.path.join(workdir, "frontend_wal"))
    cluster = Cluster(router, agent, elastic, procs, configs,
                      spawn_timeout_s, workdir=workdir, weights_seq=1,
                      store_proc=store_proc)
    router._respawn = cluster.respawn
    return cluster
