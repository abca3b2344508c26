"""Cluster worker: one OS process, one ServingEngine, RPC-served.

Counterpart of ``paddle_tpu/serving/cluster/worker.py``. Runnable module
(``python -m paddle_tpu_torch.serving.cluster.worker``); the launcher
passes everything through the ``PADDLE_TPU_TORCH_CLUSTER_CFG`` env var as
one JSON document (name/rank/world, the master store endpoint, the role,
the model config + weights npz path, engine kwargs, the ``device`` —
``"cuda"`` unless the caller asked for ``"cpu"`` — and an optional
``fault_plan``). The process builds its model from the shipped weights
(``convert.load_state_npz``: every worker and the frontend's in-process
reference decode the SAME parameters, bit for bit in bf16 too, the
greedy-parity precondition) on its device — on a card it loads the
kernel library first, so a worker that cannot launch its kernels never
registers as serving: it publishes the typed failure under its
registration key and exits — then serves ops over the TCPStore-backed
``RpcAgent`` request stream:

``submit``/``step``/``result`` — the serving loop, driven entirely by
the frontend (a worker never steps itself: chunk cadence is a routing
decision). ``step`` returns the finished outcomes AND the in-flight
tokens-so-far of every occupied slot — the frontend's replay ledger is
rebuilt every step, so a SIGKILLed worker's accepted work is already
in the frontend's hands. ``prefill``/``load_slab`` — the disaggregation
pair (prefill_extract / load_prefix_slab). ``snapshot``/``restore`` —
the crash-recovery pair (atomic manifest discipline). ``stall`` — a
drill hook: the RpcAgent serves ops SERIALLY, so one stalled op makes
every later future time out (the frontend_rpc_timeout drill).

Liveness: an ``ElasticManager`` heartbeat thread (nonce:seq over the
shared store, on a store connection of its own; observer-local
monotonic TTL) — the frontend treats a missed PROCESS heartbeat as real
replica death, exactly like the reference's elastic fleet. Telemetry: the worker's own ``ObsExporter``
serves /metrics (engine registry labelled ``{worker="<name>"}``) and
/statusz on an ephemeral port registered alongside the worker.

A restarted worker (the recover-from-snapshot drill) reuses its dead
incarnation's rank with ``resume=True`` — the RPC counters skip to the
store's high-water marks, so calls addressed to the dead incarnation
stay unanswered instead of being double-served.
"""

from __future__ import annotations

import json
import os
import signal
import sys
import threading
import time
from typing import Any, Dict, Optional

import numpy as np
import torch

from paddle_tpu_torch.runtime.resilience import StaleEpochError

__all__ = ["WorkerHost", "worker_op", "main", "launch_totals"]

_HOST: Optional["WorkerHost"] = None


def launch_totals() -> Dict[str, int]:
    """This process's kernel launch counters, ``{"module.counter": n}``
    (a dict counter's entries as ``"module.counter.key"``), from the
    wrappers' plain integer counts (``ops/kernels``)."""
    from paddle_tpu_torch.ops.kernels import launch_counts
    return {".".join(str(p) for p in k): int(n)
            for k, n in sorted(launch_counts().items(), key=str)}


def worker_op(name: str, *args, **kwargs):
    """The one RPC entry point (module-level: picklable by reference).
    Dispatches to the process-singleton :class:`WorkerHost`."""
    if _HOST is None:
        raise RuntimeError(
            "cluster worker not initialized in this process (worker_op "
            "is served by `python -m "
            "paddle_tpu_torch.serving.cluster.worker`)")
    return _HOST.handle(name, *args, **kwargs)


class WorkerHost:
    """The process-singleton worker state: engine + agent + heartbeat +
    exporter, with the op table the RPC stream dispatches into."""

    def __init__(self, cfg: Dict[str, Any], resume: bool = False):
        from paddle_tpu_torch.convert import load_state_npz
        from paddle_tpu_torch.device import resolve_device
        from paddle_tpu_torch.distributed.elastic import ElasticManager
        from paddle_tpu_torch.distributed.rpc import RpcAgent
        from paddle_tpu_torch.inference.generate import LlamaDecoder
        from paddle_tpu_torch.models.llama import (LlamaConfig,
                                                   LlamaForCausalLM)
        from paddle_tpu_torch.native.tcp_store import TCPStore
        from paddle_tpu_torch.obs.exporter import ObsExporter
        from paddle_tpu_torch.runtime.resilience import fault_injector
        from paddle_tpu_torch.serving.engine import ServingEngine

        self.cfg = cfg
        self.name = str(cfg["name"])
        self.rank = int(cfg["rank"])
        self.role = str(cfg.get("role", "unified"))
        if self.role not in ("prefill", "decode", "unified"):
            raise ValueError(
                f"worker role must be prefill|decode|unified, "
                f"got {self.role!r}")
        self._stop = threading.Event()
        if cfg.get("fault_plan"):
            # the port's injector reads no environment: the plan rides
            # the config
            fault_injector.configure(cfg["fault_plan"])
        self.device = resolve_device(cfg.get("device", "cuda"))
        if self.device.type == "cuda":
            # the kernels this engine launches: a library that does not
            # build or load is this worker's startup failure, never a
            # reason to serve through the plain versions
            from paddle_tpu_torch.ops.kernels._build import library
            library()

        # model from the shipped weights: identical params fleet-wide.
        # The version is content-derived (digest of the npz bytes), so a
        # hot-reloaded worker reports a NEW version without any registry
        # — the frontend's mixed-version migration check keys on it.
        import hashlib
        with open(cfg["weights"], "rb") as f:
            self.weights_version = ("sha256:"
                                    + hashlib.sha256(f.read())
                                      .hexdigest()[:12])
        model = LlamaForCausalLM(LlamaConfig(**cfg["model"]),
                                 device=self.device)
        load_state_npz(cfg["weights"], model)
        dec = LlamaDecoder(model, max_len=int(cfg.get("max_len", 256)),
                           quant=cfg.get("quant"), device=self.device)
        ekw = dict(cfg.get("engine") or {})
        if self.role == "prefill":
            # a prefill worker only ever runs prefill_extract: no slots
            # turn over, no prefix cache to ingest into
            ekw.pop("request_keyed_rng", None)
            ekw.pop("snapshot_every_chunks", None)
            ekw.pop("snapshot_dir", None)
        self.engine = ServingEngine(dec, replica_tag=self.name, **ekw)

        # control plane: the RPC stream and the heartbeat over the same
        # store, the heartbeat on a connection of its own: the agent's
        # serve and reply threads poll their connection with native waits
        # of up to 250 ms that hold its one lock back to back, and a beat
        # queued behind them can miss the TTL on a loaded host
        self.agent = RpcAgent(self.name, self.rank,
                              int(cfg["world_size"]),
                              host=str(cfg["master_host"]),
                              port=int(cfg["master_port"]),
                              is_master=False, resume=resume)
        self.elastic = ElasticManager(
            TCPStore(str(cfg["master_host"]), int(cfg["master_port"])),
            node_id=self.name,
            np_range=f"1:{int(cfg['world_size'])}",
            heartbeat_s=float(cfg.get("heartbeat_s", 0.5)),
            ttl_s=float(cfg.get("ttl_s", 3.0))).start()

        # frontend-epoch fence: read (add 0) the shared monotonic epoch
        # counter — each ClusterRouter incarnation claims the next value
        # and stamps it on every op; this worker tracks the HIGHEST
        # epoch it has seen and refuses anything older (a zombie
        # frontend that was declared dead but keeps issuing ops).
        self.frontend_epoch = int(
            self.agent.store.add("cluster/frontend/epoch", 0))
        # submit dedupe: (frontend rid, tokens already emitted) → engine
        # rid, so a duplicated/ghost submit (rpc_duplicate drill, or a
        # requeue whose original submit actually landed) never occupies
        # a second slot with the same request
        self._submit_seen: Dict[tuple, int] = {}

        # the worker's own pull telemetry: /metrics + /statusz, every
        # sample line labelled with the worker's name so the frontend
        # can concatenate N workers into one fleet exposition verbatim
        self.exporter = ObsExporter(port=int(cfg.get("obs_port", 0)))
        self.exporter.add_engine(self.engine, name=self.name,
                                 labels={"worker": self.name})
        self.exporter.add_status_provider(
            "worker", lambda: {"name": self.name, "role": self.role,
                               "rank": self.rank, "pid": os.getpid(),
                               "device": str(self.device),
                               "weights_version": self.weights_version,
                               "launches": launch_totals()})
        self.exporter.set_health_provider(self._health)
        self.obs_port = self.exporter.start()

        # registration: the launcher's readiness barrier
        self.agent.store.set(
            f"cluster/worker/{self.rank}",
            json.dumps({"name": self.name, "role": self.role,
                        "rank": self.rank, "pid": os.getpid(),
                        "obs_port": self.obs_port,
                        "weights_version": self.weights_version,
                        "epoch": self.frontend_epoch,
                        "device": str(self.device),
                        "resumed": bool(resume)}).encode())

    def _health(self) -> Dict[str, Any]:
        """/healthz verdict: serving until shutdown flips the flag."""
        sch = self.engine.scheduler
        return {"ok": not self._stop.is_set(), "name": self.name,
                "role": self.role,
                "weights_version": self.weights_version,
                "queued": len(sch),
                "occupied": len(sch.slots.occupied())}

    # -- op dispatch -------------------------------------------------------
    def handle(self, name: str, *args, **kwargs):
        epoch = kwargs.pop("_epoch", None)
        if epoch is not None:
            epoch = int(epoch)
            if epoch < self.frontend_epoch:
                # a zombie incarnation of the control plane: it was
                # declared dead and replaced (a newer epoch already
                # stamped an op here), but its process is still issuing
                # ops — refuse typed so it can never double-serve
                raise StaleEpochError(
                    f"worker {self.name}: op {name!r} from stale "
                    f"frontend epoch {epoch} refused (current epoch "
                    f"{self.frontend_epoch}) — zombie frontend fenced",
                    op=name, stale_epoch=epoch,
                    current_epoch=self.frontend_epoch)
            if epoch > self.frontend_epoch:
                self.frontend_epoch = epoch
        fn = getattr(self, f"op_{name}", None)
        if fn is None:
            raise ValueError(f"worker {self.name}: unknown op {name!r}")
        return fn(*args, **kwargs)

    def op_ping(self):
        return {"name": self.name, "role": self.role, "pid": os.getpid(),
                "weights_version": self.weights_version}

    def op_submit(self, prompt, **kwargs) -> int:
        key = None
        rid = kwargs.get("rng_request_id")
        if rid is not None:
            key = (int(rid), int(kwargs.get("rng_tokens_emitted") or 0))
            erid = self._submit_seen.get(key)
            # the cached engine rid answers the duplicate ONLY while
            # this engine still accounts for it — a row released by
            # extract_rows (migrated away, then legitimately requeued
            # back here) must fall through to a fresh submit
            if erid is not None and erid in self.op_known():
                return erid
        erid = self.engine.submit(np.asarray(prompt), **kwargs)
        if key is not None:
            self._submit_seen[key] = erid
        return erid

    def op_step(self) -> Dict[str, Any]:
        """One engine iteration. Ships (a) the finished outcomes —
        tokens ride as a plain array + the resilience dict, re-wrapped
        frontend-side (a GenerateResult's attribute does not survive
        pickle) — and (b) every occupied slot's tokens-so-far, the
        frontend's replay ledger for THIS worker's next crash."""
        finished = []
        for erid, res in self.engine.step():
            if isinstance(res, BaseException):
                finished.append((int(erid), "error", res, None))
            else:
                finished.append((int(erid), "tokens", np.asarray(res),
                                 getattr(res, "resilience", None)))
        inflight = {int(req.id): np.asarray(toks)
                    for req, toks, _ in self.engine.export_inflight()}
        sch = self.engine.scheduler
        return {"finished": finished, "inflight": inflight,
                "queued": len(sch),
                "occupied": len(sch.slots.occupied())}

    def op_result(self, erid: int):
        res = self.engine.result(int(erid))
        if res is None or isinstance(res, BaseException):
            return res
        return (np.asarray(res), getattr(res, "resilience", None))

    def op_known(self):
        """Engine request ids THIS incarnation can still account for
        (finished results + in-flight slots + queue) — the frontend's
        restart-recovery reconciliation set. A tracked id absent here
        was accepted after the snapshot this incarnation restored from:
        the frontend replays it from its own ledger instead."""
        ids = {int(k) for k in self.engine._results}
        for _, slot in self.engine.scheduler.slots.occupied():
            ids.add(int(slot.request.id))
        for req in self.engine.scheduler.queued():
            ids.add(int(req.id))
        return ids

    def op_adopt(self) -> Dict[str, Any]:
        """The respawned frontend's reconciliation handshake: everything
        it needs to fold this live worker back under management —
        identity, the engine ids this incarnation can still account for
        (WAL rows matching one RESUME in place; the rest ledger-replay),
        and current load."""
        sch = self.engine.scheduler
        return {"name": self.name, "role": self.role,
                "rank": self.rank, "pid": os.getpid(),
                "epoch": self.frontend_epoch,
                "weights_version": self.weights_version,
                "known": sorted(self.op_known()),
                "queued": len(sch),
                "occupied": len(sch.slots.occupied())}

    def op_prefill(self, prompt) -> Dict[str, Any]:
        return self.engine.prefill_extract(np.asarray(prompt))

    def op_load_slab(self, payload: Dict[str, Any]) -> bool:
        self.engine.load_prefix_slab(payload)
        return True

    def op_extract_rows(self, request_ids) -> Dict[str, Any]:
        """Live-migration source: serialize + RELEASE the selected
        requests (engine ownership leaves with the payload; the chunked
        RPC reply channel sha256-verifies every part in transit)."""
        return self.engine.extract_rows(request_ids)

    def op_absorb_rows(self, payload: Dict[str, Any]) -> Dict[int, int]:
        """Live-migration destination: scatter the shipped rows into
        free slots; returns {source engine id: this engine's id}."""
        return self.engine.absorb_rows(payload)

    def op_snapshot(self, path: str) -> str:
        return self.engine.snapshot(path)

    def op_restore(self, path: str) -> Dict[str, int]:
        return self.engine.restore(path)

    def op_metrics(self) -> Dict[str, Any]:
        return {
            "name": self.name, "role": self.role,
            "weights_version": self.weights_version,
            "prefill_dispatches": self.engine.prefill_dispatches,
            "chunk_dispatches": self.engine.chunk_dispatches,
            "step_dispatches": self.engine.step_dispatches,
            "engine": self.engine.metrics(),
        }

    def op_status(self) -> Dict[str, Any]:
        """Identity, the engine's status and this process's kernel
        launches (``launch_totals``): which worker launched which
        kernel."""
        mem = (torch.cuda.memory_reserved(self.device)
               if self.device.type == "cuda" else 0)
        return {"name": self.name, "role": self.role, "rank": self.rank,
                "pid": os.getpid(), "obs_port": self.obs_port,
                "device": str(self.device), "memory_reserved": int(mem),
                "weights_version": self.weights_version,
                "frontend_epoch": self.frontend_epoch,
                "launches": launch_totals(),
                "engine": self.engine.status()}

    def op_reset_launches(self) -> Dict[str, int]:
        """Zero this process's kernel launch counters (a measurement's
        start); returns the counts they held."""
        from paddle_tpu_torch.ops.kernels import reset_launches
        before = launch_totals()
        reset_launches()
        return before

    def op_stall(self, seconds: float) -> bool:
        # drill hook: RpcAgent serves SERIALLY, so this op stalls every
        # later op — the frontend sees its futures time out, exactly the
        # dead-socket signal a hung worker produces
        time.sleep(float(seconds))
        return True

    def op_shutdown(self) -> bool:
        self._stop.set()
        return True

    # -- lifecycle ---------------------------------------------------------
    def run(self) -> None:
        """Block until shutdown; the RPC server + heartbeat threads do
        the work."""
        while not self._stop.wait(0.2):
            pass
        self.elastic.stop()
        self.exporter.stop()
        self.agent.shutdown()


def _publish_failure(cfg: Dict[str, Any], e: BaseException) -> None:
    """Write a startup failure under the worker's registration key, so
    the launcher raises it typed instead of waiting out its timeout."""
    from paddle_tpu_torch.native.tcp_store import TCPStore
    try:
        store = TCPStore(str(cfg["master_host"]), int(cfg["master_port"]),
                         timeout=5.0)
        store.set(f"cluster/worker/{int(cfg['rank'])}", json.dumps(
            {"name": cfg.get("name"), "error": type(e).__name__,
             "message": str(e)[:2000]}).encode())
    except Exception:
        pass


def main(argv=None) -> int:
    global _HOST
    raw = os.environ.get("PADDLE_TPU_TORCH_CLUSTER_CFG", "")
    if not raw:
        print("PADDLE_TPU_TORCH_CLUSTER_CFG is not set (the launcher passes "
              "the worker config JSON through it)", file=sys.stderr)
        return 2
    cfg = json.loads(raw)
    resume = bool(cfg.get("resume"))
    # SIGTERM = graceful launcher shutdown (SIGKILL is the crash drill)
    try:
        host = WorkerHost(cfg, resume=resume)
    except Exception as e:
        _publish_failure(cfg, e)
        raise
    _HOST = host
    # under `python -m` this module runs as __main__ while the RPC
    # stream unpickles worker_op from the CANONICAL import — pin the
    # singleton there too, or every op sees an uninitialized host
    import paddle_tpu_torch.serving.cluster.worker as _canonical
    _canonical._HOST = host
    signal.signal(signal.SIGTERM, lambda *a: host._stop.set())
    host.run()
    return 0


if __name__ == "__main__":
    sys.exit(main())
