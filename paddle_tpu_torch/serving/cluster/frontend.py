"""ClusterRouter: the frontend of the multi-process serving cluster.

Counterpart of ``paddle_tpu/serving/cluster/frontend.py``
(the port's own copy: it imports nothing of the JAX package).

The in-process ``Router`` (serving/router.py) re-derived over RPC, with
the health signals made REAL: a replica here is an OS process, a missed
heartbeat is the ``ElasticManager`` TTL expiring on the frontend's own
monotonic clock, and a dead socket is an RPC future timing out — both
mean the process is gone (SIGKILL, OOM, hang), not that an in-process
breaker flag flipped.

Routing: disaggregated admission first — when a prefill pool exists,
the prompt is prefilled on the least-loaded PREFILL worker
(``prefill_extract``: the KV rows leave through the prefix-slab path),
shipped to the chosen DECODE worker and ingested there
(``load_prefix_slab``), so the decode worker admits with ONE
row-scatter and zero prefill dispatches (the DistServe/Splitwise
split). Decode placement is least-loaded over the frontend's own
assignment table, FIFO by rank on ties — deterministic, so fault
drills replay.

Crash recovery, two modes per the recover= knob:

- ``"replay"`` (default): the dead worker's accepted requests re-enter
  a survivor as ``prompt + tokens_so_far`` with the dead worker
  excluded. The ledger replayed is the frontend's OWN copy — ``step``
  ships every occupied slot's tokens-so-far each iteration, so the
  frontend never has to ask a corpse. Greedy replay is bit-exact
  (teacher-forcing the same tokens reproduces the same logits); sampled
  replay is bit-exact too when the decode pool runs
  ``request_keyed_rng`` (the router id + tokens-emitted count derive
  the identical stream on any worker).
- ``"restart"``: the launcher's respawn hook brings the SAME rank back
  (``resume=True`` RPC counters — the dead incarnation's calls stay
  unanswered), the new process restores the worker's last atomic
  snapshot, and the frontend reconciles: engine ids the restored
  incarnation knows resume in place (their post-snapshot tokens re-emit
  deterministically — delivery is per-request-once, so nothing
  double-emits); ids accepted after the snapshot are replayed from the
  frontend ledger. Respawn/restore failure falls back to replay — a
  crashed worker never takes accepted work down with it either way.

Fleet operations (planned churn, not just crash recovery):

- ``migrate(request_ids, src, dst)`` — at a chunk boundary the source
  engine row-subset-extracts the selected requests (carry rows + KV +
  live RNG keys + token ledger), the payload ships over the chunked
  sha256-verified RPC channel, and the destination absorbs it via the
  fused admission scatter. Greedy AND request-keyed-sampled streams
  continue bit-exactly (the raw key rides along). Ownership leaves the
  source the moment extraction succeeds — a later source death can
  never double-requeue migrated rows — and an absorb failure falls
  back to the frontend's own replay ledger: exactly-once either way.
- ``evacuate(worker)`` — drain a worker NOW by migrating all its
  assigned work to weight-version-compatible peers.
- ``rolling_restart()`` — evacuate -> graceful shutdown -> respawn ->
  re-admit, one worker at a time, while the fleet keeps serving. A
  respawned worker rebuilds from whatever versioned weights the
  launcher currently stages (hot weight reload); migration between
  mixed weight versions is refused typed (``WeightVersionError``).
- proactive SUSPECT evacuation — with ``suspect_after_s`` set, a
  worker whose heartbeat goes stale (but has NOT yet TTL-expired) is
  marked suspect, stops taking submits, and its in-flight work is
  evacuated to peers BEFORE the TTL declares it dead.

Control-plane resilience (the frontend's OWN death): every
request lifecycle transition lands in a durable WAL
(``serving/cluster/wal.py``), the TCPStore rendezvous lives in its own
store-daemon process, and each router incarnation claims a
monotonically-increasing **frontend epoch** stamped on every RPC op —
workers refuse older epochs typed (``StaleEpochError``), so a zombie
incarnation can never double-serve. A respawned
``ClusterRouter(resume_wal=...)`` replays the WAL, re-adopts the live
workers (``adopt`` handshake), resumes rows the fleet still holds in
place and ledger-replays the rest — bit-exact, exactly-once. Deadlines
persist as REMAINING budget and rebase onto the new incarnation's
monotonic clock.

Fleet observability: ``start_exporter`` serves ONE /metrics that
scrapes every live worker's own exporter at request time and
concatenates the (per-worker-labelled) expositions after the
frontend's registry, and a /statusz whose per-worker blocks are
fetched live; an unreachable worker degrades to a comment line /
error block, never a failed scrape.
"""

from __future__ import annotations

import dataclasses
import json
import time
import urllib.request
from typing import Any, Callable, Dict, List, Optional, Sequence, Set, Tuple

import numpy as np

import paddle_tpu_torch.obs as obs
from paddle_tpu_torch.obs.metrics import MetricsRegistry
from paddle_tpu_torch.runtime.resilience import (DeadlineExceededError,
                                           GenerateResult,
                                           ReplicaDeadError, ReplicaEvent,
                                           WeightVersionError,
                                           record_event)
from paddle_tpu_torch.serving.cluster.wal import WriteAheadLog
from paddle_tpu_torch.serving.cluster.worker import worker_op

__all__ = ["ClusterRouter", "WorkerHandle"]


@dataclasses.dataclass
class WorkerHandle:
    """One worker process as the frontend sees it."""
    name: str
    rank: int
    role: str                        # prefill | decode | unified
    pid: int
    obs_port: int = 0
    snapshot_dir: Optional[str] = None
    weights_version: Optional[str] = None
    state: str = "healthy"       # healthy | suspect | restarting | dead
    consecutive_fatal: int = 0
    missed_beats: int = 0
    deaths: int = 0
    last_error: Optional[str] = None
    queued: int = 0                  # last observed over RPC
    occupied: int = 0
    dead_at: Optional[float] = None  # monotonic time of the last verdict
    recovery_s: Optional[float] = None   # s its restart or requeue took

    @property
    def serves_decode(self) -> bool:
        return self.role in ("decode", "unified")

    @property
    def serves_prefill(self) -> bool:
        return self.role in ("prefill", "unified")


@dataclasses.dataclass
class _Tracked:
    """Frontend bookkeeping for one accepted request. ``prompt`` and
    ``max_new_tokens`` are the CURRENT submission's view (a requeue
    folds the replayed ledger into the prompt); ``ledger`` holds the
    tokens the current worker has produced so far — the replay payload
    for that worker's next crash."""
    rid: int
    prompt: np.ndarray
    max_new_tokens: int
    eos_token_id: Optional[int]
    temperature: float
    seed: int
    priority: int
    latency_class: str
    deadline_at: Optional[float]
    worker: int                      # rank
    engine_rid: int
    ledger: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros((0,), np.int64))
    excluded: Set[int] = dataclasses.field(default_factory=set)
    attempts: List[str] = dataclasses.field(default_factory=list)
    migrations: List[str] = dataclasses.field(default_factory=list)
    replayed_tokens: int = 0
    tag: Optional[str] = None        # caller's correlation id (WAL'd)


class ClusterRouter:
    """Health-checked router over a pool of worker PROCESSES.

    ``agent`` is the frontend's master ``RpcAgent`` (rank 0);
    ``elastic`` its started ``ElasticManager`` over the same store
    (worker heartbeats land there); ``workers`` the registered
    handles. ``respawn`` (from the launcher) restarts a dead worker's
    rank and returns its fresh registration dict — required for
    ``recover="restart"``."""

    def __init__(self, agent, workers: Sequence[WorkerHandle], elastic,
                 rpc_timeout_s: float = 60.0,
                 breaker_threshold: int = 1,
                 heartbeat_miss_threshold: int = 3,
                 recover: str = "replay",
                 respawn: Optional[Callable[[WorkerHandle], dict]] = None,
                 suspect_after_s: Optional[float] = None,
                 wal_dir: Optional[str] = None,
                 resume_wal: Optional[str] = None):
        if recover not in ("replay", "restart"):
            raise ValueError(
                f"recover must be 'replay' or 'restart', got {recover!r}")
        if not any(h.serves_decode for h in workers):
            raise ValueError("the cluster needs at least one decode or "
                             "unified worker")
        self.agent = agent
        self.elastic = elastic
        self.workers: List[WorkerHandle] = list(workers)
        self.rpc_timeout_s = float(rpc_timeout_s)
        self.breaker_threshold = int(breaker_threshold)
        self.heartbeat_miss_threshold = int(heartbeat_miss_threshold)
        self.recover = recover
        self._respawn = respawn
        # proactive SUSPECT window: a heartbeat older than this (but not
        # yet TTL-dead) marks the worker suspect and evacuates it; None
        # disables the early warning (TTL death is then the only signal)
        self.suspect_after_s = (None if suspect_after_s is None
                                else float(suspect_after_s))
        self._tracked: Dict[int, _Tracked] = {}
        self._by_engine: Dict[int, Dict[int, int]] = {
            h.rank: {} for h in self.workers}
        self._results: Dict[int, Any] = {}
        self._errors: Dict[int, BaseException] = {}
        self._next_id = 0
        self._exporter = None
        # frontend epoch: claim the next incarnation number on the
        # shared store. Workers track the highest epoch stamped on any
        # op and refuse older ones typed (StaleEpochError) — the fence
        # that stops a zombie incarnation from double-serving. Routers
        # over store-less (in-process fake) agents run unfenced at 0.
        try:
            self.epoch = int(self.agent.store.add(
                "cluster/frontend/epoch", 1))
        except Exception:
            self.epoch = 0
        self.registry = MetricsRegistry()
        r = self.registry
        self._c_submitted = r.counter(
            "serving.cluster.submitted", "requests accepted and routed")
        self._c_completed = r.counter(
            "serving.cluster.completed", "requests resolved with tokens")
        self._c_requeued = r.counter(
            "serving.cluster.requeued",
            "requests replayed onto a survivor off a dead worker")
        self._c_deaths = r.counter(
            "serving.cluster.worker_deaths",
            "workers declared dead (heartbeat TTL or RPC socket)")
        self._c_restarts = r.counter(
            "serving.cluster.worker_restarts",
            "dead workers respawned and restored from their snapshot")
        self._c_resumed = r.counter(
            "serving.cluster.requests_resumed",
            "requests resumed IN PLACE on a restarted worker (known to "
            "its restored snapshot — no replay needed)")
        self._c_dead_letter = r.counter(
            "serving.cluster.dead_letter",
            "requests resolved as typed ReplicaDeadError: no surviving "
            "decode worker")
        self._c_shed_requeue = r.counter(
            "serving.cluster.shed_requeue_deadline",
            "requests whose deadline expired before requeue")
        self._c_disagg = r.counter(
            "serving.cluster.disaggregated_admissions",
            "requests whose prefill ran on the prefill pool and shipped "
            "to a decode worker as a slab")
        self._c_disagg_fallback = r.counter(
            "serving.cluster.disaggregation_fallbacks",
            "requests admitted with a decode-side prefill because the "
            "prefill pool was unavailable")
        self._c_migrations = r.counter(
            "serving.cluster.migrations",
            "requests live-migrated between workers at a chunk "
            "boundary (carry rows + KV + RNG keys shipped, bit-exact)")
        self._c_evacuations = r.counter(
            "serving.cluster.evacuations",
            "workers drained by migrating their assigned work to "
            "weight-version-compatible peers")
        self._c_proactive = r.counter(
            "serving.cluster.proactive_evacuations",
            "SUSPECT workers (stale heartbeat, not yet TTL-dead) "
            "evacuated before the TTL declared them dead")
        self._c_rolling = r.counter(
            "serving.cluster.rolling_restarts",
            "workers restarted by rolling_restart while the fleet "
            "kept serving")
        self._c_slab_retries = r.counter(
            "serving.cluster.slab_retries",
            "chunked slab/migration transfer parts whose sha256 "
            "mismatched once and re-fetched clean (a second mismatch "
            "is a typed SlabTransferError)")
        self._g_healthy = r.gauge(
            "serving.cluster.healthy_workers", "workers taking traffic")
        self._g_healthy.set(len(self.workers))
        self._g_epoch = r.gauge(
            "serving.cluster.frontend_epoch",
            "this router incarnation's fencing epoch (workers refuse "
            "ops stamped with an older one)")
        self._g_epoch.set(self.epoch)
        self._g_wal_fsync = r.gauge(
            "serving.cluster.wal_fsync_latency_s",
            "duration of the WAL's most recent fsync")
        self._c_wal_bytes = r.counter(
            "serving.cluster.wal_bytes_written",
            "bytes appended to the frontend write-ahead log")
        obs.flight_recorder.add_state("serving.cluster", self)

        # durable request ledger: every lifecycle transition lands in
        # the WAL (submits/finishes/requeues/migrations fsynced; the
        # per-step token harvest group-commits one fsync per step), so
        # a respawned incarnation rebuilds exact tracking state
        self._wal: Optional[WriteAheadLog] = None
        self._wal_tokens: Dict[int, int] = {}   # rid -> persisted count
        self.recovery_report: Optional[Dict[str, Any]] = None
        path = resume_wal or wal_dir
        if path is not None:
            self._wal = WriteAheadLog(path)
            if self._wal.recovered and resume_wal is None:
                raise ValueError(
                    f"wal_dir {path!r} holds "
                    f"{len(self._wal.recovered)} records from a "
                    f"previous incarnation — pass resume_wal= to "
                    f"recover them (or point wal_dir at a fresh "
                    f"directory)")
        if resume_wal is not None:
            self._recover(self._wal.recovered)

    # -- pools -------------------------------------------------------------
    def _decode_pool(self, excluded: Set[int]) -> List[WorkerHandle]:
        cand = [h for h in self.workers
                if h.serves_decode and h.state == "healthy"
                and h.rank not in excluded]
        return sorted(cand, key=lambda h: (self._load(h), h.rank))

    def _prefill_pool(self) -> List[WorkerHandle]:
        cand = [h for h in self.workers
                if h.role == "prefill" and h.state == "healthy"]
        return sorted(cand, key=lambda h: (self._load(h), h.rank))

    def _load(self, h: WorkerHandle) -> int:
        # the frontend's OWN assignment table: live even when the worker
        # hasn't been stepped yet (RPC-observed depth lags a step)
        return len(self._by_engine[h.rank])

    def _handle(self, rank: int) -> WorkerHandle:
        for h in self.workers:
            if h.rank == rank:
                return h
        raise ValueError(f"no worker with rank {rank}")

    # -- RPC ---------------------------------------------------------------
    def _call(self, h: WorkerHandle, op: str, *args,
              timeout: Optional[float] = None, **kwargs):
        if self.epoch:
            # stamp the fencing epoch on every op (a worker that has
            # seen a newer incarnation refuses this one typed)
            kwargs.setdefault("_epoch", self.epoch)
        fut = self.agent.call(h.rank, worker_op, (op,) + args, kwargs)
        return fut.wait(self.rpc_timeout_s if timeout is None
                        else timeout)

    # -- routing -----------------------------------------------------------
    def submit(self, prompt, max_new_tokens: int,
               eos_token_id: Optional[int] = None,
               temperature: float = 1.0, seed: int = 0,
               priority: int = 0, latency_class: str = "default",
               deadline_s: Optional[float] = None,
               tag: Optional[str] = None) -> int:
        """Route one request; returns the cluster request id. When a
        prefill pool exists the admission prefill runs THERE and ships
        to the decode worker as a slab (full prefix hit: zero decode
        prefill dispatches); prefill-pool failure degrades to a decode-
        side prefill, never a refused request. Raises typed
        ``ReplicaDeadError`` with no routable decode worker and the
        last ``DeadlineExceededError`` when every candidate sheds."""
        prompt = np.asarray(prompt)
        if prompt.ndim == 2 and prompt.shape[0] == 1:
            prompt = prompt[0]
        cand = self._decode_pool(set())
        if not cand:
            raise ReplicaDeadError(
                f"no routable decode worker "
                f"(states={[(h.name, h.state) for h in self.workers]})")
        rid = self._next_id
        pf = self._disaggregate(prompt)
        last_shed: Optional[BaseException] = None
        for h in cand:
            try:
                self._load_slab(h, pf)
                erid = self._call(
                    h, "submit", prompt,
                    max_new_tokens=int(max_new_tokens),
                    eos_token_id=eos_token_id,
                    temperature=float(temperature), seed=int(seed),
                    priority=int(priority),
                    latency_class=str(latency_class),
                    deadline_s=deadline_s, rng_request_id=rid,
                    rng_tokens_emitted=0)
            except DeadlineExceededError as e:
                last_shed = e
                continue
            self._next_id += 1
            now = time.monotonic()
            self._tracked[rid] = _Tracked(
                rid=rid, prompt=prompt,
                max_new_tokens=int(max_new_tokens),
                eos_token_id=eos_token_id,
                temperature=float(temperature), seed=int(seed),
                priority=int(priority),
                latency_class=str(latency_class),
                deadline_at=(None if deadline_s is None
                             else now + float(deadline_s)),
                worker=h.rank, engine_rid=erid, attempts=[h.name],
                tag=tag)
            self._by_engine[h.rank][erid] = rid
            self._c_submitted.inc()
            self._wal_submit(self._tracked[rid])
            return rid
        raise last_shed

    def _disaggregate(
            self, prompt: np.ndarray
    ) -> Optional[Tuple[dict, Optional[str]]]:
        """Run the admission prefill on the prefill pool; returns the
        slab payload tagged with the prefill worker's weights version
        (``_load_slab`` refuses cross-version shipping). None = no
        pool / pool unavailable (the decode worker prefills itself)."""
        pool = self._prefill_pool()
        if not pool:
            return None
        for h in pool:
            try:
                payload = self._call(h, "prefill", prompt)
            except Exception as e:
                self._strike(h, e, [])
                continue
            h.consecutive_fatal = 0
            return payload, h.weights_version
        self._c_disagg_fallback.inc()
        return None

    def _load_slab(self, h: WorkerHandle,
                   pf: Optional[Tuple[dict, Optional[str]]]) -> None:
        """Ship a disaggregated prefill slab to the admission target —
        UNLESS the prefill ran under a different weights version (a
        mid-hot-reload fleet where only part of the pool has restarted
        onto the staged file). Cross-version KV is silent numerical
        corruption, so the decode worker prefills locally instead,
        counted as a disaggregation fallback."""
        if pf is None:
            return
        payload, version = pf
        if (version and h.weights_version
                and version != h.weights_version):
            self._c_disagg_fallback.inc()
            return
        self._call(h, "load_slab", payload)
        self._c_disagg.inc()

    # -- the serving loop --------------------------------------------------
    def step(self) -> List[Tuple[int, Any]]:
        """One iteration: heartbeat sweep over the elastic membership,
        then one RPC ``step`` per decode worker with assigned work.
        Returns the ``(cluster_rid, outcome)`` pairs resolved —
        results or typed errors."""
        finished: List[Tuple[int, Any]] = []
        self._sync_slab_retries()
        members = set(self.elastic.members)
        ttl = self.elastic.ttl_s
        for h in self.workers:
            if (h.state not in ("dead", "restarting")
                    and h.name not in members):
                # the heartbeat loop's members can be a period old, older
                # than an RPC round trip (ROADMAP.md section 3, entry 42):
                # a worker that registered or restarted since the loop
                # last looked is confirmed on a fresh read of its beat
                age = self.elastic.beat_age(h.name)
                if age is not None and age < ttl:
                    members.add(h.name)
        for h in list(self.workers):
            if h.state in ("dead", "restarting"):
                # restarting = intentionally down (rolling restart owns
                # its lifecycle); the death machinery must not fire
                continue
            if h.name not in members:
                h.missed_beats += 1
                if h.missed_beats >= self.heartbeat_miss_threshold:
                    self._declare_dead(
                        h, f"heartbeat expired ({h.missed_beats} "
                           f"missed beats)", finished)
                    continue
                if h.state == "healthy":
                    h.state = "suspect"
                    self._sync_healthy()
                    record_event(ReplicaEvent(
                        site="serving.cluster", replica=h.name,
                        action="suspect",
                        detail=f"{h.missed_beats} missed process "
                               f"heartbeats"))
            else:
                h.missed_beats = 0
                age = (self.elastic.beat_age(h.name)
                       if self.suspect_after_s is not None else None)
                if (h.state == "healthy" and age is not None
                        and age > self.suspect_after_s):
                    # proactive SUSPECT: the heartbeat is stale but the
                    # TTL has not expired — stop routing to the worker
                    # and move its work out BEFORE it dies, shrinking
                    # the blast radius to zero if it does
                    h.state = "suspect"
                    self._sync_healthy()
                    self._c_proactive.inc()
                    record_event(ReplicaEvent(
                        site="serving.cluster", replica=h.name,
                        action="suspect",
                        detail=f"stale heartbeat ({age:.2f}s > "
                               f"{self.suspect_after_s:.2f}s): "
                               f"proactive evacuation"))
                    if h.serves_decode and self._by_engine[h.rank]:
                        try:
                            self.evacuate(h)
                        except Exception as e:
                            # a hung worker fails the extract: its rows
                            # stay put and the TTL death replays them
                            record_event(ReplicaEvent(
                                site="serving.cluster", replica=h.name,
                                action="evacuate_failed",
                                detail=f"{type(e).__name__}: "
                                       f"{str(e)[:200]}"))
                elif h.state == "suspect" and (
                        age is None or age <= self.suspect_after_s):
                    h.state = "healthy"
                    self._sync_healthy()
                    record_event(ReplicaEvent(
                        site="serving.cluster", replica=h.name,
                        action="recovered",
                        detail="process heartbeat resumed"))
            if not h.serves_decode or not self._by_engine[h.rank]:
                continue
            try:
                r = self._call(h, "step")
            except Exception as e:
                self._strike(h, e, finished)
                continue
            h.consecutive_fatal = 0
            h.queued = int(r.get("queued", 0))
            h.occupied = int(r.get("occupied", 0))
            for erid, toks in r.get("inflight", {}).items():
                rid = self._by_engine[h.rank].get(int(erid))
                if rid is not None:
                    self._tracked[rid].ledger = np.asarray(toks)
                    self._wal_tokens_append(rid)
            for erid, kind, payload, resil in r.get("finished", []):
                out = self._deliver(h, int(erid), kind, payload, resil)
                if out is not None:
                    finished.append(out)
        if self._wal is not None:
            # group commit: the whole step's token harvest in one fsync
            self._wal.sync()
            self._sync_wal_stats()
        return finished

    def drain(self, max_steps: Optional[int] = None) -> Dict[int, Any]:
        """Step until every accepted request is resolved; returns the
        outcomes resolved while draining (results AND typed errors —
        the zero-request-loss accounting reads this)."""
        out: Dict[int, Any] = {}
        steps = 0
        while self.in_flight():
            for rid, res in self.step():
                out[rid] = res
            steps += 1
            if max_steps is not None and steps > max_steps:
                raise RuntimeError(
                    f"cluster drain did not converge within "
                    f"{max_steps} steps ({self.in_flight()} in flight)")
        return out

    def in_flight(self) -> int:
        return len(self._tracked) - len(self._results) - len(self._errors)

    def outcome(self, rid: int):
        """The resolved outcome: a ``GenerateResult`` or a typed error
        VALUE; None while in flight."""
        if rid in self._results:
            return self._results[rid]
        return self._errors.get(rid)

    def result(self, rid: int):
        """The result array; RAISES the stored typed error."""
        if rid in self._errors:
            raise self._errors[rid]
        return self._results.get(rid)

    def _deliver(self, h: WorkerHandle, erid: int, kind: str, payload,
                 resil) -> Optional[Tuple[int, Any]]:
        rid = self._by_engine[h.rank].pop(erid, None)
        if rid is None:
            return None
        t = self._tracked[rid]
        if kind == "error":
            self._errors[rid] = payload
            self._wal_finish(rid, error=payload)
            return rid, payload
        if resil is not None:
            # attempts counts every worker that held the request;
            # migrations are planned moves, not crash requeues
            resil["cluster"] = {
                "workers": list(t.attempts),
                "requeues": len(t.attempts) - 1 - len(t.migrations),
                "migrations": list(t.migrations),
                "replayed_tokens": t.replayed_tokens,
            }
        res = GenerateResult.wrap(np.asarray(payload), resil)
        self._results[rid] = res
        self._c_completed.inc()
        self._wal_finish(rid, tokens=np.asarray(payload), resil=resil)
        return rid, res

    # -- health / recovery -------------------------------------------------
    def _sync_healthy(self) -> None:
        self._g_healthy.set(
            sum(1 for h in self.workers if h.state == "healthy"))

    def _strike(self, h: WorkerHandle, error: BaseException,
                finished: List[Tuple[int, Any]]) -> None:
        h.consecutive_fatal += 1
        h.last_error = f"{type(error).__name__}: {str(error)[:200]}"
        record_event(ReplicaEvent(
            site="serving.cluster", replica=h.name, action="strike",
            detail=f"rpc failure: {h.last_error} "
                   f"({h.consecutive_fatal}/{self.breaker_threshold})"))
        if h.consecutive_fatal >= self.breaker_threshold:
            self._declare_dead(h, f"dead socket: {h.last_error}",
                               finished)

    def _declare_dead(self, h: WorkerHandle, reason: str,
                      finished: List[Tuple[int, Any]]) -> None:
        """A worker PROCESS is gone (TTL-expired heartbeat or dead
        socket). Fence it, then recover its accepted work: restart-from-
        snapshot when configured (falling back to replay on any respawn/
        restore failure), else replay onto survivors."""
        h.state = "dead"
        h.deaths += 1
        h.dead_at, h.recovery_s = time.monotonic(), None
        self._c_deaths.inc()
        self._sync_healthy()
        dead_err = ReplicaDeadError(
            f"worker {h.name} (rank {h.rank}, pid {h.pid}) dead: "
            f"{reason}", replica=h.name)
        record_event(ReplicaEvent(
            site="serving.cluster", replica=h.name, action="dead",
            detail=reason[:300]))
        obs.record_crash("serving.cluster.worker_dead", error=dead_err,
                         extra={"worker": h.name, "rank": h.rank,
                                "pid": h.pid, "reason": reason[:300]})
        if (self.recover == "restart" and self._respawn is not None
                and h.snapshot_dir):
            if self._restart(h, finished):
                h.recovery_s = time.monotonic() - h.dead_at
                return
        rids = list(self._by_engine[h.rank].values())
        self._by_engine[h.rank].clear()
        for rid in rids:
            self._requeue(rid, h, dead_err, finished)
        h.recovery_s = time.monotonic() - h.dead_at

    def _restart(self, h: WorkerHandle,
                 finished: List[Tuple[int, Any]]) -> bool:
        """Respawn the dead rank, restore its snapshot, reconcile the
        assignment table. Returns False (caller replays) on any
        failure."""
        try:
            info = self._respawn(h)
            h.pid = int(info["pid"])
            h.obs_port = int(info.get("obs_port", h.obs_port))
            restored = self._call(h, "restore", h.snapshot_dir,
                                  timeout=self.rpc_timeout_s)
            known = self._call(h, "known")
        except Exception as e:
            record_event(ReplicaEvent(
                site="serving.cluster", replica=h.name,
                action="restart_failed",
                detail=f"{type(e).__name__}: {str(e)[:200]}"))
            return False
        h.state = "healthy"
        h.consecutive_fatal = 0
        h.missed_beats = 0
        self._sync_healthy()
        self._c_restarts.inc()
        record_event(ReplicaEvent(
            site="serving.cluster", replica=h.name, action="restarted",
            detail=f"pid {h.pid}, restored "
                   f"{restored.get('in_flight', 0)} in-flight + "
                   f"{restored.get('queued', 0)} queued"))
        assigned = dict(self._by_engine[h.rank])
        dead_err = ReplicaDeadError(
            f"worker {h.name} crashed and restarted", replica=h.name)
        for erid, rid in assigned.items():
            if erid in known:
                # resumes in place; post-snapshot tokens re-emit
                # deterministically and delivery is per-rid-once. The
                # ledger resets to the restored engine's view on the
                # next step's inflight export.
                res = self._call(h, "result", erid)
                if res is not None:
                    # finished between the snapshot and the crash: the
                    # restored results table already holds the outcome
                    if isinstance(res, BaseException):
                        out = self._deliver(h, erid, "error", res, None)
                    else:
                        out = self._deliver(h, erid, "tokens", res[0],
                                            res[1])
                    if out is not None:
                        finished.append(out)
                else:
                    self._c_resumed.inc()
                continue
            # accepted after the snapshot: the restored engine never
            # heard of it — replay from the frontend ledger (the
            # restarted worker is NOT excluded: it crashed, it wasn't
            # wrong)
            self._by_engine[h.rank].pop(erid, None)
            self._requeue(rid, h, dead_err, finished, exclude=False)
        return True

    def _requeue(self, rid: int, dead: WorkerHandle,
                 dead_err: ReplicaDeadError,
                 finished: List[Tuple[int, Any]],
                 exclude: bool = True) -> None:
        t = self._tracked[rid]
        if exclude:
            t.excluded.add(dead.rank)
        now = time.monotonic()
        if t.deadline_at is not None and now > t.deadline_at:
            self._c_shed_requeue.inc()
            err = DeadlineExceededError(
                f"request {rid} deadline expired before requeue off "
                f"dead worker {dead.name}", request_id=rid)
            self._errors[rid] = err
            self._wal_finish(rid, error=err)
            finished.append((rid, err))
            return
        # fold the ledger into the prompt: the survivor teacher-forces
        # the same tokens (same logits — greedy bit-exact), and the
        # request-keyed RNG derivation resumes the same stream at
        # replayed_tokens for sampled parity
        if t.ledger.size:
            t.prompt = np.concatenate(
                [np.asarray(t.prompt),
                 t.ledger.astype(np.asarray(t.prompt).dtype)])
            t.max_new_tokens -= int(t.ledger.size)
            t.replayed_tokens += int(t.ledger.size)
            t.ledger = np.zeros((0,), np.int64)
        cand = self._decode_pool(t.excluded)
        if not cand:
            self._c_dead_letter.inc()
            err = ReplicaDeadError(
                f"request {rid}: no surviving decode worker "
                f"(excluded ranks {sorted(t.excluded)})",
                replica=dead.name)
            self._errors[rid] = err
            self._wal_finish(rid, error=err)
            finished.append((rid, err))
            return
        rem_deadline = (None if t.deadline_at is None
                        else t.deadline_at - now)
        # replay admissions disaggregate too: the survivor ingests the
        # grown prompt as a shipped slab, so prefill dispatches stay on
        # the prefill pool even across requeues
        pf = self._disaggregate(t.prompt)
        for h in cand:
            try:
                self._load_slab(h, pf)
                erid = self._call(
                    h, "submit", t.prompt,
                    max_new_tokens=t.max_new_tokens,
                    eos_token_id=t.eos_token_id,
                    temperature=t.temperature, seed=t.seed,
                    priority=t.priority, latency_class=t.latency_class,
                    deadline_s=rem_deadline, rng_request_id=rid,
                    rng_tokens_emitted=t.replayed_tokens)
            except DeadlineExceededError as e:
                self._c_shed_requeue.inc()
                self._errors[rid] = e
                self._wal_finish(rid, error=e)
                finished.append((rid, e))
                return
            except Exception as e:
                self._strike(h, e, finished)
                continue
            t.worker = h.rank
            t.engine_rid = erid
            t.attempts.append(h.name)
            self._by_engine[h.rank][erid] = rid
            self._c_requeued.inc()
            self._wal_requeue(t)
            record_event(ReplicaEvent(
                site="serving.cluster", replica=h.name,
                action="requeue",
                detail=f"request {rid} moved off {dead.name} with "
                       f"{t.replayed_tokens} tokens replayed"))
            return
        self._c_dead_letter.inc()
        err = ReplicaDeadError(
            f"request {rid}: every requeue candidate failed",
            replica=dead.name)
        self._errors[rid] = err
        self._wal_finish(rid, error=err)
        finished.append((rid, err))

    # -- fleet operations: migrate / evacuate / rolling restart ------------
    def _resolve(self, worker) -> WorkerHandle:
        """Accept a WorkerHandle, a rank, or a worker name."""
        if isinstance(worker, WorkerHandle):
            return worker
        if isinstance(worker, int):
            return self._handle(worker)
        for h in self.workers:
            if h.name == worker:
                return h
        raise ValueError(f"no worker named {worker!r}")

    def migrate(self, request_ids: Sequence[int], src, dst,
                timeout: Optional[float] = None,
                _on_extracted: Optional[Callable[[], None]] = None
                ) -> List[int]:
        """Live-migrate in-flight requests from ``src`` to ``dst`` at a
        chunk boundary: the source engine row-subset-extracts the carry
        rows + KV + live RNG keys + token ledgers, the payload ships
        over the sha256-verified chunked RPC channel, the destination
        absorbs via the fused admission scatter. Greedy and request-
        keyed-sampled continuations are bit-exact (the raw per-row key
        rides along — no re-derivation).

        Exactly-once discipline: frontend ownership leaves ``src`` the
        moment extraction succeeds (the source engine has ALREADY
        released the rows), so a later source death cannot double-
        requeue them; if the destination absorb then fails, the rows
        fall back to the frontend's own replay ledger — which is
        current as of the extraction boundary. ``_on_extracted`` is the
        fault-drill hook fired between the two phases.

        Raises ``WeightVersionError`` when both workers report weight
        versions and they differ (a migrated carry row decoded under
        different parameters would silently diverge)."""
        src_h, dst_h = self._resolve(src), self._resolve(dst)
        if src_h.rank == dst_h.rank:
            raise ValueError("migrate: src and dst are the same worker")
        if not (src_h.serves_decode and dst_h.serves_decode):
            raise ValueError(
                f"migrate needs decode-capable workers "
                f"(src={src_h.role}, dst={dst_h.role})")
        if dst_h.state != "healthy":
            raise ValueError(
                f"migrate: destination {dst_h.name} is {dst_h.state}")
        if src_h.state == "dead":
            raise ValueError(
                f"migrate: source {src_h.name} is dead (use the crash-"
                f"recovery replay path instead)")
        if (src_h.weights_version and dst_h.weights_version
                and src_h.weights_version != dst_h.weights_version):
            raise WeightVersionError(
                f"migrate {src_h.name} -> {dst_h.name} refused: mixed "
                f"weight versions ({src_h.weights_version} vs "
                f"{dst_h.weights_version})",
                src_version=src_h.weights_version,
                dst_version=dst_h.weights_version)
        rids = [int(r) for r in request_ids]
        erids = []
        for rid in rids:
            t = self._tracked.get(rid)
            if t is None:
                raise ValueError(f"migrate: unknown request {rid}")
            if rid in self._results or rid in self._errors:
                raise ValueError(f"migrate: request {rid} already "
                                 f"resolved")
            if t.worker != src_h.rank:
                raise ValueError(
                    f"migrate: request {rid} is on rank {t.worker}, "
                    f"not {src_h.name} (rank {src_h.rank})")
            erids.append(t.engine_rid)
        if not erids:
            return []
        payload = self._call(src_h, "extract_rows", erids,
                             timeout=timeout)
        # ownership has left the source: the engine released the rows,
        # so the frontend's table must drop them NOW — a source death
        # after this point must not requeue what the payload carries
        for rid, erid in zip(rids, erids):
            self._by_engine[src_h.rank].pop(erid, None)
        if _on_extracted is not None:
            _on_extracted()
        sink: List[Tuple[int, Any]] = []
        try:
            mapping = self._call(dst_h, "absorb_rows", payload,
                                 timeout=timeout)
        except Exception as e:
            # the payload is lost but the frontend ledger is current as
            # of the extraction boundary: replay wins, zero loss. The
            # destination is NOT struck — a mid-absorb integrity error
            # says nothing about its socket.
            record_event(ReplicaEvent(
                site="serving.cluster", replica=dst_h.name,
                action="migrate_absorb_failed",
                detail=f"{type(e).__name__}: {str(e)[:200]} — "
                       f"replaying {len(rids)} requests from the "
                       f"frontend ledger"))
            fail_err = ReplicaDeadError(
                f"migration absorb failed on {dst_h.name}",
                replica=dst_h.name)
            for rid in rids:
                self._requeue(rid, src_h, fail_err, sink, exclude=False)
            return []
        mapping = {int(k): int(v) for k, v in mapping.items()}
        for rid, erid in zip(rids, erids):
            t = self._tracked[rid]
            t.worker = dst_h.rank
            t.engine_rid = mapping[erid]
            t.attempts.append(dst_h.name)
            t.migrations.append(dst_h.name)
            self._by_engine[dst_h.rank][mapping[erid]] = rid
            self._wal_migrate(t, dst_h.name)
        if self._wal is not None:
            self._wal.sync()
            self._sync_wal_stats()
        self._c_migrations.inc(len(rids))
        record_event(ReplicaEvent(
            site="serving.cluster", replica=src_h.name,
            action="migrate",
            detail=f"{len(rids)} requests -> {dst_h.name} "
                   f"(rids {rids[:8]}{'...' if len(rids) > 8 else ''})"))
        return rids

    def evacuate(self, worker, timeout: Optional[float] = None
                 ) -> Dict[str, Any]:
        """Drain a worker by migrating ALL its assigned requests to
        weight-version-compatible decode peers, least-loaded first.
        Never raises for an individual failed group — those rids simply
        stay on the worker (``unmoved``) where the ordinary death
        machinery replays them if the worker does die. Returns
        ``{"worker", "moved", "unmoved"}``."""
        src_h = self._resolve(worker)
        rids = list(self._by_engine[src_h.rank].values())
        report = {"worker": src_h.name, "moved": [], "unmoved": []}
        if not rids:
            return report
        peers = [h for h in self._decode_pool(set())
                 if h.rank != src_h.rank
                 and not (src_h.weights_version and h.weights_version
                          and h.weights_version != src_h.weights_version)]
        if not peers:
            report["unmoved"] = rids
            return report
        # greedy least-loaded assignment with live load updates: the
        # pool sort is a snapshot, so account for rows we place
        loads = {h.rank: self._load(h) for h in peers}
        groups: Dict[int, List[int]] = {}
        for rid in rids:
            dst = min(peers, key=lambda h: (loads[h.rank], h.rank))
            groups.setdefault(dst.rank, []).append(rid)
            loads[dst.rank] += 1
        for dst_rank, group in groups.items():
            try:
                moved = self.migrate(group, src_h, dst_rank,
                                     timeout=timeout)
                report["moved"].extend(moved)
                if not moved:
                    report["unmoved"].extend(
                        r for r in group
                        if r in self._tracked
                        and r not in self._results
                        and r not in self._errors)
            except Exception as e:
                record_event(ReplicaEvent(
                    site="serving.cluster", replica=src_h.name,
                    action="evacuate_group_failed",
                    detail=f"{len(group)} rids -> rank {dst_rank}: "
                           f"{type(e).__name__}: {str(e)[:200]}"))
                report["unmoved"].extend(group)
        self._c_evacuations.inc()
        record_event(ReplicaEvent(
            site="serving.cluster", replica=src_h.name,
            action="evacuated",
            detail=f"{len(report['moved'])} moved, "
                   f"{len(report['unmoved'])} left in place"))
        return report

    def rolling_restart(self, drain_steps: int = 200) -> Dict[str, Any]:
        """Restart every live worker in sequence while the fleet keeps
        serving: evacuate its in-flight work to peers, drain whatever
        could not move, gracefully shut the process down, respawn it
        (the new process loads whatever versioned weights the launcher
        currently stages — the hot-weight-reload path), and re-admit it
        to the pool. Requires the launcher's respawn hook."""
        if self._respawn is None:
            raise RuntimeError(
                "rolling_restart needs the launcher's respawn hook "
                "(launch_cluster wires it)")
        report = {"restarted": [], "skipped": []}
        for h in list(self.workers):
            if h.state == "dead":
                report["skipped"].append(h.name)
                continue
            if h.serves_decode and self._by_engine[h.rank]:
                self.evacuate(h)
                steps = 0
                while self._by_engine[h.rank]:
                    # unmovable rows (no peer / all-busy): serve them
                    # out IN PLACE before taking the worker down
                    self.step()
                    steps += 1
                    if steps > drain_steps:
                        raise RuntimeError(
                            f"rolling_restart: {h.name} did not drain "
                            f"within {drain_steps} steps "
                            f"({len(self._by_engine[h.rank])} left)")
            h.state = "restarting"
            self._sync_healthy()
            record_event(ReplicaEvent(
                site="serving.cluster", replica=h.name,
                action="restarting",
                detail=f"rolling restart: pid {h.pid} going down"))
            try:
                self._call(h, "shutdown", timeout=5.0)
            except Exception:
                pass    # the respawn hook SIGKILLs a hung process
            old_version = h.weights_version
            info = self._respawn(h)
            h.pid = int(info["pid"])
            h.obs_port = int(info.get("obs_port", h.obs_port))
            h.weights_version = info.get("weights_version",
                                         h.weights_version)
            h.state = "healthy"
            h.consecutive_fatal = 0
            h.missed_beats = 0
            self._sync_healthy()
            self._c_rolling.inc()
            record_event(ReplicaEvent(
                site="serving.cluster", replica=h.name,
                action="restarted",
                detail=f"rolling restart: pid {h.pid}, weights "
                       f"{old_version} -> {h.weights_version}"))
            report["restarted"].append(
                {"name": h.name, "pid": h.pid,
                 "weights_version": h.weights_version})
            # keep the fleet moving between workers
            self.step()
        return report

    def _sync_slab_retries(self) -> None:
        """Fold the frontend agent's chunked-transfer retry count into
        the fleet counter (the worker-side agents' retries surface via
        their own /metrics expositions)."""
        delta = int(self.agent.transfer_retries) \
            - int(self._c_slab_retries.value)
        if delta > 0:
            self._c_slab_retries.inc(delta)

    # -- durable WAL: lifecycle records + failover recovery ----------------
    def _deadline_rem(self, t: _Tracked) -> Optional[float]:
        """The deadline as REMAINING budget — the only form that
        survives a frontend restart (``deadline_at`` is this process's
        monotonic clock, meaningless in the next incarnation)."""
        if t.deadline_at is None:
            return None
        return max(0.0, t.deadline_at - time.monotonic())

    def _sync_wal_stats(self) -> None:
        st = self._wal.stats()
        self._g_wal_fsync.set(float(st["last_fsync_s"]))
        delta = int(st["bytes_written"]) - int(self._c_wal_bytes.value)
        if delta > 0:
            self._c_wal_bytes.inc(delta)

    def _wal_submit(self, t: _Tracked) -> None:
        if self._wal is None:
            return
        self._wal.append({
            "t": "submit", "rid": t.rid, "tag": t.tag,
            "prompt": np.asarray(t.prompt).tolist(),
            "max_new_tokens": int(t.max_new_tokens),
            "eos_token_id": t.eos_token_id,
            "temperature": float(t.temperature), "seed": int(t.seed),
            "priority": int(t.priority),
            "latency_class": t.latency_class,
            "deadline_rem": self._deadline_rem(t),
            "worker": int(t.worker), "engine_rid": int(t.engine_rid),
        }, sync=True)
        self._wal_tokens[t.rid] = 0
        self._sync_wal_stats()

    def _wal_tokens_append(self, rid: int) -> None:
        """Persist the ledger tokens harvested since the last append
        (UNSYNCED — ``step`` group-commits one fsync per iteration)."""
        if self._wal is None:
            return
        t = self._tracked[rid]
        done = self._wal_tokens.get(rid, 0)
        if t.ledger.size <= done:
            return
        self._wal.append({
            "t": "tokens", "rid": rid, "off": done,
            "toks": t.ledger[done:].tolist(),
            "deadline_rem": self._deadline_rem(t),
        }, sync=False)
        self._wal_tokens[rid] = int(t.ledger.size)

    def _wal_requeue(self, t: _Tracked) -> None:
        if self._wal is None:
            return
        self._wal.append({
            "t": "requeue", "rid": t.rid, "worker": int(t.worker),
            "engine_rid": int(t.engine_rid),
            "prompt": np.asarray(t.prompt).tolist(),
            "max_new_tokens": int(t.max_new_tokens),
            "replayed_tokens": int(t.replayed_tokens),
            "excluded": sorted(t.excluded),
            "attempts": list(t.attempts),
            "deadline_rem": self._deadline_rem(t),
        }, sync=True)
        self._wal_tokens[t.rid] = 0
        self._sync_wal_stats()

    def _wal_migrate(self, t: _Tracked, dst_name: str) -> None:
        if self._wal is None:
            return
        self._wal.append({
            "t": "migrate", "rid": t.rid, "worker": int(t.worker),
            "engine_rid": int(t.engine_rid), "to": dst_name,
        }, sync=False)

    def _wal_finish(self, rid: int, tokens=None, resil=None,
                    error: Optional[BaseException] = None) -> None:
        if self._wal is None:
            return
        rec: Dict[str, Any] = {"t": "finish", "rid": rid}
        if error is not None:
            rec["etype"] = type(error).__name__
            rec["error"] = str(error)[:500]
        else:
            rec["tokens"] = np.asarray(tokens).tolist()
            try:
                rec["resil"] = (None if resil is None else json.loads(
                    json.dumps(resil, default=str)))
            except Exception:
                rec["resil"] = None
        self._wal.append(rec, sync=True)
        self._wal_tokens.pop(rid, None)
        self._sync_wal_stats()

    def close_wal(self) -> None:
        if self._wal is not None:
            self._wal.close()

    @staticmethod
    def _rebuild_error(etype: str, msg: str,
                       rid: int) -> BaseException:
        """Re-materialize a WAL'd error outcome as its TYPED class (the
        type is the contract clients dispatch on)."""
        from paddle_tpu_torch.runtime import resilience as _res
        cls = getattr(_res, etype, None)
        if cls is DeadlineExceededError:
            return DeadlineExceededError(msg, request_id=rid)
        if isinstance(cls, type) and issubclass(cls, BaseException):
            try:
                return cls(msg)
            except Exception:
                pass
        return RuntimeError(f"{etype}: {msg}")

    def _recover(self, records: List[Dict[str, Any]]) -> None:
        """Rebuild the dead incarnation's tracking state from its WAL,
        then reconcile it against the LIVE fleet: a request whose
        worker survived the outage and still accounts for its engine
        row RESUMES in place (delivery stays per-rid-once); one whose
        worker died — or released the row — ledger-replays onto a
        survivor, bit-exact, exactly-once. Deadlines rebase from the
        persisted remaining budget onto THIS process's monotonic clock
        (neither early-expired nor immortal). Finish records re-deliver
        directly — the outcome already happened."""
        now = time.monotonic()
        rem_by_rid: Dict[int, Optional[float]] = {}
        finished_in_wal = 0
        for rec in records:
            kind = rec["t"]
            rid = int(rec["rid"])
            if kind == "submit":
                self._tracked[rid] = _Tracked(
                    rid=rid,
                    prompt=np.asarray(rec["prompt"], np.int64),
                    max_new_tokens=int(rec["max_new_tokens"]),
                    eos_token_id=rec.get("eos_token_id"),
                    temperature=float(rec.get("temperature", 1.0)),
                    seed=int(rec.get("seed", 0)),
                    priority=int(rec.get("priority", 0)),
                    latency_class=str(rec.get("latency_class",
                                              "default")),
                    deadline_at=None,
                    worker=int(rec["worker"]),
                    engine_rid=int(rec["engine_rid"]),
                    tag=rec.get("tag"))
                rem_by_rid[rid] = rec.get("deadline_rem")
                continue
            t = self._tracked.get(rid)
            if kind == "tokens":
                if t is None:
                    continue
                off = int(rec.get("off", 0))
                toks = np.asarray(rec.get("toks", []), np.int64)
                t.ledger = np.concatenate([t.ledger[:off], toks])
                rem_by_rid[rid] = rec.get("deadline_rem")
            elif kind == "requeue":
                if t is None:
                    continue
                t.prompt = np.asarray(rec["prompt"], np.int64)
                t.max_new_tokens = int(rec["max_new_tokens"])
                t.replayed_tokens = int(rec.get("replayed_tokens", 0))
                t.excluded = {int(x) for x in rec.get("excluded", [])}
                t.attempts = list(rec.get("attempts", []))
                t.worker = int(rec["worker"])
                t.engine_rid = int(rec["engine_rid"])
                t.ledger = np.zeros((0,), np.int64)
                rem_by_rid[rid] = rec.get("deadline_rem")
            elif kind == "migrate":
                if t is None:
                    continue
                t.worker = int(rec["worker"])
                t.engine_rid = int(rec["engine_rid"])
                t.attempts.append(str(rec.get("to", "")))
                t.migrations.append(str(rec.get("to", "")))
            elif kind == "finish":
                finished_in_wal += 1
                if "etype" in rec:
                    self._errors[rid] = self._rebuild_error(
                        rec["etype"], rec.get("error", ""), rid)
                else:
                    self._results[rid] = GenerateResult.wrap(
                        np.asarray(rec.get("tokens", []), np.int64),
                        rec.get("resil"))
        if self._tracked:
            self._next_id = max(self._tracked) + 1
            self._c_submitted.inc(len(self._tracked))
        if self._results:
            self._c_completed.inc(len(self._results))
        for rid, rem in rem_by_rid.items():
            t = self._tracked.get(rid)
            if t is not None:
                t.deadline_at = (None if rem is None
                                 else now + max(0.0, float(rem)))
        unresolved = [rid for rid in self._tracked
                      if rid not in self._results
                      and rid not in self._errors]
        for rid in unresolved:
            self._wal_tokens[rid] = int(self._tracked[rid].ledger.size)

        # adopt the live fleet: wait for worker heartbeats to land on
        # THIS observer's clock, then handshake each worker for the
        # engine ids it still accounts for
        try:
            self.elastic.wait_for([h.name for h in self.workers],
                                  timeout_s=10.0)
        except Exception:
            pass    # stragglers strike below and their work replays
        sink: List[Tuple[int, Any]] = []
        known_by_rank: Dict[int, Set[int]] = {}
        for h in self.workers:
            try:
                info = self._call(h, "adopt")
            except Exception as e:
                self._strike(h, e, sink)
                continue
            h.queued = int(info.get("queued", 0))
            h.occupied = int(info.get("occupied", 0))
            known_by_rank[h.rank] = {int(x)
                                     for x in info.get("known", [])}
        resumed = replayed = finished_in_gap = 0
        for rid in sorted(unresolved):
            t = self._tracked[rid]
            h = next((w for w in self.workers
                      if w.rank == t.worker), None)
            if (h is not None and h.state == "healthy"
                    and t.engine_rid in known_by_rank.get(h.rank,
                                                          set())):
                self._by_engine[h.rank][t.engine_rid] = rid
                try:
                    res = self._call(h, "result", t.engine_rid)
                except Exception as e:
                    self._strike(h, e, sink)
                    if self._by_engine[h.rank].get(
                            t.engine_rid) == rid:
                        # transient op failure on a live worker: stay
                        # assigned, the serving loop resolves it
                        self._c_resumed.inc()
                        resumed += 1
                    else:
                        # the strike tripped the breaker and
                        # _declare_dead already replayed every rid it
                        # held, this one included
                        replayed += 1
                    continue
                if res is not None:
                    # finished during the control-plane outage: the
                    # worker's results table already holds the outcome
                    finished_in_gap += 1
                    if isinstance(res, BaseException):
                        self._deliver(h, t.engine_rid, "error", res,
                                      None)
                    else:
                        self._deliver(h, t.engine_rid, "tokens",
                                      res[0], res[1])
                else:
                    self._c_resumed.inc()
                    resumed += 1
                continue
            # the worker is gone, or released the row (migration in
            # flight when the frontend died): ledger-replay
            dead = h if h is not None else WorkerHandle(
                name=f"rank{t.worker}", rank=t.worker, role="decode",
                pid=0, state="dead")
            replayed += 1
            self._requeue(rid, dead, ReplicaDeadError(
                f"request {rid}: its worker (rank {t.worker}) did not "
                f"survive the frontend failover",
                replica=dead.name), sink, exclude=False)
        self.recovery_report = {
            "epoch": self.epoch,
            "wal_records": len(records),
            "finished_in_wal": finished_in_wal,
            "finished_in_gap": finished_in_gap,
            "resumed": resumed,
            "replayed": replayed,
            "unresolved": self.in_flight(),
        }
        record_event(ReplicaEvent(
            site="serving.cluster", replica="frontend",
            action="failover_recovered",
            detail=f"epoch {self.epoch}: {len(records)} WAL records, "
                   f"{resumed} resumed in place, {replayed} replayed, "
                   f"{finished_in_gap} finished during the outage"))

    def _health(self) -> Dict[str, Any]:
        """Frontend /healthz verdict: 200 while a QUORUM of workers is
        reachable and the WAL is writable, 503 otherwise."""
        healthy = sum(1 for h in self.workers if h.state == "healthy")
        quorum = len(self.workers) // 2 + 1
        wal_ok = self._wal is None or self._wal.healthy()
        return {"ok": healthy >= quorum and wal_ok,
                "epoch": self.epoch,
                "healthy_workers": healthy,
                "workers": len(self.workers), "quorum": quorum,
                "wal_ok": wal_ok,
                "wal": (None if self._wal is None
                        else self._wal.stats())}

    # -- fleet observability -----------------------------------------------
    def worker_metrics(self) -> Dict[str, dict]:
        """RPC metrics snapshot per live worker — the bench's
        accounting source (prefill dispatches live ONLY on the prefill
        pool, chunk dispatches ONLY on the decode pool)."""
        out = {}
        for h in self.workers:
            if h.state == "dead":
                continue
            try:
                out[h.name] = self._call(h, "metrics")
            except Exception as e:
                out[h.name] = {"error": f"{type(e).__name__}: "
                                        f"{str(e)[:200]}"}
        return out

    def _scrape_worker_metrics(self) -> str:
        """Fetch every live worker's own /metrics and concatenate —
        the samples are already labelled ``{worker="<name>"}`` by each
        worker's exporter, so verbatim concatenation IS the fleet
        exposition."""
        parts = []
        for h in self.workers:
            if h.state == "dead" or not h.obs_port:
                parts.append(f"# worker {h.name} not scraped "
                             f"(state={h.state})\n")
                continue
            try:
                with urllib.request.urlopen(
                        f"http://127.0.0.1:{h.obs_port}/metrics",
                        timeout=2.0) as r:
                    parts.append(r.read().decode())
            except Exception as e:
                parts.append(f"# worker {h.name} unreachable: "
                             f"{type(e).__name__}\n")
        return "".join(parts)

    def _worker_statusz(self, h: WorkerHandle) -> dict:
        if h.state == "dead" or not h.obs_port:
            return {"state": h.state, "unreachable": True}
        with urllib.request.urlopen(
                f"http://127.0.0.1:{h.obs_port}/statusz",
                timeout=2.0) as r:
            return json.loads(r.read().decode())

    def status(self) -> Dict[str, Any]:
        """The frontend's own /statusz block: per-worker health + the
        request accounting."""
        return {
            "recover": self.recover,
            "epoch": self.epoch,
            "wal": None if self._wal is None else self._wal.stats(),
            "recovery": self.recovery_report,
            "workers": [{
                "name": h.name, "rank": h.rank, "role": h.role,
                "pid": h.pid, "state": h.state,
                "weights_version": h.weights_version,
                "consecutive_fatal": h.consecutive_fatal,
                "missed_beats": h.missed_beats,
                "deaths": h.deaths, "last_error": h.last_error,
                "assigned": len(self._by_engine[h.rank]),
                "queued": h.queued, "occupied": h.occupied,
                "obs_port": h.obs_port,
            } for h in self.workers],
            "requests": {
                "submitted": int(self._c_submitted.value),
                "completed": int(self._c_completed.value),
                "requeued": int(self._c_requeued.value),
                "dead_letter": int(self._c_dead_letter.value),
                "shed_requeue_deadline":
                    int(self._c_shed_requeue.value),
                "in_flight": self.in_flight(),
            },
        }

    def snapshot(self) -> Dict[str, Any]:
        """Flight-recorder state hook (postmortem view)."""
        return self.status()

    def metrics(self) -> Dict[str, Any]:
        """Fleet-level accounting counters."""
        self._sync_slab_retries()
        return {
            "workers": len(self.workers),
            "healthy": sum(1 for h in self.workers
                           if h.state == "healthy"),
            "states": {h.name: h.state for h in self.workers},
            "submitted": int(self._c_submitted.value),
            "completed": int(self._c_completed.value),
            "requeued": int(self._c_requeued.value),
            "worker_deaths": int(self._c_deaths.value),
            "worker_restarts": int(self._c_restarts.value),
            "requests_resumed": int(self._c_resumed.value),
            "dead_letter": int(self._c_dead_letter.value),
            "shed_requeue_deadline": int(self._c_shed_requeue.value),
            "disaggregated_admissions": int(self._c_disagg.value),
            "disaggregation_fallbacks":
                int(self._c_disagg_fallback.value),
            "migrations": int(self._c_migrations.value),
            "evacuations": int(self._c_evacuations.value),
            "proactive_evacuations": int(self._c_proactive.value),
            "rolling_restarts": int(self._c_rolling.value),
            "slab_retries": int(self._c_slab_retries.value),
            "frontend_epoch": self.epoch,
            "wal_bytes_written": int(self._c_wal_bytes.value),
            "wal": None if self._wal is None else self._wal.stats(),
        }

    def start_exporter(self, port: Optional[int] = None) -> int:
        """ONE fleet /metrics + /statusz: the frontend's registry, a
        live-scraped concatenation of every worker's (per-worker-
        labelled) /metrics, and per-worker /statusz blocks fetched at
        request time. Returns the bound port."""
        if self._exporter is not None:
            return self._exporter.port
        from paddle_tpu_torch.obs.exporter import (ObsExporter,
                                             resolve_export_port)
        p = resolve_export_port() if port is None else int(port)
        if port is None and p == 0:
            return 0
        exp = ObsExporter(port=p)
        exp.add_registry("cluster", self.registry)
        exp.add_status_provider("cluster", self.status)
        exp.add_text_provider("workers", self._scrape_worker_metrics)
        exp.set_health_provider(self._health)
        for h in self.workers:
            exp.add_status_provider(
                f"worker:{h.name}",
                lambda h=h: self._worker_statusz(h))
        self._exporter = exp
        return exp.start()

    def stop_exporter(self) -> None:
        exp, self._exporter = self._exporter, None
        if exp is not None:
            exp.stop()
