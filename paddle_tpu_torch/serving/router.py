"""Fault-isolated replicated serving: replica pool, router, requeue.

Counterpart of ``paddle_tpu/serving/router.py``
(the port's own copy: it imports nothing of the JAX package).

The single-engine ``ServingEngine`` is one queue feeding one carry: a
failed chunk dispatch walks the degradation ladder for EVERY in-flight
request, and a dead backend loses all of them. This module is the
multi-replica answer (ROADMAP: "per-replica schedulers + a router would
let replicas fail independently"):

- :class:`ReplicaSet` wraps N INDEPENDENT ``ServingEngine`` replicas —
  each its own scheduler, carry and (optionally) mesh/bundle — with
  per-replica health bookkeeping: a heartbeat stamped off every
  successful step (gated through the fault injector's
  ``dead_heartbeat``/``delay_heartbeat`` plans, so the hung-replica
  drill reuses the elastic machinery), a consecutive-fatal strike
  counter, and a typed circuit breaker.

- :class:`Router` dispatches ``submit`` by CACHE AFFINITY first (the
  request's ``prefix_group`` digest probed against each replica's
  prefix cache — a guaranteed slab hit beats an idle replica) and
  LEAST-LOADED otherwise (queue depth + occupied slots), skipping dead,
  fenced and heartbeat-suspect replicas. ``step()`` drives every live
  replica; a replica whose step raises a classified-fatal error (or an
  exhausted ladder's ``DecodeFailedError``) takes a breaker strike, and
  after ``breaker_threshold`` consecutive strikes the breaker OPENS
  (typed :class:`ReplicaDeadError`, ``ReplicaEvent`` into the
  resilience spine): the replica is fenced and its accepted work is
  REQUEUED to survivors.

- Requeue with exclusion: in-flight requests leave the dead replica
  with their already-generated tokens (harvested chunk pieces — each
  piece landed exactly once, in order, so the per-request monotonic
  chunk seq makes replay dedup-safe) and re-enter a surviving replica
  as ``prompt + tokens_so_far`` with the remaining budget; the
  ``excluded_replicas`` set grows by the dead replica so the queue pop
  can never hand the work straight back. Greedy outputs stay BIT-EXACT
  with an undisturbed run (teacher-forcing the same tokens reproduces
  the same logits — the admission-parity contract). A request that runs
  out of replicas resolves to a typed ``ReplicaDeadError``; one whose
  deadline expired before requeue resolves to a typed
  ``DeadlineExceededError`` (no zombie retries). Accepted work is never
  silently dropped and never double-emitted.

Observability: ``start_exporter()`` attaches every replica's registry
(labelled ``{replica="<name>"}``) and full engine status to the
existing /metrics /statusz plane — one attach call per replica, no new
endpoint — plus the router's own health block; the flight recorder's
postmortems gain the per-replica state via ``add_state``.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Dict, List, Optional, Sequence, Set, Tuple

import numpy as np

import paddle_tpu_torch.obs as obs
from paddle_tpu_torch.obs.metrics import MetricsRegistry
from paddle_tpu_torch.runtime.resilience import (DeadlineExceededError,
                                           DecodeFailedError,
                                           ReplicaDeadError, ReplicaEvent,
                                           classify_error, fault_injector,
                                           record_event)
from paddle_tpu_torch.serving.engine import ServingEngine

__all__ = ["Replica", "ReplicaSet", "Router"]


@dataclasses.dataclass
class Replica:
    """One engine + its health bookkeeping."""
    idx: int
    name: str
    engine: ServingEngine
    state: str = "healthy"          # healthy | suspect | dead
    consecutive_fatal: int = 0
    missed_beats: int = 0
    last_heartbeat: float = dataclasses.field(
        default_factory=time.monotonic)
    deaths: int = 0
    last_error: Optional[str] = None

    def has_work(self) -> bool:
        sch = self.engine.scheduler
        return bool(len(sch) or sch.slots.occupied())

    def load(self) -> int:
        sch = self.engine.scheduler
        return len(sch) + len(sch.slots.occupied())


class ReplicaSet:
    """N independent ``ServingEngine`` replicas under one health table.

    Build with pre-constructed engines (each should carry a distinct
    ``replica_tag``) or via :meth:`from_backends`, which constructs one
    engine per backend with ``replica_tag="replica<i>"`` — the tag arms
    the per-replica fault-injection sites
    (``serving.replica<i>.chunk``/``.step``) the drills target."""

    def __init__(self, engines: Sequence[ServingEngine]):
        if not engines:
            raise ValueError("a ReplicaSet needs at least one engine")
        self.replicas: List[Replica] = []
        for i, eng in enumerate(engines):
            name = eng.replica_tag or f"replica{i}"
            eng.replica_tag = name
            self.replicas.append(Replica(idx=i, name=name, engine=eng))

    @classmethod
    def from_backends(cls, backends: Sequence[Any],
                      **engine_kw) -> "ReplicaSet":
        """One ``ServingEngine(backend, replica_tag="replica<i>")`` per
        backend; ``engine_kw`` (num_slots, chunk_size, snapshot_dir, …)
        applies to every replica."""
        engines = []
        for i, b in enumerate(backends):
            kw = dict(engine_kw)
            if kw.get("snapshot_dir"):
                import os
                kw["snapshot_dir"] = os.path.join(
                    str(kw["snapshot_dir"]), f"replica{i}")
            engines.append(ServingEngine(b, replica_tag=f"replica{i}",
                                         **kw))
        return cls(engines)

    def __len__(self) -> int:
        return len(self.replicas)

    def __iter__(self):
        return iter(self.replicas)

    def live(self) -> List[Replica]:
        return [r for r in self.replicas if r.state != "dead"]

    def routable(self, excluded: Set[int]) -> List[Replica]:
        """Replicas a NEW submit may land on: alive, heartbeat-healthy
        and not excluded. Suspect replicas keep stepping (they may
        recover) but take no new work while suspect."""
        return [r for r in self.replicas
                if r.state == "healthy" and r.idx not in excluded]


@dataclasses.dataclass
class _Tracked:
    """Router-side bookkeeping for one accepted request."""
    rid: int
    prompt: np.ndarray
    max_new_tokens: int
    eos_token_id: Optional[int]
    temperature: float
    seed: int
    priority: int
    latency_class: str
    deadline_at: Optional[float]
    replica: int
    engine_rid: int
    excluded: Set[int] = dataclasses.field(default_factory=set)
    attempts: List[str] = dataclasses.field(default_factory=list)
    replayed_tokens: int = 0
    chunk_seq: int = 0              # monotonic pieces absorbed (dedup)


class Router:
    """Health-checked request router over a :class:`ReplicaSet`.

    ``submit`` returns a ROUTER-level request id; ``step``/``drain``
    drive every live replica and resolve each accepted request to
    either a ``GenerateResult`` (greedy: bit-exact with an undisturbed
    run, replica deaths and requeues included) or a typed error value
    (``DeadlineExceededError`` / ``ReplicaDeadError``) — read both via
    :meth:`outcome`. ``breaker_threshold`` consecutive classified-fatal
    chunks open a replica's breaker; ``unfence`` revives it with a
    fresh carry."""

    def __init__(self, replicas, breaker_threshold: int = 2,
                 heartbeat_miss_threshold: int = 2,
                 heartbeat_timeout_s: float = 30.0):
        if isinstance(replicas, ReplicaSet):
            self.replicas = replicas
        else:
            self.replicas = ReplicaSet(list(replicas))
        if breaker_threshold < 1:
            raise ValueError(
                f"breaker_threshold must be >= 1, got {breaker_threshold}")
        self.breaker_threshold = int(breaker_threshold)
        self.heartbeat_miss_threshold = int(heartbeat_miss_threshold)
        self.heartbeat_timeout_s = float(heartbeat_timeout_s)
        self._tracked: Dict[int, _Tracked] = {}
        self._by_engine: List[Dict[int, int]] = [
            {} for _ in self.replicas.replicas]   # engine_rid -> rid
        self._results: Dict[int, Any] = {}
        self._errors: Dict[int, BaseException] = {}
        self._next_id = 0
        self._exporter = None
        self.registry = MetricsRegistry()
        r = self.registry
        self._c_submitted = r.counter(
            "serving.router.submitted", "requests accepted and routed")
        self._c_completed = r.counter(
            "serving.router.completed", "requests resolved with tokens")
        self._c_requeued = r.counter(
            "serving.router.requeued",
            "requests moved off a dead replica onto a survivor "
            "(already-generated tokens replayed, replica excluded)")
        self._c_deaths = r.counter(
            "serving.router.replica_deaths",
            "circuit breakers opened (K consecutive fatal chunks)")
        self._c_strikes = r.counter(
            "serving.router.strikes",
            "classified-fatal replica steps (breaker input)")
        self._c_dead_letter = r.counter(
            "serving.router.dead_letter",
            "requests resolved as typed ReplicaDeadError: every "
            "candidate replica dead or excluded")
        self._c_shed_requeue = r.counter(
            "serving.router.shed_requeue_deadline",
            "requests whose deadline expired before requeue (typed "
            "DeadlineExceededError — no zombie retries)")
        self._c_suspect = r.counter(
            "serving.router.heartbeat_suspects",
            "healthy->suspect transitions (missed/late heartbeats)")
        self._g_healthy = r.gauge(
            "serving.router.healthy_replicas", "replicas taking traffic")
        self._g_healthy.set(len(self.replicas))
        # postmortems gain the per-replica state: breaker/heartbeat/
        # occupancy per replica at crash time
        obs.flight_recorder.add_state("serving.router", self)

    # -- routing -----------------------------------------------------------
    def submit(self, prompt, max_new_tokens: int,
               eos_token_id: Optional[int] = None,
               temperature: float = 1.0, seed: int = 0,
               priority: int = 0, latency_class: str = "default",
               deadline_s: Optional[float] = None,
               excluded_replicas: Sequence[int] = ()) -> int:
        """Route one request; returns the router request id. Raises
        typed ``ReplicaDeadError`` when no routable replica exists and
        ``DeadlineExceededError`` when every candidate sheds it (expired
        budget or backpressure) — a refused submit costs nothing."""
        excluded = set(int(i) for i in excluded_replicas)
        cand = self._rank(np.asarray(prompt), excluded)
        if not cand:
            raise ReplicaDeadError(
                f"no routable replica (excluded={sorted(excluded)}, "
                f"states={[r.state for r in self.replicas]})")
        last_shed: Optional[BaseException] = None
        # the router id is the request's STABLE identity across
        # requeues: allocated up front so the engines' request-keyed RNG
        # streams (request_keyed_rng) fold in the same id on every
        # replica the request ever lands on
        rid = self._next_id
        for rep in cand:
            try:
                erid = rep.engine.submit(
                    prompt, max_new_tokens, eos_token_id=eos_token_id,
                    temperature=temperature, seed=seed,
                    priority=priority, latency_class=latency_class,
                    deadline_s=deadline_s, rng_request_id=rid)
            except DeadlineExceededError as e:
                # this replica's queue blows the budget — try the next
                # candidate before giving up (per-replica load shedding)
                last_shed = e
                continue
            self._next_id += 1
            now = time.monotonic()
            self._tracked[rid] = _Tracked(
                rid=rid, prompt=np.asarray(prompt),
                max_new_tokens=int(max_new_tokens),
                eos_token_id=eos_token_id,
                temperature=float(temperature), seed=int(seed),
                priority=int(priority),
                latency_class=str(latency_class),
                deadline_at=(None if deadline_s is None
                             else now + float(deadline_s)),
                replica=rep.idx, engine_rid=erid, excluded=excluded,
                attempts=[rep.name])
            self._by_engine[rep.idx][erid] = rid
            self._c_submitted.inc()
            return rid
        raise last_shed          # every candidate shed it, typed

    def _rank(self, prompt: np.ndarray,
              excluded: Set[int]) -> List[Replica]:
        """Routing order: cache-affinity hits first (the request's
        ``prefix_group`` digest live in a replica's prefix cache =
        a guaranteed slab reuse), then ascending load, FIFO by index on
        ties — deterministic, so fault drills are replayable."""
        cand = self.replicas.routable(excluded)

        def affinity(rep: Replica) -> int:
            cache = rep.engine.prefix_cache
            if cache is None:
                return 1
            from paddle_tpu_torch.serving.prefix_cache import prefix_digests
            digest = prefix_digests(prompt, cache.block_tokens)[-1][1]
            return 0 if cache.has_digest(digest) else 1

        return sorted(cand, key=lambda r: (affinity(r), r.load(), r.idx))

    # -- the serving loop --------------------------------------------------
    def step(self) -> List[Tuple[int, Any]]:
        """One iteration across every live replica. Returns the
        ``(router_rid, outcome)`` pairs resolved this step — outcomes
        are results or typed errors."""
        finished: List[Tuple[int, Any]] = []
        for rep in self.replicas:
            if rep.state == "dead":
                continue
            if not rep.has_work():
                self._beat(rep, ok=True)
                continue
            try:
                for erid, res in rep.engine.step():
                    out = self._deliver(rep, erid, res)
                    if out is not None:
                        finished.append(out)
            except Exception as e:
                self._on_failure(rep, e, finished)
                continue
            rep.consecutive_fatal = 0
            self._beat(rep, ok=True)
        return finished

    def drain(self, max_steps: Optional[int] = None) -> Dict[int, Any]:
        """Step until no live replica has work; returns every outcome
        resolved while draining (results AND typed errors — the
        zero-request-loss accounting reads this)."""
        out: Dict[int, Any] = {}
        steps = 0
        while any(r.has_work() for r in self.replicas.live()):
            for rid, res in self.step():
                out[rid] = res
            steps += 1
            if max_steps is not None and steps > max_steps:
                raise RuntimeError(
                    f"drain did not converge within {max_steps} steps")
        return out

    def outcome(self, rid: int):
        """The resolved outcome: a ``GenerateResult`` or a typed error
        VALUE (``DeadlineExceededError``/``ReplicaDeadError``); None
        while still in flight."""
        if rid in self._results:
            return self._results[rid]
        return self._errors.get(rid)

    def result(self, rid: int):
        """The result array; RAISES the stored typed error for a
        request that resolved to one."""
        if rid in self._errors:
            raise self._errors[rid]
        return self._results.get(rid)

    # -- health ------------------------------------------------------------
    def _beat(self, rep: Replica, ok: bool) -> None:
        """Heartbeat bookkeeping for one replica step. The beat routes
        through the fault injector's heartbeat hook (node = replica
        name), so ``delay_heartbeat``/``dead_heartbeat`` plans drill the
        hung-replica story: a skipped beat leaves the stamp stale, and
        enough stale beats (or wall-clock age) turn the replica SUSPECT
        — it keeps stepping, but takes no new submits until a clean
        beat lands."""
        now = time.monotonic()
        action = fault_injector.heartbeat_action(rep.name)
        if ok and action == "ok":
            rep.last_heartbeat = now
            rep.missed_beats = 0
            if rep.state == "suspect":
                rep.state = "healthy"
                self._g_healthy.set(len(self.replicas.routable(set())))
                record_event(ReplicaEvent(
                    site="serving.router", replica=rep.name,
                    action="recovered", detail="heartbeat resumed"))
            return
        rep.missed_beats += 1
        stale = (now - rep.last_heartbeat) > self.heartbeat_timeout_s
        if rep.state == "healthy" and (
                rep.missed_beats >= self.heartbeat_miss_threshold
                or stale):
            rep.state = "suspect"
            self._c_suspect.inc()
            self._g_healthy.set(len(self.replicas.routable(set())))
            record_event(ReplicaEvent(
                site="serving.router", replica=rep.name,
                action="suspect",
                detail=f"{rep.missed_beats} missed beats, last beat "
                       f"{now - rep.last_heartbeat:.3f}s ago"))

    def _on_failure(self, rep: Replica, error: BaseException,
                    finished: List[Tuple[int, Any]]) -> None:
        """A replica step raised. The engine already harvested
        finishable rows into its results (collect them — they are
        complete, bit-exact outputs); then count the strike and trip the
        breaker at K consecutive."""
        for erid in list(self._by_engine[rep.idx]):
            res = rep.engine.result(erid)
            if res is not None:
                out = self._deliver(rep, erid, res)
                if out is not None:
                    finished.append(out)
        fatal = (isinstance(error, DecodeFailedError)
                 or classify_error(error) == "fatal")
        rep.consecutive_fatal += 1
        rep.last_error = f"{type(error).__name__}: {str(error)[:200]}"
        self._c_strikes.inc()
        record_event(ReplicaEvent(
            site="serving.router", replica=rep.name, action="strike",
            detail=f"{'fatal' if fatal else 'transient-exhausted'} "
                   f"chunk: {rep.last_error} "
                   f"({rep.consecutive_fatal}/{self.breaker_threshold})"))
        self._beat(rep, ok=False)
        if rep.consecutive_fatal >= self.breaker_threshold:
            self._trip(rep, error, finished)

    def _trip(self, rep: Replica, error: BaseException,
              finished: List[Tuple[int, Any]]) -> None:
        """Open the breaker: fence the replica and requeue its accepted
        work to survivors with the dead replica excluded."""
        rep.state = "dead"
        rep.deaths += 1
        self._c_deaths.inc()
        self._g_healthy.set(len(self.replicas.routable(set())))
        dead_err = ReplicaDeadError(
            f"replica {rep.name} circuit breaker open after "
            f"{rep.consecutive_fatal} consecutive fatal chunks: "
            f"{rep.last_error}", replica=rep.name, last_error=error)
        record_event(ReplicaEvent(
            site="serving.router", replica=rep.name,
            action="breaker_open", detail=str(dead_err)[:300]))
        obs.record_crash("serving.replica_dead", error=dead_err,
                         extra={"replica": rep.name,
                                "strikes": rep.consecutive_fatal})
        # requeue in-flight first (they hold generated tokens), then the
        # queue (plain resubmits), all with the dead replica excluded
        inflight = rep.engine.export_inflight()
        queued = rep.engine.take_queued()
        rep.engine.clear_inflight()
        moved = self._by_engine[rep.idx]
        for req, toks, pieces in inflight:
            rid = moved.pop(req.id, None)
            if rid is None:
                continue
            self._requeue(rid, rep, dead_err, finished,
                          replay=np.asarray(toks), pieces=pieces)
        for req in queued:
            rid = moved.pop(req.id, None)
            if rid is None:
                continue
            self._requeue(rid, rep, dead_err, finished)

    def _requeue(self, rid: int, dead: Replica,
                 dead_err: ReplicaDeadError,
                 finished: List[Tuple[int, Any]],
                 replay: Optional[np.ndarray] = None,
                 pieces: int = 0) -> None:
        t = self._tracked[rid]
        t.excluded.add(dead.idx)
        now = time.monotonic()
        if t.deadline_at is not None and now > t.deadline_at:
            # no zombie retries: an expired request is resolved typed,
            # not resubmitted
            self._c_shed_requeue.inc()
            err = DeadlineExceededError(
                f"request {rid} deadline expired before requeue off "
                f"dead replica {dead.name}", request_id=rid)
            self._errors[rid] = err
            finished.append((rid, err))
            record_event(ReplicaEvent(
                site="serving.router", replica=dead.name, action="shed",
                detail=f"request {rid} expired before requeue"))
            return
        # replay: the survivor prefills prompt+generated — teacher
        # forcing the SAME tokens reproduces the same logits, so greedy
        # continuation is bit-exact; pieces absorbed exactly once, in
        # chunk-seq order (never double-emitted)
        prompt = t.prompt
        remaining = t.max_new_tokens
        if replay is not None and replay.size:
            prompt = np.concatenate(
                [np.asarray(t.prompt),
                 replay.astype(np.asarray(t.prompt).dtype)])
            remaining = t.max_new_tokens - int(replay.size)
        t.replayed_tokens += 0 if replay is None else int(replay.size)
        t.chunk_seq += int(pieces)
        cand = self._rank(prompt, t.excluded)
        if not cand:
            self._c_dead_letter.inc()
            err = ReplicaDeadError(
                f"request {rid}: no surviving replica "
                f"(excluded={sorted(t.excluded)})",
                replica=dead.name, last_error=dead_err.last_error)
            self._errors[rid] = err
            finished.append((rid, err))
            return
        rep = cand[0]
        rem_deadline = (None if t.deadline_at is None
                        else t.deadline_at - now)
        try:
            erid = rep.engine.submit(
                prompt, remaining, eos_token_id=t.eos_token_id,
                temperature=t.temperature, seed=t.seed,
                priority=t.priority, latency_class=t.latency_class,
                deadline_s=rem_deadline, rng_request_id=rid,
                rng_tokens_emitted=t.replayed_tokens)
        except DeadlineExceededError as e:
            self._c_shed_requeue.inc()
            self._errors[rid] = e
            finished.append((rid, e))
            return
        except Exception as e:
            # a requeue must resolve the request one way or the other:
            # an unexpected refusal (e.g. the grown replay prompt no
            # longer fits a bucket) becomes a typed dead-letter, never a
            # raise that loses the rest of the dead replica's work
            self._c_dead_letter.inc()
            err = ReplicaDeadError(
                f"request {rid}: requeue to {rep.name} refused: "
                f"{type(e).__name__}: {str(e)[:200]}",
                replica=dead.name, last_error=e)
            self._errors[rid] = err
            finished.append((rid, err))
            return
        t.replica = rep.idx
        t.engine_rid = erid
        t.attempts.append(rep.name)
        self._by_engine[rep.idx][erid] = rid
        self._c_requeued.inc()
        record_event(ReplicaEvent(
            site="serving.router", replica=rep.name, action="requeue",
            detail=f"request {rid} moved off {dead.name} with "
                   f"{t.replayed_tokens} tokens replayed "
                   f"(chunk seq {t.chunk_seq})"))

    def _deliver(self, rep: Replica, erid: int,
                 res: Any) -> Optional[Tuple[int, Any]]:
        rid = self._by_engine[rep.idx].pop(erid, None)
        if rid is None:
            return None
        t = self._tracked[rid]
        if isinstance(res, BaseException):
            self._errors[rid] = res
            return rid, res
        rec = getattr(res, "resilience", None)
        if rec is not None:
            # the router's audit trail rides the same record: which
            # replicas served this request, how many tokens were
            # replayed across requeues, the dedup chunk seq
            rec["router"] = {
                "replicas": list(t.attempts),
                "requeues": len(t.attempts) - 1,
                "replayed_tokens": t.replayed_tokens,
                "chunk_seq": t.chunk_seq + rec["serving"]["chunks"],
            }
        self._results[rid] = res
        self._c_completed.inc()
        return rid, res

    # -- lifecycle / observability -----------------------------------------
    def unfence(self, idx: int) -> None:
        """Close a tripped breaker: rebuild the replica's carry fresh
        and put it back in rotation (its strikes and missed beats reset;
        its deaths counter keeps history)."""
        rep = self.replicas.replicas[int(idx)]
        if rep.state != "dead":
            raise ValueError(f"replica {rep.name} is {rep.state}, "
                             f"not fenced")
        rep.engine.reset_state()
        rep.state = "healthy"
        rep.consecutive_fatal = 0
        rep.missed_beats = 0
        rep.last_heartbeat = time.monotonic()
        self._g_healthy.set(len(self.replicas.routable(set())))
        record_event(ReplicaEvent(
            site="serving.router", replica=rep.name, action="unfenced",
            detail="breaker closed; fresh carry"))

    def status(self) -> Dict[str, Any]:
        """The router's /statusz block: per-replica health + the
        request-accounting counters. Full per-replica engine status
        lives under each replica's own attachment."""
        now = time.monotonic()
        return {
            "replicas": [{
                "name": r.name,
                "state": r.state,
                "consecutive_fatal": r.consecutive_fatal,
                "missed_beats": r.missed_beats,
                "heartbeat_age_s": round(now - r.last_heartbeat, 4),
                "deaths": r.deaths,
                "last_error": r.last_error,
                "queue_depth": len(r.engine.scheduler),
                "occupancy_now": r.engine.scheduler.slots.occupancy(),
            } for r in self.replicas],
            "breaker_threshold": self.breaker_threshold,
            "requests": {
                "submitted": int(self._c_submitted.value),
                "completed": int(self._c_completed.value),
                "requeued": int(self._c_requeued.value),
                "dead_letter": int(self._c_dead_letter.value),
                "shed_requeue_deadline": int(
                    self._c_shed_requeue.value),
                "in_flight": len(self._tracked) - len(self._results)
                - len(self._errors),
            },
        }

    def snapshot(self) -> Dict[str, Any]:
        """Flight-recorder state hook: the health table a postmortem
        shows (same shape as :meth:`status`)."""
        return self.status()

    def snapshot_all(self, path: str) -> Dict[str, str]:
        """Checkpoint every live replica's carry + bookkeeping under
        ``path/<replica>`` (the whole-pool graceful-drain export)."""
        import os
        out = {}
        for rep in self.replicas.live():
            out[rep.name] = rep.engine.snapshot(
                os.path.join(path, rep.name))
        return out

    def start_exporter(self, port: Optional[int] = None) -> int:
        """The live telemetry plane over the whole pool: ONE exporter,
        one ``add_engine`` attachment per replica (metrics labelled
        ``{replica="<name>"}``; statusz gains a block per replica) plus
        the router's registry and health block. Returns the bound port
        (0 = flags say disabled)."""
        if self._exporter is not None:
            return self._exporter.port
        from paddle_tpu_torch.obs.exporter import (ObsExporter,
                                             resolve_export_port)
        p = resolve_export_port() if port is None else int(port)
        if port is None and p == 0:
            return 0
        exp = ObsExporter(port=p)
        for rep in self.replicas:
            exp.add_engine(rep.engine, name=rep.name,
                           labels={"replica": rep.name})
        exp.add_registry("router", self.registry)
        exp.add_status_provider("router", self.status)
        self._exporter = exp
        return exp.start()

    def stop_exporter(self) -> None:
        exp, self._exporter = self._exporter, None
        if exp is not None:
            exp.stop()

    def metrics(self) -> Dict[str, Any]:
        """Pool-level accounting: the router counters + per-replica
        health states. Per-replica serving metrics stay on each
        engine's own ``metrics()``."""
        return {
            "replicas": len(self.replicas),
            "healthy": len(self.replicas.routable(set())),
            "states": {r.name: r.state for r in self.replicas},
            "submitted": int(self._c_submitted.value),
            "completed": int(self._c_completed.value),
            "requeued": int(self._c_requeued.value),
            "replica_deaths": int(self._c_deaths.value),
            "dead_letter": int(self._c_dead_letter.value),
            "shed_requeue_deadline": int(self._c_shed_requeue.value),
            "heartbeat_suspects": int(self._c_suspect.value),
        }
