"""Resilience layer: typed events and failures, the retry loop, fault
injection and the decode result carrier.

Counterpart of ``paddle_tpu/runtime/resilience.py`` (its own copy: the
module imports nothing of the JAX package). One vocabulary for every
failure path of the port:

- **Typed events** -- ``RetryEvent``, ``DegradationEvent``,
  ``ReplicaEvent`` and ``FaultEvent``, logged process-wide (``record_event`` /
  ``drain_events`` / ``recent_events``) and, with obs on, mirrored into
  the obs registry and tracer.
- **resilient_call** -- the one retry loop: ``classify_error`` sorts an
  exception into transient (the JAX package's markers, verbatim:
  ``UNAVAILABLE``, ``DEADLINE_EXCEEDED``, ``ABORTED``, connection drops;
  "out of memory" / ``RESOURCE_EXHAUSTED`` only in the ``"setup"``
  phase) or fatal, and retries transients with exponential backoff.
  On a card the markers meet few real errors: a sticky CUDA error
  (illegal address, launch failure) matches none of them and is fatal,
  rightly, since the context is dead, and ``torch.cuda.OutOfMemoryError``
  ("out of memory") is transient only during setup. So on the card the
  transient errors the ladder absorbs are the injected ones.
- **FaultInjector** -- a deterministic plan of rules: ``dispatch_error``
  and ``oom`` at the decoder's dispatch sites (``on_call``, fired before
  a dispatch touches its carry), ``torn_write`` and ``bit_flip`` at
  ``atomic_write_bytes``, the heartbeat kinds at ``heartbeat_action``
  (``distributed/elastic.py``, the router's replica heartbeats) and the
  RPC kinds at ``rpc_action`` (every ``distributed/rpc.py`` send). The
  port's injector reads no environment plan (the JAX package's
  ``PADDLE_TPU_FAULT_PLAN`` is its own): ``configure`` / ``clear``
  install one, and a cluster worker receives its plan in its config.
- **Typed failures** -- ``DecodeFailedError`` (every rung of the ladder
  failed), ``CorruptCheckpointError``, ``SlabTransferError``,
  ``DeadlineExceededError``, ``ReplicaDeadError``,
  ``WeightVersionError``, ``StaleEpochError``, ``InjectedFault``.

The degradation ladder itself lives in ``inference/generate.py``
(speculative -> chunked -> fused -> per-token) and
``serving/engine.py`` (speculative -> chunked -> the per-token rung).
"""

from __future__ import annotations

import collections
import dataclasses
import fnmatch
import json
import os
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np

from paddle_tpu_torch.flags import flags as _flags

__all__ = ["RetryEvent", "DegradationEvent", "ReplicaEvent", "FaultEvent",
           "InjectedFault", "CorruptCheckpointError", "CorruptBundleError",
           "DecodeFailedError",
           "DeadlineExceededError", "ReplicaDeadError", "SlabTransferError",
           "WeightVersionError", "StaleEpochError",
           "TRANSIENT_MARKERS", "SETUP_TRANSIENT_MARKERS",
           "classify_error", "resilient_call", "FaultInjector",
           "fault_injector", "atomic_write_bytes", "record_event",
           "drain_events", "recent_events", "GenerateResult"]


@dataclasses.dataclass(frozen=True)
class RetryEvent:
    """One transient failure absorbed by ``resilient_call``."""
    site: str
    attempt: int            # 1-based attempt that failed
    max_attempts: int
    error_class: str
    error: str              # truncated message
    delay_s: float          # backoff slept before the next attempt
    kind: str = "retry"

    def as_dict(self) -> dict:
        return dataclasses.asdict(self)


@dataclasses.dataclass(frozen=True)
class DegradationEvent:
    """One automatic step down the decode ladder."""
    site: str
    from_level: str
    to_level: str
    error_class: str
    error: str
    kind: str = "degradation"

    def as_dict(self) -> dict:
        return dataclasses.asdict(self)


@dataclasses.dataclass(frozen=True)
class ReplicaEvent:
    """One replica health transition in the serving router (a chunk
    failure strike, the breaker opening, a heartbeat suspect or recovery,
    fence and unfence, a requeue), so a drill can assert which replica
    failed and what the router did about it."""
    site: str               # e.g. "serving.router"
    replica: str            # replica name ("replica1")
    action: str             # strike|breaker_open|suspect|recovered|
    #                         unfenced|requeue|shed
    detail: str
    kind: str = "replica"

    def as_dict(self) -> dict:
        return dataclasses.asdict(self)


@dataclasses.dataclass(frozen=True)
class FaultEvent:
    """One injected fault firing (the injector's own audit record)."""
    site: str
    fault: str              # plan rule kind
    detail: str
    kind: str = "fault"

    def as_dict(self) -> dict:
        return dataclasses.asdict(self)


_EVENTS: "collections.deque" = collections.deque(maxlen=512)
_EVENTS_LOCK = threading.Lock()
_EVENT_COUNTERS = {"retry": "resilience.retries",
                   "degradation": "resilience.degradations",
                   "fault": "resilience.faults_injected",
                   "replica": "resilience.replica_events"}


def record_event(ev) -> None:
    """Append a typed event to the bounded process-wide log. With obs on
    it also counts in the global obs registry (``resilience.retries`` /
    ``.degradations`` / ``.faults_injected``) and lands as an instant
    event on the trace; an obs failure is swallowed here."""
    with _EVENTS_LOCK:
        _EVENTS.append(ev)
    try:
        from paddle_tpu_torch import obs
        if obs.enabled():
            kind = getattr(ev, "kind", "event")
            obs.metrics.counter(
                _EVENT_COUNTERS.get(kind, f"resilience.{kind}"),
                "typed resilience events by kind").inc()
            obs.tracer.event(f"resilience.{kind}",
                             site=getattr(ev, "site", ""),
                             **{k: v for k, v in ev.as_dict().items()
                                if k in ("from_level", "to_level",
                                         "attempt", "error_class",
                                         "fault")})
    except Exception:
        pass


def drain_events() -> List[Any]:
    """Pop and return every logged event."""
    with _EVENTS_LOCK:
        out = list(_EVENTS)
        _EVENTS.clear()
    return out


def recent_events() -> List[Any]:
    """The logged events, left in place."""
    with _EVENTS_LOCK:
        return list(_EVENTS)


class InjectedFault(RuntimeError):
    """Raised by FaultInjector hooks. The message STARTS with the status
    code (``UNAVAILABLE: ...``), so the marker classification treats
    injected and real errors alike."""

    def __init__(self, message: str, code: str = "UNAVAILABLE"):
        super().__init__(message)
        self.code = code


class CorruptCheckpointError(RuntimeError):
    """A checkpoint or snapshot failed integrity verification (torn file,
    sha256 mismatch, missing manifest, a carry layout that does not fit)
    and is refused rather than resumed."""


class CorruptBundleError(RuntimeError):
    """An AOT bundle entry's bytes do not match the bundle manifest's
    sha256 (bit-flipped weight constants, truncated module) and the entry
    is refused rather than served."""


class DecodeFailedError(RuntimeError):
    """Every rung of the decode degradation ladder failed. Carries the
    resilience events of the attempt and the last underlying error."""

    def __init__(self, message: str, events: Optional[List[Any]] = None,
                 last_error: Optional[BaseException] = None):
        super().__init__(message)
        self.events = list(events or [])
        self.last_error = last_error


class DeadlineExceededError(RuntimeError):
    """A serving request was shed because its deadline cannot be (or was
    not) met: expired at ``submit()``, refused by queue-depth backpressure
    (the estimated queue delay already exceeds the budget), or expired
    while queued. An admission-control refusal, never a transient worth
    retrying."""

    def __init__(self, message: str, request_id: Optional[int] = None):
        super().__init__(message)
        self.request_id = request_id


class ReplicaDeadError(RuntimeError):
    """A serving replica's circuit breaker is open (K consecutive
    classified-fatal chunks or an exhausted ladder), or a request ran out
    of replicas to run on (every candidate dead or excluded). Carries the
    replica name and the last underlying error."""

    def __init__(self, message: str, replica: Optional[str] = None,
                 last_error: Optional[BaseException] = None):
        super().__init__(message)
        self.replica = replica
        self.last_error = last_error


class SlabTransferError(RuntimeError):
    """A shipped slab or row-migration payload failed integrity
    verification (its end-to-end sha256, or a cache layout that does not
    fit this engine) and is refused rather than absorbed: corrupt KV rows
    in a live carry would decode garbage silently."""

    def __init__(self, message: str, key: Optional[str] = None,
                 part: Optional[int] = None):
        super().__init__(message)
        self.key = key
        self.part = part


class WeightVersionError(RuntimeError):
    """A fleet operation would mix weight versions: migrating live decode
    rows between workers built from different weights files (mid hot
    reload) is refused, since a KV cache computed under v1 and continued
    under v2 is neither's output. Carries both versions."""

    def __init__(self, message: str, src_version: Optional[str] = None,
                 dst_version: Optional[str] = None):
        super().__init__(message)
        self.src_version = src_version
        self.dst_version = dst_version


class StaleEpochError(RuntimeError):
    """An RPC op carried a frontend epoch older than the one this worker
    has already seen: the caller is a zombie incarnation of the control
    plane (declared dead and replaced, still issuing ops), and the op is
    refused so it can never double-serve. Carries the op name and both
    epochs (only the message survives an RPC pickle round trip; the type
    is the contract)."""

    def __init__(self, message: str, op: Optional[str] = None,
                 stale_epoch: Optional[int] = None,
                 current_epoch: Optional[int] = None):
        super().__init__(message)
        self.op = op
        self.stale_epoch = stale_epoch
        self.current_epoch = current_epoch


# markers of transient trouble in any phase (the JAX package's, verbatim)
TRANSIENT_MARKERS: Tuple[str, ...] = (
    "UNAVAILABLE",
    "DEADLINE_EXCEEDED",
    "ABORTED",
    "socket closed",
    "Socket closed",
    "Connection reset",
    "connection reset",
    "Failed to connect",
    "failed to connect",
    "context deadline exceeded",
)

# transient only while setting up (a capture or a first dispatch, where a
# neighbour's spike can hold memory); in steady state the same error
# means the work does not fit
SETUP_TRANSIENT_MARKERS: Tuple[str, ...] = (
    "RESOURCE_EXHAUSTED",
    "Out of memory",
    "out of memory",
)


def classify_error(exc: BaseException, phase: str = "steady") -> str:
    """``"transient"`` (worth a backoff retry) or ``"fatal"``, from the
    message's markers. ``phase``: ``"setup"`` or ``"steady"``."""
    msg = str(exc)
    if any(m in msg for m in TRANSIENT_MARKERS):
        return "transient"
    if phase == "setup" and any(m in msg for m in SETUP_TRANSIENT_MARKERS):
        return "transient"
    return "fatal"


def resilient_call(fn: Callable, *args,
                   retries: Optional[int] = None,
                   backoff: Optional[float] = None,
                   deadline_s: Optional[float] = None,
                   jitter: float = 0.0,
                   phase: str = "steady",
                   site: str = "call",
                   classify: Optional[Callable] = None,
                   on_event: Optional[Callable] = None,
                   sleep: Callable[[float], None] = time.sleep,
                   **kwargs):
    """Call ``fn(*args, **kwargs)``, retrying transient errors up to
    ``retries`` times with backoff ``backoff * 2**(i-1)`` seconds (times
    a uniform factor in ``[1, 1 + jitter)`` when ``jitter > 0``), within
    ``deadline_s`` of elapsed time when given. A fatal error, and the last
    transient one once the budget is spent, propagates unchanged. Each
    absorbed failure emits a ``RetryEvent`` to the process log and to
    ``on_event``. Defaults: ``FLAGS_resilience_retries`` /
    ``_backoff_s`` / ``_deadline_s`` (0 = no deadline)."""
    if retries is None:
        retries = int(_flags.resilience_retries)
    if backoff is None:
        backoff = float(_flags.resilience_backoff_s)
    if deadline_s is None:
        d = float(_flags.resilience_deadline_s)
        deadline_s = d if d > 0 else None
    classify = classify or classify_error
    attempts = max(1, retries + 1)
    t0 = time.monotonic()
    for i in range(1, attempts + 1):
        try:
            return fn(*args, **kwargs)
        except Exception as e:
            if i >= attempts or classify(e, phase) != "transient":
                raise
            delay = backoff * (2 ** (i - 1))
            if jitter > 0:
                import random
                delay *= 1.0 + random.random() * float(jitter)
            if deadline_s is not None and \
                    (time.monotonic() - t0) + delay > deadline_s:
                raise
            ev = RetryEvent(site=site, attempt=i, max_attempts=attempts,
                            error_class=type(e).__name__,
                            error=str(e)[:300], delay_s=delay)
            record_event(ev)
            if on_event is not None:
                on_event(ev)
            sleep(delay)


class FaultInjector:
    """Deterministic, plan-driven fault injection.

    A plan is a list of rules (dicts); sites and paths match with fnmatch
    patterns (a path against the file's name or its whole path), and the
    call schedules are exact counters, so a plan fires at the same
    instant on every run:

    - ``{"kind": "dispatch_error", "site": "decode.chunk", "call": 3,
      "times": 1, "code": "UNAVAILABLE"}`` -- ``on_call`` raises an
      ``InjectedFault`` on the Nth matching call (1-based; default the
      first) and the ``times - 1`` calls after it (default 1).
    - ``{"kind": "oom", "site": "decode.*", "above_batch": 8}`` --
      ``RESOURCE_EXHAUSTED`` whenever an admission hook (an ``on_call``
      given ``batch``) sees a batch above the bound (bound the firings
      with ``times``).

    - ``{"kind": "torn_write", "path": "*state.npz", "at_byte": 100}`` —
      :func:`atomic_write_bytes` writes only the first ``at_byte`` bytes
      (default half) STRAIGHT to the destination, with no atomic rename,
      then raises: a crash mid-write.
    - ``{"kind": "bit_flip", "path": "*.npz", "at_byte": 7}`` — flip one
      bit of the written bytes (default the middle byte): silent media
      corruption that the sha256 manifests must catch on load.
    - ``{"kind": "dead_heartbeat", "node": "node1", "after_beats": 3}``
      -- ``heartbeat_action`` reports the node dead (beats suppressed
      forever) after N beats (default: at once).
    - ``{"kind": "delay_heartbeat", "node": "*", "after_beats": 2,
      "skip_beats": 4}`` -- suppress a window of beats, then resume (the
      stalled but alive member).
    - ``{"kind": "rpc_partition", "src": "0", "dst": "1"}`` -- drop every
      RPC message from rank ``src`` to rank ``dst`` (fnmatch patterns on
      the rank strings). Directional: a symmetric cut takes both rules.
      Sustained unless bounded with ``times``.
    - ``{"kind": "rpc_delay", "src": "*", "dst": "2", "delay_s": 0.5}``
      -- deliver matching messages late (a background timer).
    - ``{"kind": "rpc_duplicate", "src": "0", "dst": "*"}`` -- deliver
      matching messages twice, the copy under a fresh sequence number,
      so the receiver really executes it again.

    A write rule fires ``times`` times (default 1). ``configure(plan)`` /
    ``clear()`` are the only way to install a plan; a cluster worker
    gets its plan through its config. Every firing appends a
    :class:`FaultEvent` to ``self.fired`` and the process event log."""

    def __init__(self):
        self._lock = threading.Lock()
        self._rules: List[dict] = []
        self._counts: Dict[int, int] = {}   # rule idx -> matched count
        self._beats: Dict[str, int] = {}    # node -> beats attempted
        self.fired: List[FaultEvent] = []

    def configure(self, plan) -> "FaultInjector":
        """Install a plan (list of rule dicts, a single dict, or a JSON
        string) and reset all schedule counters."""
        if isinstance(plan, str):
            plan = json.loads(plan)
        if isinstance(plan, dict):
            plan = [plan]
        with self._lock:
            self._rules = [dict(r) for r in (plan or [])]
            self._counts = {}
            self._beats = {}
            self.fired = []
        return self

    def clear(self) -> None:
        self.configure([])

    def active(self) -> bool:
        return bool(self._rules)

    def _fire(self, site: str, rule: dict, detail: str) -> None:
        ev = FaultEvent(site=site, fault=rule["kind"], detail=detail)
        self.fired.append(ev)
        record_event(ev)

    def on_call(self, site: str, batch: Optional[int] = None) -> None:
        """Dispatch-shaped injection point, fired before a dispatch
        touches its carry: raises ``InjectedFault`` where a
        ``dispatch_error`` rule schedules a failure. ``batch`` (given by
        admission hooks such as ``decode.generate``, not by dispatch
        sites) arms the ``oom`` rules instead, so a plan of dispatch
        errors never trips an admission check, and the other way round."""
        if not self._rules:
            return
        with self._lock:
            for idx, rule in enumerate(self._rules):
                kind = rule.get("kind")
                if not fnmatch.fnmatchcase(site, rule.get("site", "*")):
                    continue
                if kind == "oom":
                    if batch is None or batch <= int(rule["above_batch"]):
                        continue
                    times = rule.get("times")
                    n = self._counts.get(idx, 0)
                    if times is not None and n >= int(times):
                        continue
                    self._counts[idx] = n + 1
                    code = rule.get("code", "RESOURCE_EXHAUSTED")
                    detail = (f"batch {batch} > {rule['above_batch']} "
                              f"at {site}")
                    self._fire(site, rule, detail)
                    raise InjectedFault(
                        f"{code}: injected OOM ({detail})", code=code)
                if kind != "dispatch_error" or batch is not None:
                    continue
                n = self._counts.get(idx, 0) + 1
                self._counts[idx] = n
                first = int(rule.get("call", 1))
                times = int(rule.get("times", 1))
                if first <= n < first + times:
                    code = rule.get("code", "UNAVAILABLE")
                    detail = f"call {n} at {site}"
                    self._fire(site, rule, detail)
                    raise InjectedFault(
                        f"{code}: injected transient dispatch error "
                        f"({detail})", code=code)

    def on_write(self, path: str, data: bytes) -> Tuple[bytes, bool]:
        """Write-shaped injection point. Returns ``(bytes_to_write,
        crash)``: ``bit_flip`` corrupts the payload silently; a
        ``torn_write`` truncates it AND sets ``crash`` — the caller writes
        the torn bytes to the real destination (no rename) and raises."""
        if not self._rules:
            return data, False
        name = os.path.basename(path)
        with self._lock:
            for idx, rule in enumerate(self._rules):
                kind = rule["kind"]
                if kind not in ("torn_write", "bit_flip"):
                    continue
                pat = rule.get("path", "*")
                if not (fnmatch.fnmatchcase(name, pat)
                        or fnmatch.fnmatchcase(path, pat)):
                    continue
                n = self._counts.get(idx, 0)
                if n >= int(rule.get("times", 1)):
                    continue
                self._counts[idx] = n + 1
                if kind == "torn_write":
                    cut = int(rule.get("at_byte", max(1, len(data) // 2)))
                    cut = max(0, min(cut, len(data)))
                    self._fire(path, rule,
                               f"torn at byte {cut}/{len(data)}")
                    return data[:cut], True
                at = int(rule.get("at_byte", len(data) // 2))
                at = max(0, min(at, max(0, len(data) - 1)))
                corrupted = bytearray(data)
                if corrupted:
                    corrupted[at] ^= 0x01
                self._fire(path, rule, f"bit flipped at byte {at}")
                return bytes(corrupted), False
        return data, False

    def rpc_action(self, src: str, dst: str) -> Tuple[str, float]:
        """Message-send injection point (``distributed/rpc.py`` routes
        every request and reply write through it). Returns ``(action,
        delay_s)``: ``"ok"`` (deliver), ``"drop"`` (the partition eats
        the message), ``"delay"`` (deliver after ``delay_s``) or ``"dup"``
        (deliver twice). The first matching rule wins; rules match the
        (src, dst) rank strings directionally."""
        if not self._rules:
            return "ok", 0.0
        with self._lock:
            for idx, rule in enumerate(self._rules):
                kind = rule.get("kind")
                if kind not in ("rpc_partition", "rpc_delay",
                                "rpc_duplicate"):
                    continue
                if not fnmatch.fnmatchcase(str(src),
                                           str(rule.get("src", "*"))):
                    continue
                if not fnmatch.fnmatchcase(str(dst),
                                           str(rule.get("dst", "*"))):
                    continue
                times = rule.get("times")   # default: sustained
                n = self._counts.get(idx, 0)
                if times is not None and n >= int(times):
                    continue
                self._counts[idx] = n + 1
                site = f"rpc:{src}->{dst}"
                if kind == "rpc_partition":
                    self._fire(site, rule, f"message {n + 1} dropped")
                    return "drop", 0.0
                if kind == "rpc_delay":
                    d = float(rule.get("delay_s", 0.2))
                    self._fire(site, rule,
                               f"message {n + 1} delayed {d:.3f}s")
                    return "delay", d
                self._fire(site, rule, f"message {n + 1} duplicated")
                return "dup", 0.0
        return "ok", 0.0

    def heartbeat_action(self, node: str) -> str:
        """Heartbeat injection point: ``"ok"`` (beat), ``"dead"``
        (suppress forever) or ``"skip"`` (suppress this beat)."""
        if not self._rules:
            return "ok"
        with self._lock:
            beats = self._beats.get(node, 0)
            self._beats[node] = beats + 1
            for rule in self._rules:
                kind = rule.get("kind")
                if kind not in ("dead_heartbeat", "delay_heartbeat"):
                    continue
                if not fnmatch.fnmatchcase(node, rule.get("node", "*")):
                    continue
                after = int(rule.get("after_beats", 0))
                if beats < after:
                    continue
                if kind == "dead_heartbeat":
                    if beats == after:
                        self._fire(node, rule,
                                   f"heartbeat dead after {after} beats")
                    return "dead"
                skip = int(rule.get("skip_beats", 1))
                if beats < after + skip:
                    if beats == after:
                        self._fire(node, rule,
                                   f"heartbeat delayed {skip} beats "
                                   f"after {after}")
                    return "skip"
        return "ok"


fault_injector = FaultInjector()


def atomic_write_bytes(path: str, data: bytes) -> None:
    """Crash-safe file write: bytes go to ``path + '.tmp.<pid>'`` and are
    fsynced before an atomic ``os.replace``, so a reader never sees a
    half-written file. The one place write faults inject: a ``bit_flip``
    plan corrupts the payload (still renamed atomically); a ``torn_write``
    plan writes the truncated prefix STRAIGHT to ``path`` and raises."""
    data, crash = fault_injector.on_write(path, bytes(data))
    if crash:
        with open(path, "wb") as f:
            f.write(data)
        raise InjectedFault(
            f"DATA_LOSS: injected crash mid-write of {path} "
            f"({len(data)} bytes written)", code="DATA_LOSS")
    tmp = f"{path}.tmp.{os.getpid()}"
    try:
        with open(tmp, "wb") as f:
            f.write(data)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            try:
                os.remove(tmp)
            except OSError:
                pass


class GenerateResult(np.ndarray):
    """An ``np.ndarray`` of tokens that also carries the record of the
    generate/serve call that produced it (``.resilience``: the final
    ladder level, retries, degradations and typed events)."""

    resilience: Optional[dict] = None

    @classmethod
    def wrap(cls, arr: np.ndarray, resilience: Optional[dict]):
        obj = np.asarray(arr).view(cls)
        obj.resilience = resilience
        return obj

    def __array_finalize__(self, obj):
        if obj is not None:
            self.resilience = getattr(obj, "resilience", None)
