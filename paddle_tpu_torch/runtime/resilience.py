"""Typed failures, write-fault injection and the decode result carrier.

Counterpart of ``paddle_tpu/runtime/resilience.py`` (a copy of the parts
the port serves: the module imports nothing of the JAX package). It holds
the typed errors of snapshot/restore, row migration and deadlines
(``CorruptCheckpointError``, ``SlabTransferError``,
``DeadlineExceededError``, ``InjectedFault``), the write side of the
plan-driven ``FaultInjector`` (``torn_write`` and ``bit_flip`` rules, read
by ``atomic_write_bytes``) and ``GenerateResult``. The injector's call,
RPC and heartbeat hooks and the retry and degradation ladder are not
ported yet (ROADMAP.md queue 1, items [9] and [11]); a result's record
names the decode level that produced it.
"""

from __future__ import annotations

import dataclasses
import fnmatch
import json
import os
import threading
from typing import Dict, List, Optional, Tuple

import numpy as np

__all__ = ["InjectedFault", "CorruptCheckpointError",
           "DeadlineExceededError", "SlabTransferError", "FaultEvent",
           "FaultInjector", "fault_injector", "atomic_write_bytes",
           "GenerateResult"]


class InjectedFault(RuntimeError):
    """Raised by FaultInjector hooks. The message STARTS with the status
    code (``DATA_LOSS: ...``), as a backend error's does."""

    def __init__(self, message: str, code: str = "UNAVAILABLE"):
        super().__init__(message)
        self.code = code


class CorruptCheckpointError(RuntimeError):
    """A checkpoint or snapshot failed integrity verification (torn file,
    sha256 mismatch, missing manifest, a carry layout that does not fit)
    and is refused rather than resumed."""


class DeadlineExceededError(RuntimeError):
    """A serving request was shed because its deadline cannot be (or was
    not) met: expired at ``submit()``, refused by queue-depth backpressure
    (the estimated queue delay already exceeds the budget), or expired
    while queued. An admission-control refusal, never a transient worth
    retrying."""

    def __init__(self, message: str, request_id: Optional[int] = None):
        super().__init__(message)
        self.request_id = request_id


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


@dataclasses.dataclass(frozen=True)
class FaultEvent:
    """One injected fault firing (the injector's own audit record)."""
    site: str
    fault: str              # plan rule kind
    detail: str
    kind: str = "fault"


_WRITE_KINDS = ("torn_write", "bit_flip")


class FaultInjector:
    """Deterministic, plan-driven injection of write faults.

    A plan is a list of rules (dicts); paths match with fnmatch patterns
    against the file's name or its whole path:

    - ``{"kind": "torn_write", "path": "*state.npz", "at_byte": 100}`` —
      :func:`atomic_write_bytes` writes only the first ``at_byte`` bytes
      (default half) STRAIGHT to the destination, with no atomic rename,
      then raises: a crash mid-write.
    - ``{"kind": "bit_flip", "path": "*.npz", "at_byte": 7}`` — flip one
      bit of the written bytes (default the middle byte): silent media
      corruption that the sha256 manifests must catch on load.

    Each rule fires ``times`` times (default 1). ``configure(plan)`` /
    ``clear()`` are the only way to install a plan. Every firing appends a
    :class:`FaultEvent` to ``self.fired``. Rules of the JAX injector's
    other kinds (dispatch, heartbeat, RPC) have no injection site in the
    port yet, so ``configure`` refuses them."""

    def __init__(self):
        self._lock = threading.Lock()
        self._rules: List[dict] = []
        self._counts: Dict[int, int] = {}   # rule idx -> matched count
        self.fired: List[FaultEvent] = []

    def configure(self, plan) -> "FaultInjector":
        """Install a plan (list of rule dicts, a single dict, or a JSON
        string) and reset all schedule counters. Only the write kinds
        (``torn_write``, ``bit_flip``) are ported; any other kind raises
        ``NotImplementedError``, so a drill never passes on a rule that
        cannot fire."""
        if isinstance(plan, str):
            plan = json.loads(plan)
        if isinstance(plan, dict):
            plan = [plan]
        rules = [dict(r) for r in (plan or [])]
        for rule in rules:
            if rule.get("kind") not in _WRITE_KINDS:
                raise NotImplementedError(
                    f"fault kind {rule.get('kind')!r} is not ported yet: "
                    "dispatch faults wait for the degradation ladder "
                    "(ROADMAP.md [9]), RPC and heartbeat faults for the "
                    "router (ROADMAP.md [11])")
        with self._lock:
            self._rules = rules
            self._counts = {}
            self.fired = []
        return self

    def clear(self) -> None:
        self.configure([])

    def active(self) -> bool:
        return bool(self._rules)

    def _fire(self, site: str, rule: dict, detail: str) -> None:
        self.fired.append(FaultEvent(site=site, fault=rule["kind"],
                                     detail=detail))

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
    generate/serve call that produced it (``.resilience``)."""

    resilience: Optional[dict] = None

    @classmethod
    def wrap(cls, arr: np.ndarray, resilience: Optional[dict]):
        obj = np.asarray(arr).view(cls)
        obj.resilience = resilience
        return obj

    def __array_finalize__(self, obj):
        if obj is not None:
            self.resilience = getattr(obj, "resilience", None)
