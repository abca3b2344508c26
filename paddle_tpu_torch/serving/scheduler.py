"""Slot-admission scheduling for continuous batching.

Counterpart of ``paddle_tpu/serving/scheduler.py`` (a copy: the port
imports nothing of the JAX package), holding what this slice's engine
uses. Iteration-level batching (Orca — Yu et al., OSDI 2022): the decode
batch is a table of SLOTS, each owning one row of the chunked loop's
carry (``inference/generate.DecodeState``). Between chunk dispatches,
rows whose request finished are released and the admission policy
refills them from the queue — one length-bucketed prefill dispatch per
admitted request — while the batch still runs as one chunk per step.

Pure host-side bookkeeping: the request queue (FIFO or priority), the
slot table, and prompt length bucketing. The device-side state assembly
lives in ``serving/engine.py``. The JAX scheduler's cache-aware ordering,
deadline shedding, requeue export and dp grouping arrive with their
features (ROADMAP.md queue 1).
"""

from __future__ import annotations

import dataclasses
import heapq
import itertools
import time
from typing import List, Optional, Sequence, Tuple

import numpy as np

__all__ = ["Request", "Slot", "SlotTable", "Scheduler", "bucket_length"]


def bucket_length(n: int, buckets: Optional[Sequence[int]] = None) -> int:
    """Smallest admission-prefill bucket that fits an ``n``-token prompt:
    the next power of two (floor 8) by default, or the smallest entry of
    an explicit bucket list."""
    if n < 1:
        raise ValueError(f"prompt must have at least 1 token, got {n}")
    if buckets:
        fits = [int(b) for b in buckets if int(b) >= n]
        if not fits:
            raise ValueError(
                f"prompt length {n} exceeds the largest prefill bucket "
                f"{max(int(b) for b in buckets)}")
        return min(fits)
    b = 8
    while b < n:
        b *= 2
    return b


@dataclasses.dataclass
class Request:
    """One queued generate ask. ``eos_token_id`` is already normalized
    (None = decode to the full budget); ``temperature`` and ``seed`` feed
    a sampling engine's per-row key stream; ``priority`` orders admission
    under the 'priority' policy (lower = sooner), ties broken FIFO.
    ``submit_time`` is a ``time.monotonic()`` stamp; ``Scheduler.push``
    stamps it when the caller didn't."""
    id: int
    prompt: np.ndarray            # (S,) token ids
    max_new_tokens: int
    eos_token_id: Optional[int] = None
    temperature: float = 1.0
    seed: int = 0
    priority: int = 0
    submit_time: float = 0.0      # time.monotonic(); 0.0 = unset


@dataclasses.dataclass
class Slot:
    """One occupied batch row: the request it serves plus the host-side
    reassembly buffer (per-chunk token pieces) and its timing record."""
    request: Request
    admitted_at: float = 0.0
    chunks: int = 0
    tokens: List[np.ndarray] = dataclasses.field(default_factory=list)
    # stamped after the first chunk dispatch the slot rode: the
    # admission->first-token interval is the TTFT sample
    first_token_at: Optional[float] = None


class SlotTable:
    """Which batch row belongs to which in-flight request."""

    def __init__(self, num_slots: int):
        if num_slots < 1:
            raise ValueError(f"need at least 1 slot, got {num_slots}")
        self.entries: List[Optional[Slot]] = [None] * num_slots

    def __len__(self) -> int:
        return len(self.entries)

    def free_slots(self) -> List[int]:
        return [i for i, e in enumerate(self.entries) if e is None]

    def occupied(self) -> List[Tuple[int, Slot]]:
        return [(i, e) for i, e in enumerate(self.entries) if e is not None]

    def occupy(self, request: Request) -> int:
        free = self.free_slots()
        if not free:
            raise RuntimeError("no free slot to occupy")
        i = free[0]
        self.entries[i] = Slot(request=request)
        return i

    def release(self, i: int) -> None:
        if self.entries[i] is None:
            raise RuntimeError(f"slot {i} is already free")
        self.entries[i] = None


class Scheduler:
    """Admission queue + slot table.

    ``policy='fifo'`` admits strictly in submit order; ``'priority'``
    admits by ``Request.priority`` (lower first, FIFO within a class).
    ``admissions()`` implements the between-chunk policy: pop one queued
    request per free slot and occupy it — the engine then prefills each
    admitted request and copies its row into the decode carry."""

    def __init__(self, num_slots: int, policy: str = "fifo",
                 prompt_buckets: Optional[Sequence[int]] = None):
        if policy not in ("fifo", "priority"):
            raise ValueError(f"policy must be 'fifo' or 'priority', "
                             f"got {policy!r}")
        self.policy = policy
        self.prompt_buckets = (sorted(int(b) for b in prompt_buckets)
                               if prompt_buckets else None)
        self.slots = SlotTable(num_slots)
        self._heap: list = []
        self._seq = itertools.count()

    def __len__(self) -> int:
        return len(self._heap)

    def bucket(self, prompt_len: int) -> int:
        return bucket_length(prompt_len, self.prompt_buckets)

    def push(self, request: Request) -> None:
        if not request.submit_time:
            request.submit_time = time.monotonic()
        pr = request.priority if self.policy == "priority" else 0
        heapq.heappush(self._heap, (pr, next(self._seq), request))

    def push_front(self, request: Request) -> None:
        """Re-queue ahead of every same-priority peer (the engine's ring
        is full): the request keeps its ``submit_time`` and retakes its
        tier's head through a negative sequence number. Call in reverse
        admission order when re-queuing several, so the earliest-admitted
        lands frontmost."""
        pr = request.priority if self.policy == "priority" else 0
        heapq.heappush(self._heap, (pr, -next(self._seq), request))

    def admissions(self) -> List[Tuple[int, Request]]:
        """Fill every free slot from the queue; returns the
        ``(slot_index, request)`` pairs admitted this round."""
        free_n = len(self.slots.free_slots())
        picked = [heapq.heappop(self._heap)[2]
                  for _ in range(min(free_n, len(self._heap)))]
        return [(self.slots.occupy(req), req) for req in picked]
