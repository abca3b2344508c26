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
lives in ``serving/engine.py``. With ``cache_aware`` the pop order within
a priority tier bends toward prefix-slab reuse (the JAX scheduler's
``_cache_aware_pops``). ``shed_expired`` drops queued requests past their
deadline; ``queued``, ``take_all`` and ``remove`` export the queue to a
snapshot or a migration payload. The JAX scheduler's dp grouping arrives
with meshes (ROADMAP.md queue 1, item [13]).
"""

from __future__ import annotations

import dataclasses
import heapq
import itertools
import time
from typing import Any, List, Optional, Sequence, Tuple

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
    stamps it when the caller didn't, and ``deadline_at`` from
    ``deadline_s``."""
    id: int
    prompt: np.ndarray            # (S,) token ids
    max_new_tokens: int
    eos_token_id: Optional[int] = None
    temperature: float = 1.0
    seed: int = 0
    priority: int = 0
    submit_time: float = 0.0      # time.monotonic(); 0.0 = unset
    # SLO bucket and targets (None = the engine's default for the class,
    # or no target): they only count violations
    latency_class: str = "default"
    slo_ttft_s: Optional[float] = None
    slo_latency_s: Optional[float] = None
    # hard deadline: ``deadline_s`` is the budget in seconds from submit,
    # ``deadline_at`` the absolute ``time.monotonic()`` expiry. The engine
    # sheds at submit and in the queue, and freezes an in-flight row past
    # it at a chunk boundary (partial, flagged ``deadline_expired``)
    deadline_s: Optional[float] = None
    deadline_at: Optional[float] = None
    # prefix-cache grouping key (the prompt's first block-boundary
    # digest, stamped by the engine when cache-aware admission is on)
    prefix_group: Optional[str] = None
    # multi-tenant LoRA routing: the adapter NAME this request decodes
    # through (None = base model); the engine resolves it to a row of the
    # stacked deltas at admission and pins its revision
    adapter: Optional[str] = None
    # request-keyed RNG stream inputs of the JAX engine's router: carried
    # through snapshot and migration payloads only (the router is ROADMAP
    # item [11])
    rng_request_id: Optional[int] = None
    rng_tokens_emitted: int = 0
    # per-request speculative toggle (speculative engines only): False
    # decodes this row verify-free in the same speculative chunk; None =
    # the engine default (on)
    speculative: Optional[bool] = None


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
    # prefix-cache admission record: the hit class (None = cache off),
    # the prompt tokens whose prefill it skipped, the prefill dispatches
    # its admission issued (0 = full hit, or rode a batched group's
    # dispatch) and the slab pinned for the request's flight
    prefix_hit: Optional[str] = None
    prefill_tokens_saved: int = 0
    admission_dispatches: int = 0
    pinned_slab: Any = None
    # speculative record: the row's cumulative verify rounds and accepted
    # drafts mirrored off the carry after each chunk, and the tokens its
    # chunks committed past the chunk boundary
    spec_rounds: int = 0
    spec_accepted: int = 0
    spec_overflow: int = 0
    # the adapter revision pinned at admission (None = base): a hot swap
    # of this adapter while the row is in flight is a typed refusal
    adapter_rev: Optional[int] = None
    # the resilience events (retries, degradations) of the dispatches this
    # row rode: its admission prefill and every chunk since
    events: List[Any] = dataclasses.field(default_factory=list)
    # streaming: how many of the row's tokens its on_tokens callback has
    # seen; a chunk harvest emits ``seq[streamed:]`` and advances it
    streamed: int = 0


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

    def occupancy(self) -> float:
        return len(self.occupied()) / len(self.entries)

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
    admitted request and copies its row into the decode carry.
    ``cache_aware`` (with ``cache_probe``, a digest -> live-in-cache
    callable) reorders within a priority tier for prefix-slab reuse;
    ``cache_reordered`` counts the requests that jumped a peer."""

    def __init__(self, num_slots: int, policy: str = "fifo",
                 prompt_buckets: Optional[Sequence[int]] = None,
                 cache_aware: bool = False):
        if policy not in ("fifo", "priority"):
            raise ValueError(f"policy must be 'fifo' or 'priority', "
                             f"got {policy!r}")
        self.policy = policy
        self.prompt_buckets = (sorted(int(b) for b in prompt_buckets)
                               if prompt_buckets else None)
        self.slots = SlotTable(num_slots)
        self._heap: list = []
        self._seq = itertools.count()
        self.cache_aware = bool(cache_aware)
        self.cache_probe = None      # Optional[Callable[[str], bool]]
        self.cache_reordered = 0

    def __len__(self) -> int:
        return len(self._heap)

    def bucket(self, prompt_len: int) -> int:
        return bucket_length(prompt_len, self.prompt_buckets)

    def push(self, request: Request) -> None:
        if not request.submit_time:
            request.submit_time = time.monotonic()
        if request.deadline_s is not None and request.deadline_at is None:
            request.deadline_at = request.submit_time + request.deadline_s
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

    def shed_expired(self, now: float) -> List[Request]:
        """Drop queued requests whose deadline already passed (checked
        every admission round before slots are filled, so an expired
        request never costs a prefill). The rest keep their sequence
        numbers."""
        if not self._heap:
            return []
        keep, out = [], []
        for e in self._heap:
            req = e[2]
            if req.deadline_at is not None and now > req.deadline_at:
                out.append(req)
            else:
                keep.append(e)
        if out:
            self._heap = keep
            heapq.heapify(self._heap)
        return out

    def queued(self) -> List[Request]:
        """The queue in admission order, left in place."""
        return [e[2] for e in sorted(self._heap,
                                     key=lambda e: (e[0], e[1]))]

    def take_all(self) -> List[Request]:
        """Pop every queued request, in admission order."""
        out = []
        while self._heap:
            out.append(heapq.heappop(self._heap)[2])
        return out

    def remove(self, ids) -> List[Request]:
        """Pop the queued requests whose ``id`` is in ``ids`` (in
        admission order); every other entry keeps its place."""
        want = {int(i) for i in ids}
        keep, out = [], []
        for e in self._heap:
            (out if e[2].id in want else keep).append(e)
        if out:
            self._heap = keep
            heapq.heapify(self._heap)
        return [e[2] for e in sorted(out, key=lambda e: (e[0], e[1]))]

    def admissions(self) -> List[Tuple[int, Request]]:
        """Fill every free slot from the queue; returns the
        ``(slot_index, request)`` pairs admitted this round."""
        free_n = len(self.slots.free_slots())
        if not free_n or not self._heap:
            return []
        if self.cache_aware:
            picked = self._cache_aware_pops(free_n)
        else:
            picked = [heapq.heappop(self._heap)[2]
                      for _ in range(min(free_n, len(self._heap)))]
        return [(self.slots.occupy(req), req) for req in picked]

    def _cache_aware_pops(self, free_n: int) -> List[Request]:
        """Up to ``free_n`` queued requests, reordered ONLY within a
        priority tier: the tier's head is the earliest request whose
        ``prefix_group`` digest is live in the cache (``cache_probe``),
        else the FIFO head; then same-group followers come forward (FIFO
        within the group). The rest go back on the heap with their
        sequence numbers."""
        entries = []
        while self._heap:
            entries.append(heapq.heappop(self._heap))
        chosen: List[Request] = []
        while len(chosen) < free_n and entries:
            p0 = entries[0][0]
            tier_end = next((i for i, e in enumerate(entries)
                             if e[0] != p0), len(entries))
            head_i = 0
            if self.cache_probe is not None:
                for j in range(tier_end):
                    g = entries[j][2].prefix_group
                    if g is not None and self.cache_probe(g):
                        head_i = j
                        break
            if head_i > 0:
                self.cache_reordered += 1
            head = entries.pop(head_i)
            chosen.append(head[2])
            tier_end -= 1
            g = head[2].prefix_group
            if g is not None:
                i = 0
                while i < tier_end and len(chosen) < free_n:
                    if entries[i][2].prefix_group == g:
                        if i > 0:
                            self.cache_reordered += 1
                        chosen.append(entries.pop(i)[2])
                        tier_end -= 1
                    else:
                        i += 1
        for e in entries:
            heapq.heappush(self._heap, e)
        return chosen
