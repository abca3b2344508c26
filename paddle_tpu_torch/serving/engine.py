"""Continuous-batching serving engine over chunked resumable decode.

Counterpart of ``paddle_tpu/serving/engine.py``: ``ServingEngine`` runs
the Orca-style loop — admit queued requests into freed slots (one
length-bucketed admission-prefill dispatch each), run ONE
``decode_chunk`` dispatch of T tokens across all slots, harvest finished
rows on the host, repeat.

Admission goes through the device admission ring, the JAX engine's
default route: each prefill stages its row (logits, K/V) into a free ring
row on the device (``LlamaDecoder.ring_admit_prefill``, one CUDA graph
per prompt bucket on a card), and the next chunk splices the staged rows
into the carry at their slots inside its own graph. A round that admits
more rows than the ring has free re-queues the rest at the head of their
tier (``metrics()["admission_ring"]["full"]``). The JAX engine's
host-scatter route serves only its prefix cache's slab admissions and
comes with that cache (ROADMAP [5]).

Dispatch accounting is part of the contract: one admission prefill per
admitted request plus one chunk dispatch per step with live rows, so the
decoder's ``dispatch_count`` moves by exactly ``prefill_dispatches +
chunk_dispatches``. The ring metadata copies and row retirement are
in-place tensor updates outside the counted sites.

Sampling (``do_sample``, ``top_k``, ``top_p`` engine-wide; ``temperature``
and ``seed`` per request) draws each row from its own key,
``split(PRNGKey(seed), 1)[0]`` at admission, so a request's tokens depend
only on its seed, not on the engine's shape or its batch neighbours.

``step`` (admission, the chunk dispatch, harvest) runs under
``torch.inference_mode()``, so serving records no autograd graph.

Not ported yet (ROADMAP.md queue 1), and refused with
``NotImplementedError`` when asked for: prefix cache, speculative
serving, LoRA adapters, snapshot/restore, deadlines and SLOs, the obs
exporter, meshes, AOT bundle backends, the HTTP front-end, request-keyed
keys (router) and the per-token degradation rung.
"""

from __future__ import annotations

import collections
import time
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from paddle_tpu_torch import random as rnd
from paddle_tpu_torch.inference.generate import (AdmissionRing, DecodeState,
                                                 LlamaDecoder, _batch_rows,
                                                 _normalize_eos, _not_ported,
                                                 _sample_spec)
from paddle_tpu_torch.quantization.kv_cache import (QuantMismatchError,
                                                    canonical_quant)
from paddle_tpu_torch.runtime.resilience import GenerateResult
from paddle_tpu_torch.serving.scheduler import Request, Scheduler

__all__ = ["ServingEngine"]

# engine / submit arguments of the JAX engine whose features later slices
# port: name -> (ROADMAP item, the value that leaves the feature off).
# Passing anything else raises NotImplementedError.
_LATER_ENGINE = {
    "slo_targets": ("deadlines and SLOs", None), "mesh": ("mesh", None),
    "prefix_cache": ("prefix cache", None),
    "prefix_cache_bytes": ("prefix cache", None),
    "prefix_block_tokens": ("prefix cache", None),
    "batch_admission": ("prefix cache", False),
    "cache_aware_admission": ("prefix cache", None),
    "snapshot_dir": ("snapshot", None),
    "snapshot_every_chunks": ("snapshot", 0),
    "replica_tag": ("router", None), "request_keyed_rng": ("router", False),
    "draft_model": ("speculative serving", None),
    "num_speculative_tokens": ("speculative serving", None),
    "draft_quant": ("speculative serving", None),
    "adaptive_k": ("speculative serving", False),
    "adapter_store": ("LoRA", None),
}
_LATER_SUBMIT = {
    "latency_class": ("deadlines and SLOs", "default"),
    "slo_ttft_s": ("deadlines and SLOs", None),
    "slo_latency_s": ("deadlines and SLOs", None),
    "deadline_s": ("deadlines and SLOs", None),
    "rng_request_id": ("router", None), "rng_tokens_emitted": ("router", 0),
    "adapter": ("LoRA", None), "speculative": ("speculative serving", None),
    "on_tokens": ("HTTP front-end", None),
}


def _refuse_later(kwargs: dict, table: dict, where: str) -> None:
    for name, value in kwargs.items():
        if name not in table:
            raise TypeError(f"{where}() got an unexpected keyword argument "
                            f"{name!r}")
        item, off = table[name]
        if value is not None and value is not False and value != off:
            raise _not_ported(f"{where}({name}=)", item)


def _row_key(seed: int) -> np.ndarray:
    """An admitted row's key, ``split(PRNGKey(seed), 1)[0]`` as on both of
    the JAX engine's admission routes; host bookkeeping, so a key on the
    CPU and the plain version."""
    return rnd.split(rnd.PRNGKey(seed, device="cpu"), 1)[0].numpy() \
        .view(np.uint32)


def _check_quant_ask(quant, have, what: str) -> None:
    """An engine that asks for a dtype recipe must get exactly that one
    from its backend; ``None`` serves whatever the backend has."""
    if quant is None:
        return
    want = canonical_quant(quant)
    if want != have:
        raise QuantMismatchError(
            f"{what} serves quant recipe {have or 'none'!r} but the "
            f"engine asked for {want or 'none'!r}; rebuild the backend "
            f"with the matching quant= (or drop the ask)")


class _DecoderBackend:
    """In-process backend: a ``LlamaDecoder``'s ring-staged admission
    prefill and ring chunk entries over the device admission ring. The
    carry's caches hold one batch row more than the slots: the ring's
    dump row."""

    def __init__(self, dec: LlamaDecoder, num_slots: int, do_sample,
                 top_k, top_p, quant=None):
        _check_quant_ask(quant, dec.quant, "this LlamaDecoder")
        self.dec = dec
        self.quant = dec.quant
        self.num_slots = int(num_slots)
        self.max_len = dec.max_len
        self.sample = _sample_spec(do_sample, top_k, top_p)
        self.ring: Optional[AdmissionRing] = None
        self._carry = None

    def new_state(self) -> DecodeState:
        B, dev = self.num_slots, self.dec.device
        self._carry = self.dec._empty_cache(B + 1)
        kc, vc = (_batch_rows(c, B) for c in self._carry)
        return DecodeState(
            logits=torch.zeros((B, self.dec.cfg.vocab_size),
                               dtype=torch.float32, device=dev),
            kc=kc, vc=vc,
            pos=torch.zeros((B,), dtype=torch.long, device=dev),
            keys=torch.zeros((B, 2), dtype=torch.int32, device=dev),
            done=torch.ones((B,), dtype=torch.bool, device=dev),  # all free
            eos=torch.full((B,), -1, dtype=torch.long, device=dev),
            temp=torch.ones((B,), dtype=torch.float32, device=dev))

    # -- device admission ring ---------------------------------------------
    def ring_init(self, R: int) -> None:
        """Allocate the R-row ring over the carry ``new_state`` made."""
        self.ring = AdmissionRing.allocate(self.dec, R, *self._carry)

    def ring_admit(self, ids, true_len, pos0, ring_idx) -> None:
        """ONE counted admission-prefill dispatch whose rows stage
        straight into ring rows ``ring_idx``."""
        self.dec.ring_admit_prefill(ids, true_len, pos0, self.ring,
                                    ring_idx)

    def decode_chunk_ring(self, st: DecodeState, chunk_size: int, splice):
        """Load the splice metadata (``ServingEngine._ring_args``), then
        one chunk dispatch that splices the staged rows in before its
        steps."""
        self.ring.load(*splice)
        return self.dec._chunk_decode(st, int(chunk_size), self.sample,
                                      self.ring)


class ServingEngine:
    """Slot-admission continuous-batching engine.

    ``submit`` queues a request and returns its id; ``step`` runs one
    admit-dispatch-harvest iteration and returns the requests it
    finished; ``drain`` steps until queue and slots are empty. Results
    are ``GenerateResult`` arrays (prompt + generated tokens, trimmed at
    the request's eos / budget) whose ``.resilience`` record carries the
    serving stats of that request (queue delay, latency, chunks, slot).

    Greedy tokens equal a solo ``LlamaDecoder.generate`` of the same
    request: admission, chunk slicing and batch neighbours cannot change
    them. Sampled tokens depend only on the request's seed and
    temperature (per-row keys), so they are the same across engine
    configurations and equal ``generate(chunk_size=T, seed=)`` of the
    request alone. ``do_sample`` / ``top_k`` / ``top_p`` are
    engine-wide; eos id, temperature and seed are per request.

    ``ring_slots``: rows in the device admission ring (default
    ``num_slots``, at least 1). The engine runs on its decoder's
    device."""

    def __init__(self, backend: LlamaDecoder, num_slots: int = 4,
                 chunk_size: int = 8, do_sample: bool = False,
                 top_k: Optional[int] = None, top_p: Optional[float] = None,
                 policy: str = "fifo",
                 prompt_buckets: Optional[Sequence[int]] = None,
                 quant: Optional[str] = None,
                 ring_slots: Optional[int] = None, **later):
        _refuse_later(later, _LATER_ENGINE, "ServingEngine")
        if not isinstance(backend, LlamaDecoder):
            raise TypeError(
                f"backend must be a LlamaDecoder (AOT bundle backends are "
                f"not ported yet), got {type(backend).__name__}")
        if chunk_size < 1:
            raise ValueError(f"chunk_size must be >= 1, got {chunk_size}")
        self.num_slots = int(num_slots)
        self.chunk_size = int(chunk_size)
        self._b = _DecoderBackend(backend, num_slots, do_sample, top_k,
                                  top_p, quant=quant)
        self.scheduler = Scheduler(num_slots, policy=policy,
                                   prompt_buckets=prompt_buckets)
        self.state = self._b.new_state()
        # the device admission ring: always on here (the prefix cache,
        # which keeps the JAX engine on host scatter, is not ported)
        R = int(ring_slots if ring_slots is not None else num_slots)
        if R < 1:
            raise ValueError(f"ring_slots must be >= 1, got {R}")
        self._ring_slots = R
        self._ring_meta: List[Optional[dict]] = [None] * R
        self._b.ring_init(R)
        self._next_id = 0
        self._results: Dict[int, Any] = {}
        self._n = {"prefill": 0, "chunk": 0, "slot_steps": 0,
                   "corrupt_rows": 0,
                   "ring_staged": 0, "ring_scattered": 0, "ring_full": 0}
        self._samples: Dict[str, List[float]] = {
            k: [] for k in ("queue_delay_s", "latency_s", "ttft_s",
                            "tpot_s", "occupancy", "queue_depth")}
        self._queue_depth_peak = 0

    @property
    def prefill_dispatches(self) -> int:
        return self._n["prefill"]

    @property
    def chunk_dispatches(self) -> int:
        return self._n["chunk"]

    @property
    def step_dispatches(self) -> int:
        # the per-token degradation rung is not ported: always 0
        return 0

    @property
    def host_scattered(self) -> int:
        """Admitted rows copied into the carry by the host-scatter route
        (also ``metrics()["admission_ring"]["host_scattered"]``): always 0
        here, where the ring serves every admission (the JAX engine's
        host scatter serves only the prefix cache, ROADMAP [5])."""
        return 0

    # -- submission --------------------------------------------------------
    def submit(self, prompt, max_new_tokens: int,
               eos_token_id: Optional[int] = None,
               temperature: float = 1.0, seed: int = 0,
               priority: int = 0, **later) -> int:
        """Queue one request; returns its id (results key).
        ``temperature`` and ``seed`` act on a sampling engine: the row's
        key is ``split(PRNGKey(seed), 1)[0]``."""
        _refuse_later(later, _LATER_SUBMIT, "submit")
        prompt = np.asarray(prompt)
        if prompt.ndim == 2:
            if prompt.shape[0] != 1:
                raise ValueError(
                    f"submit takes ONE request (a (S,) or (1, S) prompt), "
                    f"got batch {prompt.shape[0]}; call submit per row")
            prompt = prompt[0]
        if prompt.ndim != 1:
            raise ValueError(f"prompt must be 1-D, got shape {prompt.shape}")
        if max_new_tokens < 1:
            raise ValueError(
                f"max_new_tokens must be >= 1, got {max_new_tokens}")
        bucket = self.scheduler.bucket(len(prompt))
        if max(bucket, len(prompt) + int(max_new_tokens)) > self._b.max_len:
            raise ValueError(
                f"prompt {len(prompt)} (bucket {bucket}) + "
                f"{max_new_tokens} new tokens exceeds the backend's "
                f"max_len {self._b.max_len}")
        rid = self._next_id
        self._next_id += 1
        self.scheduler.push(Request(
            id=rid, prompt=prompt, max_new_tokens=int(max_new_tokens),
            eos_token_id=_normalize_eos(eos_token_id),
            temperature=float(temperature), seed=int(seed),
            priority=int(priority), submit_time=time.monotonic()))
        self._queue_depth_peak = max(self._queue_depth_peak,
                                     len(self.scheduler))
        return rid

    # -- the serving loop --------------------------------------------------
    @torch.inference_mode()
    def step(self) -> List[Tuple[int, Any]]:
        """One iteration: admit into free slots, run ONE chunk dispatch,
        harvest finished rows. Returns ``[(request_id, result), ...]``
        finished this step (also retrievable via ``result(id)``)."""
        now = time.monotonic()
        self._samples["queue_depth"].append(len(self.scheduler))
        admitted = self.scheduler.admissions()
        if admitted:
            self._admit_all(admitted, now)
        occupied = self.scheduler.slots.occupied()
        if not occupied:
            return []
        self._samples["occupancy"].append(len(occupied) / self.num_slots)
        toks = self._dispatch_chunk()
        t_chunk_done = time.monotonic()
        # finite guard: a row whose logits went NaN/Inf is frozen alone
        # and returned partial; its poison never reaches a neighbour
        row_finite = torch.isfinite(self.state.logits).all(-1).cpu().numpy()
        finished, freed = [], []
        for i, slot in occupied:
            slot.chunks += 1
            req = slot.request
            if not row_finite[i]:
                # the chunk that surfaced the corruption is dropped
                seq = (np.concatenate(slot.tokens) if slot.tokens
                       else np.zeros((0,), np.int64))[:req.max_new_tokens]
                self._n["corrupt_rows"] += 1
                res = self._finish(slot, seq, i, corrupt_row=True)
            else:
                slot.tokens.append(toks[i])
                if slot.first_token_at is None:
                    slot.first_token_at = t_chunk_done
                    self._samples["ttft_s"].append(
                        t_chunk_done - slot.admitted_at)
                seq = np.concatenate(slot.tokens)
                fin = False
                if req.eos_token_id is not None:
                    hit = seq == req.eos_token_id
                    if hit.any():
                        seq = seq[:int(np.argmax(hit)) + 1]
                        fin = True
                if len(seq) >= req.max_new_tokens:
                    seq = seq[:req.max_new_tokens]
                    fin = True
                if not fin:
                    continue
                res = self._finish(slot, seq, i)
            self._results[req.id] = res
            finished.append((req.id, res))
            self.scheduler.slots.release(i)
            freed.append(i)
        if freed:
            self._freeze_rows(freed)
        return finished

    def _freeze_rows(self, rows: Sequence[int]) -> None:
        """Freeze carry rows until re-admission: they keep riding the
        batched chunk, pinned to their eos fill, and their output is
        discarded."""
        self.state.done[torch.as_tensor(list(rows),
                                        device=self.state.done.device)] = True

    def drain(self, max_steps: Optional[int] = None) -> Dict[int, Any]:
        """Step until the queue and every slot are empty; returns
        ``{request_id: result}`` for everything finished while draining."""
        out: Dict[int, Any] = {}
        steps = 0
        while len(self.scheduler) or self.scheduler.slots.occupied():
            for rid, res in self.step():
                out[rid] = res
            steps += 1
            if max_steps is not None and steps > max_steps:
                raise RuntimeError(
                    f"drain did not converge within {max_steps} steps")
        return out

    def result(self, request_id: int):
        return self._results.get(request_id)

    # -- admission ---------------------------------------------------------
    def _admit_all(self, admitted, now: float) -> None:
        """One ring admission round: a free ring row per admitted request
        and one ring-staged prefill dispatch each, padded to its prompt
        bucket. Admissions beyond the ring's free rows are un-admitted
        (slot released, request re-queued at its tier's head with its
        submit time, ``ring_full``) and retry next step, once the chunk
        has drained the ring."""
        free = collections.deque(
            r for r, m in enumerate(self._ring_meta) if m is None)
        if len(admitted) > len(free):
            admitted, spill = admitted[:len(free)], admitted[len(free):]
            for slot_idx, req in reversed(spill):
                self.scheduler.slots.release(slot_idx)
                self.scheduler.push_front(req)
                self._n["ring_full"] += 1
        for slot_idx, req in admitted:
            self._admit_group_ring(self.scheduler.bucket(len(req.prompt)),
                                   [(slot_idx, req)], free, now)

    def _admit_group_ring(self, w: int, grp, free, now: float) -> None:
        """ONE ring-staged admission-prefill dispatch for the group: the
        prefilled rows land in device ring rows, with the splice metadata
        the next chunk reads recorded on the host."""
        N = len(grp)
        ids = np.zeros((N, w), np.int64)
        true_len = np.zeros((N,), np.int64)
        rows = [free.popleft() for _ in range(N)]
        for j, (_, req) in enumerate(grp):
            ids[j, :len(req.prompt)] = req.prompt
            true_len[j] = len(req.prompt)
        self._b.ring_admit(ids, true_len, np.zeros((N,), np.int64), rows)
        self._n["prefill"] += 1
        for j, (slot_idx, req) in enumerate(grp):
            self._ring_meta[rows[j]] = {
                "slot": slot_idx, "pos": len(req.prompt),
                "key": _row_key(req.seed),
                "eos": (-1 if req.eos_token_id is None
                        else req.eos_token_id),
                "temp": req.temperature}
            self._n["ring_staged"] += 1
            self._note_admit(slot_idx, req, now)

    def _ring_args(self) -> Tuple[tuple, int]:
        """The chunk's splice metadata per ring row (slot -1 = empty,
        resume pos, key, eos, temperature) and the staged count."""
        R = self._ring_slots
        slot = np.full((R,), -1, np.int64)
        pos = np.zeros((R,), np.int64)
        keys = np.zeros((R, 2), np.uint32)
        eos = np.full((R,), -1, np.int64)
        temp = np.ones((R,), np.float32)
        n = 0
        for r, m in enumerate(self._ring_meta):
            if m is None:
                continue
            slot[r], pos[r], keys[r] = m["slot"], m["pos"], m["key"]
            eos[r], temp[r] = m["eos"], m["temp"]
            n += 1
        return (slot, pos, keys, eos, temp), n

    def _ring_drained(self, n: int) -> None:
        """The chunk spliced the staged rows in: clear the metadata and
        count them."""
        if n:
            self._ring_meta = [None] * self._ring_slots
            self._n["ring_scattered"] += n

    def _note_admit(self, slot_idx: int, req: Request, now: float) -> None:
        slot = self.scheduler.slots.entries[slot_idx]
        slot.admitted_at = now
        self._samples["queue_delay_s"].append(now - req.submit_time)

    def _dispatch_chunk(self) -> np.ndarray:
        splice, n_staged = self._ring_args()
        toks, self.state = self._b.decode_chunk_ring(self.state,
                                                     self.chunk_size, splice)
        self._n["chunk"] += 1
        self._n["slot_steps"] += self.num_slots * self.chunk_size
        self._ring_drained(n_staged)
        return toks.cpu().numpy()

    def _finish(self, slot, seq: np.ndarray, slot_idx: int,
                corrupt_row: bool = False):
        req = slot.request
        fin = time.monotonic()
        latency = fin - req.submit_time
        self._samples["latency_s"].append(latency)
        ttft = (slot.first_token_at - slot.admitted_at
                if slot.first_token_at is not None else None)
        n_tok = int(seq.shape[0])
        tpot = None
        if slot.first_token_at is not None and n_tok > 1:
            tpot = max(0.0, fin - slot.first_token_at) / (n_tok - 1)
            self._samples["tpot_s"].append(tpot)
        record = {
            "level": "chunked", "requested_level": "chunked",
            "retries": 0, "degradations": [], "events": [],
            "serving": {
                "queue_delay_s": slot.admitted_at - req.submit_time,
                "latency_s": latency, "ttft_s": ttft, "tpot_s": tpot,
                "chunks": slot.chunks, "slot": slot_idx,
                "corrupt_row": bool(corrupt_row),
            },
        }
        out = np.concatenate([req.prompt,
                              seq.astype(req.prompt.dtype)])[None]
        return GenerateResult.wrap(out, record)

    # -- observability -----------------------------------------------------
    def metrics(self) -> Dict[str, Any]:
        """Serving metrics snapshot with the JAX engine's keys: dispatch
        accounting (prefills = admitted requests, chunks, per-token
        steps), slot occupancy and the slot-steps denominator, queue-delay,
        latency, TTFT and TPOT statistics (NaN until the first sample),
        queue depth now, at its peak and on average at step starts. Keys
        of features not ported yet hold their off values: 0 for counters,
        None for absent subsystems, {} for per-class maps."""
        s = self._samples

        def mean(k):
            return float(np.mean(s[k])) if s[k] else float("nan")

        def pct(k, q):
            return float(np.percentile(s[k], q)) if s[k] else float("nan")

        return {
            "num_slots": self.num_slots,
            "chunk_size": self.chunk_size,
            "requests_submitted": self._next_id,
            "requests_completed": len(self._results),
            "queued": len(self.scheduler),
            "prefill_dispatches": self.prefill_dispatches,
            "chunk_dispatches": self.chunk_dispatches,
            "step_dispatches": self.step_dispatches,
            "degradations": 0,   # the degradation ladder is not ported
            "occupancy_mean": mean("occupancy"),
            "occupancy_samples": len(s["occupancy"]),
            "slot_steps_total": self._n["slot_steps"],
            "queue_delay_mean_s": mean("queue_delay_s"),
            "queue_delay_p50_s": pct("queue_delay_s", 50),
            "queue_delay_p99_s": pct("queue_delay_s", 99),
            "request_latency_mean_s": mean("latency_s"),
            "request_latency_p50_s": pct("latency_s", 50),
            "request_latency_p99_s": pct("latency_s", 99),
            "queue_depth_now": len(self.scheduler),
            "queue_depth_peak": self._queue_depth_peak,
            "queue_depth_mean": mean("queue_depth"),
            "ttft_mean_s": mean("ttft_s"),
            "ttft_p50_s": pct("ttft_s", 50),
            "ttft_p99_s": pct("ttft_s", 99),
            "tpot_mean_s": mean("tpot_s"),
            "tpot_p50_s": pct("tpot_s", 50),
            "slo_violations": 0,
            "shed_deadline": 0,
            "shed_backpressure": 0,
            "shed_queue_deadline": 0,
            "deadline_expired_rows": 0,
            "corrupt_rows": self._n["corrupt_rows"],
            "rows_migrated_out": 0,
            "rows_migrated_in": 0,
            "snapshots": 0,
            "snapshot_age_s": None,
            "admission_dispatches_saved": 0,
            "admission_cache_reordered": 0,
            "batched_admission_groups": 0,
            "prefill_tokens_saved": 0,
            "admission_p50_s": {},
            "admission_p99_s": {},
            "prefix_cache": None,
            "draft_prefill_dispatches": 0,
            "speculative": None,
            "admission_ring": {
                "slots": self._ring_slots,
                "staged": self._n["ring_staged"],
                "scattered": self._n["ring_scattered"],
                "full": self._n["ring_full"],
                "host_scattered": self.host_scattered,
            },
            "adapters": None,
            "stream_ttft_p50_s": {},
        }
