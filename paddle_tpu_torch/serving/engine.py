"""Continuous-batching serving engine over chunked resumable decode.

Counterpart of ``paddle_tpu/serving/engine.py``: ``ServingEngine`` runs
the Orca-style loop — admit queued requests into freed slots (one
length-bucketed admission-prefill dispatch each, the row state copied
into the batch carry on the device), run ONE ``decode_chunk`` dispatch of
T tokens across all slots, harvest finished rows on the host, repeat.

Dispatch accounting is part of the contract: one admission prefill per
admitted request plus one chunk dispatch per step with live rows, so the
decoder's ``dispatch_count`` moves by exactly ``prefill_dispatches +
chunk_dispatches``. Admission copies and row retirement are in-place
tensor updates outside the counted sites.

``step`` (admission, the chunk dispatch, harvest) runs under
``torch.inference_mode()``, so serving records no autograd graph.

Admission takes the JAX engine's host-scatter route (the one it takes
with the device ring off): each prefilled row is copied into the carry
with ``index_copy_`` (counted by ``ServingEngine.host_scattered``).
Not ported yet (ROADMAP.md queue 1), and refused with
``NotImplementedError`` when asked for: the admission ring, prefix cache,
speculative serving, LoRA adapters, snapshot/restore, deadlines and SLOs,
the obs exporter, meshes, AOT bundle backends, the HTTP front-end,
sampling, and the per-token degradation rung.
"""

from __future__ import annotations

import time
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from paddle_tpu_torch.inference.generate import (DecodeState, LlamaDecoder,
                                                 _normalize_eos, _not_ported)
from paddle_tpu_torch.quantization.kv_cache import (QuantMismatchError,
                                                    canonical_quant,
                                                    is_quantized_kv)
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
    "ring_slots": ("admission ring", None), "adapter_store": ("LoRA", None),
}
_LATER_SUBMIT = {
    "temperature": ("threefry sampling", 1.0),
    "seed": ("threefry sampling", 0),
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


def _admit_row(st: DecodeState, logits1, kc1, vc1, slot: int, src: int,
               pos1: int, eos1: int) -> None:
    """Copy row ``src`` of a freshly prefilled row state into carry row
    ``slot``, in place (``index_copy_`` along the stacked caches' batch
    axis 1; both leaves of a quantized cache). Not a counted dispatch."""
    dev = st.logits.device
    si = torch.tensor([slot], device=dev)

    def put(dst, rows):
        dst.index_copy_(1, si, rows.narrow(1, src, 1).to(dst.dtype))

    for dst, rows in ((st.kc, kc1), (st.vc, vc1)):
        if is_quantized_kv(dst):
            put(dst["q"], rows["q"])
            put(dst["s"], rows["s"])
        else:
            put(dst, rows)
    st.logits[slot] = logits1[src]
    st.pos[slot] = pos1
    st.done[slot] = False
    st.eos[slot] = eos1


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
    """In-process backend: a ``LlamaDecoder``'s admission-prefill and
    chunk entries."""

    def __init__(self, dec: LlamaDecoder, num_slots: int, quant=None):
        _check_quant_ask(quant, dec.quant, "this LlamaDecoder")
        self.dec = dec
        self.quant = dec.quant
        self.num_slots = int(num_slots)
        self.max_len = dec.max_len

    def new_state(self) -> DecodeState:
        B, dev = self.num_slots, self.dec.device
        kc, vc = self.dec._empty_cache(B)
        return DecodeState(
            logits=torch.zeros((B, self.dec.cfg.vocab_size),
                               dtype=torch.float32, device=dev),
            kc=kc, vc=vc,
            pos=torch.zeros((B,), dtype=torch.long, device=dev),
            done=torch.ones((B,), dtype=torch.bool, device=dev),  # all free
            eos=torch.full((B,), -1, dtype=torch.long, device=dev))

    def admit_prefill(self, ids, true_len, pos0):
        return self.dec.admit_prefill(ids, true_len, pos0)

    def decode_chunk(self, st: DecodeState, chunk_size: int):
        return self.dec.decode_chunk(st, chunk_size)


class ServingEngine:
    """Slot-admission continuous-batching engine (greedy).

    ``submit`` queues a request and returns its id; ``step`` runs one
    admit-dispatch-harvest iteration and returns the requests it
    finished; ``drain`` steps until queue and slots are empty. Results
    are ``GenerateResult`` arrays (prompt + generated tokens, trimmed at
    the request's eos / budget) whose ``.resilience`` record carries the
    serving stats of that request (queue delay, latency, chunks, slot).

    Tokens equal a solo ``LlamaDecoder.generate`` of the same request:
    admission, chunk slicing and batch neighbours cannot change them. The
    engine runs on its decoder's device."""

    def __init__(self, backend: LlamaDecoder, num_slots: int = 4,
                 chunk_size: int = 8, do_sample: bool = False,
                 top_k: Optional[int] = None, top_p: Optional[float] = None,
                 policy: str = "fifo",
                 prompt_buckets: Optional[Sequence[int]] = None,
                 quant: Optional[str] = None, **later):
        if do_sample or top_k is not None or top_p is not None:
            raise _not_ported("sampled serving (do_sample=, top_k=, "
                              "top_p=)", "threefry sampling")
        _refuse_later(later, _LATER_ENGINE, "ServingEngine")
        if not isinstance(backend, LlamaDecoder):
            raise TypeError(
                f"backend must be a LlamaDecoder (AOT bundle backends are "
                f"not ported yet), got {type(backend).__name__}")
        if chunk_size < 1:
            raise ValueError(f"chunk_size must be >= 1, got {chunk_size}")
        self.num_slots = int(num_slots)
        self.chunk_size = int(chunk_size)
        self._b = _DecoderBackend(backend, num_slots, quant=quant)
        self.scheduler = Scheduler(num_slots, policy=policy,
                                   prompt_buckets=prompt_buckets)
        self.state = self._b.new_state()
        self._next_id = 0
        self._results: Dict[int, Any] = {}
        self._n = {"prefill": 0, "chunk": 0, "slot_steps": 0,
                   "host_scattered": 0, "corrupt_rows": 0}
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
        (the JAX engine reports it under ``metrics()["admission_ring"]``,
        which is None without the ring)."""
        return self._n["host_scattered"]

    # -- submission --------------------------------------------------------
    def submit(self, prompt, max_new_tokens: int,
               eos_token_id: Optional[int] = None, priority: int = 0,
               **later) -> int:
        """Queue one greedy request; returns its id (results key)."""
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
        """One admission round: one prefill dispatch per request, padded
        to its prompt bucket, each row then copied into its slot."""
        for slot_idx, req in admitted:
            w = self.scheduler.bucket(len(req.prompt))
            self._admit_group(w, [(slot_idx, req)], now)

    def _admit_group(self, w: int, grp, now: float) -> None:
        """ONE admission-prefill dispatch for the group: batch-N ids
        right-padded to width ``w`` with per-row true lengths, then one
        row copy per admitted request."""
        N = len(grp)
        ids = np.zeros((N, w), np.int64)
        true_len = np.zeros((N,), np.int64)
        for j, (_, req) in enumerate(grp):
            ids[j, :len(req.prompt)] = req.prompt
            true_len[j] = len(req.prompt)
        logitsN, kcN, vcN = self._b.admit_prefill(
            ids, true_len, np.zeros((N,), np.int64))
        self._n["prefill"] += 1
        for j, (slot_idx, req) in enumerate(grp):
            self._scatter(slot_idx, req, logitsN, kcN, vcN, src=j,
                          pos1=len(req.prompt))
            self._note_admit(slot_idx, req, now)

    def _scatter(self, slot_idx: int, req: Request, logits1, kc1, vc1,
                 src: int, pos1: int) -> None:
        """Row ``src`` of the prefilled row state lands in carry row
        ``slot_idx`` (the host-side admission route)."""
        self._n["host_scattered"] += 1
        _admit_row(self.state, logits1, kc1, vc1, slot_idx, src, pos1,
                   -1 if req.eos_token_id is None else req.eos_token_id)

    def _note_admit(self, slot_idx: int, req: Request, now: float) -> None:
        slot = self.scheduler.slots.entries[slot_idx]
        slot.admitted_at = now
        self._samples["queue_delay_s"].append(now - req.submit_time)

    def _dispatch_chunk(self) -> np.ndarray:
        toks, self.state = self._b.decode_chunk(self.state,
                                                self.chunk_size)
        self._n["chunk"] += 1
        self._n["slot_steps"] += self.num_slots * self.chunk_size
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
            "admission_ring": None,
            "adapters": None,
            "stream_ttft_p50_s": {},
        }
