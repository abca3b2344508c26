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
tier (``metrics()["admission_ring"]["full"]``). ``batch_admission``
folds same-bucket admissions of a round into one prefill dispatch.

The prefix cache (``prefix_cache=``, ``serving/prefix_cache.py``) turns
the ring off, as in the JAX engine, and admits by host row copy: a FULL
hit copies its slab's row into the carry with zero prefill dispatches, a
PARTIAL hit prefills only the uncached suffix on top of the loaded slab,
a miss prefills cold and inserts its slab (``_admit_group``; one CUDA
graph per (rows, bucket) on a card). ``cache_aware_admission`` orders
same-priority requests so that cached digests go first.

Speculative serving (``draft_model=``, ``num_speculative_tokens=``):
each admission group also stages the draft's prefill into the ring
(``draft_prefill_dispatches``), and each chunk runs T draft/verify
rounds, committing a per-row T..T(K+1)+1 tokens; ``adaptive_k`` sets the
next chunk's K from the running acceptance. Greedy tokens equal the
plain engine's.

Dispatch accounting is part of the contract: one admission prefill per
admission group (per request without ``batch_admission``; none for a full
hit), one draft prefill per group under speculation, plus one chunk
dispatch per step with live rows, so the decoder's ``dispatch_count``
moves by exactly ``prefill_dispatches + draft_prefill_dispatches +
chunk_dispatches``. The ring metadata copies, host row copies and row
retirement are in-place tensor updates outside the counted sites.

Multi-tenant LoRA (``adapter_store=``, ``submit(adapter=)``): the
backend merges the store's stacked deltas into the decoder's params, each
admitted row carries its adapter's index into the stacks on every
admission route (the ring's ``aidx`` column, the host row copy), and the
chunk gathers each row's deltas, so mixed tenants share one chunk
dispatch. A hot swap (``AdapterStore.update``/``register``) applies
between chunks once no in-flight row pins a revision it changes
(``apply_adapter_swap``; ``AdapterVersionError`` names the blocking row
otherwise), and requests naming a pending revision wait for it. The
prefix cache keys an adapter's prompts by ``name@rev``.

Sampling (``do_sample``, ``top_k``, ``top_p`` engine-wide; ``temperature``
and ``seed`` per request) draws each row from its own key,
``split(PRNGKey(seed), 1)[0]`` at admission on every route, so a
request's tokens depend only on its seed, not on the engine's shape, its
batch neighbours or its prefix-cache hit class.

Deadlines and load shedding (``submit(deadline_s=)``): an expired budget
is refused at submit, and so is a request whose budget the estimated
queue delay already exceeds (backpressure); a queued request that expires
is shed at the next admission round as a typed ``DeadlineExceededError``
value, and an in-flight row past its deadline is frozen like eos at a
chunk boundary and returned partial, flagged ``deadline_expired``. SLO
targets (``slo_targets=``, ``submit(latency_class=, slo_ttft_s=,
slo_latency_s=)``) only count violations per latency class.

Crash recovery and fleet moves: ``snapshot(dir)`` writes the carry's slot
rows plus the slot table and the queue as the JAX engine's payload (the
same npz layout, dtypes and sha256 manifest, so either package restores
the other's), ``restore(dir)`` resumes it on a fresh engine, row-remapped
into a larger one, and ``extract_rows`` / ``absorb_rows`` move chosen
requests between live engines (``"paddle_tpu.row_migration"``). Both
copy into the engine's existing carry in place: the ring's splice and
every captured chunk graph hold that carry's addresses.
``snapshot_every_chunks=`` snapshots on a chunk cadence and
``drain(deadline_s=)`` snapshots instead of discarding unfinished work.

The degradation ladder (the JAX engine's ``_dispatch_chunk``): a chunk
dispatch retries transient errors (the decoder's guard); a speculative
chunk that still fails demotes the carry once to the plain chunk
(``spec_demote``); a plain chunk that still fails runs its T steps on the
per-token rung (one-step chunks, ``step_dispatches``) over the same
carry, whose fault fired before the failed chunk touched it. A fatal
error, auto-degrade off, or a rung that dies harvests first the rows
whose host tokens already finish them (their prefix slabs unpinned) and
records the rest in the flight recorder's postmortem, then raises. Each
result's record names its rung, retries and degradations, from the
events of the dispatches that row rode.

Accounting lives in the engine's ``registry`` (an obs
``MetricsRegistry`` under the JAX engine's names; latency percentiles
from each histogram's newest 4096 samples), which ``metrics()`` and
``slo_counters()`` read and ``start_exporter`` serves; with obs on the
engine also emits each request's timeline (queued, admitted, finished
events and a lifetime span).

``step`` (admission, the chunk dispatch, harvest) runs under
``torch.inference_mode()``, so serving records no autograd graph; so do
the methods that write the carry between steps.

Replicas and streaming (the router, the cluster and the HTTP front-end
build on these): ``replica_tag=`` names the engine as one replica and
arms its own fault sites (``serving.<tag>.chunk`` / ``.step``);
``request_keyed_rng=True`` keys each admitted row by
``derive_row_key(seed, rng_request_id or id, rng_tokens_emitted)``, so a
requeued or replayed request that re-prefills its emitted tokens resumes
the key the undisturbed row would hold; ``submit(on_tokens=)`` streams a
row's new tokens at every chunk harvest and once more, ``final=True``,
when it finishes.

AOT bundles: the backend may be an ``AotPredictor`` over a bundle
exported with ``export_decoder_bundle(..., chunk_sizes=[...])``
(``inference/bundle.py``): its ``decode_chunk_b{B}_t{T}`` and
``admit_prefill_s{S}`` programs serve the same loop, the prompt buckets
are the bundle's admission buckets, admission is by host row copy (a
bundle has no ring-staging program; one prefill dispatch per request),
and the per-token rung is the bundle's T = 1 chunk. A bundle backend
refuses ``draft_model=``, ``adapter_store=``, a bundle without chunked
entries and sampling statics other than the baked ones.

Not ported yet (ROADMAP.md queue 1), and refused with
``NotImplementedError`` when asked for: meshes ([13]).
"""

from __future__ import annotations

import collections
import dataclasses
import hashlib
import io
import json
import os
import time
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from paddle_tpu_torch import obs
from paddle_tpu_torch import random as rnd
from paddle_tpu_torch.distributed.checkpoint import _np_restore, _np_storable
from paddle_tpu_torch.inference.generate import (AdmissionRing, DecodeState,
                                                 LlamaDecoder, _batch_rows,
                                                 _normalize_eos, _not_ported,
                                                 _row_copy, _sample_spec,
                                                 _zero_cache)
from paddle_tpu_torch.flags import flags
from paddle_tpu_torch.inference.sharding import MeshMismatchError
from paddle_tpu_torch.obs.metrics import MetricsRegistry
from paddle_tpu_torch.quantization.kv_cache import (QuantMismatchError,
                                                    canonical_quant,
                                                    is_quantized_kv)
from paddle_tpu_torch.runtime.resilience import (CorruptCheckpointError,
                                                 DeadlineExceededError,
                                                 DecodeFailedError,
                                                 DegradationEvent,
                                                 GenerateResult,
                                                 SlabTransferError,
                                                 atomic_write_bytes,
                                                 classify_error,
                                                 fault_injector,
                                                 record_event)
from paddle_tpu_torch.serving.lora import (AdapterVersionError,
                                           UnknownAdapterError)
from paddle_tpu_torch.serving.prefix_cache import (PrefixCache, SlabOps,
                                                   prefix_digests,
                                                   resolve_prefix_cache_bytes)
from paddle_tpu_torch.serving.scheduler import Request, Scheduler, Slot

__all__ = ["ServingEngine", "derive_row_key"]

# engine arguments of the JAX engine whose features later slices port:
# name -> (ROADMAP item, the value that leaves the feature off). Passing
# anything else raises NotImplementedError.
_LATER_ENGINE = {"mesh": ("mesh", None)}
_HIT_CLASSES = ("full", "partial", "miss")
# the payload dtypes of the carry's small fields: the JAX carry's (the port
# holds positions and eos ids as int64 and key words as int32)
_WIRE = {"logits": np.float32, "pos": np.int32, "keys": np.uint32,
         "done": np.bool_, "eos": np.int32, "temp": np.float32}
_SNAP_KIND = "paddle_tpu.decode_snapshot"
# the engine's counters under the JAX engine's registry names:
# short name -> (name, help)
_COUNTERS = {
    "prefill": ("serving.prefill_dispatches",
                "admission prefills (exactly one per admitted request)"),
    "chunk": ("serving.chunk_dispatches",
              "fused decode_chunk dispatches (one per step with live rows)"),
    "step": ("serving.step_dispatches",
             "per-token degradation-rung dispatches"),
    "degradations": ("serving.degradations",
                     "chunk->per_token degradations"),
    "slot_steps": ("serving.slot_steps",
                   "slot-steps run (ALL rows compute every chunk step — the "
                   "honest useful-token-occupancy denominator)"),
    "done": ("serving.requests_completed", ""),
    "prefix_full": ("serving.prefix.hits_full",
                    "admissions served ENTIRELY from a cached slab: zero "
                    "prefill dispatches"),
    "prefix_partial": ("serving.prefix.hits_partial",
                       "admissions that prefilled only the uncached "
                       "suffix"),
    "prefix_miss": ("serving.prefix.misses",
                    "cold admissions (cache populated on the way through)"),
    "prefix_insert": ("serving.prefix.insertions",
                      "slabs inserted into the pool"),
    "prefix_evict": ("serving.prefix.evictions",
                     "LRU slabs evicted past the byte budget"),
    "tokens_saved": ("serving.prefill_tokens_saved",
                     "prompt tokens whose prefill compute a cached prefix "
                     "avoided"),
    "batched_groups": ("serving.admission.batched_groups",
                       "admission rounds that batched several same-bucket "
                       "(suffix-)prefills into one dispatch"),
    "disp_saved": ("serving.admission.dispatches_saved",
                   "prefill dispatches avoided vs one-per-request admission "
                   "(batched groups + full-prefix hits)"),
    "reordered": ("serving.admission.cache_reordered",
                  "queued requests admitted ahead of an earlier-submitted "
                  "same-priority peer because their prefix digest "
                  "maximized slab reuse (cache-aware admission ordering)"),
    "shed_deadline": ("serving.shed.deadline",
                      "submits refused typed: the deadline was already "
                      "expired (shed before any prefill)"),
    "shed_backpressure": ("serving.shed.backpressure",
                          "submits refused typed: estimated queue delay "
                          "already blows the request's deadline"),
    "shed_queue_deadline": ("serving.shed.queue_deadline",
                            "queued requests shed at admission: deadline "
                            "expired while waiting (no prefill was ever "
                            "dispatched)"),
    "deadline_expired_rows": ("serving.deadline.expired_rows",
                              "in-flight rows frozen at a chunk boundary "
                              "past their deadline and returned partial "
                              "(flagged deadline_expired)"),
    "snapshots": ("serving.snapshots",
                  "resumable DecodeState snapshots written "
                  "(crash-recovery cadence + graceful drain)"),
    "corrupt_rows": ("serving.corrupt_rows",
                     "rows whose harvested logits went NaN/Inf: frozen "
                     "ALONE and returned partial (flagged corrupt_row)"),
    "migrated_out": ("serving.rows_migrated_out",
                     "requests extracted off this engine by a live "
                     "migration (ownership leaves with the payload)"),
    "migrated_in": ("serving.rows_migrated_in",
                    "requests absorbed into this engine by a live "
                    "migration"),
    "ring_staged": ("serving.admission.ring_staged",
                    "admitted rows staged into the device ring (their "
                    "prefill dispatch scattered the row state "
                    "device-side)"),
    "ring_scattered": ("serving.admission.ring_scattered",
                       "staged rows spliced into the carry by a chunk "
                       "program's ring prologue (no host round-trip, no "
                       "extra dispatch)"),
    "ring_full": ("serving.admission.ring_full",
                  "admissions deferred because the ring had no free row "
                  "(un-admitted and re-queued at their tier's head)"),
    "host_scattered": ("serving.admission.host_scattered",
                       "legacy host row-scatter admissions (prefix-cache "
                       "paths; 0 whenever the device ring serves "
                       "admission)"),
    "draft_prefill": ("serving.draft_prefill_dispatches",
                      "draft-model admission prefills staged into the "
                      "ring's draft caches (one per admission group under "
                      "speculation)"),
    "spec_rounds": ("serving.spec.rounds",
                    "draft/verify/accept rounds run for live rows"),
    "spec_accepted": ("serving.spec.accepted_drafts",
                      "draft tokens accepted by verification"),
    "spec_overflow": ("serving.spec.overflow_tokens",
                      "tokens committed past the chunk boundary by a round "
                      "that straddled it"),
    "adapter_swaps": ("serving.adapter.swaps",
                      "adapter hot-swaps applied between chunks (stacks "
                      "re-merged after an update() once no in-flight row "
                      "pinned the old revision)"),
}
# histograms: short name -> (name, help, buckets or None for the default)
_HISTOGRAMS = {
    "queue_delay_s": ("serving.queue_delay_s", "submit -> admission wait",
                      None),
    "latency_s": ("serving.request_latency_s", "submit -> finished", None),
    "occupancy": ("serving.occupancy",
                  "occupied-slot fraction per chunk dispatch",
                  [i / 8 for i in range(1, 9)]),
    "queue_depth": ("serving.queue_depth",
                    "queued requests observed per step",
                    [0, 1, 2, 4, 8, 16, 32, 64, 128]),
    "ttft_s": ("serving.ttft_s", "time to first token (admission -> first "
               "chunk completion)", None),
    "tpot_s": ("serving.tpot_s", "per-request mean inter-token time after "
               "the first token", None),
    **{f"admission_s.{c}": (f"serving.admission_s.{c}",
                            f"per-request admission wall time, {c}-hit "
                            f"class", None) for c in _HIT_CLASSES},
}
_MIGRATION_KIND = "paddle_tpu.row_migration"


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


def derive_row_key(seed: int, request_id: int, tokens_emitted: int,
                   device=None) -> torch.Tensor:
    """The request-keyed row stream (``request_keyed_rng=True``):
    ``split(fold_in(PRNGKey(seed), request_id), 1)[0]``, advanced once per
    already-emitted token by the rule the chunk's step uses (``next =
    split(key)[0]``). An admission that replays ``tokens_emitted``
    teacher-forced tokens so resumes the key the undisturbed row would
    hold: a sampled requeue or replay on another engine or worker draws
    the same continuation. The key is made on ``device`` (the card unless
    the caller says otherwise), where each step runs the threefry
    kernel."""
    key = rnd.split(rnd.fold_in(rnd.PRNGKey(seed, device=device),
                                int(request_id)), 1)[0]
    for _ in range(int(tokens_emitted)):
        key = rnd.split(key)[0]
    return key


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


def _cache_leaves(cache) -> list:
    """A stacked cache's leaves in ``jax.tree_util`` order: the tensor, or
    a quantized cache's ``q`` then ``s``."""
    if is_quantized_kv(cache):
        return [cache[k] for k in sorted(cache)]
    return [cache]


def _carry_leaves(st: DecodeState) -> List[Tuple[str, torch.Tensor]]:
    """``(field, tensor)`` per leaf of the JAX engine's snapshot carry
    ``(logits, kc, vc, pos, keys, done, eos, temp)``, in its flatten
    order."""
    return ([("logits", st.logits)]
            + [("kc", t) for t in _cache_leaves(st.kc)]
            + [("vc", t) for t in _cache_leaves(st.vc)]
            + [(n, getattr(st, n))
               for n in ("pos", "keys", "done", "eos", "temp")])


def _to_wire(field: str, t: torch.Tensor) -> Tuple[np.ndarray, str]:
    """A carry leaf (or rows of it) as the payload stores it, with its
    dtype tag: caches in their own dtype (bf16 as tagged ``uint16``
    bits), the small fields in the JAX carry's dtypes (key words as
    ``uint32``)."""
    if field in ("kc", "vc"):
        return _np_storable(t)
    a = t.detach().cpu().numpy()
    a = a.view(np.uint32) if field == "keys" else a.astype(_WIRE[field])
    return a, str(a.dtype)


def _wire_tag(field: str, t: torch.Tensor) -> str:
    """The dtype tag a payload leaf must carry to fit carry leaf ``t``."""
    if field in ("kc", "vc"):
        return _np_storable(torch.empty((0,), dtype=t.dtype))[1]
    return np.dtype(_WIRE[field]).name


class _DecoderBackend:
    """In-process backend: a ``LlamaDecoder``'s ring-staged admission
    prefills and ring chunk entries (plain or speculative), and the
    host-scatter route's admission prefill, row copy and plain chunk. The
    carry's caches (the draft's too) hold one batch row more than the
    slots: the ring's dump row. With an ``adapter_store`` it keeps the
    store's stacks merged into the decoder's params (``lora_version`` is
    the store version they serve)."""

    has_ring = True
    # any admission batch size and suffix prefills (pos0 > 0) are native
    # to the in-process admission prefill; the scheduler's own buckets
    admit_batch_any = True
    admit_pos0 = True
    prompt_buckets = None

    def __init__(self, dec: LlamaDecoder, num_slots: int, do_sample,
                 top_k, top_p, quant=None, draft_model=None,
                 num_speculative_tokens=None, draft_quant=None,
                 adapter_store=None):
        _check_quant_ask(quant, dec.quant, "this LlamaDecoder")
        self.dec = dec
        self.lora = adapter_store
        self.lora_version = -1
        if adapter_store is not None:
            self.refresh_adapters()
        self.quant = dec.quant
        self.num_slots = int(num_slots)
        self.max_len = dec.max_len
        self.head_major = dec._head_major
        self.sample = _sample_spec(do_sample, top_k, top_p)
        self.K = dec._resolve_k(draft_model, num_speculative_tokens,
                                draft_quant)
        self.spec_eng = (dec._spec_engine(draft_model, draft_quant)
                         if self.K else None)
        self.ring: Optional[AdmissionRing] = None
        self._carry = self._dcarry = None

    @property
    def device(self) -> torch.device:
        return self.dec.device

    def refresh_adapters(self) -> bool:
        """(Re)merge the store's stacked ``lora.*`` tensors into the
        decoder's params, on its device. The shapes are validated against
        the live params first (an int8 base keeps its matrix geometry in
        the ``:int8`` tensor). The stacks are new tensors each time, so a
        captured graph keyed on the old ones is never replayed over them
        (the graphs hold the old ones). Returns True when the stacks
        moved."""
        store = self.lora
        if store is None or store.version == self.lora_version:
            return False
        p = self.dec.params
        shapes = {}
        for pn in store.param_names():
            w = p.get(pn)
            if w is None:
                w = p.get(pn + ":int8")
            if w is None:
                raise ValueError(
                    f"adapter store targets decoder param {pn!r} which "
                    f"this model does not have")
            shapes[pn] = tuple(int(s) for s in w.shape[-2:])
        stacks = store.stacks(param_shapes=shapes)
        p.update({k: torch.from_numpy(v).to(self.dec.device)
                  for k, v in stacks.items()})
        self.lora_version = store.version
        return True

    def new_state(self) -> DecodeState:
        """A fresh carry, every slot free. The caches are allocated on the
        first call and zeroed in place on later ones: the ring's splice
        and the captured chunk graphs hold their addresses."""
        B, dev = self.num_slots, self.dec.device
        if self._carry is None:
            self._carry = self.dec._empty_cache(B + 1)
            if self.spec_eng is not None:
                self._dcarry = self.dec._empty_cache(B + 1,
                                                     self.spec_eng["cfg"])
        else:
            for c in self._carry + (self._dcarry or ()):
                _zero_cache(c)
        kc, vc = (_batch_rows(c, B) for c in self._carry)
        kw = {}
        if self.spec_eng is not None:
            # the speculative carry: draft caches (ring-staged at
            # admission), the pending-token sentinel and zeroed per-row
            # acceptance counts
            dkc, dvc = (_batch_rows(c, B) for c in self._dcarry)
            zeros = torch.zeros((B,), dtype=torch.long, device=dev)
            kw = dict(dkc=dkc, dvc=dvc, tok=torch.full_like(zeros, -1),
                      spec_rounds=zeros, spec_accepted=zeros.clone(),
                      nv=zeros.clone(),
                      spec_on=torch.ones((B,), dtype=torch.bool, device=dev),
                      spec={"ekey": self.spec_eng["ekey"], "K": self.K})
        if self.lora is not None:
            kw["adapter_idx"] = torch.zeros((B,), dtype=torch.long,
                                            device=dev)
        return DecodeState(
            logits=torch.zeros((B, self.dec.cfg.vocab_size),
                               dtype=torch.float32, device=dev),
            kc=kc, vc=vc,
            pos=torch.zeros((B,), dtype=torch.long, device=dev),
            keys=torch.zeros((B, 2), dtype=torch.int32, device=dev),
            done=torch.ones((B,), dtype=torch.bool, device=dev),  # all free
            eos=torch.full((B,), -1, dtype=torch.long, device=dev),
            temp=torch.ones((B,), dtype=torch.float32, device=dev), **kw)

    # -- device admission ring ---------------------------------------------
    def ring_init(self, R: int) -> None:
        """Allocate the R-row ring over the carry ``new_state`` made (and
        the draft-cache ring under speculation)."""
        spec = {}
        if self.spec_eng is not None:
            spec = dict(draft_cfg=self.spec_eng["cfg"],
                        carry_dkc=self._dcarry[0], carry_dvc=self._dcarry[1])
        self.ring = AdmissionRing.allocate(self.dec, R, *self._carry,
                                           lora=self.lora is not None, **spec)

    def ring_admit(self, ids, true_len, pos0, ring_idx, aidx=None) -> None:
        """ONE counted admission-prefill dispatch whose rows stage
        straight into ring rows ``ring_idx``; ``aidx`` prefills each row
        through its adapter's deltas."""
        self.dec.ring_admit_prefill(ids, true_len, pos0, self.ring,
                                    ring_idx, aidx)

    def ring_admit_draft(self, ids, ring_idx) -> None:
        """ONE counted draft prefill staged into the ring's draft caches."""
        self.dec.ring_admit_draft(ids, self.ring, ring_idx, self.spec_eng)

    def decode_chunk_ring(self, st: DecodeState, chunk_size: int, splice):
        """Load the splice metadata (``ServingEngine._ring_args``), then
        one chunk dispatch that splices the staged rows in before its
        steps."""
        self.ring.load(**splice)
        return self.dec._chunk_decode(st, int(chunk_size), self.sample,
                                      self.ring)

    def decode_chunk_spec(self, st: DecodeState, chunk_size: int, splice,
                          K: Optional[int] = None):
        """One speculative chunk dispatch over the serving carry after
        the ring's splice: returns ``(buf (B, T (K + 1) + 1), nv, new
        state)``. ``K`` overrides the draft length for this chunk."""
        self.ring.load(**splice)
        K = self.K if K is None else int(K)
        toks, st = self.dec._spec_chunk_decode(st, int(chunk_size), K,
                                               self.sample, self.ring)
        return toks, st.nv, st

    # -- host-scatter route (the prefix cache's) ---------------------------
    def admit_prefill(self, ids, true_len, pos0, prepare=None, aidx=None):
        """One (possibly batched) admission-prefill dispatch: ``ids``
        (N, bucket) right-padded rows, per-row ``true_len``/``pos0``;
        ``prepare(kc, vc)`` preloads the prefix cache's slabs; ``aidx``
        routes each row through its adapter's deltas. Returns ``(logits,
        kc, vc)``."""
        return self.dec.admit_prefill(ids, true_len, pos0, prepare=prepare,
                                      aidx=aidx)

    def scatter(self, st: DecodeState, slot: int, logits1, kc1, vc1,
                src: int, pos1: int, key, eos: int, temp: float,
                aidx: Optional[int] = None) -> None:
        """Copy row ``src`` of an admission's row state (a batched
        prefill's output or a batch-1 slab, possibly shorter on the length
        axis) into carry row ``slot``, with the row's key, eos,
        temperature and, on a LoRA carry given ``aidx``, adapter index:
        the JAX engine's ``_admit_row``. ``slot`` is a slot index, never
        the dump row."""
        _row_copy(st.kc, kc1, slot, src, self.head_major)
        _row_copy(st.vc, vc1, slot, src, self.head_major)
        st.logits[slot].copy_(logits1[src])
        st.pos[slot] = pos1
        st.keys[slot].copy_(torch.from_numpy(
            np.asarray(key, np.uint32).view(np.int32)))
        st.done[slot] = False
        st.eos[slot] = eos
        st.temp[slot] = float(np.float32(temp))
        if st.adapter_idx is not None and aidx is not None:
            st.adapter_idx[slot] = aidx

    def decode_chunk(self, st: DecodeState, chunk_size: int):
        return self.dec._chunk_decode(st, int(chunk_size), self.sample)

    # -- the degradation ladder ---------------------------------------------
    def decode_step_ring(self, st: DecodeState, splice):
        """One per-token rung step (``decode.chunk_step``) after the ring's
        splice: the pending one on the rung's first step, an empty one
        after it (every ring row's slot -1)."""
        self.ring.load(**splice)
        return self.dec._chunk_step(st, self.sample, self.ring)

    def decode_step(self, st: DecodeState):
        return self.dec._chunk_step(st, self.sample)

    def has_step_rung(self) -> bool:
        return True

    def spec_demote(self, st: DecodeState) -> DecodeState:
        """Speculative -> chunked: commit each row's pending token with
        one counted masked forward and drop the draft side of the carry."""
        return self.dec.spec_demote(st)

    def event_count(self) -> int:
        return len(self.dec._events)

    def events_since(self, n: int) -> list:
        return list(self.dec._events[n:])


class _BundleBackend:
    """AOT backend: the ``decode_chunk_b{B}_t{T}`` / ``admit_prefill_s{S}``
    programs of a bundle exported with ``chunk_sizes=``
    (``decode_mode.chunked``), run by an ``AotPredictor``: no model
    Python. The carry holds the slots' rows only (no ring, so no dump
    row); its caches and each admission bucket's batch-1 caches are
    allocated once, so the predictor's entry graphs keep reading and
    writing them on a card."""

    has_ring = False       # no ring-staging programs: host row copies
    spec_eng = None
    K = 0
    lora = None            # refused typed in __init__: no adapter stacks
    lora_version = -1
    # the admit programs are fixed batch-1 programs
    admit_batch_any = False

    def __init__(self, pred, num_slots: int, chunk_size: int, do_sample,
                 top_k, top_p, quant=None, draft_model=None,
                 num_speculative_tokens=None, draft_quant=None,
                 adapter_store=None):
        meta = pred.meta
        mode = meta.get("decode_mode") or {}
        if draft_model is not None or num_speculative_tokens is not None \
                or draft_quant is not None:
            ch0 = mode.get("chunked") or {}
            raise ValueError(
                f"speculative serving needs the in-process LlamaDecoder "
                f"backend: this bundle's chunked entries carry no "
                f"speculative chunk program (decode_mode.chunked."
                f"spec_chunk={bool(ch0.get('spec_chunk'))!r}); serve "
                f"draft_model= over a LlamaDecoder instead")
        if adapter_store is not None:
            raise ValueError(
                "LoRA adapter serving needs the in-process LlamaDecoder "
                "backend: this bundle's programs were exported without "
                "the stacked lora.* params or the adapter_idx carry; serve "
                "adapter_store= over a LlamaDecoder instead")
        _check_quant_ask(quant, pred.quant_recipe, "this bundle")
        self.pred = pred
        self.quant = pred.quant_recipe
        self.num_slots = int(num_slots)
        self.head_major = pred._head_major()
        ch = mode.get("chunked")
        if not ch:
            raise ValueError(
                "this bundle has no chunked decode entries; re-export it "
                "with export_decoder_bundle(..., chunk_sizes=[...]) to "
                "serve continuous batching")
        for name, want in (("do_sample", bool(do_sample)),
                           ("top_k", top_k), ("top_p", top_p)):
            baked = mode.get(name)
            if name == "do_sample":
                baked = bool(baked)
            if baked != want:
                raise ValueError(
                    f"bundle chunked entries were exported with "
                    f"{name}={baked!r}; the engine asked for {want!r}")
        self.max_len = meta["max_len"]
        by_chunk = {b["chunk"]: b["file"] for b in meta["chunk_buckets"]
                    if b["batch"] == self.num_slots}
        if int(chunk_size) not in by_chunk:
            have = [(b["batch"], b["chunk"])
                    for b in meta["chunk_buckets"]]
            raise ValueError(
                f"no chunked decode bucket for batch={self.num_slots}, "
                f"chunk={chunk_size}; exported (batch, chunk): {have}")
        self._chunk = (by_chunk[int(chunk_size)], int(chunk_size))
        self._step = (by_chunk[1], 1) if 1 in by_chunk else None
        self._admit = {b["seq"]: b["file"]
                       for b in meta["admit_prefill_buckets"]}
        self.admit_pos0 = bool(ch.get("admit_pos0"))
        self.prompt_buckets = sorted(self._admit)
        self._vocab = meta["vocab_size"]
        self._carry = None
        self._admit_caches: Dict[int, tuple] = {}

    @property
    def device(self) -> torch.device:
        return self.pred.device

    def event_count(self) -> int:
        return len(self.pred._events)

    def events_since(self, n: int) -> list:
        return list(self.pred._events[n:])

    def new_state(self) -> DecodeState:
        """A fresh carry, every slot free; its caches are allocated on the
        first call and zeroed in place on later ones."""
        B, dev = self.num_slots, self.device
        if self._carry is None:
            self._carry = self.pred._make_cache(B)
        else:
            for c in self._carry:
                _zero_cache(c)
        return DecodeState(
            logits=torch.zeros((B, self._vocab), dtype=torch.float32,
                               device=dev),
            kc=self._carry[0], vc=self._carry[1],
            pos=torch.zeros((B,), dtype=torch.long, device=dev),
            keys=torch.zeros((B, 2), dtype=torch.int32, device=dev),
            done=torch.ones((B,), dtype=torch.bool, device=dev),
            eos=torch.full((B,), -1, dtype=torch.long, device=dev),
            temp=torch.ones((B,), dtype=torch.float32, device=dev))

    def admit_prefill(self, ids, true_len, pos0, prepare=None, aidx=None):
        """One batch-1 admission-prefill dispatch of the prompt bucket's
        program over that bucket's own caches, zeroed and handed to
        ``prepare(kc, vc)`` (the prefix cache's slab) first. Returns
        ``(logits, kc, vc)``; the caches stay valid until the bucket's
        next admission. ``aidx`` is always None: the backend refuses an
        adapter store."""
        from paddle_tpu_torch.inference.bundle import _run_once
        ids = np.asarray(ids)
        if ids.shape[0] != 1:
            raise ValueError(
                f"bundle admit entries serve batch 1, got {ids.shape[0]}")
        S = int(ids.shape[1])
        if S not in self._admit:
            raise ValueError(f"no admit_prefill bucket for prompt bucket "
                             f"{S}; exported: {self.prompt_buckets}")
        kc, vc = self._admit_caches.get(S) or (None, None)
        if kc is None:
            kc, vc = self._admit_caches[S] = self.pred._make_cache(1)
        else:
            _zero_cache(kc)
            _zero_cache(vc)
        if prepare is not None:
            prepare(kc, vc)
        dev = self.device
        (logits,) = self.pred._run_entry(
            self._admit[S], "bundle.admit_prefill", _run_once,
            (torch.as_tensor(ids, dtype=torch.long, device=dev), kc, vc,
             torch.as_tensor(np.asarray(true_len), dtype=torch.long,
                             device=dev),
             torch.as_tensor(np.asarray(pos0), dtype=torch.long,
                             device=dev)), (1, 2))
        return logits, kc, vc

    scatter = _DecoderBackend.scatter

    def _run(self, entry, site, st: DecodeState):
        from paddle_tpu_torch.inference.bundle import _run_steps
        fname, T = entry
        toks, logits, pos, keys, done = self.pred._run_entry(
            fname, site, _run_steps(T),
            (st.logits, st.kc, st.vc, st.pos, st.keys, st.done, st.eos,
             st.temp), (1, 2))
        return toks, dataclasses.replace(st, logits=logits, pos=pos,
                                         keys=keys, done=done)

    def decode_chunk(self, st: DecodeState, chunk_size: int):
        return self._run(self._chunk, "bundle.chunk", st)

    def decode_step(self, st: DecodeState):
        return self._run(self._step, "bundle.chunk_step", st)

    def has_step_rung(self) -> bool:
        return self._step is not None


def _make_backend(backend, num_slots, chunk_size, do_sample, top_k, top_p,
                  **kw):
    from paddle_tpu_torch.inference.bundle import AotPredictor
    if isinstance(backend, LlamaDecoder):
        return _DecoderBackend(backend, num_slots, do_sample, top_k, top_p,
                               **kw)
    if isinstance(backend, AotPredictor):
        return _BundleBackend(backend, num_slots, chunk_size, do_sample,
                              top_k, top_p, **kw)
    raise TypeError(
        f"backend must be a LlamaDecoder or an AotPredictor, "
        f"got {type(backend).__name__}")


class ServingEngine:
    """Slot-admission continuous-batching engine.

    ``submit`` queues a request and returns its id; ``step`` runs one
    admit-dispatch-harvest iteration and returns the requests it
    finished; ``drain`` steps until queue and slots are empty. Results
    are ``GenerateResult`` arrays (prompt + generated tokens, trimmed at
    the request's eos / budget) whose ``.resilience`` record carries the
    serving stats of that request (queue delay, latency, chunks, slot,
    prefix-cache hit class, speculative counts) and its rung on the
    degradation ladder (``level``, ``retries``, ``degradations``,
    ``events``).

    Greedy tokens equal a solo ``LlamaDecoder.generate`` of the same
    request: admission, chunk slicing, batch neighbours, the prefix
    cache and speculation cannot change them. Sampled tokens depend only
    on the request's seed and temperature (per-row keys), so they are the
    same across engine configurations and equal ``generate(chunk_size=T,
    seed=)`` of the request alone. ``do_sample`` / ``top_k`` / ``top_p``
    are engine-wide; eos id, temperature and seed are per request.

    ``ring_slots``: rows in the device admission ring (default
    ``num_slots``, at least 1; refused with a prefix cache, which admits
    by host row copy). ``prefix_cache``: ``None`` reads the
    ``serving_prefix_cache_bytes`` flag / ``PADDLE_TPU_PREFIX_CACHE_BYTES``
    budget (0 = off, the default), ``True`` turns it on, a
    ``PrefixCache`` is served directly. ``batch_admission``: one prefill
    dispatch per same-bucket group of a round. ``cache_aware_admission``
    (default: on with the cache) orders cached digests first.
    ``draft_model`` / ``num_speculative_tokens`` / ``draft_quant`` serve
    speculatively (not with a prefix cache); ``adaptive_k`` sets each
    chunk's K from the running acceptance mean. ``adapter_store``: an
    ``AdapterStore`` whose adapters requests name with
    ``submit(adapter=)``; base rows keep the base model's tokens.

    ``slo_targets`` maps a latency class to its default targets,
    ``{"ttft_s": ..., "latency_s": ...}``; ``submit(slo_ttft_s=,
    slo_latency_s=)`` override them per request. Every finished request
    of a class with a target counts in ``slo_counters()`` (the JAX
    registry's ``serving.slo.<class>.*`` names) and ``metrics()
    ["slo_violations"]``. ``submit(deadline_s=)`` is a hard budget (see
    the module docstring). ``snapshot_dir`` / ``snapshot_every_chunks``:
    write a resumable snapshot into ``snapshot_dir`` every N chunk
    dispatches (not with a draft model, whose carry the payload does not
    hold); ``snapshot_dir`` is also ``drain(deadline_s=)``'s default
    destination. ``registry`` holds the engine's counters, gauges and
    histograms; ``start_exporter(port)`` serves them over HTTP. The
    engine runs on its backend's device: a ``LlamaDecoder``, or an
    ``AotPredictor`` over a chunked bundle."""

    def __init__(self, backend, num_slots: int = 4,
                 chunk_size: int = 8, do_sample: bool = False,
                 top_k: Optional[int] = None, top_p: Optional[float] = None,
                 policy: str = "fifo",
                 prompt_buckets: Optional[Sequence[int]] = None,
                 prefix_cache=None,
                 prefix_cache_bytes: Optional[int] = None,
                 prefix_block_tokens: Optional[int] = None,
                 batch_admission: bool = False,
                 quant: Optional[str] = None,
                 cache_aware_admission: Optional[bool] = None,
                 draft_model=None,
                 num_speculative_tokens: Optional[int] = None,
                 draft_quant: Optional[str] = None,
                 ring_slots: Optional[int] = None,
                 adaptive_k: bool = False, adapter_store=None,
                 slo_targets: Optional[Dict[str, Dict[str, float]]] = None,
                 snapshot_dir: Optional[str] = None,
                 snapshot_every_chunks: int = 0,
                 replica_tag: Optional[str] = None,
                 request_keyed_rng: bool = False, **later):
        _refuse_later(later, _LATER_ENGINE, "ServingEngine")
        if chunk_size < 1:
            raise ValueError(f"chunk_size must be >= 1, got {chunk_size}")
        self.num_slots = int(num_slots)
        self.chunk_size = int(chunk_size)
        self._b = _make_backend(
            backend, num_slots, chunk_size, do_sample, top_k, top_p,
            quant=quant, draft_model=draft_model,
            num_speculative_tokens=num_speculative_tokens,
            draft_quant=draft_quant, adapter_store=adapter_store)
        self._spec_configured = self._b.spec_eng is not None
        if adaptive_k and not self._spec_configured:
            raise ValueError("adaptive_k requires a draft_model")
        self.adaptive_k = bool(adaptive_k)
        self._k_now = self._b.K
        self._accept_ewma: Optional[float] = None
        self.adapter_store = adapter_store
        # the revisions the device stacks serve (the store's at every
        # applied swap) and the adapters they hold
        self._served_rev: Dict[str, int] = (
            {} if adapter_store is None
            else {n: adapter_store.revision(n)
                  for n in adapter_store.names()})
        if self._spec_configured and (snapshot_dir or snapshot_every_chunks):
            raise ValueError(
                "speculative serving does not snapshot yet: the carry's "
                "draft caches and pending-token fields are outside the "
                "snapshot payload — drop snapshot_dir/"
                "snapshot_every_chunks or serve without draft_model")
        self.scheduler = Scheduler(
            num_slots, policy=policy,
            prompt_buckets=prompt_buckets or self._b.prompt_buckets)
        self.state = self._b.new_state()
        self.batch_admission = bool(batch_admission)
        self.prefix_cache = self._resolve_prefix_cache(
            prefix_cache, prefix_cache_bytes, prefix_block_tokens)
        if self._spec_configured and self.prefix_cache is not None:
            raise ValueError(
                "speculative serving does not compose with the prefix "
                "cache yet: slab admission bypasses the ring's draft-"
                "cache staging — disable prefix_cache or drop "
                "draft_model")
        # the device admission ring; the prefix cache's slab admissions
        # need the host row copy, so the cache keeps that route
        self._ring_slots = 0
        self._ring_meta: List[Optional[dict]] = []
        if self._b.has_ring and self.prefix_cache is None:
            R = int(ring_slots if ring_slots is not None else num_slots)
            if R < 1:
                raise ValueError(f"ring_slots must be >= 1, got {R}")
            self._ring_slots = R
            self._ring_meta = [None] * R
            self._b.ring_init(R)
        elif ring_slots is not None:
            raise ValueError(
                "ring_slots needs the device admission ring: an "
                "in-process LlamaDecoder backend without a prefix cache")
        self._slab_ops = None
        if self.prefix_cache is not None:
            self.prefix_cache.bind_mesh(None)
            self._slab_ops = SlabOps(None, self._b.head_major)
        self._cache_aware = (bool(cache_aware_admission)
                             if cache_aware_admission is not None
                             else self.prefix_cache is not None)
        if self._cache_aware and self.prefix_cache is not None:
            self.scheduler.cache_aware = True
            self.scheduler.cache_probe = self.prefix_cache.has_digest
        self._last_nv: Optional[np.ndarray] = None
        self._next_id = 0
        self._results: Dict[int, Any] = {}
        # the engine's own always-on registry: every count, gauge and
        # latency distribution metrics() reports (histogram percentiles
        # from the newest 4096 samples, as in the JAX engine)
        self.registry = r = MetricsRegistry()
        self._c = {k: r.counter(n, h) for k, (n, h) in _COUNTERS.items()}
        self._h = {k: r.histogram(n, h, b)
                   for k, (n, h, b) in _HISTOGRAMS.items()}
        self._g_qdepth = r.gauge("serving.queue_depth_now", "")
        self._g_prefix_bytes = r.gauge("serving.prefix.bytes_cached",
                                       "live slab bytes in the pool")
        self._g_prefix_slabs = r.gauge("serving.prefix.slabs",
                                       "live slabs in the pool")
        self._g_spec_accept_mean = r.gauge(
            "serving.spec.acceptance_len_mean",
            "cumulative accepted drafts per verify round")
        self._g_k_now = r.gauge(
            "serving.spec.k_now",
            "the draft depth K the next speculative chunk dispatches with "
            "(== num_speculative_tokens unless adaptive_k clamps it from "
            "the live acceptance mean)")
        if self._spec_configured:
            self._g_k_now.set(self._b.K)
        self._g_adapters_active = r.gauge(
            "serving.adapter.active",
            "adapters registered in this engine's AdapterStore")
        if adapter_store is not None:
            self._g_adapters_active.set(len(adapter_store))
        self._c_adapter_rows: Dict[str, Any] = {}
        self._last_prefix_stats = {"insertions": 0, "evictions": 0}
        # the speculative rung: on until a failed speculative chunk
        # demotes the carry to the plain chunk (one-way)
        self._spec_active = self._spec_configured
        self._exporter = None
        # per-latency-class streaming TTFT (histograms made on first use)
        # and each streaming request's callback
        self._h_stream_ttft: Dict[str, Any] = {}
        self._stream_cb: Dict[int, Any] = {}
        self.replica_tag = None if replica_tag is None else str(replica_tag)
        self.request_keyed_rng = bool(request_keyed_rng)
        # a ladder exhaustion's postmortem carries this registry and the
        # prefix cache's pool (weakrefs)
        tag = (f"serving.{self.replica_tag}" if self.replica_tag
               else "serving")
        obs.flight_recorder.add_registry(tag, self.registry)
        if self.prefix_cache is not None:
            obs.flight_recorder.add_state(f"{tag}.prefix_cache",
                                          self.prefix_cache)
        # crash recovery: the snapshot cadence, the last snapshot (its
        # monotonic time and path) and the carry's decode steps, which the
        # JAX carry keeps as ``DecodeState.steps_done``
        self._snap_dir = snapshot_dir
        self._snap_every = int(snapshot_every_chunks or 0)
        if self._snap_every and not self._snap_dir:
            raise ValueError(
                "snapshot_every_chunks needs snapshot_dir to write into")
        self._snap_last_chunks = 0
        self._last_snapshot: Optional[Tuple[float, str]] = None
        self._steps_done = 0
        self.slo_targets = {k: dict(v)
                            for k, v in (slo_targets or {}).items()}

    @staticmethod
    def _resolve_prefix_cache(prefix_cache, bytes_, block):
        if prefix_cache is False:
            return None
        if isinstance(prefix_cache, PrefixCache):
            return prefix_cache
        budget = bytes_ if bytes_ is not None \
            else resolve_prefix_cache_bytes()
        if prefix_cache is None and not budget:
            return None           # default: flags/env say disabled
        if prefix_cache is not None and prefix_cache is not True:
            raise TypeError(
                f"prefix_cache must be None, a bool, or a PrefixCache, "
                f"got {type(prefix_cache).__name__}")
        return PrefixCache(bytes_budget=budget or None,
                           block_tokens=block)

    @property
    def prefill_dispatches(self) -> int:
        return self._count("prefill")

    @property
    def chunk_dispatches(self) -> int:
        return self._count("chunk")

    @property
    def step_dispatches(self) -> int:
        return self._count("step")

    def _count(self, name: str) -> int:
        return int(self._c[name].value)

    def _adapter_row_counter(self, name: str):
        ctr = self._c_adapter_rows.get(name)
        if ctr is None:
            ctr = self._c_adapter_rows[name] = self.registry.counter(
                f"serving.adapter.rows.{name}",
                f"rows admitted for adapter {name!r} ('base' = no "
                f"adapter) — mixed names across one chunk ARE the "
                f"shared fused dispatch")
        return ctr

    def _stream_ttft_hist(self, cls: str):
        h = self._h_stream_ttft.get(cls)
        if h is None:
            h = self.registry.histogram(
                f"serving.stream.ttft_s.{cls}",
                f"admission -> first streamed flush, latency class "
                f"{cls!r} (streaming submits only)")
            self._h_stream_ttft[cls] = h
        return h

    def _row_key(self, req: Request) -> np.ndarray:
        """An admitted row's key as uint32 words: the request-keyed stream
        under ``request_keyed_rng``, else ``split(PRNGKey(seed), 1)[0]``,
        as on both of the JAX engine's admission routes."""
        if not self.request_keyed_rng:
            return _row_key(req.seed)
        rng_id = (req.rng_request_id if req.rng_request_id is not None
                  else req.id)
        return derive_row_key(req.seed, rng_id, req.rng_tokens_emitted,
                              device=self._b.device).cpu().numpy() \
            .view(np.uint32)

    @property
    def host_scattered(self) -> int:
        """Admitted rows copied into the carry by the host-scatter route
        (the prefix cache's); 0 when the device ring serves admission."""
        return self._count("host_scattered")

    # -- multi-tenant LoRA --------------------------------------------------
    def _adapter_tag(self, name: Optional[str]) -> Optional[str]:
        """The prefix-cache content tag of a request's adapter,
        ``"name@rev"``, or None for base rows (base digests stay those of
        a cache without adapters)."""
        if name is None or self.adapter_store is None:
            return None
        return self.adapter_store.tag(name)

    def _adapter_index(self, name: Optional[str]) -> int:
        return (0 if self.adapter_store is None
                else self.adapter_store.index(name))

    def _swap_blocker(self) -> Optional[AdapterVersionError]:
        """The refusal of a pending swap: an in-flight row that still
        decodes through a revision the swap would change, or None."""
        store = self.adapter_store
        for i, slot in self.scheduler.slots.occupied():
            ad = slot.request.adapter
            if ad is None or slot.adapter_rev is None:
                continue
            cur = store.revision(ad)
            if cur != slot.adapter_rev:
                return AdapterVersionError(
                    f"adapter {ad!r} staged rev {cur} but request "
                    f"{slot.request.id} (slot {i}) still decodes "
                    f"through rev {slot.adapter_rev}; the swap applies "
                    f"once those rows drain",
                    adapter=ad, pinned_rev=slot.adapter_rev,
                    store_rev=cur)
        return None

    def apply_adapter_swap(self) -> bool:
        """Apply the store's pending registrations and updates to the
        decoder's stacks. Refused with ``AdapterVersionError`` while an
        in-flight row still decodes through a revision the swap would
        change (a KV cache computed under one revision and continued under
        another is neither tenant's output). ``step()`` applies a pending
        swap as soon as nothing blocks it; requests naming the pending
        revision wait for it. Returns True when the stacks moved."""
        store = self.adapter_store
        if store is None or store.version == self._b.lora_version:
            return False
        err = self._swap_blocker()
        if err is not None:
            raise err
        self._b.refresh_adapters()
        self._c["adapter_swaps"].inc()
        self._g_adapters_active.set(len(store))
        self._served_rev = {n: store.revision(n) for n in store.names()}
        return True

    # -- submission --------------------------------------------------------
    def submit(self, prompt, max_new_tokens: int,
               eos_token_id: Optional[int] = None,
               temperature: float = 1.0, seed: int = 0,
               priority: int = 0, latency_class: str = "default",
               slo_ttft_s: Optional[float] = None,
               slo_latency_s: Optional[float] = None,
               deadline_s: Optional[float] = None,
               speculative: Optional[bool] = None,
               adapter: Optional[str] = None,
               rng_request_id: Optional[int] = None,
               rng_tokens_emitted: int = 0, on_tokens=None) -> int:
        """Queue one request; returns its id (results key).
        ``temperature`` and ``seed`` act on a sampling engine: the row's
        key is ``split(PRNGKey(seed), 1)[0]``. ``latency_class`` buckets
        the request's SLO counts; ``slo_ttft_s`` / ``slo_latency_s``
        override the class's targets. ``deadline_s`` is a hard budget
        from now: an expired one, or one below
        ``estimated_queue_delay_s()``, raises ``DeadlineExceededError``
        here, before any prefill. ``speculative=False`` opts
        the request out of speculation on a draft-equipped engine (its row
        decodes verify-free in the same chunk). ``adapter`` serves the
        request through a registered LoRA adapter of the engine's
        ``adapter_store``: an unknown name, or any name on an engine
        without a store, is an ``UnknownAdapterError`` here.
        ``rng_request_id`` / ``rng_tokens_emitted`` feed the
        ``request_keyed_rng`` key (a router passes its stable request id
        and, on a replay, how many generated tokens the prompt already
        carries); the seed-only rule ignores them. ``on_tokens`` is a
        streaming callback ``(request_id, new_tokens, final)`` fired at
        every chunk harvest with the tokens the row gained since the last
        call, then once with ``final=True`` when it finishes."""
        if adapter is not None:
            if self.adapter_store is None:
                raise UnknownAdapterError(
                    f"request names adapter {adapter!r} but this engine "
                    f"serves no AdapterStore (pass adapter_store=)")
            self.adapter_store.index(adapter)   # the typed unknown-name check
        if speculative and not self._spec_configured:
            raise ValueError(
                "submit(speculative=True) needs a draft_model-equipped "
                "engine")
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
        # a verify writes K + 1 positions past the last committed token
        slack = self._b.K if self._spec_configured else 0
        if max(bucket,
               len(prompt) + int(max_new_tokens) + slack) > self._b.max_len:
            extra = (f" + {slack} speculative lookahead slack"
                     if slack else "")
            raise ValueError(
                f"prompt {len(prompt)} (bucket {bucket}) + "
                f"{max_new_tokens} new tokens{extra} exceeds the "
                f"backend's max_len {self._b.max_len}")
        if deadline_s is not None:
            deadline_s = float(deadline_s)
            if deadline_s <= 0:
                # the cheapest shed: the budget is gone before any work
                self._c["shed_deadline"].inc()
                raise DeadlineExceededError(
                    f"request deadline ({deadline_s:.4f}s) already "
                    f"expired at submit; shed before any prefill")
            est = self.estimated_queue_delay_s()
            if est > deadline_s:
                self._c["shed_backpressure"].inc()
                raise DeadlineExceededError(
                    f"estimated queue delay {est:.4f}s (depth "
                    f"{len(self.scheduler)} over {self.num_slots} "
                    f"slots) already exceeds the {deadline_s:.4f}s "
                    f"deadline; shed at submit")
        rid = self._next_id
        self._next_id += 1
        req = Request(
            id=rid, prompt=prompt, max_new_tokens=int(max_new_tokens),
            eos_token_id=_normalize_eos(eos_token_id),
            temperature=float(temperature), seed=int(seed),
            priority=int(priority), submit_time=time.monotonic(),
            latency_class=str(latency_class), slo_ttft_s=slo_ttft_s,
            slo_latency_s=slo_latency_s, deadline_s=deadline_s,
            rng_request_id=(None if rng_request_id is None
                            else int(rng_request_id)),
            rng_tokens_emitted=int(rng_tokens_emitted), adapter=adapter,
            speculative=None if speculative is None else bool(speculative))
        if self.scheduler.cache_aware:
            # the grouping key: the prompt's first block-boundary digest,
            # seeded by the adapter's tag (another tenant's KV is other
            # content)
            req.prefix_group = prefix_digests(
                prompt, self.prefix_cache.block_tokens,
                adapter=self._adapter_tag(adapter))[-1][1]
        if on_tokens is not None:
            self._stream_cb[rid] = on_tokens
        self.scheduler.push(req)
        self._g_qdepth.set(len(self.scheduler))
        obs.tracer.event("serving.request.queued", request=rid,
                         prompt_len=len(prompt),
                         max_new_tokens=int(max_new_tokens))
        return rid

    def estimated_queue_delay_s(self) -> float:
        """The backpressure signal: how long a new submit would likely
        wait for a slot, (queued ahead / slots) admission waves at the
        mean request latency observed so far. 0.0 until a request has
        finished or while the queue is empty."""
        lat = self._h["latency_s"]
        if not lat.count or not len(self.scheduler):
            return 0.0
        return len(self.scheduler) / self.num_slots * lat.mean

    # -- the serving loop --------------------------------------------------
    @torch.inference_mode()
    def step(self) -> List[Tuple[int, Any]]:
        """One iteration: shed and freeze expired deadlines, admit into
        free slots, run ONE chunk dispatch, harvest finished rows. Returns
        ``[(request_id, result), ...]`` finished this step (also
        retrievable via ``result(id)``); a request shed for an expired
        deadline finishes as a typed ``DeadlineExceededError`` value. A
        staged adapter swap applies first, once no in-flight row pins a
        revision it changes. With ``snapshot_every_chunks`` the step ends
        with a snapshot when the cadence is due."""
        now = time.monotonic()
        store = self.adapter_store
        if (store is not None and store.version != self._b.lora_version
                and self._swap_blocker() is None):
            self.apply_adapter_swap()
        pre = self._enforce_deadlines(now)
        self._h["queue_depth"].observe(len(self.scheduler))
        admitted = self.scheduler.admissions()
        reordered = self.scheduler.cache_reordered - self._count("reordered")
        if reordered > 0:
            self._c["reordered"].inc(reordered)
        if admitted:
            self._admit_all(admitted, now)
        self._g_qdepth.set(len(self.scheduler))
        occupied = self.scheduler.slots.occupied()
        if not occupied:
            return pre
        self._h["occupancy"].observe(len(occupied) / self.num_slots)
        toks = self._dispatch_chunk(occupied)
        nv = self._last_nv
        t_chunk_done = time.monotonic()
        # finite guard: a row whose logits went NaN/Inf is frozen alone
        # and returned partial; its poison never reaches a neighbour
        row_finite = torch.isfinite(self.state.logits).all(-1).cpu().numpy()
        sr = sa = None
        if self._spec_active:
            # the carry's per-row cumulative counts (reset at admission)
            sr = self.state.spec_rounds.cpu().numpy()
            sa = self.state.spec_accepted.cpu().numpy()
        finished, freed = [], []
        for i, slot in occupied:
            slot.chunks += 1
            req = slot.request
            if not row_finite[i]:
                # the chunk that surfaced the corruption is dropped
                seq = (np.concatenate(slot.tokens) if slot.tokens
                       else np.zeros((0,), np.int64))[:req.max_new_tokens]
                self._c["corrupt_rows"].inc()
                obs.record_crash(
                    "serving.corrupt_row",
                    error=FloatingPointError(
                        f"non-finite logits in carry row {i} (request "
                        f"{req.id}) after chunk {slot.chunks}"),
                    extra={"request": int(req.id), "slot": int(i),
                           "chunks": int(slot.chunks),
                           "tokens_kept": int(seq.shape[0])})
                res = self._finish(slot, seq, i, corrupt_row=True)
            else:
                slot.tokens.append(toks[i] if nv is None
                                   else toks[i][:int(nv[i])])
                if sr is not None:
                    self._spec_harvest(slot, i, sr, sa, nv)
                if slot.first_token_at is None:
                    slot.first_token_at = t_chunk_done
                    self._h["ttft_s"].observe(
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
                    cb = self._stream_cb.get(req.id)
                    if cb is not None and len(seq) > slot.streamed:
                        # the flush cadence is the chunk harvest; _finish
                        # fires the final flush
                        if slot.streamed == 0:
                            self._stream_ttft_hist(req.latency_class)\
                                .observe(t_chunk_done - slot.admitted_at)
                        new = seq[slot.streamed:]
                        slot.streamed = int(len(seq))
                        cb(req.id, np.asarray(new), False)
                    continue
                res = self._finish(slot, seq, i)
            self._results[req.id] = res
            finished.append((req.id, res))
            self._unpin(slot)
            self.scheduler.slots.release(i)
            freed.append(i)
        if sr is not None:
            self._spec_adapt()
        if freed:
            self._freeze_rows(freed)
        if self._snap_every and (self.chunk_dispatches
                                 - self._snap_last_chunks
                                 >= self._snap_every):
            # at the end of the step the carry and the host token
            # buffers agree: every chunk's tokens are in slot.tokens
            self.snapshot(self._snap_dir)
        return pre + finished

    def _unpin(self, slot) -> None:
        """The request's slab outlived its flight: unpinned, it becomes
        evictable again."""
        if slot.pinned_slab is not None:
            self.prefix_cache.unpin(slot.pinned_slab)
            slot.pinned_slab = None

    def _spec_harvest(self, slot, i: int, sr, sa, nv) -> None:
        """Mirror row ``i``'s cumulative speculative counts into its slot
        and the engine totals, and count its tokens past the chunk
        boundary."""
        dr = int(sr[i]) - slot.spec_rounds
        da = int(sa[i]) - slot.spec_accepted
        if dr > 0:
            self._c["spec_rounds"].inc(dr)
            slot.spec_rounds = int(sr[i])
        if da > 0:
            self._c["spec_accepted"].inc(da)
            slot.spec_accepted = int(sa[i])
        ov = int(nv[i]) - self.chunk_size
        if ov > 0:
            slot.spec_overflow += ov
            self._c["spec_overflow"].inc(ov)

    def _spec_adapt(self) -> None:
        """Update the acceptance mean and, with ``adaptive_k``, the next
        chunk's K from its moving average (clamped to [1, K])."""
        rt = self._count("spec_rounds")
        if not rt:
            return
        mean = self._count("spec_accepted") / rt
        self._g_spec_accept_mean.set(mean)
        if self.adaptive_k:
            e = self._accept_ewma
            self._accept_ewma = mean if e is None else 0.8 * e + 0.2 * mean
            self._k_now = max(1, min(self._b.K,
                                     int(np.ceil(self._accept_ewma)) + 1))
            self._g_k_now.set(self._k_now)

    def _freeze_rows(self, rows: Sequence[int]) -> None:
        """Freeze carry rows until re-admission (freed slots, expired
        deadlines, rows migrated out): they keep riding the batched chunk,
        pinned to their eos fill, and their output is discarded."""
        self.state.done[torch.as_tensor(list(rows),
                                        device=self.state.done.device)] = True

    def _enforce_deadlines(self, now: float) -> List[Tuple[int, Any]]:
        """The deadline sweep at the top of every step: (a) queued
        requests whose deadline passed are shed as typed errors before
        they cost a prefill; (b) in-flight rows past their deadline are
        frozen like eos and finished partial, flagged
        ``deadline_expired``, and their slots free for this step's
        admission. Returns the ``(request_id, outcome)`` pairs resolved
        here."""
        out: List[Tuple[int, Any]] = []
        for req in self.scheduler.shed_expired(now):
            self._c["shed_queue_deadline"].inc()
            err = DeadlineExceededError(
                f"request {req.id} deadline expired after "
                f"{now - req.submit_time:.4f}s in queue "
                f"(budget {req.deadline_s:.4f}s); shed at admission",
                request_id=req.id)
            self._results[req.id] = err
            out.append((req.id, err))
            cb = self._stream_cb.pop(req.id, None)
            if cb is not None:
                # a shed streaming request still terminates its stream
                cb(req.id, np.zeros((0,), np.int64), True)
        frozen = []
        for i, slot in self.scheduler.slots.occupied():
            req = slot.request
            if req.deadline_at is None or now <= req.deadline_at:
                continue
            seq = (np.concatenate(slot.tokens) if slot.tokens
                   else np.zeros((0,), np.int64))[:req.max_new_tokens]
            self._c["deadline_expired_rows"].inc()
            res = self._finish(slot, seq, i, deadline_expired=True)
            self._results[req.id] = res
            out.append((req.id, res))
            self._unpin(slot)
            self.scheduler.slots.release(i)
            frozen.append(i)
        if frozen:
            self._freeze_rows(frozen)
        return out

    def drain(self, max_steps: Optional[int] = None,
              deadline_s: Optional[float] = None,
              snapshot_path: Optional[str] = None) -> Dict[int, Any]:
        """Step until the queue and every slot are empty; returns
        ``{request_id: outcome}`` for everything finished while draining
        (results, or typed deadline errors).

        ``deadline_s`` is the graceful drain's budget: when it runs out
        with work left, the engine snapshots to ``snapshot_path`` (or its
        ``snapshot_dir``) instead of discarding accepted work and returns
        what finished; ``restore()`` on a fresh engine resumes the rest.
        With no destination it raises ``ValueError`` before any work."""
        if deadline_s is not None and not (snapshot_path
                                           or self._snap_dir):
            raise ValueError(
                "drain(deadline_s=) needs snapshot_path or an engine "
                "snapshot_dir: a graceful drain SNAPSHOTS unfinished "
                "work, it never discards it")
        t0 = time.monotonic()
        out: Dict[int, Any] = {}
        steps = 0
        while len(self.scheduler) or self.scheduler.slots.occupied():
            if deadline_s is not None \
                    and time.monotonic() - t0 > deadline_s:
                self.snapshot(snapshot_path or self._snap_dir)
                break
            for rid, res in self.step():
                out[rid] = res
            steps += 1
            if max_steps is not None and steps > max_steps:
                raise RuntimeError(
                    f"drain did not converge within {max_steps} steps")
        return out

    def result(self, request_id: int):
        return self._results.get(request_id)

    # -- crash recovery: snapshot / restore --------------------------------
    _SNAP_DATA = "state.npz"
    _SNAP_MANIFEST = "manifest.json"

    def _refuse_moves(self, what: str) -> None:
        """The refusals snapshot and migration share: a draft model's
        carry is not in the payload, and staged ring rows are not in the
        carry yet."""
        if self._spec_configured:
            raise ValueError(
                f"speculative serving does not {what} yet: the draft "
                f"cache / pending-token carry is not in the payload; "
                f"serve without draft_model= to {what}")
        if any(m is not None for m in self._ring_meta):
            raise RuntimeError(
                f"{what} with staged-but-unscattered admission ring rows: "
                f"run one more step() so the pending ring splice lands in "
                f"the carry, then {what} at the chunk boundary")

    def _check_payload(self, meta: dict, what: str) -> None:
        """The quant recipe and mesh a payload recorded must be this
        engine's (the port serves no mesh: ``mesh_axes`` is None)."""
        if meta.get("quant") != self._b.quant:
            raise QuantMismatchError(
                f"{what} carries quant recipe "
                f"{meta.get('quant') or 'none'!r} but this engine's "
                f"backend serves {self._b.quant or 'none'!r}")
        if meta.get("mesh_axes") is not None:
            raise MeshMismatchError(
                f"{what} recorded mesh {meta.get('mesh_axes')} but this "
                f"engine serves None")

    @torch.inference_mode()
    def snapshot(self, path: str) -> str:
        """Write everything needed to resume this engine's accepted work
        into directory ``path``: the carry's B slot rows (never the
        ring's dump row) as the JAX engine's leaves — ``logits``, the
        ``kc`` and ``vc`` leaves (a quantized cache's ``q`` then ``s``),
        ``pos``, ``keys``, ``done``, ``eos``, ``temp``, in the JAX
        carry's dtypes, bf16 as tagged ``uint16`` bits — plus each slot's
        request and tokens so far and the queued requests, each deadline
        as its remaining budget. One ``state.npz`` under a
        ``manifest.json`` with its sha256, both written atomically (data
        first), so a torn or flipped file is refused at restore. The
        meta's ``steps_done`` is this engine's count of decode steps (the
        JAX carry's ``DecodeState.steps_done``). Taken between steps,
        where the carry and the host token buffers agree, so a restored
        greedy row continues exactly. A draft-model engine raises
        ``ValueError``, staged ring rows ``RuntimeError``."""
        self._refuse_moves("snapshot")
        os.makedirs(path, exist_ok=True)
        arrays: Dict[str, np.ndarray] = {}
        leaf_meta = []
        for i, (field, leaf) in enumerate(_carry_leaves(self.state)):
            arrays[f"leaf_{i}"], tag = _to_wire(field, leaf)
            leaf_meta.append({"dtype": tag})
        now = time.monotonic()
        slots_meta = [self._pack_slot(arrays, "slot", i, slot, now)
                      for i, slot in self.scheduler.slots.occupied()]
        queue_meta = []
        for j, req in enumerate(self.scheduler.queued()):
            arrays[f"queue{j}_prompt"] = np.asarray(req.prompt)
            queue_meta.append(self._req_meta(req, now))
        meta = {
            "kind": _SNAP_KIND, "version": 1, "time_unix": time.time(),
            "num_slots": self.num_slots, "chunk_size": self.chunk_size,
            "quant": self._b.quant, "mesh_axes": None,
            "steps_done": int(self._steps_done), "next_id": self._next_id,
            "leaves": leaf_meta, "slots": slots_meta, "queue": queue_meta,
        }
        buf = io.BytesIO()
        np.savez(buf, **arrays)
        payload = buf.getvalue()
        manifest = {"kind": meta["kind"], "data": self._SNAP_DATA,
                    "sha256": hashlib.sha256(payload).hexdigest(),
                    "bytes": len(payload), "meta": meta}
        # data first, manifest second: a crash between the two leaves a
        # digest mismatch, refused at restore
        atomic_write_bytes(os.path.join(path, self._SNAP_DATA), payload)
        atomic_write_bytes(os.path.join(path, self._SNAP_MANIFEST),
                           json.dumps(manifest, indent=1).encode())
        self._c["snapshots"].inc()
        self._snap_last_chunks = self.chunk_dispatches
        self._last_snapshot = (time.monotonic(), path)
        return path

    @torch.inference_mode()
    def restore(self, path: str) -> Dict[str, int]:
        """Resume a :meth:`snapshot` (of either package) on a fresh engine
        over a same-shape backend. Refused typed, before anything is
        written: an unreadable manifest, missing data, a sha256 mismatch
        or a carry layout that does not fit (``CorruptCheckpointError``);
        a snapshot with more slots (``ValueError``); an engine that has
        taken submissions (``RuntimeError``); another quant recipe
        (``QuantMismatchError``) or a mesh (``MeshMismatchError``). Every
        leaf is copied into the engine's existing carry in place. A
        snapshot with fewer slots lands in rows ``[0:snap_slots]``, and
        the other rows stay free. Each restored row's adapter index comes
        from its request's adapter name. Returns ``{"in_flight",
        "queued", "remapped_rows"}`` (``remapped_rows`` 0 on an
        exact-shape restore)."""
        if self._spec_configured:
            raise ValueError(
                "speculative serving does not snapshot yet: restore into "
                "an engine built without draft_model=")
        if self._next_id or len(self.scheduler) \
                or self.scheduler.slots.occupied():
            raise RuntimeError(
                "restore() needs a fresh engine (no submissions yet): "
                "build a new ServingEngine over the same backend shape "
                "and restore into that")
        mpath = os.path.join(path, self._SNAP_MANIFEST)
        dpath = os.path.join(path, self._SNAP_DATA)
        try:
            with open(mpath) as f:
                manifest = json.load(f)
        except (OSError, ValueError) as e:
            raise CorruptCheckpointError(
                f"snapshot manifest unreadable at {mpath}: {e}") from e
        try:
            with open(dpath, "rb") as f:
                raw = f.read()
        except OSError as e:
            raise CorruptCheckpointError(
                f"snapshot data missing at {dpath}: {e}") from e
        got = hashlib.sha256(raw).hexdigest()
        want = manifest.get("sha256", "")
        if got != want:
            raise CorruptCheckpointError(
                f"snapshot data is corrupt: sha256 {got[:16]}… != "
                f"manifest {want[:16]}… — refusing to resume from a "
                f"torn/corrupt snapshot")
        meta = manifest["meta"]
        snap_slots = int(meta["num_slots"])
        if snap_slots > self.num_slots:
            raise ValueError(
                f"snapshot was taken with num_slots={snap_slots}, this "
                f"engine has only {self.num_slots}; a snapshot restores "
                f"1:1 or INTO a larger batch (row-remapping), never a "
                f"smaller one")
        self._check_payload(meta, "snapshot")
        npz = np.load(io.BytesIO(raw), allow_pickle=False)
        targets = _carry_leaves(self.state)
        lm = meta["leaves"]
        if len(lm) != len(targets):
            raise CorruptCheckpointError(
                f"snapshot carry layout mismatch: {len(lm)} leaves "
                f"recorded, backend expects {len(targets)}")
        # check every leaf before the first copy: a refusal leaves the
        # carry as it was
        copies = []
        for i, ((field, tgt), m) in enumerate(zip(targets, lm)):
            arr = npz[f"leaf_{i}"]
            if m["dtype"] != _wire_tag(field, tgt):
                raise CorruptCheckpointError(
                    f"snapshot leaf {i} ({field}) has dtype {m['dtype']}, "
                    f"backend expects {_wire_tag(field, tgt)}")
            tshape = tuple(tgt.shape)
            if tuple(arr.shape) == tshape:
                copies.append((tgt, arr, m["dtype"]))
                continue
            # row remap: the only tolerated difference is the batch axis,
            # the snapshot's rows landing in [0:snap_slots]
            diff = ([ax for ax, (a, b) in enumerate(zip(arr.shape, tshape))
                     if a != b] if arr.ndim == tgt.dim() else [])
            if (snap_slots == self.num_slots or len(diff) != 1
                    or arr.shape[diff[0]] != snap_slots
                    or tshape[diff[0]] != self.num_slots):
                raise CorruptCheckpointError(
                    f"snapshot leaf {i} has shape {arr.shape}, backend "
                    f"expects {tshape} (snapshot rows {snap_slots}, "
                    f"engine rows {self.num_slots})")
            copies.append((tgt.narrow(diff[0], 0, snap_slots), arr,
                           m["dtype"]))
        for tgt, arr, tag in copies:
            tgt.copy_(_np_restore(arr, tag))
        self._steps_done = int(meta["steps_done"])
        now = time.monotonic()
        for sm in meta["slots"]:
            i = int(sm["slot"])
            self.scheduler.slots.entries[i] = slot = self._unpack_slot(
                npz, "slot", sm, now)
            self._route_adapter(i, slot.request)
        for j, qm in enumerate(meta["queue"]):
            self.scheduler.push(
                self._req_from_meta(qm, npz[f"queue{j}_prompt"], now))
        self._next_id = int(meta["next_id"])
        return {"in_flight": len(meta["slots"]),
                "queued": len(meta["queue"]),
                "remapped_rows": (snap_slots
                                  if snap_slots != self.num_slots else 0)}

    def _route_adapter(self, i: int, req: Request) -> None:
        """A restored or absorbed row's adapter routing, from its
        request's adapter name (bookkeeping, not payload): the carry's
        index into the stacks and the slot's pinned revision. An adapter
        the store does not know is ``UnknownAdapterError``."""
        st = self.state
        if st.adapter_idx is None:
            return
        st.adapter_idx[i] = self._adapter_index(req.adapter)
        if req.adapter is not None:
            self.scheduler.slots.entries[i].adapter_rev = \
                self.adapter_store.revision(req.adapter)

    @classmethod
    def _pack_slot(cls, arrays: Dict[str, np.ndarray], key: str, idx: int,
                   slot: Slot, now: float) -> dict:
        """One occupied slot into a snapshot (``key`` "slot") or migration
        payload (``key`` "row"): its prompt and token pieces as the arrays
        ``{key}{idx}_prompt`` / ``{key}{idx}_piece{j}``, its record as the
        returned meta. :meth:`_unpack_slot` is its inverse."""
        arrays[f"{key}{idx}_prompt"] = np.asarray(slot.request.prompt)
        for j, piece in enumerate(slot.tokens):
            arrays[f"{key}{idx}_piece{j}"] = np.asarray(piece, np.int32)
        return {key: idx, "request": cls._req_meta(slot.request, now),
                "pieces": len(slot.tokens), "chunks": slot.chunks}

    @classmethod
    def _unpack_slot(cls, npz, key: str, sm: dict, now: float) -> Slot:
        idx = int(sm[key])
        return Slot(
            request=cls._req_from_meta(sm["request"],
                                       npz[f"{key}{idx}_prompt"], now),
            admitted_at=now, chunks=int(sm["chunks"]),
            tokens=[np.asarray(npz[f"{key}{idx}_piece{j}"])
                    for j in range(int(sm["pieces"]))])

    @staticmethod
    def _req_meta(req: Request, now: float) -> dict:
        """The serialized request of :meth:`snapshot` and
        :meth:`extract_rows`, the JAX engine's record; a deadline crosses
        as its remaining budget (a monotonic clock does not survive a
        restart). :meth:`_req_from_meta` is its inverse."""
        return {
            "id": req.id, "max_new_tokens": req.max_new_tokens,
            "eos_token_id": req.eos_token_id,
            "temperature": req.temperature, "seed": req.seed,
            "priority": req.priority,
            "latency_class": req.latency_class,
            "slo_ttft_s": req.slo_ttft_s,
            "slo_latency_s": req.slo_latency_s,
            "deadline_remaining_s": (None if req.deadline_at is None
                                     else req.deadline_at - now),
            "rng_request_id": req.rng_request_id,
            "rng_tokens_emitted": req.rng_tokens_emitted,
            "adapter": req.adapter,
            "speculative": req.speculative,
        }

    @staticmethod
    def _req_from_meta(m: dict, prompt: np.ndarray, now: float) -> Request:
        # an already-negative remaining budget is shed on the first step
        rem = m.get("deadline_remaining_s")
        return Request(
            id=int(m["id"]), prompt=np.asarray(prompt),
            max_new_tokens=int(m["max_new_tokens"]),
            eos_token_id=m.get("eos_token_id"),
            temperature=float(m["temperature"]), seed=int(m["seed"]),
            priority=int(m["priority"]), submit_time=now,
            latency_class=m.get("latency_class", "default"),
            slo_ttft_s=m.get("slo_ttft_s"),
            slo_latency_s=m.get("slo_latency_s"),
            deadline_s=rem, deadline_at=None if rem is None else now + rem,
            rng_request_id=m.get("rng_request_id"),
            rng_tokens_emitted=int(m.get("rng_tokens_emitted") or 0),
            adapter=m.get("adapter"), speculative=m.get("speculative"))

    # -- replica plumbing --------------------------------------------------
    def export_inflight(self) -> List[Tuple[Request, np.ndarray, int]]:
        """``(request, tokens generated so far, chunk pieces)`` per
        occupied slot: the requeue payload of a dead replica (host
        bookkeeping only)."""
        out = []
        for _, slot in self.scheduler.slots.occupied():
            toks = (np.concatenate(slot.tokens) if slot.tokens
                    else np.zeros((0,), np.int64))
            out.append((slot.request, toks, len(slot.tokens)))
        return out

    def take_queued(self) -> List[Request]:
        """Pop every queued request (the requeue export of a dead
        replica)."""
        return self.scheduler.take_all()

    def clear_inflight(self) -> None:
        """Release every occupied slot (and unpin its prefix slab): the
        fence of a replica whose work was exported. Rows staged in the
        admission ring belong to those slots and go too (ROADMAP.md
        section 3, entry 31): left staged, they would hold the ring full
        after an unfence and no admission could ever land."""
        for i, slot in self.scheduler.slots.occupied():
            self._unpin(slot)
            self.scheduler.slots.release(i)
        if self._ring_slots:
            self._ring_meta = [None] * self._ring_slots

    @torch.inference_mode()
    def reset_state(self) -> None:
        """A fresh carry, every slot free: its caches are zeroed in place,
        so the ring keeps splicing into the carry the engine then serves
        and the chunk graphs keep their keys."""
        if self.scheduler.slots.occupied():
            raise RuntimeError(
                "reset_state with occupied slots would orphan in-flight "
                "requests; export/clear them first")
        self.state = self._b.new_state()
        self._steps_done = 0

    # -- live row migration ------------------------------------------------
    @torch.inference_mode()
    def extract_rows(self, request_ids) -> Dict[str, Any]:
        """Serialize the chosen requests into one migration payload, the
        row subset of :meth:`snapshot`. An in-flight request ships its
        carry rows (logits, the ``kc`` / ``vc`` leaves, pos, its live key,
        eos, temperature; gathered on the batch axis in the JAX carry's
        dtypes) and its tokens so far; a queued one its prompt and
        record. Ownership leaves with the payload: the source releases the
        slots (unpinning their slabs) and freezes the rows, and removes
        the queue entries. Ids neither in a slot nor queued are refused
        (``ValueError``) before anything is touched. Call it between
        steps. Returns ``{"kind", "meta", "data" (npz bytes),
        "sha256"}``."""
        self._refuse_moves("extract_rows")
        want = [int(i) for i in request_ids]
        by_slot = {int(s.request.id): (i, s)
                   for i, s in self.scheduler.slots.occupied()}
        queued_ids = {int(r.id) for r in self.scheduler.queued()}
        unknown = [i for i in want
                   if i not in by_slot and i not in queued_ids]
        if unknown:
            raise ValueError(
                f"extract_rows: request ids {unknown} are neither in a "
                f"slot nor queued on this engine (already finished, or "
                f"never submitted here)")
        inflight = [(rid,) + by_slot[rid] for rid in want if rid in by_slot]
        rows = [slot_idx for _, slot_idx, _ in inflight]
        arrays: Dict[str, np.ndarray] = {}
        leaf_meta: Dict[str, Any] = {"kc": [], "vc": []}
        if rows:
            st = self.state
            idx = torch.as_tensor(rows, device=st.logits.device)
            for name in ("kc", "vc"):
                for i, leaf in enumerate(_cache_leaves(getattr(st, name))):
                    arrays[f"{name}_leaf_{i}"], tag = _to_wire(
                        name, leaf.index_select(1, idx))
                    leaf_meta[name].append({"dtype": tag})
            for name in ("logits", "pos", "keys", "eos", "temp"):
                arrays[name], tag = _to_wire(
                    name, getattr(st, name).index_select(0, idx))
                leaf_meta[name] = {"dtype": tag}
        now = time.monotonic()
        slots_meta = [self._pack_slot(arrays, "row", j, slot, now)
                      for j, (_, _, slot) in enumerate(inflight)]
        queue_meta = []
        for j, req in enumerate(self.scheduler.remove(
                [rid for rid in want if rid not in by_slot])):
            arrays[f"queue{j}_prompt"] = np.asarray(req.prompt)
            queue_meta.append(self._req_meta(req, now))
        for _, slot_idx, slot in inflight:
            self._unpin(slot)
            self.scheduler.slots.release(slot_idx)
        if rows:
            self._freeze_rows(rows)
        meta = {
            "kind": _MIGRATION_KIND, "version": 1,
            "rows": len(inflight), "quant": self._b.quant,
            "mesh_axes": None, "leaves": leaf_meta, "slots": slots_meta,
            "queue": queue_meta,
        }
        buf = io.BytesIO()
        np.savez(buf, **arrays)
        payload = buf.getvalue()
        self._c["migrated_out"].inc(len(want))
        return {"kind": meta["kind"], "meta": meta, "data": payload,
                "sha256": hashlib.sha256(payload).hexdigest()}

    @torch.inference_mode()
    def absorb_rows(self, payload: Dict[str, Any]) -> Dict[int, int]:
        """The destination of a live migration: verify the payload's
        sha256 (``SlabTransferError``), its quant recipe
        (``QuantMismatchError``), mesh (``MeshMismatchError``) and cache
        layout, and that enough slots are free (``RuntimeError``), all
        before anything is written. Each shipped row is then copied into a
        free slot of the existing carry by the host row copy
        (``_DecoderBackend.scatter``) with its SHIPPED key, so a sampled
        stream continues where the source left it; this holds on the ring
        route and the prefix cache's. Its adapter index comes from the
        request's adapter name. Shipped queued requests join this queue.
        Every absorbed request gets a new id; returns ``{source id: new
        id}``."""
        if self._spec_configured:
            raise ValueError(
                "speculative serving does not migrate rows yet: absorb "
                "into an engine built without draft_model=")
        if payload.get("kind") != _MIGRATION_KIND:
            raise ValueError(
                f"absorb_rows: payload kind {payload.get('kind')!r} is "
                f"not a row-migration payload")
        raw = payload["data"]
        got = hashlib.sha256(raw).hexdigest()
        want = payload.get("sha256", "")
        if got != want:
            raise SlabTransferError(
                f"migration payload is corrupt: sha256 {got[:16]}… != "
                f"{want[:16]}… — refusing to scatter corrupt rows into "
                f"a live carry", key="row_migration")
        meta = payload["meta"]
        self._check_payload(meta, "migration payload")
        n = int(meta["rows"])
        free = self.scheduler.slots.free_slots()
        if len(free) < n:
            raise RuntimeError(
                f"absorb_rows needs {n} free slots, this engine has "
                f"{len(free)} — migrate to a less-loaded worker")
        npz = np.load(io.BytesIO(raw), allow_pickle=False)
        now = time.monotonic()
        mapping: Dict[int, int] = {}
        if n:
            lm = meta["leaves"]
            dev = self.state.logits.device

            def cache(name):
                tl = _cache_leaves(getattr(self.state, name))
                recorded = lm[name]
                if len(recorded) != len(tl):
                    raise SlabTransferError(
                        f"migration payload cache layout mismatch: "
                        f"{len(recorded)} {name} leaves recorded, backend "
                        f"expects {len(tl)}", key=name)
                got = [_np_restore(npz[f"{name}_leaf_{i}"], m["dtype"])
                       .to(dev) for i, m in enumerate(recorded)]
                for g, t in zip(got, tl):
                    if g.dtype != t.dtype or g.shape[2:] != t.shape[2:] \
                            or g.shape[0] != t.shape[0]:
                        raise SlabTransferError(
                            f"migration payload {name} leaf "
                            f"{tuple(g.shape)} {g.dtype} does not fit the "
                            f"carry's {tuple(t.shape)} {t.dtype}", key=name)
                return (dict(zip(("q", "s"), got)) if len(got) == 2
                        else got[0])

            kc1, vc1 = cache("kc"), cache("vc")
            logits1 = _np_restore(npz["logits"],
                                  lm["logits"]["dtype"]).to(dev)
            pos1, keys1, eos1, temp1 = (npz[k] for k in
                                        ("pos", "keys", "eos", "temp"))
            for sm in meta["slots"]:
                j = int(sm["row"])
                slot = self._unpack_slot(npz, "row", sm, now)
                req = slot.request
                old_id = int(req.id)
                req.id = self._next_id
                self._next_id += 1
                slot_idx = self.scheduler.slots.occupy(req)
                self.scheduler.slots.entries[slot_idx] = slot
                # the shipped key is the row's live stream state: no
                # re-derivation from the seed
                self._b.scatter(self.state, slot_idx, logits1, kc1, vc1, j,
                                int(pos1[j]), keys1[j], int(eos1[j]),
                                float(temp1[j]))
                self._route_adapter(slot_idx, req)
                mapping[old_id] = req.id
        for j, qm in enumerate(meta["queue"]):
            req = self._req_from_meta(qm, npz[f"queue{j}_prompt"], now)
            old_id = int(req.id)
            req.id = self._next_id
            self._next_id += 1
            self.scheduler.push(req)
            mapping[old_id] = req.id
        self._c["migrated_in"].inc(len(mapping))
        return mapping

    # -- disaggregated prefill (slab payloads) -----------------------------
    @torch.inference_mode()
    def prefill_extract(self, prompt) -> Dict[str, Any]:
        """Run ONE admission prefill for ``prompt`` outside the slot table
        and return its row state as a prefix-slab payload (CPU tensors,
        bf16 included: the bucketed K/V rows and the resume logits,
        tagged with the quant recipe). Counts on
        ``prefill_dispatches``."""
        prompt = np.asarray(prompt)
        if prompt.ndim == 2 and prompt.shape[0] == 1:
            prompt = prompt[0]
        if prompt.ndim != 1:
            raise ValueError(
                f"prefill_extract takes one (S,) prompt, got shape "
                f"{prompt.shape}")
        S = len(prompt)
        bucket = self.scheduler.bucket(S)
        ids = np.zeros((1, bucket), np.int64)
        ids[0, :S] = prompt
        logitsN, kcN, vcN = self._b.admit_prefill(ids, [S], [0])
        self._c["prefill"].inc()
        ops = self._slab_ops or SlabOps(None, self._b.head_major)
        skc, svc, slg = ops.extract(kcN, vcN, logitsN, 0, bucket)

        def host(t):
            if isinstance(t, dict):
                return {k: host(v) for k, v in t.items()}
            return t.cpu()

        return {"prompt": prompt, "bucket": int(bucket),
                "kc": host(skc), "vc": host(svc),
                "logits": host(slg), "quant": self._b.quant}

    def load_prefix_slab(self, payload: Dict[str, Any]):
        """Insert a ``prefill_extract`` payload into this engine's prefix
        cache: the next ``submit`` of the same prompt admits as a full
        hit. A quant-recipe mismatch is a ``QuantMismatchError``."""
        if self.prefix_cache is None:
            raise ValueError(
                "load_prefix_slab needs the prefix cache enabled: the "
                "shipped slab admits through the full-hit path")
        if payload.get("quant") != self._b.quant:
            raise QuantMismatchError(
                f"shipped slab carries quant recipe "
                f"{payload.get('quant') or 'none'!r} but this engine's "
                f"backend serves {self._b.quant or 'none'!r}")
        dev = self._b.device

        def put(t):
            if isinstance(t, dict):
                return {k: put(v) for k, v in t.items()}
            return torch.as_tensor(t, device=dev)

        return self.prefix_cache.insert(
            np.asarray(payload["prompt"]), put(payload["kc"]),
            put(payload["vc"]), put(payload["logits"]),
            int(payload["bucket"]))

    # -- admission ---------------------------------------------------------
    def _admit_all(self, admitted, now: float) -> None:
        """One admission round. Through the device ring when it is on
        (``_admit_all_ring``). Otherwise, per request, the prefix cache's
        verdict: a FULL hit is one host row copy of its slab (no prefill
        dispatch); the rest group by padded suffix bucket and prefill one
        dispatch a group with ``batch_admission`` (else one each), with
        each partial row's slab loaded under its suffix. While an adapter
        swap is pending, requests naming an adapter whose revision the
        stacks do not serve yet go back to the head of their tier."""
        store = self.adapter_store
        if store is not None and store.version != self._b.lora_version:
            keep = []
            for slot_idx, req in admitted:
                if (req.adapter is not None
                        and self._served_rev.get(req.adapter)
                        != store.revision(req.adapter)):
                    self.scheduler.slots.release(slot_idx)
                    self.scheduler.push_front(req)
                else:
                    keep.append((slot_idx, req))
            admitted = keep
            if not admitted:
                return
        if self._ring_slots:
            self._admit_all_ring(admitted, now)
            return
        cache = self.prefix_cache
        plans = []
        for slot_idx, req in admitted:
            t0 = time.monotonic()
            S = len(req.prompt)
            hit = (cache.lookup(req.prompt,
                                allow_partial=self._b.admit_pos0,
                                adapter=self._adapter_tag(req.adapter))
                   if cache is not None else None)
            if hit is not None and hit.kind == "full":
                cache.pin(hit.slab)
                self._scatter(slot_idx, req, hit.slab.logits, hit.slab.kc,
                              hit.slab.vc, src=0, pos1=S)
                self._note_admit(slot_idx, req, now, t0, "full",
                                 tokens_saved=S, dispatches=0,
                                 slab=hit.slab, events=[])
                self._c["disp_saved"].inc()
                continue
            plans.append((slot_idx, req, hit))
        groups: Dict[int, list] = {}
        for slot_idx, req, hit in plans:
            cached = (hit.cached_len
                      if hit is not None and hit.kind == "partial" else 0)
            w = self.scheduler.bucket(len(req.prompt) - cached)
            groups.setdefault(w, []).append((slot_idx, req, hit, cached))
        for w, grp in sorted(groups.items()):
            if self.batch_admission and self._b.admit_batch_any \
                    and len(grp) > 1:
                self._admit_group(w, grp, now)
            else:
                for item in grp:
                    self._admit_group(w, [item], now)
        self._prefix_sync()

    def _admit_all_ring(self, admitted, now: float) -> None:
        """One ring admission round: a free ring row per admitted request
        and one ring-staged prefill dispatch per bucket group (one per
        request without ``batch_admission``). Admissions beyond the
        ring's free rows are un-admitted (slot released, request
        re-queued at its tier's head with its submit time, ``ring_full``)
        and retry next step, once the chunk has drained the ring."""
        free = collections.deque(
            r for r, m in enumerate(self._ring_meta) if m is None)
        if len(admitted) > len(free):
            admitted, spill = admitted[:len(free)], admitted[len(free):]
            for slot_idx, req in reversed(spill):
                self.scheduler.slots.release(slot_idx)
                self.scheduler.push_front(req)
                self._c["ring_full"].inc()
            self._g_qdepth.set(len(self.scheduler))
        groups: Dict[int, list] = {}
        for slot_idx, req in admitted:
            w = self.scheduler.bucket(len(req.prompt))
            groups.setdefault(w, []).append((slot_idx, req))
        for w, grp in sorted(groups.items()):
            if self.batch_admission and len(grp) > 1:
                self._admit_group_ring(w, grp, free, now)
            else:
                for item in grp:
                    self._admit_group_ring(w, [item], free, now)

    def _admit_group_ring(self, w: int, grp, free, now: float) -> None:
        """ONE ring-staged admission-prefill dispatch for the group (and
        one draft-cache staging dispatch under speculation): the
        prefilled rows land in device ring rows, with the splice metadata
        the next chunk reads recorded on the host."""
        t0 = time.monotonic()
        N = len(grp)
        ids = np.zeros((N, w), np.int64)
        true_len = np.zeros((N,), np.int64)
        rows = [free.popleft() for _ in range(N)]
        for j, (_, req) in enumerate(grp):
            ids[j, :len(req.prompt)] = req.prompt
            true_len[j] = len(req.prompt)
        aidx = self._group_aidx(grp)
        ev0 = self._b.event_count()
        self._b.ring_admit(ids, true_len, np.zeros((N,), np.int64), rows,
                           aidx)
        self._c["prefill"].inc()
        if self._spec_active:
            self._b.ring_admit_draft(ids, rows)
            self._c["draft_prefill"].inc()
        events = self._b.events_since(ev0)
        if N > 1:
            self._c["batched_groups"].inc()
            self._c["disp_saved"].inc(N - 1)
        for j, (slot_idx, req) in enumerate(grp):
            # the splice metadata, under ``AdmissionRing.load``'s names
            self._ring_meta[rows[j]] = {
                "slot": slot_idx, "pos": len(req.prompt),
                "keys": self._row_key(req),
                "eos": (-1 if req.eos_token_id is None
                        else req.eos_token_id),
                "temp": req.temperature,
                "aidx": 0 if aidx is None else int(aidx[j]),
                "son": (req.speculative if req.speculative is not None
                        else True)}
            self._c["ring_staged"].inc()
            self._note_admit(slot_idx, req, now, t0, "miss",
                             tokens_saved=0, dispatches=int(j == 0),
                             slab=None, events=events)

    def _group_aidx(self, grp) -> Optional[np.ndarray]:
        """The adapter indices of an admission group's requests (each
        item's second entry), or None without a store."""
        if self.adapter_store is None:
            return None
        return np.asarray([self._adapter_index(item[1].adapter)
                           for item in grp], np.int64)

    def _ring_args(self) -> Tuple[dict, int]:
        """The chunk's splice metadata per ring row (slot -1 = empty,
        resume pos, key, eos, temperature; the speculative switch under
        speculation, the adapter index with a store), as
        ``AdmissionRing.load``'s keywords, and the staged count."""
        R = self._ring_slots
        out = dict(slot=np.full((R,), -1, np.int64),
                   pos=np.zeros((R,), np.int64),
                   keys=np.zeros((R, 2), np.uint32),
                   eos=np.full((R,), -1, np.int64),
                   temp=np.ones((R,), np.float32))
        if self._spec_configured:
            out["son"] = np.ones((R,), np.bool_)
        if self.adapter_store is not None:
            out["aidx"] = np.zeros((R,), np.int64)
        n = 0
        for r, m in enumerate(self._ring_meta):
            if m is None:
                continue
            for k, a in out.items():
                a[r] = m[k]
            n += 1
        return out, n

    def _ring_drained(self, n: Optional[int]) -> None:
        """The chunk spliced the staged rows in: clear the metadata and
        count them."""
        if n:
            self._ring_meta = [None] * self._ring_slots
            self._c["ring_scattered"].inc(n)

    def _admit_group(self, w: int, grp, now: float) -> None:
        """ONE admission-prefill dispatch for the group: batch-N padded
        suffix ids, per-row true lengths and cache offsets, each partial
        row's slab loaded into the prefill's caches; then one host row
        copy per admitted request and, for a prompt whose full entry is
        not cached, one slab extraction."""
        cache, ops = self.prefix_cache, self._slab_ops
        t0 = time.monotonic()
        N = len(grp)
        ids = np.zeros((N, w), np.int64)
        true_len = np.zeros((N,), np.int64)
        pos0 = np.zeros((N,), np.int64)
        loads = []
        for j, (slot_idx, req, hit, cached) in enumerate(grp):
            suffix = np.asarray(req.prompt)[cached:]
            ids[j, :len(suffix)] = suffix
            true_len[j] = len(suffix)
            pos0[j] = cached
            if cached:
                cache.pin(hit.slab)
                loads.append((j, hit.slab))

        def prepare(kc, vc):
            for j, slab in loads:
                ops.load(kc, vc, slab.kc, slab.vc, j)

        ev0 = self._b.event_count()
        logitsN, kcN, vcN = self._b.admit_prefill(
            ids, true_len, pos0, prepare if loads else None,
            self._group_aidx(grp))
        events = self._b.events_since(ev0)
        self._c["prefill"].inc()
        if N > 1:
            self._c["batched_groups"].inc()
            self._c["disp_saved"].inc(N - 1)
        for j, (slot_idx, req, hit, cached) in enumerate(grp):
            S = len(req.prompt)
            self._scatter(slot_idx, req, logitsN, kcN, vcN, src=j, pos1=S)
            if cache is not None:
                digests = hit.digests if hit is not None else None
                if digests is None or not cache.contains_full(digests):
                    bucket = self.scheduler.bucket(S)
                    skc, svc, slg = ops.extract(kcN, vcN, logitsN, j,
                                                bucket)
                    cache.insert(req.prompt, skc, svc, slg, bucket,
                                 digests=digests,
                                 adapter=self._adapter_tag(req.adapter))
            self._note_admit(slot_idx, req, now, t0,
                             "partial" if cached else "miss",
                             tokens_saved=cached, dispatches=int(j == 0),
                             slab=hit.slab if cached else None,
                             events=events)

    def _scatter(self, slot_idx: int, req: Request, logits1, kc1, vc1,
                 src: int, pos1: int) -> None:
        """The host-scatter admission: row ``src`` of the given row state
        lands in carry row ``slot_idx`` with the request's key
        (``split(PRNGKey(seed), 1)[0]``, as the ring gives it), eos,
        temperature and adapter index. A full hit's whole admission is one
        of these."""
        self._c["host_scattered"].inc()
        self._b.scatter(self.state, slot_idx, logits1, kc1, vc1, src, pos1,
                        self._row_key(req),
                        -1 if req.eos_token_id is None
                        else req.eos_token_id, req.temperature,
                        self._adapter_index(req.adapter))

    def _note_admit(self, slot_idx: int, req: Request, now: float,
                    t0: float, cls: str, tokens_saved: int,
                    dispatches: int, slab, events) -> None:
        slot = self.scheduler.slots.entries[slot_idx]
        slot.admitted_at = now
        slot.events.extend(events)
        if self.adapter_store is not None:
            slot.adapter_rev = (None if req.adapter is None
                                else self.adapter_store.revision(req.adapter))
            self._adapter_row_counter(req.adapter or "base").inc()
        enabled = self.prefix_cache is not None
        slot.prefix_hit = cls if enabled else None
        slot.prefill_tokens_saved = int(tokens_saved)
        slot.admission_dispatches = int(dispatches)
        slot.pinned_slab = slab
        self._h[f"admission_s.{cls}"].observe(time.monotonic() - t0)
        if enabled:
            self._c[f"prefix_{cls}"].inc()
            if tokens_saved:
                self._c["tokens_saved"].inc(int(tokens_saved))
        self._h["queue_delay_s"].observe(now - req.submit_time)
        obs.tracer.event("serving.request.admitted", request=req.id,
                         slot=slot_idx,
                         queue_delay_s=round(now - req.submit_time, 6),
                         prefix_hit=slot.prefix_hit,
                         prefill_tokens_saved=int(tokens_saved))

    def _prefix_sync(self) -> None:
        """Mirror the cache's pool numbers into the registry: the gauges
        absolute, insertions and evictions by delta (a shared cache's
        events land once per engine observation)."""
        cache = self.prefix_cache
        if cache is None:
            return
        st = cache.stats()
        self._g_prefix_bytes.set(st["bytes_cached"])
        self._g_prefix_slabs.set(st["slabs"])
        last = self._last_prefix_stats
        for key, short in (("insertions", "prefix_insert"),
                           ("evictions", "prefix_evict")):
            if st[key] > last[key]:
                self._c[short].inc(st[key] - last[key])
                last[key] = st[key]

    def _dispatch_chunk(self, occupied) -> np.ndarray:
        """One chunk on the serving ladder (the JAX engine's): a
        speculative chunk that fails transiently (past its retries)
        demotes the carry once to the plain chunk (``spec_demote``); a
        plain chunk that fails transiently degrades to the per-token
        rung, T one-step dispatches on the same carry (the failed chunk's
        fault fired before it touched the carry), the pending ring splice
        on the first step only. A fatal error, auto-degrade off, or a
        rung that dies partway harvest what the host tokens already
        finish (``_harvest_before_raise``) and raise; a rung's completed
        steps keep their tokens."""
        self._last_nv = None
        splice, n_staged = (self._ring_args() if self._ring_slots
                            else (None, None))
        degr: list = []
        ev0 = self._b.event_count()
        if self._spec_active:
            try:
                if self.replica_tag:
                    fault_injector.on_call(
                        f"serving.{self.replica_tag}.chunk")
                toks, nv, self.state = self._b.decode_chunk_spec(
                    self.state, self.chunk_size, splice, K=self._k_now)
                self._chunk_done(n_staged)
                self._last_nv = nv.cpu().numpy()
                self._note_events(occupied, ev0, [])
                return toks.cpu().numpy()
            except Exception as e:
                if classify_error(e) != "transient":
                    self._harvest_before_raise(e, "serving.chunk_fatal")
                    raise
                if not flags.resilience_auto_degrade:
                    err = DecodeFailedError(
                        f"serving speculative chunk dispatch failed with "
                        f"auto-degrade off: {str(e)[:300]}",
                        events=self._b.events_since(ev0), last_error=e)
                    self._harvest_before_raise(
                        e, "serving.chunk_failed_no_rung")
                    raise err from e
                # one-way: the pending tokens are committed, the draft
                # carry dropped, and the plain ring chunk below serves the
                # same state; admissions stop staging draft caches
                ev = DegradationEvent(
                    site="serve.chunk", from_level="speculative",
                    to_level="chunked", error_class=type(e).__name__,
                    error=str(e)[:300])
                record_event(ev)
                self._c["degradations"].inc()
                degr.append(ev)
                self.state = self._b.spec_demote(self.state)
                self._spec_active = False
        try:
            if self.replica_tag:
                # the replica's own fault site: a plan aimed at
                # "serving.<tag>.chunk" kills or hangs this replica while
                # its peers keep serving
                fault_injector.on_call(f"serving.{self.replica_tag}.chunk")
            if splice is not None:
                toks, self.state = self._b.decode_chunk_ring(
                    self.state, self.chunk_size, splice)
            else:
                toks, self.state = self._b.decode_chunk(self.state,
                                                        self.chunk_size)
            self._chunk_done(n_staged)
            self._note_events(occupied, ev0, degr)
            return toks.cpu().numpy()
        except Exception as e:
            if classify_error(e) != "transient":
                self._harvest_before_raise(e, "serving.chunk_fatal")
                raise
            if (not flags.resilience_auto_degrade
                    or not self._b.has_step_rung()):
                err = DecodeFailedError(
                    f"serving chunk dispatch failed with no per-token "
                    f"rung available: {str(e)[:300]}",
                    events=self._b.events_since(ev0) + degr, last_error=e)
                self._harvest_before_raise(
                    e, "serving.chunk_failed_no_rung")
                raise err from e
            ev = DegradationEvent(
                site="serve.chunk", from_level="chunked",
                to_level="per_token", error_class=type(e).__name__,
                error=str(e)[:300])
            record_event(ev)
            self._c["degradations"].inc()
            degr.append(ev)
        parts = []
        try:
            for s in range(self.chunk_size):
                if self.replica_tag:
                    fault_injector.on_call(
                        f"serving.{self.replica_tag}.step")
                if splice is not None:
                    toks1, self.state = self._b.decode_step_ring(
                        self.state, splice)
                    if s == 0:
                        self._ring_drained(n_staged)
                        splice, _ = self._ring_args()   # now empty
                else:
                    toks1, self.state = self._b.decode_step(self.state)
                self._c["step"].inc()
                self._steps_done += 1
                parts.append(toks1.cpu().numpy())
        except Exception as e2:
            # the steps that ran advanced the carry: their tokens are
            # real, so they join the slots' buffers before the harvest
            if parts:
                cols = np.concatenate(parts, axis=1)
                for i, slot in occupied:
                    slot.tokens.append(cols[i])
                    slot.chunks += 1
            err = DecodeFailedError(
                f"serving per-token rung failed after the chunk rung "
                f"degraded: {str(e2)[:300]}",
                events=self._b.events_since(ev0) + degr, last_error=e2)
            self._harvest_before_raise(e2, "serving.ladder_exhausted")
            raise err from e2
        self._c["slot_steps"].inc(self.num_slots * self.chunk_size)
        self._note_events(occupied, ev0, degr)
        return np.concatenate(parts, axis=1)

    def _chunk_done(self, n_staged: Optional[int]) -> None:
        """A chunk dispatch ran: count it and its slot-steps, and clear
        the ring rows it spliced in."""
        self._c["chunk"].inc()
        self._steps_done += self.chunk_size
        self._c["slot_steps"].inc(self.num_slots * self.chunk_size)
        self._ring_drained(n_staged)

    def _harvest_before_raise(self, error: BaseException,
                              reason: str) -> None:
        """The last act before a chunk error propagates: rows whose host
        tokens already finish them (eos seen, or the budget met by a
        rung's completed steps) are harvested bit-exact into
        ``_results``, their prefix slabs unpinned, their slots freed and
        their carry rows frozen (best effort: the device may be what
        failed); the unfinished requests go into the flight recorder's
        postmortem (``lost_requests``: id and tokens so far), so a crash
        dump accounts for every accepted request."""
        harvested, lost = [], []
        for i, slot in self.scheduler.slots.occupied():
            req = slot.request
            seq = (np.concatenate(slot.tokens) if slot.tokens
                   else np.zeros((0,), np.int64))
            fin = False
            if req.eos_token_id is not None and seq.size:
                hit = seq == req.eos_token_id
                if hit.any():
                    seq = seq[:int(np.argmax(hit)) + 1]
                    fin = True
            if len(seq) >= req.max_new_tokens:
                seq = seq[:req.max_new_tokens]
                fin = True
            if fin:
                self._results[req.id] = self._finish(slot, seq, i)
                harvested.append(req.id)
                self._unpin(slot)
                self.scheduler.slots.release(i)
                try:
                    self._freeze_rows([i])
                except Exception:
                    pass
            else:
                lost.append({"request": req.id,
                             "prompt_len": int(len(req.prompt)),
                             "tokens_generated": int(seq.size),
                             "max_new_tokens": req.max_new_tokens,
                             "chunks": slot.chunks})
        obs.record_crash(
            reason, error=error,
            extra={"site": "serve.chunk", "replica": self.replica_tag,
                   "harvested_requests": harvested,
                   "lost_requests": lost})

    def _note_events(self, occupied, ev0: int, degradations) -> None:
        """Give this dispatch's retry and degradation events to the rows
        that rode it, and only to those."""
        new = self._b.events_since(ev0) + list(degradations)
        for _, slot in occupied:
            slot.events.extend(new)

    def _finish(self, slot, seq: np.ndarray, slot_idx: int,
                deadline_expired: bool = False, corrupt_row: bool = False):
        req = slot.request
        fin = time.monotonic()
        latency = fin - req.submit_time
        self._h["latency_s"].observe(latency)
        self._c["done"].inc()
        ttft = (slot.first_token_at - slot.admitted_at
                if slot.first_token_at is not None else None)
        n_tok = int(seq.shape[0])
        tpot = None
        if slot.first_token_at is not None and n_tok > 1:
            tpot = max(0.0, fin - slot.first_token_at) / (n_tok - 1)
            self._h["tpot_s"].observe(tpot)
        slo = self._check_slo(req, ttft, latency)
        degr = [e for e in slot.events
                if getattr(e, "kind", "") == "degradation"]
        record = {
            "level": "per_token" if degr else "chunked",
            "requested_level": "chunked",
            "retries": sum(1 for e in slot.events
                           if getattr(e, "kind", "") == "retry"),
            "degradations": [e.as_dict() for e in degr],
            "events": [e.as_dict() for e in slot.events],
            "serving": {
                "queue_delay_s": slot.admitted_at - req.submit_time,
                "latency_s": latency, "ttft_s": ttft, "tpot_s": tpot,
                "chunks": slot.chunks, "slot": slot_idx,
                "latency_class": req.latency_class, "slo": slo,
                "prefix_hit": slot.prefix_hit,
                "prefill_tokens_saved": slot.prefill_tokens_saved,
                "admission_dispatches": slot.admission_dispatches,
                "deadline_expired": bool(deadline_expired),
                "corrupt_row": bool(corrupt_row),
                "speculative": None if not self._spec_configured else {
                    "rounds": int(slot.spec_rounds),
                    "accepted_drafts": int(slot.spec_accepted),
                    "acceptance_len_mean": (
                        slot.spec_accepted / slot.spec_rounds
                        if slot.spec_rounds else 0.0),
                    "num_speculative_tokens": int(self._b.K),
                    "overflow_tokens": int(slot.spec_overflow),
                },
            },
        }
        # the request's lifetime span (submit -> finished) on the axis of
        # the dispatch spans it contains
        obs.tracer.add_span(
            "serving.request", int(req.submit_time * 1e9),
            int(fin * 1e9), request=req.id, slot=slot_idx,
            chunks=slot.chunks, tokens=n_tok,
            queue_delay_s=round(record["serving"]["queue_delay_s"], 6),
            level=record["level"])
        obs.tracer.event("serving.request.finished", request=req.id,
                         latency_s=round(latency, 6))
        if req.adapter is not None:
            record["serving"]["adapter"] = req.adapter
            record["serving"]["adapter_rev"] = slot.adapter_rev
        cb = self._stream_cb.pop(req.id, None)
        if cb is not None:
            # the final flush: what the finish-side trims left beyond the
            # last chunk flush, with the final=True marker
            new = seq[slot.streamed:]
            if slot.streamed == 0 and len(new):
                self._stream_ttft_hist(req.latency_class).observe(
                    fin - slot.admitted_at)
            slot.streamed = int(len(seq))
            cb(req.id, np.asarray(new), True)
        out = np.concatenate([req.prompt,
                              seq.astype(req.prompt.dtype)])[None]
        return GenerateResult.wrap(out, record)

    def _check_slo(self, req: Request, ttft: Optional[float],
                   latency: float) -> Optional[dict]:
        """The request against its SLO targets (its own, else its
        class's): counts the class's requests and violations and returns
        the record's ``slo`` block (None when the class has no target). A
        request that produced no token has no TTFT, which violates a TTFT
        target."""
        cls = req.latency_class
        defaults = self.slo_targets.get(cls, {})
        t_ttft = (req.slo_ttft_s if req.slo_ttft_s is not None
                  else defaults.get("ttft_s"))
        t_lat = (req.slo_latency_s if req.slo_latency_s is not None
                 else defaults.get("latency_s"))
        if t_ttft is None and t_lat is None:
            return None
        r = self.registry
        key = f"serving.slo.{cls}."
        r.counter(key + "requests",
                  "requests finished in this latency class").inc()
        out = {"class": cls, "violated": False}
        if t_ttft is not None:
            out["ttft_target_s"] = t_ttft
            if ttft is None or ttft > t_ttft:
                out["violated"] = out["ttft_violated"] = True
                r.counter(key + "ttft_violations",
                          "TTFT above the class/request target").inc()
        if t_lat is not None:
            out["latency_target_s"] = t_lat
            if latency > t_lat:
                out["violated"] = out["latency_violated"] = True
                r.counter(key + "latency_violations",
                          "end-to-end latency above the class/request "
                          "target").inc()
        return out

    def slo_counters(self) -> Dict[str, int]:
        """The per-class SLO counters of ``registry``:
        ``serving.slo.<class>.requests``, ``.ttft_violations`` and
        ``.latency_violations`` (a name appears once it counts)."""
        return {n: int(self.registry.get(n).value)
                for n in self.registry.names() if n.startswith("serving.slo.")}

    # -- observability -----------------------------------------------------

    def _speculative(self, status: bool) -> Optional[Dict[str, Any]]:
        if not self._spec_configured:
            return None
        out = {
            "active": bool(self._spec_active),
            "num_speculative_tokens": int(self._b.K),
            "k_now": int(self._k_now),
            "adaptive_k": self.adaptive_k,
            "rounds": self._count("spec_rounds"),
            "accepted_drafts": self._count("spec_accepted"),
            "acceptance_len_mean": float(self._g_spec_accept_mean.value),
            "overflow_tokens": self._count("spec_overflow"),
        }
        if status:
            out["draft_prefill_dispatches"] = self._count("draft_prefill")
        return out

    def _ring(self, status: bool) -> Optional[Dict[str, Any]]:
        if not self._ring_slots:
            return None
        out = {"slots": self._ring_slots}
        if status:
            out["staged_now"] = sum(1 for m in self._ring_meta
                                    if m is not None)
        out.update(staged=self._count("ring_staged"),
                   scattered=self._count("ring_scattered"),
                   full=self._count("ring_full"),
                   host_scattered=self.host_scattered)
        return out

    def _adapter_rows(self) -> Dict[str, int]:
        return {name: int(c.value)
                for name, c in sorted(self._c_adapter_rows.items())}

    def status(self) -> Dict[str, Any]:
        """The live view with the JAX engine's keys: the slot table,
        queue depth, in-flight requests, occupancy, the ladder rung, the
        prefix cache's pool (``PrefixCache.snapshot``), the speculative
        rung and the ring. Keys of features not ported yet hold their off
        values."""
        slots = []
        for i, e in enumerate(self.scheduler.slots.entries):
            if e is None:
                slots.append({"slot": i, "state": "free"})
                continue
            slots.append({
                "slot": i, "state": "occupied",
                "request": e.request.id,
                "latency_class": e.request.latency_class,
                "prompt_len": int(len(e.request.prompt)),
                "max_new_tokens": e.request.max_new_tokens,
                "tokens_produced": int(sum(len(t) for t in e.tokens)),
                "chunks": e.chunks,
                "age_s": round(time.monotonic() - e.admitted_at, 4),
            })
        occupied = self.scheduler.slots.occupied()
        degraded = self._count("degradations")
        return {
            "num_slots": self.num_slots,
            "chunk_size": self.chunk_size,
            "quant": self._b.quant,
            "replica_tag": self.replica_tag,
            "mesh": None,
            "slots": slots,
            "occupancy_now": len(occupied) / self.num_slots,
            "queue_depth": len(self.scheduler),
            "in_flight": [s.request.id for _, s in occupied],
            "requests_submitted": self._next_id,
            "requests_completed": len(self._results),
            # any chunk degradation this lifetime means the per-token
            # rung has been exercised (each record names its own rung)
            "resilience": {
                "ladder_rung": "per_token" if degraded else "chunked",
                "degradations": degraded,
                "step_dispatches": self.step_dispatches},
            "slo_targets": self.slo_targets,
            "shed": {"deadline": self._count("shed_deadline"),
                     "backpressure": self._count("shed_backpressure"),
                     "queue_deadline": self._count("shed_queue_deadline"),
                     "expired_rows": self._count("deadline_expired_rows")},
            "snapshot": (None if self._last_snapshot is None else {
                "path": self._last_snapshot[1],
                "age_s": round(time.monotonic()
                               - self._last_snapshot[0], 4),
                "count": self._count("snapshots"),
                "every_chunks": self._snap_every or None,
            }),
            "prefix_cache": (None if self.prefix_cache is None
                             else self.prefix_cache.snapshot()),
            "speculative": self._speculative(status=True),
            "adapters": (None if self.adapter_store is None else {
                **self.adapter_store.describe(),
                "served_version": int(self._b.lora_version),
                "swap_pending": bool(self.adapter_store.version
                                     != self._b.lora_version),
                "rows_by_adapter": self._adapter_rows(),
            }),
            "admission_ring": self._ring(status=True),
        }

    def metrics(self) -> Dict[str, Any]:
        """Serving metrics with the JAX engine's keys, read from
        ``registry``: dispatch accounting (prefills, draft prefills,
        chunks, per-token rung steps, degradations), slot occupancy and
        the slot-steps denominator, queue-delay, latency, TTFT and TPOT
        statistics (percentiles over each histogram's newest 4096
        samples; NaN until the first sample), queue depth now, at its
        peak and on average at step starts, the admission economics
        (dispatches saved, cache reorderings, batched groups, prefill
        tokens saved, admission time by hit class), the prefix cache,
        speculation and the ring. Keys of features not ported yet hold
        their off values: None for absent subsystems, {} for per-class
        maps."""
        h, cache = self._h, self.prefix_cache
        self._g_qdepth.set(len(self.scheduler))

        def pct(k, q):
            return h[k].percentile(q)

        def mean(k):
            return h[k].mean if h[k].count else float("nan")

        return {
            "num_slots": self.num_slots,
            "chunk_size": self.chunk_size,
            "requests_submitted": self._next_id,
            "requests_completed": len(self._results),
            "queued": len(self.scheduler),
            "prefill_dispatches": self.prefill_dispatches,
            "chunk_dispatches": self.chunk_dispatches,
            "step_dispatches": self.step_dispatches,
            "degradations": self._count("degradations"),
            "occupancy_mean": mean("occupancy"),
            "occupancy_samples": h["occupancy"].count,
            "slot_steps_total": self._count("slot_steps"),
            "queue_delay_mean_s": mean("queue_delay_s"),
            "queue_delay_p50_s": pct("queue_delay_s", 50),
            "queue_delay_p99_s": pct("queue_delay_s", 99),
            "request_latency_mean_s": mean("latency_s"),
            "request_latency_p50_s": pct("latency_s", 50),
            "request_latency_p99_s": pct("latency_s", 99),
            "queue_depth_now": int(self._g_qdepth.value),
            "queue_depth_peak": int(self._g_qdepth.max),
            "queue_depth_mean": mean("queue_depth"),
            "ttft_mean_s": mean("ttft_s"),
            "ttft_p50_s": pct("ttft_s", 50),
            "ttft_p99_s": pct("ttft_s", 99),
            "tpot_mean_s": mean("tpot_s"),
            "tpot_p50_s": pct("tpot_s", 50),
            "slo_violations": sum(v for k, v in self.slo_counters().items()
                                  if k.endswith("_violations")),
            "shed_deadline": self._count("shed_deadline"),
            "shed_backpressure": self._count("shed_backpressure"),
            "shed_queue_deadline": self._count("shed_queue_deadline"),
            "deadline_expired_rows": self._count("deadline_expired_rows"),
            "corrupt_rows": self._count("corrupt_rows"),
            "rows_migrated_out": self._count("migrated_out"),
            "rows_migrated_in": self._count("migrated_in"),
            "snapshots": self._count("snapshots"),
            "snapshot_age_s": (
                None if self._last_snapshot is None
                else round(time.monotonic() - self._last_snapshot[0], 4)),
            "admission_dispatches_saved": self._count("disp_saved"),
            "admission_cache_reordered": self._count("reordered"),
            "batched_admission_groups": self._count("batched_groups"),
            "prefill_tokens_saved": self._count("tokens_saved"),
            "admission_p50_s": {c: pct(f"admission_s.{c}", 50)
                                for c in _HIT_CLASSES},
            "admission_p99_s": {c: pct(f"admission_s.{c}", 99)
                                for c in _HIT_CLASSES},
            "prefix_cache": (None if cache is None else {
                **cache.stats(),
                "engine_hits_full": self._count("prefix_full"),
                "engine_hits_partial": self._count("prefix_partial"),
                "engine_misses": self._count("prefix_miss"),
            }),
            "draft_prefill_dispatches": self._count("draft_prefill"),
            "speculative": self._speculative(status=False),
            "admission_ring": self._ring(status=False),
            "adapters": (None if self.adapter_store is None else {
                "active": int(self._g_adapters_active.value),
                "swaps": self._count("adapter_swaps"),
                "store_version": int(self.adapter_store.version),
                "rows_by_adapter": self._adapter_rows(),
            }),
            "stream_ttft_p50_s": {
                cls: h.percentile(50)
                for cls, h in sorted(self._h_stream_ttft.items())},
        }

    def start_exporter(self, port: Optional[int] = None) -> int:
        """Start the telemetry exporter (``obs/exporter.py``) over this
        engine: ``/metrics`` scrapes the global obs registry and this
        engine's, ``/statusz`` carries :meth:`status`, ``/tracez`` the
        recent spans. ``port=None`` reads ``FLAGS_obs_export_port`` (0
        there: no exporter, returns 0). Returns the bound port;
        idempotent while running."""
        if self._exporter is not None:
            return self._exporter.port
        from paddle_tpu_torch.obs.exporter import (ObsExporter,
                                                   resolve_export_port)
        p = resolve_export_port() if port is None else int(port)
        if port is None and p == 0:
            return 0
        self._exporter = ObsExporter(port=p).add_engine(self)
        return self._exporter.start()

    def stop_exporter(self) -> None:
        """Stop the exporter and release its port (no-op when not
        running)."""
        exp, self._exporter = self._exporter, None
        if exp is not None:
            exp.stop()
