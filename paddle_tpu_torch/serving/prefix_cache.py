"""Content-hashed prefix cache and length-bucketed KV slab pool.

Counterpart of ``paddle_tpu/serving/prefix_cache.py`` on torch tensors.
The store holds DENSE batch-1 KV slabs, each the contiguous cache rows
``[0, bucket(S))`` of one previously prefilled prompt plus the logits of
its last position, keyed by chained content hashes of the token ids taken
at every ``block_tokens`` boundary and at the full length:

- a FULL hit (the whole prompt matches a cached entry) admits by the
  serving engine's row copy alone: zero prefill dispatches;
- a PARTIAL hit (the longest block-boundary digest matches) loads the
  slab into a fresh cache row and prefills only the uncached suffix at
  ``pos0 = cached_len``;
- a MISS populates the cache: the admission prefill's row is sliced to
  the prompt's length bucket and inserted under its full-length digest
  and every block-boundary digest.

Rows ``[0, L)`` of a causal prefill depend only on tokens ``[0, L)``, so
both hit classes give the tokens of a cold admission. Slabs are
ref-counted (a slab pinned by an in-flight request is never evicted) and
least-recently-used unpinned slabs go once ``bytes_budget`` is passed.

The digests, lookup, insert, eviction and statistics are the JAX
package's, so the same sequence of operations leaves both caches in the
same state. ``SlabOps`` copies slab rows on the device: ``extract`` clones
one row out of a batch-N cache, ``load`` copies a slab into a row of one.
Meshes are not ported (ROADMAP.md queue 1: mesh): ``bind_mesh`` takes
``None`` only.
"""

from __future__ import annotations

import dataclasses
import hashlib
import itertools
import os
import threading
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from paddle_tpu_torch.quantization.kv_cache import is_quantized_kv

__all__ = ["PrefixCache", "PrefixSlab", "PrefixLookup", "prefix_digests",
           "resolve_prefix_cache_bytes", "SlabOps"]

_UNBOUND = object()      # cache not yet bound to a topology


def resolve_prefix_cache_bytes() -> int:
    """The prefix-cache byte budget: ``PADDLE_TPU_PREFIX_CACHE_BYTES``
    wins over ``FLAGS_serving_prefix_cache_bytes``; 0 = disabled."""
    env = os.environ.get("PADDLE_TPU_PREFIX_CACHE_BYTES", "").strip()
    if env:
        return int(float(env))
    from paddle_tpu_torch.flags import flags
    return int(flags.serving_prefix_cache_bytes)


def prefix_digests(tokens, block_tokens: int,
                   adapter: Optional[str] = None) -> List[Tuple[int, str]]:
    """Chained blake2b digests of a token-id prefix at every
    ``block_tokens`` boundary plus the full length, longest first
    (``h_i = H(h_{i-1} || block_i)`` over the int64 bytes of the ids), so
    a one-token divergence changes every digest at and past its block.
    ``adapter`` (a LoRA tag ``"name@rev"``) seeds the chain; ``None``
    leaves it unseeded."""
    ids = np.ascontiguousarray(np.asarray(tokens).reshape(-1), np.int64)
    S = int(ids.shape[0])
    if S < 1:
        raise ValueError("prefix must have at least 1 token")
    block = int(block_tokens)
    if block < 1:
        raise ValueError(f"block_tokens must be >= 1, got {block}")
    out: List[Tuple[int, str]] = []
    h = hashlib.blake2b(digest_size=16)
    if adapter is not None:
        h.update(b"adapter:" + str(adapter).encode("utf-8") + b"\x00")
    done = 0
    for end in range(block, S + 1, block):
        h.update(ids[done:end].tobytes())
        done = end
        out.append((end, h.hexdigest()))
    if done < S:
        h.update(ids[done:S].tobytes())
        out.append((S, h.hexdigest()))
    out.reverse()            # longest (= full length) first
    return out


@dataclasses.dataclass(eq=False)     # identity equality: fields hold
class PrefixSlab:                    # device tensors
    """One cached prefix: batch-1 KV caches trimmed to the prompt's
    length bucket, plus the logits of position ``length - 1`` (what a
    full hit resumes from). ``refs`` pins it against eviction."""
    kc: Any
    vc: Any
    logits: Any               # (1, V): valid for the FULL length only
    length: int               # true token length of the inserted prefix
    bucket: int               # cache columns the tensors hold
    nbytes: int
    digests: List[str] = dataclasses.field(default_factory=list)
    refs: int = 0
    stamp: int = 0            # LRU clock (bumped on hit / insert)
    dtype: str = ""           # KV leaf dtypes, e.g. "int8+float32"

    def describe(self) -> dict:
        return {"length": self.length, "bucket": self.bucket,
                "bytes": self.nbytes, "dtype": self.dtype,
                "refs": self.refs}


@dataclasses.dataclass
class PrefixLookup:
    """One prompt's verdict: ``kind`` in {"full", "partial", "miss"};
    ``cached_len`` is the prefix length the admission may skip;
    ``digests`` is the prompt's hash ladder, reused by the insert that
    follows a miss."""
    kind: str
    slab: Optional[PrefixSlab]
    cached_len: int
    digests: List[Tuple[int, str]]


def _leaves(tree):
    if isinstance(tree, (tuple, list)):
        for t in tree:
            yield from _leaves(t)
    elif isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k])
    else:
        yield tree


def _dtype_name(x) -> str:
    return str(x.dtype).replace("torch.", "")


def _nbytes(tree) -> int:
    """Slab bytes at the leaves' own dtypes: an int8 KV slab charges 1
    byte an element plus its f32 scales."""
    return int(sum(x.nbytes if isinstance(x, np.ndarray)
                   else x.element_size() * x.numel()
                   for x in _leaves(tree)))


def _kv_dtype(tree) -> str:
    return "+".join(sorted({_dtype_name(x) for x in _leaves(tree)}))


class SlabOps:
    """The two slab copies on the device, in stacked-cache layout (batch
    axis 1 of ``(layers, B, ...)``; the length axis 3 head-major, 2
    token-major). Not counted dispatches: like the engine's row copy they
    are plain tensor updates outside the serving dispatch contract.

    ``extract``: row ``row`` of a batch-N cache pair cut to ``cols``
    length columns, and that row's logits, as new tensors: the slab that
    enters the pool. ``load``: a slab's columns copied into row ``row``
    of a batch-N cache pair, in place (the engine's row copy): the base a
    suffix prefill computes on. Loading all of the slab's columns is
    sound, since the columns past the reused prefix stay masked until the
    suffix prefill or decode overwrite them."""

    def __init__(self, sharding=None, head_major: bool = False):
        from paddle_tpu_torch.inference.generate import _not_ported
        if sharding is not None:
            raise _not_ported("a prefix cache on a mesh", "mesh")
        self._hm = bool(head_major)

    def extract(self, kc, vc, logits, row: int, cols: int):
        ax = 3 if self._hm else 2

        def cut(c):
            if is_quantized_kv(c):
                return {k: cut(v) for k, v in c.items()}
            return c.narrow(1, int(row), 1).narrow(ax, 0, int(cols)).clone()
        return cut(kc), cut(vc), logits.narrow(0, int(row), 1).clone()

    def load(self, kc, vc, slab_kc, slab_vc, row: int):
        from paddle_tpu_torch.inference.generate import _row_copy
        _row_copy(kc, slab_kc, int(row), 0, self._hm)
        _row_copy(vc, slab_vc, int(row), 0, self._hm)
        return kc, vc


class PrefixCache:
    """The ref-counted, LRU and byte-budget slab store: host bookkeeping
    under a lock; the slab tensors are never written after insertion.
    One cache may be shared by several engines of the same decoder
    layout."""

    def __init__(self, bytes_budget: Optional[int] = None,
                 block_tokens: Optional[int] = None):
        from paddle_tpu_torch.flags import flags
        if bytes_budget is None:
            bytes_budget = resolve_prefix_cache_bytes() or (1 << 62)
        self.bytes_budget = int(bytes_budget)
        if self.bytes_budget < 1:
            raise ValueError(
                f"bytes_budget must be >= 1, got {bytes_budget} "
                f"(an engine disables the cache by not building one)")
        self.block_tokens = int(block_tokens
                                if block_tokens is not None
                                else flags.serving_prefix_block_tokens)
        if self.block_tokens < 1:
            raise ValueError(f"block_tokens must be >= 1, "
                             f"got {self.block_tokens}")
        self._lock = threading.RLock()
        self._index: Dict[str, Tuple[PrefixSlab, int]] = {}
        self._slabs: List[PrefixSlab] = []
        self._clock = itertools.count(1)
        self._mesh: Any = _UNBOUND
        self.bytes_cached = 0
        self.hits_full = 0
        self.hits_partial = 0
        self.misses = 0
        self.insertions = 0
        self.evictions = 0
        self.bytes_evicted = 0
        self.prefill_tokens_saved = 0

    # -- topology binding ---------------------------------------------------
    def bind_mesh(self, axes: Optional[Dict[str, int]]) -> None:
        """Fix the topology the slabs live under: ``None`` (one device)
        only, since meshes are not ported."""
        if axes:
            from paddle_tpu_torch.inference.generate import _not_ported
            raise _not_ported("a prefix cache on a mesh", "mesh")
        with self._lock:
            self._mesh = None

    # -- lookup / insert ----------------------------------------------------
    def lookup(self, tokens, allow_partial: bool = True,
               adapter: Optional[str] = None) -> PrefixLookup:
        """Longest-prefix match over the prompt's digest ladder. A full
        hit needs the exact full-length entry with resume logits; else
        the longest boundary entry is a partial base, capped at ``S - 1``
        so that at least one suffix token recomputes the resume logits."""
        digests = prefix_digests(tokens, self.block_tokens,
                                 adapter=adapter)
        S = digests[0][0]
        with self._lock:
            for L, d in digests:
                ent = self._index.get(d)
                if ent is None:
                    continue
                slab, ent_len = ent
                if L == S and ent_len == slab.length:
                    slab.stamp = next(self._clock)
                    self.hits_full += 1
                    self.prefill_tokens_saved += S
                    return PrefixLookup("full", slab, S, digests)
                if not allow_partial:
                    continue
                cached = min(ent_len, S - 1)
                if cached < 1:
                    continue
                slab.stamp = next(self._clock)
                self.hits_partial += 1
                self.prefill_tokens_saved += cached
                return PrefixLookup("partial", slab, cached, digests)
            self.misses += 1
            return PrefixLookup("miss", None, 0, digests)

    def has_digest(self, digest: str) -> bool:
        """True when a live slab is keyed under this digest: the
        cache-aware admission ordering's probe."""
        with self._lock:
            return digest in self._index

    def contains_full(self, digests: List[Tuple[int, str]]) -> bool:
        """True when the full-length entry (with resume logits) of this
        ladder is live: the engine then skips the slab extraction."""
        with self._lock:
            ent = self._index.get(digests[0][1])
            return ent is not None and ent[1] == ent[0].length

    def insert(self, tokens, kc, vc, logits, bucket: int,
               digests: Optional[List[Tuple[int, str]]] = None,
               adapter: Optional[str] = None) -> Optional[PrefixSlab]:
        """Register one prefilled prompt's row under its full-length
        digest and every block-boundary digest (boundary keys keep their
        first writer). Returns the slab (the live one when the full entry
        exists already), or None when it was evicted on the way in."""
        if digests is None:
            digests = prefix_digests(tokens, self.block_tokens,
                                     adapter=adapter)
        S = digests[0][0]
        with self._lock:
            have = self._index.get(digests[0][1])
            if have is not None and have[1] == have[0].length:
                have[0].stamp = next(self._clock)
                return have[0]        # dedupe: full entry already live
            slab = PrefixSlab(kc=kc, vc=vc, logits=logits, length=S,
                              bucket=int(bucket),
                              nbytes=_nbytes((kc, vc, logits)),
                              dtype=_kv_dtype((kc, vc)),
                              stamp=next(self._clock))
            for L, d in digests:
                cur = self._index.get(d)
                if cur is None or L == S:
                    self._index[d] = (slab, L)
                    slab.digests.append(d)
            self._slabs.append(slab)
            self.insertions += 1
            self.bytes_cached += slab.nbytes
            self._evict_to_budget()
            return slab if slab in self._slabs else None

    # -- pinning / eviction -------------------------------------------------
    def pin(self, slab: PrefixSlab) -> None:
        with self._lock:
            slab.refs += 1

    def unpin(self, slab: PrefixSlab) -> None:
        with self._lock:
            if slab.refs < 1:
                raise RuntimeError("unpin without a matching pin")
            slab.refs -= 1
            self._evict_to_budget()

    def _evict_to_budget(self) -> None:
        # lock held; pinned slabs are untouchable, so the pool may
        # overshoot the budget until they unpin
        while self.bytes_cached > self.bytes_budget:
            victims = [s for s in self._slabs if s.refs == 0]
            if not victims:
                return
            v = min(victims, key=lambda s: s.stamp)
            self._slabs.remove(v)
            for d in v.digests:
                if self._index.get(d, (None,))[0] is v:
                    del self._index[d]
            self.bytes_cached -= v.nbytes
            self.bytes_evicted += v.nbytes
            self.evictions += 1

    # -- introspection ------------------------------------------------------
    def __len__(self) -> int:
        with self._lock:
            return len(self._slabs)

    @property
    def mesh_axes(self) -> Optional[Dict[str, int]]:
        return None

    def stats(self) -> Dict[str, Any]:
        with self._lock:
            hits = self.hits_full + self.hits_partial
            total = hits + self.misses
            return {
                "slabs": len(self._slabs),
                "bytes_cached": self.bytes_cached,
                "bytes_budget": self.bytes_budget,
                "block_tokens": self.block_tokens,
                "hits_full": self.hits_full,
                "hits_partial": self.hits_partial,
                "misses": self.misses,
                "hit_rate": (hits / total) if total else 0.0,
                "insertions": self.insertions,
                "evictions": self.evictions,
                "bytes_evicted": self.bytes_evicted,
                "prefill_tokens_saved": self.prefill_tokens_saved,
                "pinned": sum(1 for s in self._slabs if s.refs),
            }

    def snapshot(self) -> Dict[str, Any]:
        """The stats plus the occupancy and a bounded slab table (newest
        first): what ``ServingEngine.status()`` shows."""
        with self._lock:
            out = self.stats()
            out["occupancy"] = self.bytes_cached / self.bytes_budget
            slabs = sorted(self._slabs, key=lambda s: -s.stamp)[:32]
            out["slab_table"] = [s.describe() for s in slabs]
            out["slab_dtypes"] = sorted({s.dtype for s in self._slabs})
            out["mesh"] = self.mesh_axes
            return out
