"""Multi-tenant LoRA adapter registry for batched serving.

Counterpart of ``paddle_tpu/serving/lora/store.py``, numpy only, with the
same indices, messages, rank padding and revision rules; the port's
``ServingEngine`` moves the stacks onto the decoder's device as torch
tensors.

One base model serving thousands of fine-tuned tenants (S-LoRA,
arXiv:2311.03285; Punica, arXiv:2310.18547 — PAPERS.md) without a
weight copy per tenant: each adapter is a set of low-rank ``(A, B)``
delta pairs over the decoder's fused projection matrices, and the
store batches every registered adapter into STACKED device arrays
``lora.<param>.A (N+1, d_in, r)`` / ``lora.<param>.B (N+1, r, d_out)``
that merge into the decoder's param dict. The decode chunk then
gathers each batch row's pair by the ``(B,) adapter_idx`` carry field
(``inference/generate._mm``) — mixed-tenant batches share ONE chunk
dispatch, exactly like per-row positions/keys/temperatures
already do. Row 0 of every stack is zeros: ``adapter_idx == 0`` is the
base model, bit-for-bit (a zero delta adds exact float zeros).

Adapters registered with different ranks zero-pad to the store's max
rank — padding columns contribute exact zeros, so a rank-4 adapter in
a rank-8 stack emits the same tokens it would alone. An adapter that
carries no delta for some projection gets zero rows there (base
behaviour for that matrix).

Hot-swap rides the versioned-weights discipline of fleet hot reload:
``update()`` bumps the adapter's REVISION and the store's monotonic
``version``; the serving engine refreshes its stacks between chunks
only when no in-flight row still decodes through a changed adapter —
otherwise the swap is a typed ``AdapterVersionError`` refusal (a KV
cache computed under rev N continued under rev N+1 is neither tenant's
output; same argument as ``WeightVersionError``).
"""

from __future__ import annotations

import threading
from typing import Dict, List, Optional, Tuple

import numpy as np

__all__ = ["AdapterStore", "AdapterVersionError", "UnknownAdapterError"]


class UnknownAdapterError(ValueError):
    """A request named an adapter the store has never registered —
    refused at submit, before any slot/prefill work is spent on it."""


class AdapterVersionError(RuntimeError):
    """An adapter hot-swap would change the deltas under in-flight rows:
    ``update()`` bumped a revision while requests pinned to the old one
    still decode. Refused typed — the engine retries the refresh once
    those rows drain. Carries the adapter name and both revisions."""

    def __init__(self, message: str, adapter: Optional[str] = None,
                 pinned_rev: Optional[int] = None,
                 store_rev: Optional[int] = None):
        super().__init__(message)
        self.adapter = adapter
        self.pinned_rev = pinned_rev
        self.store_rev = store_rev


def _check_pair(name: str, pname: str, A, B) -> Tuple[np.ndarray,
                                                      np.ndarray]:
    A = np.asarray(A)
    B = np.asarray(B)
    if A.ndim != 2 or B.ndim != 2:
        raise ValueError(
            f"adapter {name!r} delta for {pname!r} must be 2-D (A "
            f"(d_in, r), B (r, d_out)); got A{A.shape} B{B.shape}")
    if A.shape[1] != B.shape[0]:
        raise ValueError(
            f"adapter {name!r} delta for {pname!r}: rank mismatch — "
            f"A{A.shape} @ B{B.shape}")
    return A, B


class AdapterStore:
    """Append-only registry of named LoRA adapters.

    ``register(name, deltas)`` assigns the adapter a STABLE row index
    (>= 1; 0 is the base row) — indices never move, so a live carry's
    ``adapter_idx`` stays valid across later registrations.
    ``deltas`` maps full decoder param names (the fused
    ``model.layers.{i}.self_attn.qkv.weight`` /
    ``.self_attn.o_proj.weight`` / ``.mlp.gate_up.weight`` /
    ``.mlp.down_proj.weight``) to ``(A, B)`` pairs.

    ``stacks(dtype=)`` builds the mergeable ``lora.*`` param dict; the
    dtype defaults to the store's (fp32). fp16 stacks over an int8w
    base are the intended cheap-tenant recipe — the delta math happens
    in the adapter dtype and accumulates into the base activation
    dtype.
    """

    def __init__(self, dtype: str = "float32"):
        self.dtype = np.dtype(dtype)
        self._adapters: Dict[str, dict] = {}   # name -> {index, rev,
        self._order: List[str] = []            # deltas}
        self.version = 0        # monotonic: bumps on register AND update
        self._lock = threading.Lock()

    # -- registry -----------------------------------------------------------
    def __len__(self) -> int:
        return len(self._adapters)

    def __contains__(self, name: str) -> bool:
        return name in self._adapters

    def names(self) -> List[str]:
        return list(self._order)

    def register(self, name: str, deltas: Dict[str, tuple]) -> int:
        """Add a NEW adapter; returns its stable row index (>= 1)."""
        checked = {pn: _check_pair(name, pn, a, b)
                   for pn, (a, b) in deltas.items()}
        if not checked:
            raise ValueError(f"adapter {name!r} has no delta pairs")
        with self._lock:
            if name in self._adapters:
                raise ValueError(
                    f"adapter {name!r} already registered — use "
                    f"update() to stage a new revision")
            idx = len(self._order) + 1
            self._adapters[name] = {"index": idx, "rev": 0,
                                    "deltas": checked}
            self._order.append(name)
            self.version += 1
            return idx

    def update(self, name: str, deltas: Dict[str, tuple]) -> int:
        """Stage a new REVISION of an existing adapter (hot-swap);
        returns the new revision. The engine applies it between chunks
        once no in-flight row still pins the old revision."""
        checked = {pn: _check_pair(name, pn, a, b)
                   for pn, (a, b) in deltas.items()}
        with self._lock:
            ad = self._adapters.get(name)
            if ad is None:
                raise UnknownAdapterError(
                    f"update of unregistered adapter {name!r}")
            ad["deltas"] = checked
            ad["rev"] += 1
            self.version += 1
            return ad["rev"]

    def index(self, name: Optional[str]) -> int:
        """The adapter's row in the stacked arrays; None -> 0 (base)."""
        if name is None:
            return 0
        ad = self._adapters.get(name)
        if ad is None:
            raise UnknownAdapterError(
                f"unknown adapter {name!r} (registered: "
                f"{self._order or 'none'})")
        return ad["index"]

    def revision(self, name: str) -> int:
        ad = self._adapters.get(name)
        if ad is None:
            raise UnknownAdapterError(f"unknown adapter {name!r}")
        return ad["rev"]

    def tag(self, name: Optional[str]) -> Optional[str]:
        """The content tag that seeds prefix-cache digests: adapter KV
        is revision-specific content, so the tag pins BOTH — ``None``
        (base) keeps the pre-adapter digests byte-for-byte."""
        if name is None:
            return None
        return f"{name}@{self.revision(name)}"

    # -- stacked device arrays ---------------------------------------------
    def param_names(self) -> List[str]:
        """Every decoder param any adapter touches, sorted."""
        out = set()
        for ad in self._adapters.values():
            out.update(ad["deltas"].keys())
        return sorted(out)

    def max_rank(self) -> int:
        r = 0
        for ad in self._adapters.values():
            for A, _ in ad["deltas"].values():
                r = max(r, int(A.shape[1]))
        return r

    def stacks(self, dtype: Optional[str] = None,
               param_shapes: Optional[Dict[str, tuple]] = None
               ) -> Dict[str, np.ndarray]:
        """The mergeable ``{"lora.<pname>.A"/".B": stacked}`` dict.

        ``param_shapes`` (``{pname: (d_in, d_out)}``) validates every
        delta against its host matrix up front — a shape skew fails HERE
        with the param named, not as a trace error inside the chunk
        program. Ranks zero-pad to the store max; missing deltas are
        zero rows; row 0 is always the all-zero base row."""
        with self._lock:
            dt = np.dtype(dtype) if dtype is not None else self.dtype
            names = self.param_names()
            r = max(self.max_rank(), 1)
            N = len(self._order)
            out: Dict[str, np.ndarray] = {}
            for pn in names:
                din = dout = None
                for ad in self._adapters.values():
                    pair = ad["deltas"].get(pn)
                    if pair is not None:
                        din, dout = int(pair[0].shape[0]), \
                            int(pair[1].shape[1])
                        break
                if param_shapes is not None:
                    want = param_shapes.get(pn)
                    if want is None:
                        raise ValueError(
                            f"adapter delta targets unknown decoder "
                            f"param {pn!r}")
                    if (int(want[0]), int(want[1])) != (din, dout):
                        raise ValueError(
                            f"adapter delta for {pn!r} is ({din}, "
                            f"{dout}) but the decoder matrix is "
                            f"{tuple(int(x) for x in want)}")
                A = np.zeros((N + 1, din, r), dt)
                Bm = np.zeros((N + 1, r, dout), dt)
                for ad in self._adapters.values():
                    pair = ad["deltas"].get(pn)
                    if pair is None:
                        continue
                    a, b = pair
                    i, rr = ad["index"], int(a.shape[1])
                    A[i, :, :rr] = a.astype(dt)
                    Bm[i, :rr, :] = b.astype(dt)
                out["lora." + pn + ".A"] = A
                out["lora." + pn + ".B"] = Bm
            return out

    def describe(self) -> dict:
        """/statusz material: per-adapter index/revision + stack geometry."""
        with self._lock:
            return {
                "version": self.version,
                "adapters": {
                    n: {"index": ad["index"], "rev": ad["rev"],
                        "params": sorted(ad["deltas"].keys())}
                    for n, ad in self._adapters.items()},
                "rank": self.max_rank(),
                "dtype": str(self.dtype),
            }
