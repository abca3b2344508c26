"""Distributed checkpoints and the numpy storage of tensors.

Counterpart of ``paddle_tpu/distributed/checkpoint.py``, in its format,
so a checkpoint one package writes the other reads:

- ``metadata.json`` (the merged map: each tensor's global shape and dtype
  and the stored slices that cover it, each slice's file, npz key,
  offset, shape and dtype tag; a sha256 manifest of the data files),
  ``meta_r{rank}.json`` (the rank's own map and manifest entry) and
  ``data_r{rank}.npz`` (its slices);
- every file is written through ``runtime.resilience.atomic_write_bytes``
  (a temp file and an atomic rename), the data file's digest taken from
  the intended bytes before they reach the disk;
- load verifies each data file against the manifest when it first opens
  it and raises ``CorruptCheckpointError`` on a mismatch, a missing file
  or torn metadata, and assembles each tensor from whatever slices cover
  it, so a checkpoint the JAX package wrote in slices from a sharded
  mesh loads whole.

The port runs one process: ``save_state_dict`` writes rank 0 with each
tensor whole at offset 0, and ``load_state_dict`` fills the state dict's
tensors in place, cast to their dtypes.

A tensor goes into an npz as a numpy-native array plus a dtype tag
(``_np_storable`` / ``_np_restore``, also the serving payloads' storage):
bf16 has no numpy dtype, so it is stored as its ``uint16`` bits tagged
``"bfloat16"`` and comes back as a bf16 tensor through torch's own view
of the bits (no ``ml_dtypes``).
"""

from __future__ import annotations

import hashlib
import io
import json
import os
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from paddle_tpu_torch.runtime.resilience import (CorruptCheckpointError,
                                                 atomic_write_bytes)

__all__ = ["save_state_dict", "load_state_dict", "CorruptCheckpointError",
           "_np_storable", "_np_restore"]

_META = "metadata.json"
_RANK_META = "meta_r{rank}.json"
_DATA = "data_r{rank}.npz"


def _np_storable(t) -> Tuple[np.ndarray, str]:
    """A tensor (or numpy array) -> ``(numpy-native array, dtype tag)`` on
    the host: bf16 becomes its ``uint16`` bits tagged ``"bfloat16"``; any
    other dtype keeps its numpy name as the tag."""
    if isinstance(t, torch.Tensor):
        t = t.detach().cpu()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16), "bfloat16"
        a = t.numpy()
    else:
        a = np.asarray(t)
    return a, str(a.dtype)


def _np_restore(arr: np.ndarray, dtype_tag: str) -> torch.Tensor:
    """The inverse of :func:`_np_storable`, as a CPU tensor: a ``uint16``
    array tagged ``"bfloat16"`` becomes a bf16 tensor of the same bits.
    torch computes on no unsigned type wider than 8 bits, so a ``uint16``
    / ``uint32`` / ``uint64`` array comes back as the signed tensor of the
    same width and bits (the port holds threefry key words so)."""
    a = np.ascontiguousarray(arr)
    if dtype_tag == "bfloat16" and a.dtype == np.uint16:
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    if a.dtype.kind == "u" and a.dtype.itemsize > 1:
        a = a.view(np.dtype(f"i{a.dtype.itemsize}"))
    return torch.from_numpy(a.copy())


def save_state_dict(state_dict: Dict[str, torch.Tensor], path: str,
                    process_group=None, coordinator_rank: int = 0) -> None:
    """Write ``state_dict`` (name -> tensor or array) as the checkpoint
    at ``path``: rank 0's data file and map, then the merged map."""
    os.makedirs(path, exist_ok=True)
    fname = _DATA.format(rank=0)
    meta: Dict[str, dict] = {}
    arrays: Dict[str, np.ndarray] = {}
    for i, (name, t) in enumerate(state_dict.items()):
        store, tag = _np_storable(t)
        key = f"s{i}"
        arrays[key] = store
        meta[name] = {"shape": list(store.shape), "dtype": tag,
                      "storage": [{"file": fname, "key": key,
                                   "offset": [0] * store.ndim,
                                   "shape": list(store.shape),
                                   "dtype": tag}]}
    buf = io.BytesIO()
    np.savez(buf, **arrays)
    payload = buf.getvalue()
    files = {fname: {"sha256": hashlib.sha256(payload).hexdigest(),
                     "bytes": len(payload)}}
    atomic_write_bytes(os.path.join(path, fname), payload)
    atomic_write_bytes(os.path.join(path, _RANK_META.format(rank=0)),
                       json.dumps({"tensors": meta,
                                   "files": files}).encode())
    atomic_write_bytes(os.path.join(path, _META),
                       json.dumps({"version": 3, "tensors": meta,
                                   "files": files}).encode())


def _open_data(path: str, fname: str, files_manifest: Optional[dict],
               cache: Dict[str, "np.lib.npyio.NpzFile"]):
    """One data file of the read plan, sha256-checked against the
    manifest on first open (a checkpoint without a manifest loads
    unchecked)."""
    npz = cache.get(fname)
    if npz is not None:
        return npz
    full = os.path.join(path, fname)
    expect = (files_manifest or {}).get(fname)
    try:
        if expect is None:
            npz = np.load(full)
        else:
            with open(full, "rb") as f:
                raw = f.read()
            got = hashlib.sha256(raw).hexdigest()
            if got != expect["sha256"]:
                raise CorruptCheckpointError(
                    f"checkpoint shard {fname} is corrupt: sha256 "
                    f"{got[:16]}… != manifest {expect['sha256'][:16]}… "
                    f"({len(raw)} bytes on disk, {expect['bytes']} "
                    f"expected) — torn write or media corruption; "
                    f"restore the shard or resave")
            npz = np.load(io.BytesIO(raw))
    except FileNotFoundError as e:
        raise CorruptCheckpointError(
            f"checkpoint shard {fname} is missing from {path} — "
            f"incomplete save (crash before the shard was written?)"
        ) from e
    except (CorruptCheckpointError, MemoryError):
        raise
    except Exception as e:
        raise CorruptCheckpointError(
            f"checkpoint shard {fname} failed to parse: {e}") from e
    cache[fname] = npz
    return npz


def _assemble(entry: dict, cache: Dict[str, "np.lib.npyio.NpzFile"],
              path: str, files_manifest: Optional[dict]) -> np.ndarray:
    """The whole tensor of ``entry`` from the stored slices, in their
    numpy-native storage dtype (``uint16`` for bf16)."""
    shape = list(entry["shape"])
    tag = entry["dtype"]
    buf = np.zeros(tuple(shape), dtype=np.uint16 if tag == "bfloat16"
                   else np.dtype(tag))
    filled = 0
    for st in entry["storage"]:
        s_offs, s_shape = st["offset"], st["shape"]
        lo = [max(0, b) for b in s_offs]
        hi = [min(n, b + m) for n, b, m in zip(shape, s_offs, s_shape)]
        if any(a >= b for a, b in zip(lo, hi)):
            continue
        piece = _open_data(path, st["file"], files_manifest,
                           cache)[st["key"]]
        src = tuple(slice(a - o, b - o) for a, b, o in zip(lo, hi, s_offs))
        dst = tuple(slice(a, b) for a, b in zip(lo, hi))
        buf[dst] = piece[src]
        filled += int(np.prod([b - a for a, b in zip(lo, hi)]))
    want = int(np.prod(shape)) if shape else 1
    if filled < want:
        raise CorruptCheckpointError(
            f"checkpoint read plan incomplete: {filled}/{want} elements "
            f"(shape {shape}) — the checkpoint does not cover the tensor "
            f"(partial save?)")
    return buf


@torch.no_grad()
def load_state_dict(state_dict: Dict[str, torch.Tensor], path: str,
                    process_group=None) -> None:
    """Fill ``state_dict``'s tensors in place from the checkpoint at
    ``path``, each assembled whole from the slices that cover it and cast
    to the tensor's dtype."""
    try:
        with open(os.path.join(path, _META)) as f:
            meta = json.load(f)
    except FileNotFoundError as e:
        raise CorruptCheckpointError(
            f"no {_META} in {path} — the save never completed its "
            f"metadata merge (crash mid-save?) or the path is not a "
            f"checkpoint directory") from e
    except json.JSONDecodeError as e:
        raise CorruptCheckpointError(
            f"{_META} in {path} is not valid JSON: torn metadata "
            f"write") from e
    tensors_meta = meta["tensors"]
    files_manifest = meta.get("files")
    cache: Dict[str, "np.lib.npyio.NpzFile"] = {}
    for name, t in state_dict.items():
        entry = tensors_meta.get(name)
        if entry is None:
            raise KeyError(f"tensor {name!r} not in checkpoint {path}")
        gshape = tuple(entry["shape"])
        if tuple(t.shape) != gshape:
            raise ValueError(f"{name}: checkpoint shape {gshape} != "
                             f"target {tuple(t.shape)}")
        full = _np_restore(_assemble(entry, cache, path, files_manifest),
                           entry["dtype"])
        # (a 0-dim tensor comes back 1-d from np.ascontiguousarray)
        t.copy_(full.reshape(gshape).to(t.dtype))
