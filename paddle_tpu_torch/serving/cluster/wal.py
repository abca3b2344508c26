"""Durable frontend write-ahead log (the control plane's black box).

Counterpart of ``paddle_tpu/serving/cluster/wal.py``
(the port's own copy: it imports nothing of the JAX package).
The log writes the same bytes as the JAX package's, so either package
replays the other's.

Workers are disposable, but the frontend's replay ledger in
``ClusterRouter._tracked`` memory dies with the frontend, with every
in-flight and queued request. This module is the durable form —
an append-only, per-record-checksummed, segment-rotated log of the
request lifecycle (submit with prompt/params/remaining-deadline-budget,
per-step harvested tokens, finish, requeue, migration ownership
transfer) that a respawned ``ClusterRouter(resume_wal=...)`` replays to
rebuild its exact tracking state.

Record framing (one record = one lifecycle event, JSON body)::

    MAGIC(4) | body_len(4, LE) | sha256(body)(32) | body

Recovery discipline — the atomic/sha256 rules of the snapshots applied to an
append-only file:

- a TORN TAIL (the process died mid-append: missing header bytes, or a
  body shorter than its declared length, at the very end of the LAST
  segment) is truncated away and the log reopens for appending — the
  in-flight record was by definition not yet acknowledged;
- MID-FILE corruption (bad magic, or a COMPLETE record whose body
  fails its sha256) is refused typed ``CorruptCheckpointError`` —
  silently skipping a damaged lifecycle record would replay a wrong
  fleet state, which is worse than refusing to start;
- segments rotate at ``segment_bytes`` so no single file grows without
  bound; rotation happens only on record boundaries, so a torn tail
  can only ever live in the last segment.

Appends route through ``fault_injector.on_write`` — the existing
``torn_write`` / ``bit_flip`` plans drill exactly the two recovery
branches above without any test-only seams.

Durability: ``append(rec, sync=True)`` fsyncs before returning (the
submit acknowledgement path); the per-step token harvest appends with
``sync=False`` and the router group-commits one ``sync()`` per serving
step. fsync latency and bytes written are tracked in :meth:`stats` and
surface as frontend /metrics gauges.
"""

from __future__ import annotations

import hashlib
import json
import os
import struct
import time
from typing import Any, Dict, List, Optional

import numpy as np

from paddle_tpu_torch.runtime.resilience import (CorruptCheckpointError,
                                           InjectedFault, fault_injector)

__all__ = ["WriteAheadLog"]

_MAGIC = b"PTW1"
_LEN = struct.Struct("<I")
_HEADER_BYTES = 4 + 4 + 32           # magic | body_len | sha256(body)
_SEG_FMT = "wal-{:06d}.log"


def _json_default(o):
    if isinstance(o, np.integer):
        return int(o)
    if isinstance(o, np.floating):
        return float(o)
    if isinstance(o, np.ndarray):
        return o.tolist()
    raise TypeError(f"WAL record field of type {type(o).__name__} "
                    f"is not JSON-serializable")


class WriteAheadLog:
    """Append-only checksummed segment log under one directory.

    Opening is recovery: the constructor scans every segment, validates
    each record, truncates a torn tail, refuses mid-file corruption
    typed, exposes the surviving records as :attr:`recovered`, and
    positions the writer at the end of the last segment. A fresh
    directory therefore opens with ``recovered == []`` and the same
    code path."""

    def __init__(self, directory: str, segment_bytes: int = 1 << 20):
        self.directory = str(directory)
        self.segment_bytes = int(segment_bytes)
        os.makedirs(self.directory, exist_ok=True)
        self._f = None
        self._seg_seq = 0
        self._seg_size = 0
        self._dirty = False
        self._last_error: Optional[str] = None
        self._records = 0
        self._bytes_written = 0
        self._fsyncs = 0
        self._last_fsync_s = 0.0
        self.recovered: List[Dict[str, Any]] = self._scan_and_open()
        self._records = len(self.recovered)

    # -- recovery ----------------------------------------------------------
    def _segments(self) -> List[str]:
        names = sorted(n for n in os.listdir(self.directory)
                       if n.startswith("wal-") and n.endswith(".log"))
        return [os.path.join(self.directory, n) for n in names]

    def _scan_and_open(self) -> List[Dict[str, Any]]:
        records: List[Dict[str, Any]] = []
        segs = self._segments()
        for si, path in enumerate(segs):
            last = si == len(segs) - 1
            with open(path, "rb") as f:
                data = f.read()
            off = 0
            while off < len(data):
                rem = len(data) - off
                if rem < _HEADER_BYTES:
                    if not last:
                        raise CorruptCheckpointError(
                            f"WAL segment {path}: {rem} trailing bytes "
                            f"mid-log (rotation only happens on record "
                            f"boundaries — this is corruption, not a "
                            f"torn tail)")
                    self._truncate(path, off)
                    data = data[:off]
                    break
                if data[off:off + 4] != _MAGIC:
                    raise CorruptCheckpointError(
                        f"WAL segment {path}: bad record magic at byte "
                        f"{off} — refusing the corrupt log")
                (ln,) = _LEN.unpack(data[off + 4:off + 8])
                if rem < _HEADER_BYTES + ln:
                    if not last:
                        raise CorruptCheckpointError(
                            f"WAL segment {path}: record at byte {off} "
                            f"declares {ln} body bytes but only "
                            f"{rem - _HEADER_BYTES} follow mid-log")
                    # torn tail: the append died inside the body —
                    # truncate-and-recover (the record was never acked)
                    self._truncate(path, off)
                    data = data[:off]
                    break
                digest = data[off + 8:off + 40]
                body = data[off + 40:off + 40 + ln]
                if hashlib.sha256(body).digest() != digest:
                    raise CorruptCheckpointError(
                        f"WAL segment {path}: record at byte {off} "
                        f"failed sha256 verification — refusing the "
                        f"corrupt log (a silently skipped lifecycle "
                        f"record replays a wrong fleet state)")
                records.append(json.loads(body.decode()))
                off += _HEADER_BYTES + ln
        # position the writer: append to the last segment, or start one
        if segs:
            path = segs[-1]
            self._seg_seq = int(os.path.basename(path)[4:10])
            self._seg_size = os.path.getsize(path)
            self._f = open(path, "ab")
        else:
            self._open_segment(1)
        return records

    @staticmethod
    def _truncate(path: str, size: int) -> None:
        with open(path, "rb+") as f:
            f.truncate(size)
            f.flush()
            os.fsync(f.fileno())

    def _open_segment(self, seq: int) -> None:
        self._seg_seq = seq
        path = os.path.join(self.directory, _SEG_FMT.format(seq))
        self._f = open(path, "ab")
        self._seg_size = os.path.getsize(path)

    # -- appending ---------------------------------------------------------
    def append(self, rec: Dict[str, Any], sync: bool = True) -> None:
        """Frame, checksum and append one record; ``sync=True`` fsyncs
        before returning (the acknowledgement path — a submit is only
        accepted once it is durable). Rotates to a fresh segment after
        the append when the current one is past ``segment_bytes``."""
        if self._f is None:
            raise CorruptCheckpointError(
                f"WAL {self.directory} is closed")
        body = json.dumps(rec, default=_json_default).encode()
        framed = (_MAGIC + _LEN.pack(len(body))
                  + hashlib.sha256(body).digest() + body)
        path = self._f.name
        framed, crash = fault_injector.on_write(path, framed)
        try:
            self._f.write(framed)
            self._f.flush()
        except OSError as e:
            self._last_error = f"{type(e).__name__}: {e}"
            raise
        self._seg_size += len(framed)
        self._bytes_written += len(framed)
        self._dirty = True
        if crash:
            # injected mid-append crash: the torn prefix is on disk,
            # recovery truncates it — the drill for the torn-tail branch
            self._last_error = "injected torn append"
            raise InjectedFault(
                f"DATA_LOSS: injected crash mid-append to {path} "
                f"({len(framed)} bytes written)", code="DATA_LOSS")
        self._records += 1
        if sync:
            self.sync()
        if self._seg_size >= self.segment_bytes:
            self.sync()
            self._f.close()
            self._open_segment(self._seg_seq + 1)

    def sync(self) -> None:
        """fsync pending appends (the router's per-step group commit)."""
        if self._f is None or not self._dirty:
            return
        t0 = time.monotonic()
        try:
            self._f.flush()
            os.fsync(self._f.fileno())
        except OSError as e:
            self._last_error = f"{type(e).__name__}: {e}"
            raise
        self._last_fsync_s = time.monotonic() - t0
        self._fsyncs += 1
        self._dirty = False

    def close(self) -> None:
        if self._f is not None:
            try:
                self.sync()
            finally:
                self._f.close()
                self._f = None

    # -- introspection -----------------------------------------------------
    def healthy(self) -> bool:
        """Writable and no append/fsync has failed — the frontend
        /healthz verdict's WAL half."""
        return self._f is not None and self._last_error is None

    def stats(self) -> Dict[str, Any]:
        return {
            "dir": self.directory,
            "records": int(self._records),
            "recovered": len(self.recovered),
            "segments": int(self._seg_seq),
            "bytes_written": int(self._bytes_written),
            "fsyncs": int(self._fsyncs),
            "last_fsync_s": float(self._last_fsync_s),
            "last_error": self._last_error,
        }
