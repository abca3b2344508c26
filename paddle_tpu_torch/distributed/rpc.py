"""Simple RPC between workers (paddle.distributed.rpc analog).

Counterpart of ``paddle_tpu/distributed/rpc.py``
(the port's own copy: it imports nothing of the JAX package).

Redesign of the reference's RPC package
(paddle/fluid/distributed/rpc/rpc_agent.cc + python/paddle/distributed/rpc)
on top of the native TCPStore control plane instead of brpc: requests are
densely-numbered store keys (``rpc/req/{dst}/{seq}``), every worker runs a
daemon that blocks on its next sequence number, results come back on
``rpc/res/{src}/{seq}``. Fine for control-plane traffic (the reference's
stated scope); a payload above 512 KiB (a KV slab, a migrated row)
travels as sha256-checked parts.

Security note (same trust model as the reference): payloads are pickled —
RPC peers must be the trusted training cluster, never untrusted input.
"""

from __future__ import annotations

import hashlib
import json
import pickle
import threading
import time
from dataclasses import dataclass
from typing import Any, Callable, Dict, Optional

from paddle_tpu_torch.native.tcp_store import TCPStore

__all__ = ["init_rpc", "rpc_sync", "rpc_async", "shutdown",
           "get_worker_info", "get_current_worker_info", "get_all_worker_info",
           "WorkerInfo"]

_DEFAULT_TIMEOUT = 30.0

# TCPStore replies are read into a fixed 1 MiB client buffer
# (native/tcp_store.py): payloads above this ride multiple part keys
# written BEFORE the header value, so a reader that sees the header can
# fetch every part without waiting. 512 KiB leaves headroom for the
# pickle framing and key names.
_CHUNK_BYTES = 512 * 1024
_CHUNK_MAGIC = b"__chunked__:"


@dataclass(frozen=True)
class WorkerInfo:
    name: str
    rank: int


class Future:
    def __init__(self):
        self._ev = threading.Event()
        self._result = None
        self._exc = None

    def _set(self, ok: bool, payload):
        if ok:
            self._result = payload
        else:
            self._exc = payload
        self._ev.set()

    def wait(self, timeout: Optional[float] = None):
        if not self._ev.wait(timeout if timeout is not None
                             else _DEFAULT_TIMEOUT):
            raise TimeoutError("rpc future timed out")
        if self._exc is not None:
            raise self._exc
        return self._result


class RpcAgent:
    """One worker's RPC endpoint. Module-level init_rpc manages a process
    singleton; tests may run several agents in one process."""

    def __init__(self, name: str, rank: int, world_size: int,
                 host: str = "127.0.0.1", port: int = 0,
                 is_master: Optional[bool] = None, resume: bool = False):
        # port=0: the master picks a free port (TCPStore default); workers
        # must pass the master's advertised host/port
        self.name = name
        self.rank = rank
        self.world_size = world_size
        self.store = TCPStore(host=host, port=port,
                              is_master=(rank == 0 if is_master is None
                                         else is_master),
                              world_size=world_size)
        self.store.set(f"rpc/worker/{rank}", name.encode())
        # resume=True: this agent REUSES a dead incarnation's rank (a
        # restarted worker). The request/reply counters live in the
        # store and survive the process, so a fresh agent starting at 0
        # would re-serve every request the dead incarnation already
        # consumed. Skip to the current high-water marks instead: calls
        # addressed to the dead incarnation stay unanswered (the caller's
        # future times out — its signal the worker died mid-call).
        self._served = self.store.add(f"rpc/cnt/{rank}", 0) if resume else 0
        self._seen = (self.store.add(f"rpc/rescnt/{rank}", 0)
                      if resume else 0)
        self._next_reply: Dict[int, Future] = {}
        # integrity accounting for the chunked bulk channel: per-part
        # sha256 mismatches that a re-fetch healed (a second mismatch is
        # a typed SlabTransferError, not a count). The cluster frontend
        # mirrors this into its /metrics as serving.cluster.slab_retries.
        self.transfer_retries = 0
        self._seq_lock = threading.Lock()
        self._stop = threading.Event()
        self._server = threading.Thread(target=self._serve, daemon=True)
        self._server.start()
        self._replier = threading.Thread(target=self._collect, daemon=True)
        self._replier.start()
        self._sent = 0

    # -- worker info -------------------------------------------------------
    def worker_info(self, name_or_rank) -> WorkerInfo:
        if isinstance(name_or_rank, int):
            nm = self.store.get(f"rpc/worker/{name_or_rank}").decode()
            return WorkerInfo(nm, name_or_rank)
        for r in range(self.world_size):
            try:
                nm = self.store.get(f"rpc/worker/{r}").decode()
            except Exception:
                continue
            if nm == name_or_rank:
                return WorkerInfo(nm, r)
        raise ValueError(f"unknown rpc worker {name_or_rank!r}")

    def all_worker_info(self):
        return [self.worker_info(r) for r in range(self.world_size)]

    # -- chunked store values ----------------------------------------------
    def _put(self, key: str, payload: bytes) -> None:
        """Store ``payload`` under ``key``, splitting values past the
        TCPStore client-buffer limit across ``{key}/part{i}`` keys. The
        parts land BEFORE the header, so any reader that observes the
        header value can fetch every part immediately. The header
        carries each part's sha256 — the slab/migration bulk channel
        verifies every part on fetch (a flipped bit in a shipped KV row
        must never scatter into a live carry)."""
        if len(payload) <= _CHUNK_BYTES:
            self.store.set(key, payload)
            return
        n = (len(payload) + _CHUNK_BYTES - 1) // _CHUNK_BYTES
        sha = []
        for i in range(n):
            part = payload[i * _CHUNK_BYTES:(i + 1) * _CHUNK_BYTES]
            sha.append(hashlib.sha256(part).hexdigest())
            self.store.set(f"{key}/part{i}", part)
        self.store.set(key, _CHUNK_MAGIC
                       + json.dumps({"n": n, "sha": sha}).encode())

    def _fetch(self, key: str, timeout: float) -> bytes:
        from paddle_tpu_torch.runtime.resilience import (SlabTransferError,
                                                   classify_error,
                                                   resilient_call)
        raw = self.store.wait(key, timeout=timeout)
        if not raw.startswith(_CHUNK_MAGIC):
            return raw
        hdr = raw[len(_CHUNK_MAGIC):]
        try:
            # pre-integrity header format: just the part count (a
            # resumed incarnation may still read a value its
            # predecessor wrote) — fetched unverified
            n, sha = int(hdr), None
        except ValueError:
            meta = json.loads(hdr)
            n, sha = int(meta["n"]), meta["sha"]

        def _get_verified(i: int) -> bytes:
            part = self.store.get(f"{key}/part{i}")
            got = hashlib.sha256(part).hexdigest()
            if got != sha[i]:
                raise SlabTransferError(
                    f"chunked transfer {key}/part{i} failed sha256 "
                    f"verification ({got[:16]}… != {sha[i][:16]}…) — "
                    f"refusing the corrupt payload", key=key, part=i)
            return part

        parts = []
        for i in range(n):
            if sha is None:
                parts.append(self.store.get(f"{key}/part{i}"))
                continue
            # one retry through the shared retry loop: a torn read
            # re-fetches clean (counted here AND as a RetryEvent, so
            # serving.cluster.slab_retries and resilience.retries
            # agree); real corruption — the stored bytes themselves
            # are wrong — mismatches again and the typed
            # SlabTransferError propagates
            parts.append(resilient_call(
                _get_verified, i, retries=1, backoff=0.05, jitter=0.5,
                site="distributed.rpc.chunk_fetch",
                classify=lambda e, phase: (
                    "transient" if isinstance(e, SlabTransferError)
                    else classify_error(e, phase)),
                on_event=self._count_transfer_retry))
        return b"".join(parts)

    def _count_transfer_retry(self, _ev) -> None:
        self.transfer_retries += 1

    # -- partitionable sends ------------------------------------------------
    def _send(self, peer: int, cnt_key: str, key_prefix: str, idx: int,
              payload: bytes) -> None:
        """One request/reply write, routed through the network-partition
        fault sites: a ``rpc_partition`` plan DROPS the message (the
        store never sees it — on this retransmit-free transport the
        peer's serial stream stalls at the missing index, exactly a
        partitioned link), ``rpc_delay`` delivers it from a background
        timer, and ``rpc_duplicate`` delivers it twice under a FRESH
        index so the receiver genuinely processes it again (duplicate
        replies resolve no future; duplicate requests are executed —
        worker-side submission dedupe is what keeps the fleet
        exactly-once). Rules match directionally on (this rank, peer
        rank), so asymmetric partitions are one-sided plans."""
        from paddle_tpu_torch.runtime.resilience import fault_injector
        action, delay = ("ok", 0.0)
        if fault_injector.active():
            action, delay = fault_injector.rpc_action(str(self.rank),
                                                      str(peer))
        if action == "drop":
            return
        if action == "delay":
            t = threading.Timer(delay, self._put,
                                args=(f"{key_prefix}/{idx}", payload))
            t.daemon = True
            t.start()
            return
        self._put(f"{key_prefix}/{idx}", payload)
        if action == "dup":
            idx2 = self.store.add(cnt_key, 1)
            self._put(f"{key_prefix}/{idx2}", payload)

    # -- client ------------------------------------------------------------
    def call(self, to, fn: Callable, args=(), kwargs=None,
             timeout: float = _DEFAULT_TIMEOUT) -> Future:
        dst = self.worker_info(to).rank if not isinstance(to, int) else to
        fut = Future()
        with self._seq_lock:
            seq = self.store.add(f"rpc/cnt/{dst}", 1)
            self._next_reply[(dst, seq)] = fut  # noqa: consumed by _collect
        payload = pickle.dumps((self.rank, seq, fn, args, kwargs or {}))
        self._send(dst, f"rpc/cnt/{dst}", f"rpc/req/{dst}", seq, payload)
        return fut

    def _collect(self):
        """Wait for replies addressed to this rank, in arrival order."""
        while not self._stop.is_set():
            try:
                raw = self._fetch(f"rpc/res/{self.rank}/{self._seen + 1}",
                                  timeout=0.25)
            except TimeoutError:
                continue
            except Exception:
                if self._stop.is_set():
                    return
                continue
            self._seen += 1
            dst, seq, ok, payload = pickle.loads(raw)
            fut = self._next_reply.pop((dst, seq), None)
            if fut is not None:
                fut._set(ok, payload)

    # -- server ------------------------------------------------------------
    def _serve(self):
        while not self._stop.is_set():
            nxt = self._served + 1
            try:
                raw = self._fetch(f"rpc/req/{self.rank}/{nxt}",
                                  timeout=0.25)
            except TimeoutError:
                continue
            except Exception:
                if self._stop.is_set():
                    return
                continue
            self._served = nxt
            src, seq, fn, args, kwargs = pickle.loads(raw)
            try:
                result = (True, fn(*args, **kwargs))
            except Exception as e:  # ship the exception back to the caller
                result = (False, e)
            try:
                payload = pickle.dumps((self.rank, seq) + result)
            except Exception as e:  # unpicklable result/exception: degrade
                payload = pickle.dumps(
                    (self.rank, seq, False,
                     RuntimeError(f"rpc result not picklable: {e}")))
            # reply stream is indexed by the CALLER's arrival order
            ridx = self.store.add(f"rpc/rescnt/{src}", 1)
            self._send(src, f"rpc/rescnt/{src}", f"rpc/res/{src}",
                       ridx, payload)

    def shutdown(self):
        self._stop.set()
        self._server.join(timeout=2)
        self._replier.join(timeout=2)


_agent: Optional[RpcAgent] = None


def init_rpc(name: str, rank: Optional[int] = None,
             world_size: Optional[int] = None,
             master_endpoint: Optional[str] = None) -> None:
    """python/paddle/distributed/rpc/rpc.py:init_rpc analog."""
    global _agent
    import os
    rank = int(os.environ.get("PADDLE_TRAINER_ID", 0)) if rank is None else rank
    world_size = (int(os.environ.get("PADDLE_TRAINERS_NUM", 1))
                  if world_size is None else world_size)
    host, port = "127.0.0.1", 0
    if master_endpoint:
        host, port = master_endpoint.rsplit(":", 1)
        port = int(port)
    _agent = RpcAgent(name, rank, world_size, host=host, port=port)


def _require_agent() -> RpcAgent:
    if _agent is None:
        raise RuntimeError("rpc not initialized; call init_rpc first")
    return _agent


def rpc_sync(to, fn: Callable, args=(), kwargs=None,
             timeout: float = _DEFAULT_TIMEOUT):
    return _require_agent().call(to, fn, args, kwargs,
                                 timeout).wait(timeout)


def rpc_async(to, fn: Callable, args=(), kwargs=None,
              timeout: float = _DEFAULT_TIMEOUT) -> Future:
    return _require_agent().call(to, fn, args, kwargs, timeout)


def get_current_worker_info() -> WorkerInfo:
    a = _require_agent()
    return WorkerInfo(a.name, a.rank)


def get_worker_info(name: str) -> WorkerInfo:
    return _require_agent().worker_info(name)


def get_all_worker_info():
    return _require_agent().all_worker_info()


def shutdown():
    global _agent
    if _agent is not None:
        _agent.shutdown()
        _agent = None
