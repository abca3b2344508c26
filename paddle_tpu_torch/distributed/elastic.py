"""Elastic training manager.

Counterpart of ``paddle_tpu/distributed/elastic.py``
(the port's own copy: it imports nothing of the JAX package).

Redesign of python/paddle/distributed/fleet/elastic/manager.py
(ElasticManager:124): the reference registers nodes in etcd with TTL
heartbeats and relaunches on membership change. Here the
native TCPStore plays the etcd role (no external dependency), nodes
register with heartbeats, the manager watches membership within an
``np="min:max"`` range and signals scale events so the launcher restarts
training from the latest distributed checkpoint.

Liveness is judged with OBSERVER-LOCAL ``time.monotonic()`` bookkeeping,
not sender wall-clock timestamps: each heartbeat publishes an opaque
monotonically-changing value (boot nonce + sequence number), and every
observer tracks when it last SAW each node's value change on its own
monotonic clock. Consequences: NTP steps / wall-clock adjustments can't
expire healthy members or resurrect dead ones, the scheme needs no
clock agreement between hosts, and a node restart (fresh nonce) reads
as a change — no stale-sequence collision. Heartbeats route through the
fault injector (``dead_heartbeat`` / ``delay_heartbeat`` plans), so
preemption drills run without killing real processes.
"""

from __future__ import annotations

import os
import threading
import time
from typing import Callable, Dict, List, Optional, Tuple

__all__ = ["ElasticManager", "ElasticStatus"]


class ElasticStatus:
    COMPLETED = "completed"
    ERROR = "error"
    HOLD = "hold"
    RESTART = "restart"
    EXIT = "exit"


class ElasticManager:
    def __init__(self, store, node_id: str, np_range: str = "1:1",
                 heartbeat_s: float = 5.0, ttl_s: float = 15.0,
                 on_scale: Optional[Callable[[List[str]], None]] = None):
        self.store = store
        self.node_id = node_id
        lo, _, hi = np_range.partition(":")
        self.np_min = int(lo)
        self.np_max = int(hi or lo)
        self.heartbeat_s = heartbeat_s
        self.ttl_s = ttl_s
        self.on_scale = on_scale
        self._stop = threading.Event()
        self._members: List[str] = []
        self._thread: Optional[threading.Thread] = None
        # boot nonce: a restarted node's fresh sequence can never collide
        # with the value an observer cached from its previous life
        self._nonce = f"{os.getpid():x}-{id(self):x}"
        self._seq = 0
        # observer-local liveness: node -> (last value seen, monotonic
        # time the value last CHANGED on THIS observer's clock)
        self._seen: Dict[str, Tuple[bytes, float]] = {}

    # -- registry (manager.py:217 heartbeat analog over TCPStore) ----------
    def _beat(self):
        from paddle_tpu_torch.runtime.resilience import fault_injector
        if fault_injector.heartbeat_action(self.node_id) != "ok":
            return    # injected dead/delayed heartbeat (preemption drill)
        self._seq += 1
        self.store.set(f"__elastic__/node/{self.node_id}",
                       f"{self._nonce}:{self._seq}".encode())

    def _alive_nodes(self) -> List[str]:
        now = time.monotonic()
        alive = []
        idx = self.store.get("__elastic__/index")
        known = (idx.decode().split(",") if idx else [])
        if self.node_id not in known:
            known.append(self.node_id)
            self.store.set("__elastic__/index", ",".join(sorted(known)))
        for nid in known:
            v = self.store.get(f"__elastic__/node/{nid}")
            if v is None:
                continue
            prev = self._seen.get(nid)
            if prev is None or prev[0] != v:
                self._seen[nid] = (v, now)   # value changed: beat observed
                alive.append(nid)
            elif now - prev[1] < self.ttl_s:
                alive.append(nid)
        return sorted(alive)

    def start(self):
        self._beat()
        self._members = self._alive_nodes()
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()
        return self

    def _loop(self):
        while not self._stop.wait(self.heartbeat_s):
            self._beat()
            members = self._alive_nodes()
            if members != self._members:
                old, self._members = self._members, members
                if self.on_scale is not None:
                    self.on_scale(members)

    @property
    def members(self) -> List[str]:
        return list(self._members)

    def beat_age(self, node_id: str) -> Optional[float]:
        """Seconds (this observer's monotonic clock) since ``node_id``'s
        heartbeat value last CHANGED — the early-warning signal between
        "beating normally" and "TTL-expired dead". None for a node this
        observer has never seen beat. Refreshes the observation first,
        so a caller polling between sweep intervals sees a just-landed
        beat, not the stale age from the last sweep."""
        self._alive_nodes()
        prev = self._seen.get(node_id)
        return None if prev is None else time.monotonic() - prev[1]

    def wait_for(self, node_ids, timeout_s: float = 10.0) -> List[str]:
        """Block until every node in ``node_ids`` is alive on THIS
        observer's clock (a fresh observer starts with an empty
        ``_seen`` table — a respawned frontend must wait one beat per
        worker before judging liveness). Returns the alive set; raises
        ``TimeoutError`` naming the stragglers."""
        want = {str(n) for n in node_ids}
        deadline = time.monotonic() + float(timeout_s)
        while True:
            alive = set(self._alive_nodes())
            if want <= alive:
                return sorted(alive)
            if time.monotonic() >= deadline:
                raise TimeoutError(
                    f"nodes {sorted(want - alive)} not alive within "
                    f"{timeout_s:.1f}s (alive: {sorted(alive)})")
            time.sleep(min(0.05, self.heartbeat_s / 4))

    def status(self) -> str:
        n = len(self._members)
        if n < self.np_min:
            return ElasticStatus.HOLD     # wait for quorum
        return ElasticStatus.RESTART if self._scale_pending() else "ok"

    def _scale_pending(self) -> bool:
        return self._alive_nodes() != self._members

    def adopt_members(self, members) -> dict:
        """Atomically adopt a quorum snapshot as the authoritative
        membership for the next incarnation and return its PADDLE_* env.
        The one entry point launchers should use: it keeps the snapshot
        used for scale-change detection and the env handed to the worker
        consistent even while the heartbeat loop keeps rewriting state."""
        self._members = list(members)
        return self.endpoints_env(members)

    def endpoints_env(self, members=None) -> dict:
        """Rewritten PADDLE_* env for the relaunch (manager.py endpoint
        rewrite analog). Pass an explicit ``members`` snapshot when the
        caller must stay consistent with a quorum it just observed (the
        background loop mutates self._members every heartbeat)."""
        if members is None:
            members = self._members
        return {
            "PADDLE_TRAINERS_NUM": str(len(members)),
            "PADDLE_TRAINER_ID": str(members.index(self.node_id)
                                     if self.node_id in members else 0),
        }

    def stop(self):
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=2)
