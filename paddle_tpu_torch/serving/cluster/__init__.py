"""paddle_tpu_torch.serving.cluster — multi-process disaggregated serving.

Counterpart of ``paddle_tpu/serving/cluster``. The workers run on the card
unless the launcher is given ``device="cpu"``.

The in-process ``Router``/``ReplicaSet`` (serving/router.py) isolates
replica FAILURES but not replica PROCESSES: one interpreter still hosts
every carry, so a segfault, an OOM or a SIGKILL takes the whole pool.
This package is the multi-process form — the DistServe/Splitwise shape
over the repo's own control plane:

- :mod:`worker` — one OS process per worker, hosting ONE
  ``ServingEngine`` in ``prefill``/``decode``/``unified`` mode. It
  answers submit/step/prefill/snapshot ops over the TCPStore-backed
  ``RpcAgent``, heartbeats through an ``ElasticManager`` (nonce:seq over
  the same store), and serves its own ``/metrics``/``/statusz`` via an
  ``ObsExporter``.
- :mod:`frontend` — the :class:`ClusterRouter`: cache-affinity +
  least-loaded routing with a circuit breaker (the in-process router's
  policy, re-derived over RPC), where a missed PROCESS heartbeat or a
  dead socket is real replica death. Crashed decode work is requeued to
  a survivor as ``prompt + tokens_so_far`` replay (greedy bit-exact;
  sampled bit-exact under ``request_keyed_rng``) or the worker is
  restarted from its last atomic snapshot. The frontend aggregates every
  worker's live /metrics into one fleet exposition.
- :mod:`launch` — spawns the worker pool (stdlib subprocess), ships the
  model weights once as an npz, waits for registration, returns a
  :class:`Cluster` handle with kill/respawn hooks for fault drills.
  The TCPStore rendezvous lives in its own store-daemon process
  (:mod:`store_daemon`), so the control plane's death no longer takes
  the fleet's nervous system with it.
- :mod:`wal` — the frontend's durable :class:`WriteAheadLog`: an
  append-only, per-record-checksummed, segment-rotated log of every
  request lifecycle transition. A respawned
  ``ClusterRouter(resume_wal=...)`` replays it, re-adopts the live
  workers under a fresh fencing epoch (stale incarnations are refused
  typed ``StaleEpochError``), resumes rows the fleet still holds and
  ledger-replays the rest — bit-exact, exactly-once.
- :mod:`frontend_proc` — the frontend AS a process: the drill harness
  that spawns store daemon + workers + a killable frontend child and
  asserts zero-loss recovery across a frontend SIGKILL.

Disaggregation: prefill workers run the admission prefill and EXTRACT
the KV rows through the prefix-slab path (``engine.prefill_extract``);
decode workers ingest the shipped slab (``engine.load_prefix_slab``)
so admission there is ONE row-scatter — zero decode-pool prefill
dispatches for disaggregated requests.
"""

from paddle_tpu_torch.serving.cluster.frontend import (  # noqa: F401
    ClusterRouter,
    WorkerHandle,
)
from paddle_tpu_torch.serving.cluster.launch import (  # noqa: F401
    Cluster,
    launch_cluster,
    parse_cluster_spec,
)
from paddle_tpu_torch.serving.cluster.wal import (  # noqa: F401
    WriteAheadLog,
)

__all__ = ["ClusterRouter", "WorkerHandle", "Cluster", "launch_cluster",
           "parse_cluster_spec", "WriteAheadLog"]
