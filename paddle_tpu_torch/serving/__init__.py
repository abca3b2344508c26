"""Continuous-batching serving: the slot scheduler, the engine, the
prefix cache, the LoRA adapter store, the replicated router, the
streaming HTTP front-end and the multi-process cluster."""

from paddle_tpu_torch.serving.cluster import (Cluster, ClusterRouter,
                                              WorkerHandle, launch_cluster,
                                              parse_cluster_spec)
from paddle_tpu_torch.serving.engine import ServingEngine
from paddle_tpu_torch.serving.http import DrainingError, HttpFrontend
from paddle_tpu_torch.serving.lora import (AdapterStore, AdapterVersionError,
                                           UnknownAdapterError)
from paddle_tpu_torch.serving.prefix_cache import PrefixCache, prefix_digests
from paddle_tpu_torch.serving.router import Replica, ReplicaSet, Router
from paddle_tpu_torch.serving.scheduler import (Request, Scheduler, Slot,
                                                SlotTable, bucket_length)

__all__ = ["ServingEngine", "AdapterStore", "AdapterVersionError",
           "UnknownAdapterError", "PrefixCache", "prefix_digests", "Request",
           "Scheduler", "Slot", "SlotTable", "bucket_length", "Replica",
           "ReplicaSet", "Router", "Cluster", "ClusterRouter",
           "WorkerHandle", "launch_cluster", "parse_cluster_spec",
           "HttpFrontend", "DrainingError"]
