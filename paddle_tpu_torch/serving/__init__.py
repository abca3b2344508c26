"""Continuous-batching serving: the slot scheduler, the engine and the
prefix cache."""

from paddle_tpu_torch.serving.engine import ServingEngine
from paddle_tpu_torch.serving.prefix_cache import PrefixCache, prefix_digests
from paddle_tpu_torch.serving.scheduler import (Request, Scheduler, Slot,
                                                SlotTable, bucket_length)

__all__ = ["ServingEngine", "PrefixCache", "prefix_digests", "Request",
           "Scheduler", "Slot", "SlotTable", "bucket_length"]
