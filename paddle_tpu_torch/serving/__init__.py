"""Continuous-batching serving: the slot scheduler, the engine, the
prefix cache and the LoRA adapter store."""

from paddle_tpu_torch.serving.engine import ServingEngine
from paddle_tpu_torch.serving.lora import (AdapterStore, AdapterVersionError,
                                           UnknownAdapterError)
from paddle_tpu_torch.serving.prefix_cache import PrefixCache, prefix_digests
from paddle_tpu_torch.serving.scheduler import (Request, Scheduler, Slot,
                                                SlotTable, bucket_length)

__all__ = ["ServingEngine", "AdapterStore", "AdapterVersionError",
           "UnknownAdapterError", "PrefixCache", "prefix_digests", "Request",
           "Scheduler", "Slot", "SlotTable", "bucket_length"]
