"""Continuous-batching serving: the slot scheduler and the engine."""

from paddle_tpu_torch.serving.engine import ServingEngine
from paddle_tpu_torch.serving.scheduler import (Request, Scheduler, Slot,
                                                SlotTable, bucket_length)

__all__ = ["ServingEngine", "Request", "Scheduler", "Slot", "SlotTable",
           "bucket_length"]
