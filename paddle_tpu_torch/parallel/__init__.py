"""Training on the card: ``ShardedTrainer``."""

from paddle_tpu_torch.parallel.train import ShardedTrainer

__all__ = ["ShardedTrainer"]
