"""AMP, mixed precision: ``auto_cast`` with the JAX package's white and
black lists, ``GradScaler`` for f16, and ``decorate`` (O2).

Counterpart of ``paddle_tpu/amp``; ``debugging`` is a typed refusal
until the op registry it hooks is ported (ROADMAP.md section 1, item
14.1)."""

from paddle_tpu_torch.amp import debugging
from paddle_tpu_torch.amp.auto_cast import (amp_guard, amp_state, auto_cast,
                                            black_list, decorate,
                                            is_auto_cast_enabled, white_list)
from paddle_tpu_torch.amp.grad_scaler import AmpScaler, GradScaler

__all__ = ["auto_cast", "amp_guard", "is_auto_cast_enabled", "amp_state",
           "white_list", "black_list", "decorate", "GradScaler",
           "AmpScaler", "debugging"]
