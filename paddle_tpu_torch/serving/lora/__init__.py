"""paddle_tpu_torch.serving.lora — batched multi-tenant LoRA adapters.

``AdapterStore`` registers named low-rank (A, B) delta pairs and stacks
them into ``(N+1, ...)`` arrays that the decoder gathers per batch row
(``DecodeState.adapter_idx``): mixed-tenant batches decode in one chunk
dispatch. See store.py for the hot-swap and revision contract.
"""

from paddle_tpu_torch.serving.lora.store import (  # noqa: F401
    AdapterStore,
    AdapterVersionError,
    UnknownAdapterError,
)

__all__ = ["AdapterStore", "AdapterVersionError", "UnknownAdapterError"]
