"""What the models share: the device, dtype and seeded generator every
layer of a GPT or BERT is built with, and token ids as long tensors on
the model's device."""

from __future__ import annotations

import numpy as np
import torch

from paddle_tpu_torch.device import resolve_device


def layer_kwargs(device, dtype, seed: int) -> dict:
    """``device`` (the card unless the caller asks otherwise), ``dtype``
    and one ``torch.Generator`` on that device seeded with ``seed``."""
    dev = resolve_device(device)
    return dict(device=dev, dtype=dtype,
                generator=torch.Generator(device=dev).manual_seed(int(seed)))


def as_ids(ids, device) -> torch.Tensor:
    """Token ids (a tensor or anything numpy takes) as int64 on
    ``device``."""
    if isinstance(ids, torch.Tensor):
        return ids.to(device, torch.long)
    return torch.as_tensor(np.asarray(ids), dtype=torch.long, device=device)
