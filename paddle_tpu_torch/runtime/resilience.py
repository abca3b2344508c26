"""Decode result carrier.

Counterpart of ``paddle_tpu/runtime/resilience.py:GenerateResult``. The
retry and degradation ladder of the JAX package is not ported yet
(ROADMAP queue 1); the record a result carries names the decode level
that produced it.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

__all__ = ["GenerateResult"]


class GenerateResult(np.ndarray):
    """An ``np.ndarray`` of tokens that also carries the record of the
    generate/serve call that produced it (``.resilience``)."""

    resilience: Optional[dict] = None

    @classmethod
    def wrap(cls, arr: np.ndarray, resilience: Optional[dict]):
        obj = np.asarray(arr).view(cls)
        obj.resilience = resilience
        return obj

    def __array_finalize__(self, obj):
        if obj is not None:
            self.resilience = getattr(obj, "resilience", None)
