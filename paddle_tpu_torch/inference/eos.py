"""End-of-sequence helpers shared by the decoder and the AOT predictor.

They live apart from ``inference/generate.py`` so that a process serving
an AOT bundle (``inference/bundle.py``) imports neither the decoder nor
the model code.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

__all__ = ["_normalize_eos", "_trim_after_eos"]


def _normalize_eos(eos_token_id) -> Optional[int]:
    """``None`` or any negative id (the bundles' ``-1``) means no eos."""
    if eos_token_id is None:
        return None
    e = int(eos_token_id)
    return None if e < 0 else e


def _trim_after_eos(toks: np.ndarray, eos_token_id: int) -> np.ndarray:
    """Drop columns past the point where every row has emitted eos; a row
    whose first token is eos keeps length 1."""
    hit = toks == eos_token_id
    n = toks.shape[1]
    first = np.where(hit.any(axis=1), hit.argmax(axis=1), n - 1)
    return toks[:, :int(first.max()) + 1]
