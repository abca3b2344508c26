"""Global RNG state: the stream dropout and other random ops draw from.

Counterpart of ``paddle_tpu/framework/random.py`` over the port's
threefry2x32 (``paddle_tpu_torch/random.py``, bit-equal to ``jax.random``):

- ``Generator(seed)`` holds a key, ``(0, seed)`` as ``jax.random.key``
  makes it; ``split(num)`` splits it into ``num + 1`` keys, keeps the
  first as the new state and hands out the rest, as the JAX generator
  does outside a trace. The key moves to the device of the data drawn
  with it at its first draw there and stays, so a draw on the card
  splits it on the card (no host copy) and updates it in place (a
  captured draw advances it at every replay).
- ``push_trace_key`` / ``pop_trace_key``: a training step pushes a key
  made on the device from its step counter; while a key is pushed,
  ``split_key`` splits that key (``split(top, num + 1)``, the first kept
  on the stack), so every replay of a captured step draws fresh masks
  from the counter it bumps.
- ``seed(s)`` resets the default generator; ``split_key(num)`` is what
  the random ops call.

The JAX generator's in-trace ``fold_in`` route has no counterpart: the
port traces nothing, and a captured step draws from its pushed key.
"""

from __future__ import annotations

import threading
from typing import List, Optional

import torch

from paddle_tpu_torch import random as _rnd

__all__ = ["Generator", "seed", "get_rng_state", "split_key",
           "push_trace_key", "pop_trace_key", "in_trace"]


class Generator:
    """A splittable stream over one threefry key, on the device of the
    last draw (the CPU until the first)."""

    def __init__(self, seed_: int = 0):
        self._key = _rnd.PRNGKey(seed_, device="cpu")
        self._lock = threading.Lock()

    def manual_seed(self, seed_: int) -> "Generator":
        with self._lock, torch.inference_mode(False):
            self._key = _rnd.PRNGKey(seed_, device=self._key.device)
        return self

    def split(self, num: int = 1, device=None) -> List[torch.Tensor]:
        """``num`` fresh subkeys on ``device`` (the key's own by default),
        advancing the stream."""
        # a normal tensor even when the first draw is made under
        # inference mode, so that later draws can update it in place
        with self._lock, torch.inference_mode(False):
            if device is not None and self._key.device != torch.device(
                    device):
                self._key = self._key.to(device)
            keys = _rnd.split(self._key, num + 1)
            self._key.copy_(keys[0])
            return list(keys[1:])

    def get_state(self) -> torch.Tensor:
        return self._key.clone()


class _TraceKeyStack(threading.local):
    def __init__(self):
        self.stack: List[torch.Tensor] = []


_trace_keys = _TraceKeyStack()


def push_trace_key(key: torch.Tensor) -> None:
    _trace_keys.stack.append(key)


def pop_trace_key() -> None:
    _trace_keys.stack.pop()


def in_trace() -> bool:
    return bool(_trace_keys.stack)


_default = Generator(0)


def seed(s: int) -> Generator:
    """``paddle.seed``: reset the default generator."""
    return _default.manual_seed(int(s))


def split_key(num: int = 1, generator: Optional[Generator] = None,
              device=None):
    """One key (``num == 1``) or a list of ``num`` keys: split off the
    pushed step key when there is one, else off ``generator`` (the
    default one), on ``device``."""
    if _trace_keys.stack:
        keys = _rnd.split(_trace_keys.stack[-1], num + 1)
        _trace_keys.stack[-1] = keys[0]
        return keys[1] if num == 1 else list(keys[1:])
    keys = (generator or _default).split(num, device)
    return keys[0] if num == 1 else keys


def get_rng_state() -> torch.Tensor:
    return _default.get_state()
