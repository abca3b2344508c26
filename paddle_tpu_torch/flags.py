"""Runtime switches of the PyTorch port, overridable from the environment.

Counterpart of ``paddle_tpu/flags.py`` (its own copy: the port imports
nothing of the JAX package). The flags the serving and training paths
read are declared, with the JAX package's names and defaults. The port
reads them only as flags: the JAX package's ``PADDLE_TPU_OBS*`` and
``PADDLE_TPU_FAULT_PLAN`` variables are its own. Read one as
``flags.<name>``; a ``FLAGS_<name>`` environment variable overrides its
default at first read, and ``set_flags`` overrides both.
"""

from __future__ import annotations

import os
from typing import Any, Dict

__all__ = ["set_flags", "flags"]

_TRUE = {"1", "true", "yes", "on"}
_FALSE = {"0", "false", "no", "off", ""}

_DEFAULTS: Dict[str, Any] = {
    # route single-token GQA cache attention through the CUDA
    # decode-attention kernel (ops/kernels/decode_attention.py); off, or
    # for MHA, the masked dense form runs instead
    "use_decode_attention": True,
    # default decode recipe for LlamaDecoder when neither quant= nor
    # weight_dtype= is passed: '' (fp32/bf16), 'int8w' (per-channel absmax
    # int8 weights, int8 matmul kernel) or 'int8wk' (int8w + int8 KV cache
    # with per-row absmax scales); PADDLE_TPU_DECODE_QUANT is equivalent
    "decode_quant": "",
    # serve LlamaDecoder.generate through the per-token host loop (one
    # counted dispatch and one host sync per token) instead of the fused
    # loop; PADDLE_TPU_DECODE_FALLBACK=1 is equivalent
    "decode_fallback": False,
    # default number of draft tokens proposed per speculative verify step
    # (K) when LlamaDecoder.generate is given a draft_model without an
    # explicit num_speculative_tokens
    "decode_speculative_tokens": 4,
    # byte budget of the serving engine's content-hashed prefix cache
    # (serving/prefix_cache.py); 0 disables it unless prefix_cache= asks
    "serving_prefix_cache_bytes": 0,
    # prefix-cache hash granularity: prompts are hashed at every multiple
    # of this many tokens, plus the full length
    "serving_prefix_block_tokens": 64,
    # route scaled_dot_product_attention through the CUDA flash-attention
    # kernels (ops/kernels/flash_attention.py) when there is no mask or
    # dropout and the key length is at least flash_attention_min_seq
    "use_fused_attention": True,
    "flash_attention_min_seq": 512,
    # route rms_norm through the CUDA RMSNorm kernels when eligible
    "use_fused_rms_norm": True,
    # route GroupNorm(+SiLU) through the CUDA GroupNorm kernels
    # (ops/kernels/group_norm.py) when eligible
    "use_fused_group_norm": True,
    # route rope through the CUDA rope kernel (ops/kernels/rope.py) when
    # eligible; off by default, as in the JAX package
    "use_fused_rope": False,
    # route large-vocab LM losses through the chunked-vocab fused head+CE
    # (ops/fused_ce.py) instead of materializing (T, V) logits
    "use_fused_lm_ce": True,
    # transient f32 logits budget (MB) of the chunked fused lm-head CE
    "fused_ce_logits_budget_mb": 1536,
    # run every fused op as its canonical unfused composition
    "decompose_fused_ops": False,
    # generator of the training step's key (dropout & co.): the port has
    # threefry2x32 only (the JAX package defaults to its TPU 'rbg')
    "train_rng_impl": "threefry2x32",
    # transient-error retries per device dispatch in
    # runtime/resilience.resilient_call (UNAVAILABLE / DEADLINE_EXCEEDED /
    # ABORTED, plus RESOURCE_EXHAUSTED during setup); 0 disables retrying
    "resilience_retries": 3,
    # base exponential-backoff delay (seconds) between retries: attempt i
    # sleeps base * 2**(i-1)
    "resilience_backoff_s": 0.5,
    # total wall-clock budget (seconds) a resilient_call may spend
    # retrying; 0 means no deadline
    "resilience_deadline_s": 0.0,
    # step the decode ladder down on a transient dispatch failure
    # (speculative -> chunked -> fused -> per-token), recording a typed
    # DegradationEvent per step; off, the first level's error propagates
    "resilience_auto_degrade": True,
    # master switch of the obs spine (paddle_tpu_torch/obs): dispatch
    # spans, obs counters, dispatch cost records; off, each instrumented
    # call pays one flag read
    "obs_enabled": False,
    # ring-buffer capacity (spans) of the global tracer
    "obs_buffer_size": 8192,
    # TCP port of the telemetry exporter (obs/exporter.py); 0 = none
    "obs_export_port": 0,
    # on an exhausted ladder, dump a postmortem JSON (obs/flight.py)
    "obs_flight_recorder": True,
    # how many of the newest spans a postmortem carries
    "obs_flight_spans": 256,
    # directory of postmortem dumps (empty = the working directory)
    "obs_flight_dir": "",
    # attach a dispatch cost record (FLOPs, bytes, peak bytes) to each
    # dispatch span, derived once per (site, input signature)
    "obs_cost_analysis": True,
}


# the prefixes of the flags that act around a dispatch, not inside it
_AROUND_DISPATCH = ("resilience_", "obs_")


def _parse(name: str, value: Any) -> Any:
    if not isinstance(_DEFAULTS[name], bool):
        return type(_DEFAULTS[name])(value)
    if not isinstance(value, str):
        return bool(value)
    v = value.strip().lower()
    if v in _TRUE:
        return True
    if v in _FALSE:
        return False
    raise ValueError(f"cannot parse boolean flag {name}={value!r}")


class _Flags:
    def __init__(self) -> None:
        self._values: Dict[str, Any] = {}

    def __getattr__(self, name: str) -> Any:
        if name not in _DEFAULTS:
            raise AttributeError(f"undefined flag {name!r}")
        if name not in self._values:
            env = os.environ.get("FLAGS_" + name)
            self._values[name] = (_DEFAULTS[name] if env is None
                                  else _parse(name, env))
        return self._values[name]

    def get(self, name: str) -> Any:
        return getattr(self, name)

    def names(self) -> list:
        return list(_DEFAULTS)

    def snapshot(self) -> tuple:
        """Every declared flag's current value, as (name, value) pairs in
        declaration order: what a captured training step is keyed on,
        since a replay runs whatever route the flags chose at its
        capture."""
        return tuple((n, getattr(self, n)) for n in _DEFAULTS)

    def route_snapshot(self) -> tuple:
        """``snapshot()`` without the ``resilience_*`` and ``obs_*``
        flags: what the decoder's captured chunks and prefills are keyed
        on. Those flags act around a dispatch (its retries, span and cost
        record), never inside the captured work, so switching obs on or
        off replays the graphs it has."""
        return tuple((n, getattr(self, n)) for n in _DEFAULTS
                     if not n.startswith(_AROUND_DISPATCH))


flags = _Flags()


def set_flags(d: Dict[str, Any]) -> None:
    for name, value in d.items():
        if name not in _DEFAULTS:
            raise KeyError(f"undefined flag {name!r}")
        flags._values[name] = _parse(name, value)
