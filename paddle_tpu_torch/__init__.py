"""paddle_tpu_torch — the PyTorch and CUDA port of paddle_tpu.

A second package beside the JAX one, with its module paths and public
names: ``models.llama``, ``models.unet``, ``inference.generate``,
``serving``, ``quantization``, ``nn.functional``, ``nn.layers``,
``incubate.nn.functional``, ``optimizer`` (with ``lr``), ``amp``,
``distributed.checkpoint``, ``parallel.train`` and the
hand-written CUDA kernels under ``ops/kernels`` (sources in ``csrc/``).
It imports ``torch`` and numpy, never ``jax`` and nothing of
``paddle_tpu``. Entry points run on the card (``cuda``) unless the caller
passes ``device="cpu"``.

Submodules load on first attribute access, so ``import paddle_tpu_torch``
stays cheap.
"""

from __future__ import annotations

import importlib

from paddle_tpu_torch import flags  # noqa: F401

__version__ = "0.1.0"

_LAZY = {
    "LlamaConfig": "paddle_tpu_torch.models.llama",
    "LlamaForCausalLM": "paddle_tpu_torch.models.llama",
    "UNetConfig": "paddle_tpu_torch.models.unet",
    "UNet2DConditionModel": "paddle_tpu_torch.models.unet",
    "LlamaDecoder": "paddle_tpu_torch.inference.generate",
    "DecodeState": "paddle_tpu_torch.inference.generate",
    "ServingEngine": "paddle_tpu_torch.serving.engine",
    "ShardedTrainer": "paddle_tpu_torch.parallel.train",
    "from_jax_state_dict": "paddle_tpu_torch.convert",
    "to_numpy_state_dict": "paddle_tpu_torch.convert",
}
_SUBMODULES = ("models", "inference", "serving", "quantization", "ops",
               "runtime", "convert", "device", "nn", "optimizer", "parallel",
               "incubate", "obs", "amp", "distributed")

__all__ = ["flags", "__version__", *_LAZY, *_SUBMODULES]


def __getattr__(name):
    if name in _LAZY:
        return getattr(importlib.import_module(_LAZY[name]), name)
    if name in _SUBMODULES:
        return importlib.import_module(f"paddle_tpu_torch.{name}")
    raise AttributeError(f"module 'paddle_tpu_torch' has no attribute "
                         f"{name!r}")
