"""paddle_tpu_torch.inference: the decoder and the deployment predictor.

Counterpart of ``paddle_tpu/inference/__init__.py``: ``Config``,
``Predictor`` and ``create_predictor`` (the reference's AnalysisPredictor
surface) over an AOT bundle (``set_aot_bundle``: ``torch.export``
programs with the weights baked in, ``inference/bundle.py``) or over a
live ``nn.Module`` (``set_layer``, run eagerly under ``no_grad``). Names
load on first use, so a process that serves a bundle imports neither the
decoder (``inference/generate.py``) nor the model code.
"""

from __future__ import annotations

import importlib
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from paddle_tpu_torch.device import resolve_device

__all__ = ["Config", "Predictor", "create_predictor"]

_LAZY = {
    "DecodeState": "paddle_tpu_torch.inference.generate",
    "LlamaDecoder": "paddle_tpu_torch.inference.generate",
    "save_compiled": "paddle_tpu_torch.inference.aot",
    "load_compiled": "paddle_tpu_torch.inference.aot",
    "read_meta": "paddle_tpu_torch.inference.aot",
    "AotPredictor": "paddle_tpu_torch.inference.bundle",
    "export_predict_bundle": "paddle_tpu_torch.inference.bundle",
    "export_decoder_bundle": "paddle_tpu_torch.inference.bundle",
    "MeshMismatchError": "paddle_tpu_torch.inference.sharding",
}
__all__ += list(_LAZY)


def __getattr__(name):
    if name in _LAZY:
        return getattr(importlib.import_module(_LAZY[name]), name)
    raise AttributeError(f"module 'paddle_tpu_torch.inference' has no "
                         f"attribute {name!r}")


class Config:
    """paddle_infer.Config analog. The device is ``cuda`` unless
    ``disable_gpu()`` asks for the CPU."""

    def __init__(self, model_path: Optional[str] = None,
                 params_path: Optional[str] = None):
        self.model_path = model_path
        self.params_path = params_path
        self._device = None
        self._memory_optim = True
        self._layer = None
        self._aot_dir = None
        self._warmup = False
        self._cast_inputs = True
        self._bucket_padding = True

    def enable_warmup(self, flag: bool = True):
        """Run every AOT entry once at load: the first request pays no
        load or first-call latency."""
        self._warmup = flag

    def set_cast_inputs(self, flag: bool):
        """Cast feeds to each bucket's exported dtype (default on)."""
        self._cast_inputs = flag

    def set_bucket_padding(self, flag: bool):
        """Serve smaller batches by padding to the nearest bucket (default
        on; turn it off for models with batch-coupled outputs)."""
        self._bucket_padding = flag

    def set_aot_bundle(self, bundle_dir: str):
        """Serve from an AOT bundle (``inference/bundle.py``): programs
        with their weights baked in; the serving process imports no model
        Python."""
        self._aot_dir = bundle_dir

    def set_model(self, model_path: str, params_path: Optional[str] = None):
        self.model_path = model_path
        self.params_path = params_path

    def set_layer(self, layer):
        """Predict directly from a live ``nn.Module``."""
        self._layer = layer

    def enable_memory_optim(self, flag: bool = True):
        self._memory_optim = flag

    def disable_gpu(self):
        self._device = "cpu"

    def enable_use_gpu(self, *a, **k):
        self._device = "cuda"


class _IOHandle:
    def __init__(self, predictor, name):
        self._p = predictor
        self.name = name

    def copy_from_cpu(self, arr: np.ndarray):
        self._p._feeds[self.name] = np.asarray(arr)

    def reshape(self, shape):
        pass

    def copy_to_cpu(self) -> np.ndarray:
        return self._p._results[self.name]


class Predictor:
    def __init__(self, config: Config):
        self.config = config
        self._feeds: Dict[str, np.ndarray] = {}
        self._results: Dict[str, np.ndarray] = {}
        if config._aot_dir is not None:
            from paddle_tpu_torch.inference.bundle import AotPredictor
            self._aot = AotPredictor(
                config._aot_dir, device=config._device,
                warmup=config._warmup, cast_inputs=config._cast_inputs,
                allow_bucket_padding=config._bucket_padding)
            self._layer = None
            self._input_names = self._aot.get_input_names()
            self._output_names = self._aot.get_output_names()
            return
        self._aot = None
        if config._layer is not None:
            self._layer = config._layer
        elif config.model_path is not None:
            raise NotImplementedError(
                "Config.set_model(path) needs jit.load, which is not ported "
                "to paddle_tpu_torch yet (ROADMAP.md queue 1: [16] jit/); "
                "use set_layer(module) or set_aot_bundle(dir)")
        else:
            raise ValueError("Config needs set_model(path) or set_layer(layer)")
        self._device = resolve_device(config._device)
        if hasattr(self._layer, "eval"):
            self._layer.eval()
        self._input_names: List[str] = ["x"]
        self._output_names: List[str] = ["out"]

    def get_input_names(self) -> List[str]:
        return list(self._input_names)

    def get_output_names(self) -> List[str]:
        return list(self._output_names)

    def get_input_handle(self, name: str) -> _IOHandle:
        if name not in self._input_names:
            self._input_names.append(name)
        return _IOHandle(self, name)

    def get_output_handle(self, name: str) -> _IOHandle:
        return _IOHandle(self, name)

    def run(self, inputs: Optional[Sequence[np.ndarray]] = None):
        if self._aot is not None:
            feeds = dict(self._feeds)
            if inputs is not None:
                feeds = {n: np.asarray(a)
                         for n, a in zip(self._input_names, inputs)}
            self._results = self._aot.run(feeds)
            self._output_names = list(self._aot.get_output_names())
            if inputs is not None:
                return [self._results[n] for n in self._output_names]
            return True
        arrs = (list(inputs) if inputs is not None
                else [self._feeds[n] for n in self._input_names
                      if n in self._feeds])
        args = [torch.as_tensor(np.asarray(a), device=self._device)
                for a in arrs]
        with torch.no_grad():
            out = self._layer(*args)
        outs = out if isinstance(out, (list, tuple)) else [out]
        self._output_names = [f"out_{i}" for i in range(len(outs))] \
            if len(outs) > 1 else ["out"]
        self._results = {n: o.detach().cpu().numpy()
                         for n, o in zip(self._output_names, outs)}
        if inputs is not None:
            return [self._results[n] for n in self._output_names]
        return True

    def memory_report(self):
        """AOT bundles: artifact and serving-cache sizes
        (``AotPredictor.memory_report``)."""
        if self._aot is not None:
            return self._aot.memory_report()
        raise ValueError("memory_report requires an AOT bundle predictor")

    def generate(self, input_ids, max_new_tokens: int = 32,
                 max_len: int = 512, eos_token_id=None,
                 do_sample: bool = False, temperature=None,
                 top_k=None, top_p=None, seed: int = 0,
                 draft_model=None, num_speculative_tokens=None
                 ) -> np.ndarray:
        """Decode. AOT bundles take eos id, seed and temperature at run
        time; ``do_sample`` / ``top_k`` / ``top_p`` and any draft model
        were fixed at export (``bundle.json``'s ``decode_mode``), so pass
        ``draft_model`` to ``export_decoder_bundle``, not here. A layer
        predictor decodes through a ``LlamaDecoder`` on the config's
        device."""
        if self._aot is not None:
            if draft_model is not None or num_speculative_tokens is not None:
                raise ValueError(
                    "AOT bundles bake the draft model at export time; "
                    "pass draft_model to export_decoder_bundle, not to "
                    "generate()")
            return self._aot.generate(input_ids,
                                      max_new_tokens=max_new_tokens,
                                      eos_token_id=eos_token_id,
                                      do_sample=do_sample,
                                      temperature=temperature, seed=seed)
        from paddle_tpu_torch.inference.generate import LlamaDecoder
        dec = getattr(self, "_decoder", None)
        if dec is None or dec.max_len < max_len:
            dec = LlamaDecoder(self._layer, max_len=max_len,
                               device=self._device)
            self._decoder = dec
        return dec.generate(input_ids, max_new_tokens=max_new_tokens,
                            eos_token_id=eos_token_id, do_sample=do_sample,
                            temperature=(1.0 if temperature is None
                                         else temperature),
                            top_k=top_k, top_p=top_p, seed=seed,
                            draft_model=draft_model,
                            num_speculative_tokens=num_speculative_tokens)


def create_predictor(config: Config) -> Predictor:
    return Predictor(config)
