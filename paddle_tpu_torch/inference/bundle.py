"""AOT predictor bundles: serving with no model Python.

Counterpart of ``paddle_tpu/inference/bundle.py``. Each entry of a bundle
is one ``torch.export`` program (``inference/aot.py``) with the decoder's
weights baked in as its own weights, so one entry file runs alone; the
serving process imports neither the model code nor the decoder
(``inference/generate.py``), loads no separate weights file and unpickles
nothing. Shapes are static: one entry per declared shape bucket.

The layout is the JAX package's, file name for file name and key for key
(``bundle.json``, ``predict_<shapes>.aot``, ``prefill_b{B}_s{S}.aot``,
``decode_b{B}_n{N}.aot``, ``decode_plain_b{B}_n{N}.aot``,
``draft_prefill_b{B}_s{S}.aot``, ``decode_chunk_b{B}_t{T}.aot``,
``admit_prefill_s{S}.aot``; ``decode_mode`` with its ``quant``,
``speculative`` and ``chunked`` records; the sha256 ``manifest``), with
numpy dtype names, plus one key of its own: ``program_format``, the
program format and the device type the entries were exported on (a
``cuda`` bundle serves on a card, a ``cpu`` bundle on the CPU).

Where the JAX package compiles a whole ``lax.scan`` into one module, an
entry here holds the loop BODY (``inference/entries.py``: one fused decode
step, one chunk step, one speculative round) and its loop count sits in
the metadata (``steps``, ``chunk``); ``AotPredictor`` runs the body that
many times as one counted dispatch, the port's mapping of ``lax.scan``.
A plain decode bucket of N steps runs its body N + 1 times: the last run
makes the final pick, and its forward, one cache slot past the tokens
served, is discarded. The speculative loop's trip count depends on the
data: its entry is one round, with the host check between rounds that
``LlamaDecoder``'s loop makes. On a card each entry call (prefill, a
decode bucket's N + 1 bodies, a chunk's T bodies, a round) after the
first of its key replays one CUDA graph of the loaded program, captured in
thread-local mode; the first runs eagerly.

``AotPredictor.run`` serves predict bundles by named inputs and outputs,
``generate`` decoder bundles (prefill at the (B, S) bucket, the decode at
the smallest bucket that holds the request, the speculative ladder down
to a plain bucket under faults), and ``ServingEngine(AotPredictor(dir))``
serves a bundle exported with ``chunk_sizes=`` (``serving/engine.py``).
"""

from __future__ import annotations

import collections
import hashlib
import io
import json
import os
import zipfile
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from paddle_tpu_torch import obs
from paddle_tpu_torch import random as rnd
from paddle_tpu_torch.device import resolve_device
from paddle_tpu_torch.flags import flags
from paddle_tpu_torch.inference.aot import (PROGRAM_FORMAT,
                                            ForeignProgramError,
                                            archive_bytes, export_program,
                                            load_program, read_entry,
                                            save_program, write_entry)
from paddle_tpu_torch.inference.eos import _normalize_eos, _trim_after_eos
from paddle_tpu_torch.ops import kernels as _kernels
from paddle_tpu_torch.quantization.kv_cache import (QuantMismatchError,
                                                    canonical_quant,
                                                    is_quantized_kv)
from paddle_tpu_torch.runtime.resilience import (DecodeFailedError,
                                                 DegradationEvent,
                                                 GenerateResult,
                                                 atomic_write_bytes,
                                                 classify_error,
                                                 fault_injector,
                                                 record_event,
                                                 resilient_call)

__all__ = ["export_predict_bundle", "export_decoder_bundle", "AotPredictor",
           "BundleDeviceError"]

_META = "bundle.json"
# captured entry graphs a predictor keeps (each holds its own memory
# pool): a bundle served by an engine uses one chunk key, the rung's, and
# one per admission bucket; generate() one per prefill and decode bucket
_GRAPHS = 32


class BundleDeviceError(ValueError):
    """A bundle's programs were exported on another device type than the
    predictor serves on (their weights and device constants live there)."""


def _np_name(dtype: torch.dtype) -> str:
    """A torch dtype under numpy's name (``"float32"``, ``"bfloat16"``)."""
    return str(dtype).rsplit(".", 1)[-1]


def _torch_dtype(name: str) -> torch.dtype:
    return getattr(torch, name)


def _write_meta(out_dir: str, meta: dict) -> None:
    """bundle.json, written crash-safe (temp + atomic rename)."""
    atomic_write_bytes(os.path.join(out_dir, _META),
                       json.dumps(meta, indent=2).encode())


def _format_record(device: torch.device) -> dict:
    return {"format": PROGRAM_FORMAT, "device": device.type,
            "torch": torch.__version__}


def _output_shapes(ep) -> List[tuple]:
    """The user outputs' shapes of an ``ExportedProgram``."""
    out = next(n for n in ep.graph.nodes if n.op == "output")
    return [tuple(v.meta["val"].shape)
            for v, spec in zip(out.args[0], ep.graph_signature.output_specs)
            if spec.kind.name == "USER_OUTPUT"]


def export_predict_bundle(layer, example_inputs: Sequence, out_dir: str,
                          input_names: Optional[List[str]] = None,
                          output_names: Optional[List[str]] = None,
                          extra_batch_sizes: Sequence[int] = ()) -> None:
    """Export a plain forward ``nn.Module`` as an AOT bundle.

    ``example_inputs`` (arrays or tensors) fixes the primary shape bucket;
    each entry of ``extra_batch_sizes`` adds another with the leading dim
    replaced. The layer's weights are baked into each entry; the entries
    run on the device of the layer's parameters."""
    if hasattr(layer, "eval"):
        layer.eval()
    dev = next((t.device for t in layer.parameters()), torch.device("cpu"))
    examples = [torch.as_tensor(np.asarray(a) if not torch.is_tensor(a)
                                else a).to(dev) for a in example_inputs]
    os.makedirs(out_dir, exist_ok=True)
    shapes_list = [tuple(tuple(a.shape) for a in examples)]
    for b in extra_batch_sizes:
        shapes_list.append(tuple((int(b),) + tuple(a.shape[1:])
                                 for a in examples))
    buckets, manifest, outs0 = [], {}, None
    for shapes in shapes_list:
        args = [torch.zeros(s, dtype=a.dtype, device=dev)
                for s, a in zip(shapes, examples)]
        tag = "predict_" + "_".join("x".join(map(str, s)) for s in shapes)
        ep = export_program(layer, args)
        if outs0 is None:
            outs0 = _output_shapes(ep)
        manifest[tag + ".aot"] = save_program(
            ep, os.path.join(out_dir, tag + ".aot"),
            meta={"entry": "predict", "shapes": [list(s) for s in shapes]})
        buckets.append({"file": tag + ".aot",
                        "shapes": [list(s) for s in shapes],
                        "dtypes": [_np_name(a.dtype) for a in examples]})
    meta = {
        "kind": "predict",
        "inputs": input_names or [f"x{i}" for i in range(len(examples))],
        "outputs": output_names or [f"out_{i}" for i in range(len(outs0))],
        "buckets": buckets,
        "manifest": manifest,
        "program_format": _format_record(dev),
    }
    # which outputs are batch-major BY CONSTRUCTION: trace again at
    # another batch; an output is batch-major iff its leading dim tracks
    # the input batch, so the padded run() never trims a non-batch output
    # whose leading dim happens to equal the padded batch
    try:
        B0 = examples[0].shape[0]
        alt = B0 + 1
        outs1 = _output_shapes(export_program(layer, [
            torch.zeros((alt,) + tuple(a.shape[1:]), dtype=a.dtype,
                        device=dev) for a in examples]))
        meta["output_batch_major"] = [
            bool(len(s0) and len(s1) and s0[0] == B0 and s1[0] == alt)
            for s0, s1 in zip(outs0, outs1)]
    except Exception:
        # a batch-baked model: batch axes unknown, run() serves exact
        # shapes only
        pass
    _write_meta(out_dir, meta)


def _cache_meta(kc) -> dict:
    meta = {"n_buffers": 1, "layout": "stacked"}
    if is_quantized_kv(kc):
        # int8 KV carry (the int8wk recipe): the serving process rebuilds
        # {"q": int8, "s": f32 scale} buffers from this
        meta.update(shape=list(kc["q"].shape), dtype="int8",
                    quant={"kv": "int8",
                           "scale_shape": list(kc["s"].shape),
                           "scale_dtype": _np_name(kc["s"].dtype)})
    else:
        meta.update(shape=list(kc.shape), dtype=_np_name(kc.dtype))
    return meta


def export_decoder_bundle(decoder, out_dir: str,
                          prompt_lens: Sequence[int],
                          decode_steps: Sequence[int],
                          batch_sizes: Sequence[int] = (1,),
                          do_sample: bool = False,
                          temperature: float = 1.0,
                          top_k: Optional[int] = None,
                          top_p: Optional[float] = None,
                          draft_model=None,
                          num_speculative_tokens: Optional[int] = None,
                          plain_fallback: bool = True,
                          chunk_sizes: Sequence[int] = ()) -> None:
    """Export a ``LlamaDecoder`` as prefill + decode AOT entries on the
    decoder's device: one prefill per (B, S) bucket, one decode per (B, N)
    bucket (N steps of the fused loop, N + 1 tokens).

    The eos id (-1 = none), the key and the temperature are runtime
    inputs of the decode entries; ``do_sample`` / ``top_k`` / ``top_p``
    change the program, are baked at export and recorded in
    ``decode_mode`` (the export ``temperature`` as
    ``default_temperature``).

    With ``draft_model`` (a ``LlamaForCausalLM`` or ``'skip:N'``) the
    decode entries are SPECULATIVE: the bundle also carries
    ``draft_prefill_b{B}_s{S}`` entries and the draft's cache metadata,
    a decode entry is one round (``steps`` is the output buffer size: it
    serves ``max_new_tokens <= N``), and ``plain_fallback`` adds a plain
    decode entry of the same capacity per bucket, the ladder's lower
    rung.

    ``chunk_sizes`` also exports the continuous-batching entries
    (``decode_mode.chunked``): per batch bucket one
    ``decode_chunk_b{B}_t{T}`` (T steps over the whole carry, which is
    its input and output; T = 1 always included, the per-token rung) and
    one batch-1 ``admit_prefill_s{S}`` per prompt bucket (right-padded
    prompt, per-row true length and cache offset). Serve them with
    ``ServingEngine(AotPredictor(dir), ...)``.

    Loop statics live in each entry's metadata (``aot.read_meta``) with
    the route flags the trace read (``flags.route_snapshot()``)."""
    from paddle_tpu_torch.inference import entries as E
    from paddle_tpu_torch.inference.generate import _sample_spec

    if getattr(decoder, "sharding", None) is not None:
        raise NotImplementedError(
            "bundles of a mesh-built decoder are not ported to "
            "paddle_tpu_torch yet (ROADMAP.md queue 1: mesh)")
    os.makedirs(out_dir, exist_ok=True)
    cfg, p, dev = decoder.cfg, decoder.params, decoder.device
    sample = _sample_spec(do_sample, top_k, top_p)
    route = {n: v for n, v in flags.route_snapshot()}
    eng, K = None, None
    if draft_model is not None:
        eng = decoder._spec_engine(draft_model)
        K = int(num_speculative_tokens if num_speculative_tokens is not None
                else flags.decode_speculative_tokens)
        if K < 1:
            raise ValueError(f"num_speculative_tokens must be >= 1, got {K}")
        worst = max(prompt_lens) + max(decode_steps) + K
        if worst > decoder.max_len:
            raise ValueError(
                f"speculative buckets can overshoot the cache by up to "
                f"K={K} slots: prompt {max(prompt_lens)} + buffer "
                f"{max(decode_steps)} + {K} exceeds max_len "
                f"{decoder.max_len}")
    elif num_speculative_tokens is not None:
        raise ValueError("num_speculative_tokens requires a draft_model")
    csizes = sorted({int(t) for t in chunk_sizes} | {1}) if chunk_sizes \
        else []
    manifest: Dict[str, str] = {}
    prefills, dprefills, decodes, chunks, admits = [], [], [], [], []
    caches, dcaches = {}, {}
    base = (p, cfg, decoder.max_len)
    spec_kw = ({} if eng is None
               else dict(draft_params=eng["params"], draft_cfg=eng["cfg"]))
    long_ = dict(dtype=torch.long, device=dev)

    def save(program, args, tag, meta):
        """Write one entry: ``program`` exported at ``args``, or the archive
        bytes of an earlier entry with the same program. Returns the
        archive bytes."""
        blob = (program if isinstance(program, bytes)
                else archive_bytes(export_program(program, args)))
        manifest[tag + ".aot"] = write_entry(
            os.path.join(out_dir, tag + ".aot"), blob,
            meta=dict(meta, route=route))
        return blob

    prefill = E.Prefill(*base)
    for B in (int(b) for b in batch_sizes):
        fused = E.FusedStep(*base, sample=sample)
        if eng is not None:
            spec_round = E.SpecRound(*base, K=K, sample=sample, **spec_kw)
        kc, vc = decoder._empty_cache(B)
        caches[str(B)] = _cache_meta(kc)
        if eng is not None:
            dkc, dvc = decoder._empty_cache(B, eng["cfg"])
            dcaches[str(B)] = _cache_meta(dkc)
            dprefill = E.Prefill(*base, draft=True, **spec_kw)
        for S in (int(s) for s in prompt_lens):
            ids = torch.zeros((B, S), **long_)
            tag = f"prefill_b{B}_s{S}"
            save(prefill, (ids, kc, vc), tag,
                 {"entry": "prefill", "batch": B, "seq": S})
            prefills.append({"file": tag + ".aot", "batch": B, "seq": S})
            if eng is not None:
                dtag = f"draft_prefill_b{B}_s{S}"
                save(dprefill, (ids, dkc, dvc), dtag,
                     {"entry": "draft_prefill", "batch": B, "seq": S})
                dprefills.append({"file": dtag + ".aot", "batch": B,
                                  "seq": S})
        logits0 = torch.zeros((B, cfg.vocab_size), dtype=torch.float32,
                              device=dev)
        fused_args = (logits0, kc, vc, torch.zeros((B,), **long_),
                      rnd.PRNGKey(0, device=dev),
                      torch.zeros((B,), dtype=torch.bool, device=dev),
                      torch.tensor(-1, **long_),
                      torch.tensor(float(temperature), dtype=torch.float32,
                                   device=dev))
        for N in (int(n) for n in decode_steps):
            # the step is one program for every bucket of the batch
            tag = f"decode_b{B}_n{N}"
            if eng is None:
                fused = save(fused, fused_args, tag,
                             {"entry": "decode", "batch": B, "steps": N})
                decodes.append({"file": tag + ".aot", "batch": B,
                                "steps": N})
                continue
            spec_round = save(spec_round, (logits0, kc, vc, dkc, dvc,
                                           torch.full((B,), -1, **long_),
                                           *fused_args[3:]), tag,
                              {"entry": "spec_round", "batch": B,
                               "steps": N, "K": K})
            decodes.append({"file": tag + ".aot", "batch": B, "steps": N,
                            "speculative": True})
            if plain_fallback and N >= 1:
                # the ladder's lower rung: a plain fused entry of the
                # same capacity (N tokens) as the speculative buffer
                ptag = f"decode_plain_b{B}_n{N}"
                fused = save(fused, fused_args, ptag,
                             {"entry": "decode", "batch": B,
                              "steps": N - 1})
                decodes.append({"file": ptag + ".aot", "batch": B,
                                "steps": N - 1})
        chunk = E.ChunkStep(*base, sample=sample)
        chunk_args = (logits0, kc, vc, torch.zeros((B,), **long_),
                      torch.zeros((B, 2), dtype=torch.int32, device=dev),
                      torch.zeros((B,), dtype=torch.bool, device=dev),
                      torch.full((B,), -1, **long_),
                      torch.ones((B,), dtype=torch.float32, device=dev))
        for T in csizes:
            # one program, the step, for every chunk size; T is static
            ctag = f"decode_chunk_b{B}_t{T}"
            chunk = save(chunk, chunk_args, ctag,
                         {"entry": "decode_chunk", "batch": B, "chunk": T,
                          "admit_ring": False, "spec_chunk": False})
            chunks.append({"file": ctag + ".aot", "batch": B, "chunk": T})
    if csizes:
        # batch-1 admission prefills: right-padded prompt bucket, per-row
        # true length and cache offset (pos0 > 0: a prefix-cache suffix
        # prefill over caches preloaded with the cached rows)
        kc1, vc1 = decoder._empty_cache(1)
        caches["1"] = _cache_meta(kc1)
        admit = E.AdmitPrefill(*base)
        for S in (int(s) for s in prompt_lens):
            atag = f"admit_prefill_s{S}"
            save(admit, (torch.zeros((1, S), **long_), kc1, vc1,
                         torch.ones((1,), **long_),
                         torch.zeros((1,), **long_)), atag,
                 {"entry": "admit_prefill", "batch": 1, "seq": S,
                  "admit_pos0": True})
            admits.append({"file": atag + ".aot", "batch": 1, "seq": S})
    mode = {"do_sample": bool(do_sample),
            "temperature": "runtime",
            "default_temperature": float(temperature),
            "top_k": None if top_k is None else int(top_k),
            "top_p": None if top_p is None else float(top_p),
            # the recipe baked into every entry: load-side serving
            # cross-checks an explicit quant ask against it
            "quant": {
                "recipe": decoder.quant or "none",
                "weights": ("int8" if decoder.weight_dtype == "int8"
                            else _np_name(cfg.torch_dtype)),
                "kv_cache": ("int8" if decoder.quant_kv
                             else _np_name(cfg.torch_dtype)),
            }}
    if eng is not None:
        mode["speculative"] = {
            "num_speculative_tokens": K,
            "draft": (draft_model if isinstance(draft_model, str)
                      else "model"),
            "draft_layers": eng["cfg"].num_hidden_layers,
        }
    if csizes:
        mode["chunked"] = {"chunk_sizes": csizes,
                           "state_inputs": ["logits", "kc", "vc", "pos",
                                            "keys", "done", "eos",
                                            "temp"],
                           "admit_pos0": True,
                           # no admission-ring prologue and no speculative
                           # chunk program: the engine admits a bundle by
                           # host row copy and refuses draft_model= typed
                           "admit_ring": False,
                           "spec_chunk": False}
    meta = {
        "kind": "llama_decoder",
        "inputs": ["input_ids"],
        "outputs": ["tokens"],
        "weight_dtype": decoder.weight_dtype or "none",
        "max_len": decoder.max_len,
        "vocab_size": cfg.vocab_size,
        "logits_dtype": "float32",
        "caches": caches,
        "prefill_buckets": prefills,
        "decode_buckets": decodes,
        "decode_mode": mode,
        "manifest": manifest,
        "program_format": _format_record(dev),
    }
    if eng is not None:
        meta["draft_caches"] = dcaches
        meta["draft_prefill_buckets"] = dprefills
    if csizes:
        meta["chunk_buckets"] = chunks
        meta["admit_prefill_buckets"] = admits
    _write_meta(out_dir, meta)


def _program_key(blob: bytes):
    """Identifies an archive's program: the serialization id that
    ``torch.export.save`` writes into the archive (entries that share a
    program share its bytes), else the bytes' sha256."""
    with zipfile.ZipFile(io.BytesIO(blob)) as zf:
        for name in zf.namelist():
            if name.endswith(".data/serialization_id"):
                return len(blob), zf.read(name)
    return hashlib.sha256(blob).digest()


def _leaves(t) -> list:
    return [t[k] for k in sorted(t)] if isinstance(t, dict) else [t]


def _clone(t):
    return {k: v.clone() for k, v in t.items()} if isinstance(t, dict) \
        else t.clone()


class _EntryGraph:
    """``run(*args)`` captured once as a CUDA graph: over static copies of
    the arguments, except those at ``direct`` (the caches), which it reads
    and writes where they are. ``replay`` copies the other arguments in,
    replays, counts the captured kernel launches, and returns clones of
    the outputs."""

    def __init__(self, run, args, direct):
        self.direct = frozenset(direct)
        self.args = [a if i in self.direct else _clone(a)
                     for i, a in enumerate(args)]
        self.graph = torch.cuda.CUDAGraph()
        self.replays = 0
        before = _kernels.launch_counts()
        with _kernels.capture(self.graph,
                              capture_error_mode=_kernels._CAPTURE_MODE):
            self.out = run(*self.args)
        self.launches = _kernels.captured_launches(before)

    def replay(self, args):
        for i, (dst, src) in enumerate(zip(self.args, args)):
            if i not in self.direct:
                for d, s in zip(_leaves(dst), _leaves(src)):
                    d.copy_(s)
        self.graph.replay()
        self.replays += 1
        _kernels.add_launches(self.launches)
        return tuple(o.clone() for o in self.out)


def _run_once(m, *args):
    out = m(*args)
    return tuple(out) if isinstance(out, (list, tuple)) else (out,)


def _run_steps(n: int):
    """The loop of a decode or chunk entry: ``n`` body runs over the
    carry ``(logits, kc, vc, pos, key(s), done, eos, temp)``, tokens
    stacked; returns ``(tokens (B, n), logits, pos, key(s), done)``."""
    def run(m, logits, kc, vc, pos, keys, done, eos, temp):
        toks = []
        for _ in range(n):
            tok, logits, pos, keys, done = m(logits, kc, vc, pos, keys,
                                             done, eos, temp)
            toks.append(tok)
        return torch.stack(toks, 1), logits, pos, keys, done
    run.steps = n
    return run


class AotPredictor:
    """Serve an AOT bundle: no model Python, no re-tracing, no pickle.

    ``run`` serves predict bundles by named inputs and outputs;
    ``generate`` serves llama_decoder bundles. A smaller batch than any
    exported bucket pads up to the NEAREST bucket and trims the outputs
    (``padded_calls`` counts them; ``allow_bucket_padding=False`` serves
    exact shapes only, for models whose rows are coupled);
    ``warmup=True`` runs every entry once at load; ``cast_inputs=True``
    casts feeds to the bucket's dtype; ``memory_report()`` sizes the
    artifact and the serving caches.

    ``device`` defaults to ``cuda`` (``device="cpu"`` for a bundle
    exported on the CPU); a bundle exported for the other device type is
    refused (``BundleDeviceError``), a bundle of JAX programs too
    (``ForeignProgramError``). Each entry's bytes are checked against the
    manifest at first use (``CorruptBundleError``). On a card each entry
    key's first call runs eagerly and later calls replay its CUDA graph
    (``graph_replays``)."""

    def __init__(self, bundle_dir: str, device: Optional[str] = None,
                 warmup: bool = False, cast_inputs: bool = True,
                 allow_bucket_padding: bool = True):
        with open(os.path.join(bundle_dir, _META)) as f:
            self.meta = json.load(f)
        fmt = self.meta.get("program_format")
        if not isinstance(fmt, dict) or fmt.get("format") != PROGRAM_FORMAT:
            raise ForeignProgramError(
                f"{bundle_dir}: a bundle of StableHLO (jax.export) "
                f"programs, exported by the JAX package; paddle_tpu_torch "
                f"serves {PROGRAM_FORMAT} bundles: re-export it with "
                f"paddle_tpu_torch.inference")
        self.device = resolve_device(device)
        if fmt.get("device") != self.device.type:
            raise BundleDeviceError(
                f"{bundle_dir}: exported on {fmt.get('device')!r}; this "
                f"predictor serves on {self.device.type!r} (the programs' "
                f"weights and constants live on the export device): "
                f"re-export it there or pass device={fmt.get('device')!r}")
        self._dir = bundle_dir
        self._entries: Dict[str, object] = {}
        self._programs: Dict[bytes, object] = {}
        self.cast_inputs = cast_inputs
        self.allow_bucket_padding = allow_bucket_padding
        self.padded_calls = 0      # nearest-bucket serves
        self.last_spec_stats = None
        self.last_resilience = None
        self._events: list = []
        # entry graph key -> its captured graph, or None after the key's
        # eager first call
        self._graphs: "collections.OrderedDict[tuple, object]" = \
            collections.OrderedDict()
        self._caches: Dict[tuple, tuple] = {}
        if warmup:
            self.warmup()

    # -- common ------------------------------------------------------------
    @property
    def quant_recipe(self) -> Optional[str]:
        """The dtype recipe this bundle was exported with (``None`` =
        unquantized, else 'int8w' / 'int8wk'), from ``decode_mode.quant``
        or, without it, the ``weight_dtype`` metadata."""
        q = (self.meta.get("decode_mode") or {}).get("quant")
        if q is not None:
            r = q.get("recipe")
            return None if r in (None, "none") else r
        return "int8w" if self.meta.get("weight_dtype") == "int8" else None

    @property
    def graph_replays(self) -> int:
        """CUDA-graph replays of this predictor's entries so far."""
        return sum(g.replays for g in self._graphs.values()
                   if g is not None)

    def get_input_names(self) -> List[str]:
        return list(self.meta["inputs"])

    def get_output_names(self) -> List[str]:
        return list(self.meta["outputs"])

    def _entry(self, fname):
        """The entry's program, loaded at first use after its bytes are
        checked against the manifest; entries that hold the same program
        (a chunk size's and the rung's, each decode bucket's step) share
        one loaded module and its weights."""
        fn = self._entries.get(fname)
        if fn is None:
            expected = (self.meta.get("manifest") or {}).get(fname)
            _, blob = read_entry(os.path.join(self._dir, fname),
                                 expected_sha256=expected)
            key = _program_key(blob)
            fn = self._programs.get(key)
            if fn is None:
                fn = self._programs[key] = load_program(blob)
            self._entries[fname] = fn
        return fn

    def _call(self, fname, run, args, direct=()):
        """``run(program, *args)``: eagerly on the CPU and at a key's first
        call on a card, later as a replay of the key's CUDA graph. The key
        is the entry, the loop, the shapes and dtypes of the copied
        arguments and the addresses of the ``direct`` ones."""
        m = self._entry(fname)
        if self.device.type != "cuda":
            with torch.no_grad():
                return run(m, *args)
        key = (fname, getattr(run, "steps", None), tuple(
            tuple(t.data_ptr() for t in _leaves(a)) if i in direct
            else tuple((tuple(t.shape), t.dtype) for t in _leaves(a))
            for i, a in enumerate(args)))
        graphs = self._graphs
        with torch.no_grad():
            if key not in graphs:
                graphs[key] = None
                while len(graphs) > _GRAPHS:
                    graphs.popitem(last=False)
                return run(m, *args)
            graphs.move_to_end(key)
            if graphs[key] is None:
                graphs[key] = _EntryGraph(lambda *a: run(m, *a), args,
                                          direct)
            return graphs[key].replay(args)

    def _run_entry(self, fname, site, run, args, direct=()):
        """One dispatch of an entry, ``_call(fname, run, args, direct)``,
        under ``_guarded``."""
        return self._guarded(fname, site,
                             lambda: self._call(fname, run, args, direct))

    def _guarded(self, fname, site, work):
        """``work()``, one entry dispatch under the resilience contract:
        the fault hook fires first, then transient errors retry with
        backoff (their events on the in-flight record). With obs on, a
        dispatch span named after the site (the entry file in its attrs)
        and the ``dispatches.<site>`` counter; timing only, no FLOPs
        record, as for the JAX package's bundles."""
        def attempt():
            fault_injector.on_call(site)
            if not obs.enabled():
                return work()
            with obs.span(site, kind="dispatch", entry=fname):
                out = work()
            obs.metrics.counter(
                "dispatches." + site,
                "bundle entries executed at this site").inc()
            return out

        return resilient_call(attempt, site=site,
                              on_event=self._events.append)

    def _make_cache(self, B: int, which: str = "caches"):
        """Zeroed serving caches of batch ``B`` (``which``: the target's
        or ``"draft_caches"``), from the recorded shapes."""
        cm = self.meta[which][str(B)]
        shape, dev = tuple(cm["shape"]), self.device
        quant = cm.get("quant")

        def z():
            if quant is not None:
                return {"q": torch.zeros(shape, dtype=torch.int8,
                                         device=dev),
                        "s": torch.zeros(tuple(quant["scale_shape"]),
                                         dtype=_torch_dtype(
                                             quant["scale_dtype"]),
                                         device=dev)}
            return torch.zeros(shape, dtype=_torch_dtype(cm["dtype"]),
                               device=dev)
        return z(), z()

    def _cache(self, B: int, which: str = "caches"):
        """This predictor's own caches of batch ``B``, zeroed: allocated
        once, so a captured entry graph keeps reading and writing them."""
        c = self._caches.get((which, B))
        if c is None:
            c = self._caches[(which, B)] = self._make_cache(B, which)
        else:
            for t in c:
                for leaf in _leaves(t):
                    leaf.zero_()
        return c

    def _head_major(self) -> bool:
        """Head-major cache rows ``(B, KV, max_len, D)`` against
        token-major ``(B, max_len, KV, D)``, from the recorded shapes."""
        for cm in (self.meta.get("caches") or {}).values():
            shape = cm["shape"]
            return len(shape) >= 2 and shape[-2] == self.meta["max_len"]
        return False

    def warmup(self) -> None:
        """Run every entry once on zeros: each program's load and first
        (eager) call happen here instead of on the first request."""
        dev = self.device
        long_ = dict(dtype=torch.long, device=dev)
        if self.meta["kind"] == "predict":
            for b in self.meta["buckets"]:
                self._call(b["file"], _run_once, [
                    torch.zeros(tuple(s), dtype=_torch_dtype(d), device=dev)
                    for s, d in zip(b["shapes"], b["dtypes"])])
            return
        V = self.meta["vocab_size"]
        for pf in self.meta["prefill_buckets"]:
            B = pf["batch"]
            kc, vc = self._cache(B)
            self._call(pf["file"], _run_once,
                       (torch.zeros((B, pf["seq"]), **long_), kc, vc), (1, 2))
        for pf in self.meta.get("draft_prefill_buckets", ()):
            B = pf["batch"]
            dkc, dvc = self._cache(B, "draft_caches")
            self._call(pf["file"], _run_once,
                       (torch.zeros((B, pf["seq"]), **long_), dkc, dvc),
                       (1, 2))
        for dc in self.meta["decode_buckets"]:
            B = dc["batch"]
            logits = torch.zeros((B, V), dtype=torch.float32, device=dev)
            self._decode_call(dc, logits, B, 0, None, 0, None, warm=True)
        for cb in self.meta.get("chunk_buckets", ()):
            B = cb["batch"]
            kc, vc = self._cache(B)
            self._call(cb["file"], _run_steps(cb["chunk"]), (
                torch.zeros((B, V), dtype=torch.float32, device=dev), kc, vc,
                torch.zeros((B,), **long_),
                torch.zeros((B, 2), dtype=torch.int32, device=dev),
                torch.ones((B,), dtype=torch.bool, device=dev),
                torch.full((B,), -1, **long_),
                torch.ones((B,), dtype=torch.float32, device=dev)), (1, 2))
        for ab in self.meta.get("admit_prefill_buckets", ()):
            kc, vc = self._cache(1, "caches")
            self._call(ab["file"], _run_once, (
                torch.zeros((1, ab["seq"]), **long_), kc, vc,
                torch.ones((1,), **long_), torch.zeros((1,), **long_)),
                (1, 2))

    def memory_report(self) -> Dict[str, object]:
        """Artifact and serving-buffer sizes: each entry's bytes on disk
        (the baked-weight programs ARE the deployment payload) and the KV
        cache bytes a call allocates per batch bucket."""
        entries, total = {}, 0
        for f in os.listdir(self._dir):
            if f.endswith(".aot"):
                sz = os.path.getsize(os.path.join(self._dir, f))
                entries[f] = sz
                total += sz
        report = {"entries_bytes": entries, "artifact_bytes": total}
        if self.meta["kind"] == "llama_decoder":
            caches = {}
            for b, cm in self.meta["caches"].items():
                per = int(np.prod(cm["shape"])) * cm["n_buffers"] \
                    * _torch_dtype(cm["dtype"]).itemsize
                q = cm.get("quant")
                if q is not None:        # + the int8 carry's f32 scales
                    per += int(np.prod(q["scale_shape"])) \
                        * cm["n_buffers"] \
                        * _torch_dtype(q["scale_dtype"]).itemsize
                caches[b] = 2 * per                      # K and V
            report["kv_cache_bytes_per_batch"] = caches
        return report

    def _feed(self, arr, dtype: str) -> torch.Tensor:
        t = torch.as_tensor(np.asarray(arr)).to(self.device)
        if self.cast_inputs and _np_name(t.dtype) != dtype:
            t = t.to(_torch_dtype(dtype))
        return t

    @staticmethod
    def _host(t: torch.Tensor) -> np.ndarray:
        t = t.detach().cpu()
        return (t.float() if t.dtype == torch.bfloat16 else t).numpy()

    # -- plain forward -----------------------------------------------------
    def run(self, feeds: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
        if self.meta["kind"] != "predict":
            raise ValueError(f"bundle kind {self.meta['kind']!r} has no "
                             "plain-forward entry; use generate()")
        names = self.meta["inputs"]
        args = [np.asarray(feeds[n]) for n in names]
        shapes = tuple(tuple(a.shape) for a in args)
        self._events = []
        for b in self.meta["buckets"]:
            if tuple(tuple(s) for s in b["shapes"]) == shapes:
                outs = self._run_entry(
                    b["file"], "bundle.predict", _run_once,
                    [self._feed(a, d) for a, d in zip(args, b["dtypes"])])
                return {n: self._host(o)
                        for n, o in zip(self.meta["outputs"], outs)}
        # nearest-bucket batch padding: every input shares ONE leading
        # batch dim and the bucket's trailing dims; the smallest bucket
        # batch that fits; outputs trimmed back to the fed batch
        B = shapes[0][0] if shapes and shapes[0] else None
        same_batch = (self.allow_bucket_padding and B is not None
                      and all(s and s[0] == B for s in shapes))
        cands = []
        for b in self.meta["buckets"]:
            bs = [tuple(s) for s in b["shapes"]]
            if (same_batch
                    and all(len(s) == len(g) and s[1:] == g[1:]
                            for s, g in zip(bs, shapes))
                    and all(s[0] == bs[0][0] for s in bs)
                    and bs[0][0] > B):
                cands.append((bs[0][0], b))
        if cands:
            nb, b = min(cands, key=lambda t: t[0])
            bm = self.meta.get("output_batch_major")
            if bm is None:
                # no batch-axis metadata: padding could silently truncate
                # a non-batch output
                raise ValueError(
                    f"no exact shape bucket for inputs {shapes} and this "
                    "bundle predates output batch-axis metadata; re-export "
                    "it to enable padded serving (exported buckets: "
                    f"{[b['shapes'] for b in self.meta['buckets']]})")
            self.padded_calls += 1
            padded = []
            for a, d in zip(args, b["dtypes"]):
                t = self._feed(a, d)
                padded.append(torch.cat([t, t.new_zeros(
                    (nb - t.shape[0],) + tuple(t.shape[1:]))], 0))
            outs = self._run_entry(b["file"], "bundle.predict", _run_once,
                                   padded)
            # trim ONLY the outputs the exporter found batch-major
            return {n: (self._host(o)[:B] if is_bm else self._host(o))
                    for n, o, is_bm in zip(self.meta["outputs"], outs, bm)}
        raise ValueError(
            f"no shape bucket for inputs {shapes}; exported buckets: "
            f"{[b['shapes'] for b in self.meta['buckets']]}")

    # -- LM decode ---------------------------------------------------------
    def _decode_temp(self, temperature) -> float:
        """The decode temperature under the bundle contract: a runtime
        input (the export value by default); a bundle whose metadata
        records a baked temperature refuses another."""
        mode = self.meta.get("decode_mode") or {}
        if mode.get("temperature") == "runtime":
            if temperature is None:
                return float(mode.get("default_temperature", 1.0))
            return float(temperature)
        baked = float(mode.get("temperature", 1.0))
        if temperature is not None and float(temperature) != baked:
            raise ValueError(
                f"this bundle records a baked temperature={baked}; "
                f"re-export it to serve temperature={temperature}")
        return baked

    def _decode_call(self, dcb, logits, nb, S, eos, seed, temperature,
                     max_new=None, warm=False):
        """One decode dispatch at bucket ``dcb`` from the prefill's
        ``logits`` (the caches are this predictor's batch-``nb`` ones).
        Plain: ``steps + 1`` fused bodies -> tokens (nb, steps + 1).
        Speculative: rounds until every row holds ``max_new`` tokens (a
        host check between rounds, as ``LlamaDecoder``'s loop makes) ->
        ``(tokens (nb, max_new), rounds, accepted)``."""
        dev = self.device
        long_ = dict(dtype=torch.long, device=dev)
        kc, vc = self._caches[("caches", nb)]
        pos = torch.full((nb,), S, **long_)
        key = rnd.PRNGKey(seed, device=dev)
        done = torch.zeros((nb,), dtype=torch.bool, device=dev)
        eos_t = torch.tensor(-1 if eos is None else eos, **long_)
        temp = torch.tensor(self._decode_temp(temperature),
                            dtype=torch.float32, device=dev)
        if not dcb.get("speculative"):
            args = (logits, kc, vc, pos, key, done, eos_t, temp)
            run = _run_steps(dcb["steps"] + 1)
            if warm:
                return self._call(dcb["file"], run, args, (1, 2))
            return self._run_entry(dcb["file"], "bundle.decode", run, args,
                                   (1, 2))[0]
        dkc, dvc = self._caches[("draft_caches", nb)]
        K = self.meta["decode_mode"]["speculative"]["num_speculative_tokens"]
        tok = torch.full((nb,), -1, **long_)
        if warm:
            return self._call(dcb["file"], _run_once, (
                logits, kc, vc, dkc, dvc, tok, pos, key, done, eos_t, temp),
                (1, 2, 3, 4))

        return self._guarded(dcb["file"], "bundle.spec_decode", lambda: (
            self._spec_loop(dcb["file"], logits, kc, vc, dkc, dvc, tok, pos,
                            key, done, eos_t, temp, S, max_new, K)))

    def _spec_loop(self, fname, logits, kc, vc, dkc, dvc, tok, pos, key,
                   done, eos, temp, S, max_new, K):
        """``LlamaDecoder._spec_loop`` over the round entry: the first
        round also makes the first pick; each round commits a per-row
        1..K + 1 tokens into a ``(B, max_new + 1)`` buffer whose last
        column takes the writes the JAX package drops."""
        B, dev = logits.shape[0], logits.device
        buf = torch.zeros((B, max_new + 1), dtype=torch.long, device=dev)
        jidx = torch.arange(K + 1, device=dev)[None, :]
        sr = sa = 0
        first = True
        while True:
            cnt = pos - S + 1
            active = cnt < max_new
            if not first and not bool(active.any()):
                break
            tok0, done0, emit, a, tok2, key, done2 = self._call(
                fname, _run_once, (logits, kc, vc, dkc, dvc, tok, pos, key,
                                   done, eos, temp), (1, 2, 3, 4))
            if first:
                buf[:, 0] = tok0
                first = False
                if not bool(active.any()):
                    break
            live = active & ~done0
            sr += int(live.sum())
            sa += int(torch.where(live, a, 0).sum())
            idx = cnt[:, None] + jidx
            valid = (jidx <= a[:, None]) & active[:, None] & (idx < max_new)
            buf.scatter_(1, torch.where(valid, idx, max_new), emit)
            pos = torch.where(active, pos + a + 1, pos)
            tok = torch.where(active, tok2, tok0)
            done = torch.where(active, done2, done0)
        return buf[:, :max_new], sr, sa

    def generate(self, input_ids, max_new_tokens: int,
                 eos_token_id: Optional[int] = None,
                 do_sample: bool = False,
                 temperature: Optional[float] = None,
                 seed: int = 0, quant: Optional[str] = None) -> np.ndarray:
        """Serve a decode: one prefill dispatch and one decode dispatch
        (the bucket's loop). Eos id (``None`` or negative = none), seed and
        temperature are runtime inputs; ``do_sample`` / ``top_k`` /
        ``top_p`` were fixed at export and a mismatching request is a
        contract violation. ``quant`` cross-checks the recipe baked into
        the bundle (``QuantMismatchError`` both ways; ``None`` serves
        whatever was exported). Speculative bundles also run the draft
        prefill, record ``last_spec_stats``, and step down to the plain
        bucket (``plain_fallback``) when the speculative entry keeps
        failing. Returns a ``GenerateResult`` whose ``.resilience`` (also
        ``last_resilience``) holds the level, retries and degradations."""
        if self.meta["kind"] != "llama_decoder":
            raise ValueError(f"bundle kind {self.meta['kind']!r} cannot "
                             "generate; use run()")
        if quant is not None:
            want, have = canonical_quant(quant), self.quant_recipe
            if want != have:
                raise QuantMismatchError(
                    f"this bundle was exported with quant recipe "
                    f"{have or 'none'!r} (the weights are baked into its "
                    f"programs); the ask for {want or 'none'!r} cannot be "
                    f"served — re-export the decoder with the matching "
                    f"quant=")
        eos_token_id = _normalize_eos(eos_token_id)
        mode = self.meta["decode_mode"]
        if bool(do_sample) != bool(mode["do_sample"]):
            raise ValueError(
                f"bundle decode entries were exported with do_sample="
                f"{mode['do_sample']} (temperature={mode['temperature']}, "
                f"top_k={mode['top_k']}, top_p={mode['top_p']}); "
                f"requested do_sample={do_sample}")
        self._decode_temp(temperature)      # refused before any dispatch
        spec = mode.get("speculative")
        ids = np.asarray(input_ids)
        B, S = ids.shape
        # admission hook for batch-conditional faults
        fault_injector.on_call("bundle.generate", batch=B)
        if S + max_new_tokens > self.meta["max_len"]:
            raise ValueError(
                f"prompt {S} + {max_new_tokens} new tokens exceeds the "
                f"bundle's max_len {self.meta['max_len']}")
        # exact batch bucket, else the smallest exported batch that fits
        # (zero prompt rows, outputs trimmed: decode rows are independent)
        batches = sorted({b["batch"] for b in self.meta["prefill_buckets"]
                          if b["seq"] == S
                          and (b["batch"] == B
                               or (self.allow_bucket_padding
                                   and b["batch"] >= B))})
        if not batches:
            have = [(b["batch"], b["seq"])
                    for b in self.meta["prefill_buckets"]]
            raise ValueError(
                f"no prefill bucket for (B={B}, S={S}); exported: {have}")
        nb = batches[0]
        pf = next(b for b in self.meta["prefill_buckets"]
                  if b["batch"] == nb and b["seq"] == S)

        # capacity: plain entries decode steps + 1 tokens; a speculative
        # entry's steps IS its output buffer
        def cap(b):
            return b["steps"] + (0 if b.get("speculative") else 1)

        want_spec = spec is not None
        cands = [b for b in self.meta["decode_buckets"]
                 if b["batch"] == nb and cap(b) >= max_new_tokens
                 and bool(b.get("speculative")) == want_spec]
        if not cands:
            have = [(b["batch"], cap(b))
                    for b in self.meta["decode_buckets"]]
            raise ValueError(
                f"no decode bucket with B={nb}, capacity>={max_new_tokens};"
                f" exported (batch, capacity): {have}")
        dc = min(cands, key=cap)
        fed = ids
        if nb != B:
            self.padded_calls += 1
            fed = np.concatenate([ids, np.zeros((nb - B, S), ids.dtype)], 0)
        fed_d = torch.as_tensor(fed.astype(np.int64), device=self.device)

        def run_level(dcb):
            """One serve attempt at one decode bucket, from zeroed
            caches."""
            use_spec = bool(dcb.get("speculative"))
            kc, vc = self._cache(nb)
            (logits,) = self._run_entry(pf["file"], "bundle.prefill",
                                        _run_once, (fed_d, kc, vc), (1, 2))
            if use_spec:
                dpf = next(b for b in self.meta["draft_prefill_buckets"]
                           if b["batch"] == nb and b["seq"] == S)
                dkc, dvc = self._cache(nb, "draft_caches")
                self._run_entry(dpf["file"], "bundle.draft_prefill",
                                _run_once, (fed_d, dkc, dvc), (1, 2))
            out = self._decode_call(dcb, logits, nb, S, eos_token_id, seed,
                                    temperature, max_new=max_new_tokens)
            return out, use_spec

        # the serve-side ladder: the speculative bucket steps down to a
        # plain bucket of the same batch and capacity when the bundle has
        # one (export_decoder_bundle plain_fallback)
        ladder = [("speculative" if want_spec else "fused", dc)]
        if want_spec:
            plain = [b for b in self.meta["decode_buckets"]
                     if b["batch"] == nb and not b.get("speculative")
                     and cap(b) >= max_new_tokens]
            if plain:
                ladder.append(("fused", min(plain, key=cap)))
        self._events = []
        self.last_resilience = None
        self.last_spec_stats = None
        degradations = []
        out, use_spec, level = None, False, None
        for li, (name, dcb) in enumerate(ladder):
            try:
                out, use_spec = run_level(dcb)
                level = name
                break
            except Exception as e:
                if classify_error(e) != "transient":
                    raise
                if (li == len(ladder) - 1
                        or not flags.resilience_auto_degrade):
                    obs.record_crash(
                        "bundle.ladder_exhausted", error=e,
                        extra={"site": "bundle.generate",
                               "failed_level": name,
                               "bundle_dir": self._dir})
                    raise DecodeFailedError(
                        f"bundle decode failed at ladder level {name!r} "
                        f"with no further fallback: {str(e)[:300]}",
                        events=list(self._events), last_error=e) from e
                ev = DegradationEvent(
                    site="bundle.generate", from_level=name,
                    to_level=ladder[li + 1][0],
                    error_class=type(e).__name__, error=str(e)[:300])
                record_event(ev)
                self._events.append(ev)
                degradations.append(ev)
        if use_spec:
            toks, r, a = out
            self.last_spec_stats = {
                "rounds": r, "accepted_drafts": a,
                "acceptance_len_mean": (a / r) if r else float(
                    spec["num_speculative_tokens"]),
                "num_speculative_tokens": spec["num_speculative_tokens"],
            }
        else:
            toks = out
        toks = toks.cpu().numpy()[:B, :max_new_tokens]
        if eos_token_id is not None:
            toks = _trim_after_eos(toks, eos_token_id)
        self.last_resilience = {
            "level": level,
            "requested_level": ladder[0][0],
            "retries": sum(1 for e in self._events
                           if getattr(e, "kind", "") == "retry"),
            "degradations": [e.as_dict() for e in degradations],
            "events": [e.as_dict() for e in self._events],
        }
        return GenerateResult.wrap(
            np.concatenate([ids, toks.astype(ids.dtype)], axis=1),
            self.last_resilience)
