"""Serving A/B: the serving line's drains for one checkout, to set beside
another checkout's in the same call.

    python3 serve_ab.py [--root DIR] [--label NAME] [--out DIR]

``--root DIR``: measure DIR's ``paddle_tpu_torch`` (a ``git archive`` of
another commit unpacked under ``build/``, say); default this script's own
directory. The model and the 16 requests are this checkout's
``chip_smoke.serving_inputs()`` whatever the root, so every root serves
the same traffic; the eager-chunk route is the root's own
``chip_smoke.eager_chunks``. For each recipe (unquantized, ``int8wk``),
8 slots, chunk 16, the ring, max_len 256:

- ``graphed``: two drains that warm up and capture every key, then three
  timed drains;
- ``obs`` (where the root has the ``obs_enabled`` flag): one more drain
  with obs on, then obs on and off in turn, three timed drains each, on
  the same engine;
- ``eager``: a new decoder whose chunks run eagerly: its first drain
  (which warms and captures the prefill keys), then three timed drains;
- each timed drain's wall time, tokens/s and the garbage collector's
  pauses in it (``gc.callbacks``);
- ``host_us``: the microseconds of one ``flags.snapshot()`` (and
  ``route_snapshot()`` where the root has it), a part of every graph key;
- a ``cProfile`` of one more drain of each route (graphed obs off,
  graphed obs on, eager), its 20 costliest functions by own time written
  to ``serve_ab_<label>_<recipe>.txt`` in ``--out`` (default
  ``build/serve_ab`` of this checkout).

Each recipe prints one JSON line; the last line is ``{"ab": {...}}``
with the tokens/s lists. Run it for parent, change, change, parent in
one call: two versions compare only on one card in one call.
"""

from __future__ import annotations

import cProfile
import gc
import importlib.util
import io
import json
import os
import pstats
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))


def _load(path: str, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class _GcClock:
    """The garbage collector's pauses, summed, from ``gc.callbacks``."""

    def __init__(self):
        self.ms, self.runs, self._t0 = 0.0, 0, None
        gc.callbacks.append(self._cb)

    def _cb(self, phase, info):
        if phase == "start":
            self._t0 = time.perf_counter()
        elif self._t0 is not None:
            self.ms += 1e3 * (time.perf_counter() - self._t0)
            self.runs += 1
            self._t0 = None

    def read(self):
        return self.ms, self.runs


def main() -> int:
    args = sys.argv[1:]
    opts = dict(zip(args[::2], args[1::2]))
    if len(args) % 2 or set(opts) - {"--root", "--label", "--out"}:
        print("usage: python3 serve_ab.py [--root DIR] [--label NAME] "
              "[--out DIR]", file=sys.stderr)
        return 2
    root = os.path.abspath(opts.get("--root", HERE))
    label = opts.get("--label", os.path.basename(root))
    sys.path.insert(0, root)
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("serve_ab: no CUDA device", file=sys.stderr)
        return 2
    here_cs = _load(os.path.join(HERE, "chip_smoke.py"), "ab_chip_smoke")
    root_cs = (here_cs if root == HERE else
               _load(os.path.join(root, "chip_smoke.py"), "root_chip_smoke"))
    from paddle_tpu_torch.flags import _DEFAULTS, flags, set_flags
    from paddle_tpu_torch.inference.generate import LlamaDecoder
    from paddle_tpu_torch.ops.kernels import _build
    from paddle_tpu_torch.serving import ServingEngine
    import paddle_tpu_torch
    assert paddle_tpu_torch.__file__.startswith(root), paddle_tpu_torch

    card = here_cs.card_line()
    print(f"card: {card}; root {root}", flush=True)
    _build.library()
    model, reqs = here_cs.serving_inputs()
    has_obs = "obs_enabled" in _DEFAULTS
    clock = _GcClock()
    out_dir = os.path.abspath(opts.get("--out", os.path.join(
        HERE, "build", "serve_ab")))
    os.makedirs(out_dir, exist_ok=True)

    def drain(eng):
        torch.cuda.synchronize()
        g0 = clock.read()
        t0 = time.perf_counter()
        ids = [eng.submit(p, n, eos_token_id=e) for p, n, e in reqs]
        res = eng.drain()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        g1 = clock.read()
        gens = here_cs.collect(res, reqs, ids)
        n = int(sum(len(g) for g in gens))
        return gens, dict(wall_s=wall, tokens_per_s=n / wall,
                          gc_ms=g1[0] - g0[0], gc_runs=g1[1] - g0[1])

    def profiled(eng, what, sink):
        pr = cProfile.Profile()
        pr.enable()
        drain(eng)
        pr.disable()
        buf = io.StringIO()
        pstats.Stats(pr, stream=buf).sort_stats("tottime").print_stats(20)
        sink.write(f"== {label} {what}\n{buf.getvalue()}\n")

    def host_us(fn, n=10000):
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        return 1e6 * (time.perf_counter() - t0) / n

    ab = {"root": root, "label": label, "card": card}
    for q in (None, "int8wk"):
        tag = q or "none"
        sink = open(os.path.join(out_dir, f"serve_ab_{label}_{tag}.txt"),
                    "w")
        dec = LlamaDecoder(model, max_len=256, quant=q)
        eng = ServingEngine(dec, num_slots=8, chunk_size=16)
        ref, _ = drain(eng)
        drain(eng)

        def same(gens, what):
            for j, (a, b) in enumerate(zip(gens, ref)):
                if not np.array_equal(a, b):
                    raise SystemExit(f"serve_ab {label} {tag}: request {j} "
                                     f"{what} gave other tokens")

        line = {"label": label, "quant": tag, "card": card,
                "graphed": [], "obs_on": [], "obs_off": [], "eager": []}
        for _ in range(3):
            gens, r = drain(eng)
            same(gens, "graphed")
            line["graphed"].append(r)
        profiled(eng, f"{tag} graphed", sink)
        if has_obs:
            set_flags({"obs_enabled": True})
            drain(eng)
            for on in (True, False) * 3:
                set_flags({"obs_enabled": on})
                gens, r = drain(eng)
                same(gens, f"obs {on}")
                line["obs_on" if on else "obs_off"].append(r)
            set_flags({"obs_enabled": True})
            profiled(eng, f"{tag} graphed obs on", sink)
            set_flags({"obs_enabled": False})
        del eng, dec
        edec = root_cs.eager_chunks(LlamaDecoder(model, max_len=256,
                                                 quant=q))
        eeng = ServingEngine(edec, num_slots=8, chunk_size=16)
        gens, line["eager_first"] = drain(eeng)
        same(gens, "eager")
        for _ in range(3):
            gens, r = drain(eeng)
            same(gens, "eager")
            line["eager"].append(r)
        profiled(eeng, f"{tag} eager", sink)
        sink.close()
        del eeng, edec
        torch.cuda.empty_cache()
        line["host_us"] = {"flags_snapshot": host_us(flags.snapshot)}
        if hasattr(flags, "route_snapshot"):
            line["host_us"]["flags_route_snapshot"] = host_us(
                flags.route_snapshot)
        print(json.dumps(line), flush=True)
        ab[tag] = {k: [r["tokens_per_s"] for r in line[k]]
                   for k in ("graphed", "obs_on", "obs_off", "eager")}
        ab[tag]["eager_first"] = line["eager_first"]["tokens_per_s"]
    print(json.dumps({"ab": ab}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
