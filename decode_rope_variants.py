"""Times the decode-attention and rope kernels against variants of their
design on one CUDA card.

    python3 decode_rope_variants.py [variant ...]

Each variant is the committed sources of ``paddle_tpu_torch/csrc`` with
one text patch, copied to ``build/decode_rope_variants/<name>/`` (the
sources themselves are not touched) and built there. The script loads
every build, checks its outputs against the plain versions (the
``diag_`` variants excepted: their results are wrong by design), then
times,
in turns (every build once, then every build again), decode attention at
the served model's shape (B 8, H 12, KV 4, D 64; L 256 with lengths 1-256
and L 4096 with lengths 1-4096; bf16 q with a bf16 or an int8 cache) and
rope forward and backward at the Llama trainer's (B 8, S 1024, H 12,
D 64; bf16 and f32), each as a CUDA graph of 200 calls over enough input
copies to overflow the L2 (``chip_smoke.time_ms``). The ``base`` build
also times decode attention under every split P of 1, 2, 4 and 8 in
place of ``split_for``'s, and ``floor_us``: a graph of one-element
fills (``Tensor.zero_``), the least a kernel costs in this timing. It
prints one JSON line per build and round, in microseconds, the card
(``nvidia-smi`` name and power limit) and last ``{"ok": true, ...}``.

Variants:
- ``base``: the sources as committed;
- ``da_stages1``, ``da_stages4``: decode attention's cp.async ring one
  step deep (no copies in flight across steps) or four (80 KB of shared
  memory in bf16), not as deep as 40 KB holds (bf16 2, int8 3, f32 1);
- ``da_threads256``: decode attention in blocks of 8 warps, not 4;
- ``diag_da_empty``: the decode-attention kernel returns at once (the
  launch of its clusters alone);
- ``diag_da_no_kv``: it reads lens and q but no cache row;
- ``diag_da_no_merge``: it stops before the cluster merge (no output);
- ``rope_heads8``, ``rope_heads12``: rope with the loads of 8 or 12 heads
  in flight together, not 4.
"""

from __future__ import annotations

import shutil
import sys
from pathlib import Path

import torch

import chip_smoke as cs

ROOT = Path(__file__).resolve().parent
DA, ROPE = "decode_attention.cu", "rope.cu"
STAGE_RULE = "return n < 1 ? 1 : n > 4 ? 4 : n;"
PATCHES = {
    "base": [],
    "da_stages1": [(DA, STAGE_RULE, "return 1;")],
    "da_stages4": [(DA, STAGE_RULE, "return 4;")],
    "da_threads256": [
        (DA, "constexpr int kThreads = 128;",
         "constexpr int kThreads = 256;")],
    "diag_da_empty": [
        (DA, "  const int tid = threadIdx.x;\n",
         "  const int tid = threadIdx.x;\n  if (L > 0) return;\n")],
    "diag_da_no_kv": [
        (DA, "const int r1 = min(r0 + chunk, len);",
         "const int r1 = len < 0 ? L : r0;")],
    "diag_da_no_merge": [
        (DA, "  cluster.sync();   // every block's partial",
         "  if (L > 0) return;\n"
         "  cluster.sync();   // every block's partial")],
    "rope_heads8": [
        (ROPE, "constexpr int kHeads = 4;", "constexpr int kHeads = 8;")],
    "rope_heads12": [
        (ROPE, "constexpr int kHeads = 4;", "constexpr int kHeads = 12;")],
}
LENS = {256: [1, 37, 256, 100, 200, 129, 64, 255],
        4096: [4096, 1, 3000, 2049, 4000, 17, 1024, 4095]}


def build(name):
    """The library built from the sources with ``name``'s patches."""
    from paddle_tpu_torch.ops.kernels import _build
    d = ROOT / "build" / "decode_rope_variants" / name
    if d.exists():
        shutil.rmtree(d)
    shutil.copytree(ROOT / "paddle_tpu_torch" / "csrc", d)
    for f, old, new in PATCHES[name]:
        text = (d / f).read_text()
        if old not in text:
            raise RuntimeError(f"{name}: {f} no longer holds the patched "
                               f"text {old[:60]!r}")
        (d / f).write_text(text.replace(old, new))
    _build.CSRC, _build._lib = d, None
    return _build.library()


def inputs(g):
    """Input copies per case: decode attention (L, quant) -> [(q, kc, vc,
    lens, k_scale, v_scale)], rope dtype -> [(x, cos, sin)]."""
    from paddle_tpu_torch.quantization.kv_cache import quantize_kv_rows
    bf = torch.bfloat16
    da = {}
    for L, lens in LENS.items():
        lt = torch.tensor(lens, dtype=torch.int32, device="cuda")
        for quant in (False, True):
            sets = []
            for _ in range(cs.n_copies(2 * 8 * 4 * L * (66 if quant
                                                        else 128))):
                q = torch.randn(8, 12, 64, generator=g, device="cuda").to(bf)
                kf, vf = (torch.randn(8, 4, L, 64, generator=g,
                                      device="cuda") for _ in range(2))
                if quant:
                    k, v = quantize_kv_rows(kf), quantize_kv_rows(vf)
                    sets.append((q, k["q"], v["q"], lt, k["s"], v["s"]))
                else:
                    sets.append((q, kf.to(bf), vf.to(bf), lt, None, None))
            da[(L, quant)] = sets
    rope = {}
    for dt in (bf, torch.float32):
        esz = torch.tensor([], dtype=dt).element_size()
        sets = []
        for _ in range(cs.n_copies(2 * 8 * 1024 * 12 * 64 * esz)):
            x = torch.randn(8, 1024, 12, 64, generator=g, device="cuda")
            t = torch.randn(1024, 32, generator=g, device="cuda")
            sets.append((x.to(dt), t.cos().to(dt), t.sin().to(dt)))
        rope[str(dt).split(".")[-1]] = sets
    return da, rope


def attend(q, kc, vc, lt, ks, vs):
    from paddle_tpu_torch.ops.kernels import decode_attention as da
    return da.decode_attention(q, kc, vc, lt, k_scale=ks, v_scale=vs)


def check(name, da_sets, rope_sets):
    from paddle_tpu_torch.ops.kernels import decode_attention as da
    from paddle_tpu_torch.ops.kernels import rope as rp
    for key, sets in da_sets.items():
        q, kc, vc, lt, ks, vs = sets[0]
        _, ratio, _ = cs.err_and_tol(
            attend(*sets[0]), da.decode_attention_ref(q, kc, vc, lt, ks, vs),
            torch.bfloat16)
        cs.check(ratio <= 1, f"{name} decode {key}: {ratio} x its tolerance")
    for key, sets in rope_sets.items():
        x, c, s = sets[0]
        for fn, sign in ((rp.rope_fwd, 1), (rp.rope_bwd, -1)):
            _, ratio, _ = cs.err_and_tol(fn(x, c, s),
                                         rp.rope_ref(x, c, s, sign), x.dtype)
            cs.check(ratio <= 1, f"{name} rope {key}: {ratio} x its "
                     f"tolerance")


def da_us(da_sets):
    return {f"L{L}{'_int8' if quant else ''}": 1e3 * cs.time_ms(attend, sets)
            for (L, quant), sets in da_sets.items()}


def main() -> int:
    if not torch.cuda.is_available():
        print("decode_rope_variants: no CUDA device", file=sys.stderr)
        return 2
    from paddle_tpu_torch.ops.kernels import _build
    from paddle_tpu_torch.ops.kernels import decode_attention as da
    from paddle_tpu_torch.ops.kernels import rope as rp
    names = sys.argv[1:] or list(PATCHES)
    libs = {n: build(n) for n in names}
    da_sets, rope_sets = inputs(torch.Generator(device="cuda").manual_seed(0))
    for name, lib in libs.items():
        _build._lib = lib
        torch.cuda.synchronize()
        if not name.startswith("diag_"):
            check(name, da_sets, rope_sets)
    torch.cuda.synchronize()
    rule = da.split_for
    for rnd in range(2):
        for name, lib in libs.items():
            _build._lib = lib
            row = dict(round=rnd, variant=name, decode_us=da_us(da_sets))
            row["rope_us"] = {
                f"{k}_{d}": 1e3 * cs.time_ms(fn, sets)
                for k, sets in rope_sets.items()
                for d, fn in (("fwd", rp.rope_fwd), ("bwd", rp.rope_bwd))}
            if name == "base":
                tiny = torch.zeros(1, device="cuda")
                row["floor_us"] = 1e3 * cs.time_ms(lambda t: t.zero_(),
                                                   [(tiny,)])
                for P in (1, 2, 4, 8):
                    da.split_for = lambda B, KV, L, P=P: P
                    try:
                        if rnd == 0:
                            check(f"split {P}", da_sets, {})
                        row[f"decode_us_split{P}"] = da_us(da_sets)
                    finally:
                        da.split_for = rule
            cs.emit(row)
    print(cs.card_line(), flush=True)
    cs.emit({"ok": True, "device": {"platform": "gpu",
                                    "kind": torch.cuda.get_device_name(0),
                                    "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
