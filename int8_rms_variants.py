"""Times the int8 weight-only matmul and the RMSNorm backward against
variants of their design on one CUDA card.

    python3 int8_rms_variants.py [variant ...]

Each variant is the committed sources of ``paddle_tpu_torch/csrc`` with
one text patch, copied to ``build/int8_rms_variants/<name>/`` (the sources
themselves are not touched) and built there. The script loads every
build, checks its outputs against the plain versions (the ``diag_``
variants excepted: their results are wrong by design), then times, in
turns (every build once, then every build again), the int8 matmul at
every shape of the served model (qkv, o_proj, gate_up, down, head) and row
count (8, 16, 32, 48, 64) and the RMSNorm backward at 8192 x 768 in bf16
and f32, each as a CUDA graph of 100 calls over enough input copies to
overflow the L2 (``chip_smoke.time_ms``). It prints one JSON line per
build and round, in microseconds (``step8_us``: one decode step's 49 int8
launches at 8 rows), the card (``nvidia-smi`` name and power limit) and
last ``{"ok": true, ...}``.

Variants:
- ``base``: the sources as committed;
- ``int8_bk64_fill2``: 64-deep int8 stages, with strips and K splits
  chosen to give every SM two blocks instead of one;
- ``int8_bn256``: 256-column int8 strips allowed;
- ``diag_no_dequant``: the int8 kernel's dequantization replaced by one
  byte permute, to show what dequantizing costs;
- ``diag_no_mma``: its mma replaced by an xor into the accumulator, to
  show what the products cost;
- ``rms_one_block``: the RMSNorm backward without the register bound that
  keeps two blocks on an SM.
"""

from __future__ import annotations

import json
import shutil
import sys
from pathlib import Path

import torch

import chip_smoke as cs

ROOT = Path(__file__).resolve().parent
I8, RMS = "int8_matmul.cu", "rms_norm.cu"
PATCHES = {
    "base": [],
    "int8_bk64_fill2": [
        (I8, "constexpr int kBK = 128;", "constexpr int kBK = 64;"),
        (I8, "const int slots = sm_count();",
         "const int slots = 2 * sm_count();")],
    "int8_bn256": [
        (I8, "int bn = 128;", "int bn = 256;"),
        (I8, "kRingBudget / stage_bytes(128, nt) < kMaxStages\n"
             "             ? kRingBudget / stage_bytes(128, nt)",
         "kRingBudget / stage_bytes(256, nt) < kMaxStages\n"
         "             ? kRingBudget / stage_bytes(256, nt)"),
        (I8, "smem_bytes(128, NT));", "smem_bytes(256, NT));"),
        (I8, "2 * smem_bytes(128, 8)", "2 * smem_bytes(256, 8)")],
    "diag_no_dequant": [
        (I8, "  const uint32_t sel = 0x7440u | static_cast<uint32_t>(j);",
         "  return __byte_perm(p, q, 0x5140u + j);\n"
         "  const uint32_t sel = 0x7440u | static_cast<uint32_t>(j);")],
    "diag_no_mma": [
        (I8, "uint32_t b0, uint32_t b1) {",
         "uint32_t b0, uint32_t b1) {\n  c[0] += __uint_as_float((a[0] ^ "
         "a[1] ^ a[2] ^ a[3] ^ b0 ^ b1) & 0x3f000000u);\n  return;")],
    "rms_one_block": [
        (RMS, "int VPL>\n__global__ void __launch_bounds__(kThreads, 2)",
         "int VPL>\n__global__ void __launch_bounds__(kThreads)")],
}
SHAPES = (("qkv", 768, 1280), ("o_proj", 768, 768), ("gate_up", 768, 4096),
          ("down", 2048, 768), ("head", 768, 32000))
ROWS = (8, 16, 32, 48, 64)


def build(name):
    """The library built from the sources with ``name``'s patches."""
    from paddle_tpu_torch.ops.kernels import _build
    d = ROOT / "build" / "int8_rms_variants" / name
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
    """Input copies per case: int8 (name, rows) -> [(x, w, scale)], and
    RMSNorm dtype -> [(x, w, gy, inv)]."""
    from paddle_tpu_torch.ops.kernels import rms_norm as rn
    from paddle_tpu_torch.quantization import weight_quantize
    i8 = {}
    for what, K, N in SHAPES:
        ws = [weight_quantize(torch.randn(K, N, generator=g, device="cuda")
                              * 0.02) for _ in range(cs.n_copies(K * N))]
        for B in ROWS:
            i8[(what, B)] = [(torch.randn(B, K, generator=g, device="cuda")
                              .to(torch.bfloat16), w, s) for w, s in ws]
    rms = {}
    for dt in (torch.bfloat16, torch.float32):
        esz = torch.tensor([], dtype=dt).element_size()
        sets = []
        for _ in range(cs.n_copies(3 * 8192 * 768 * esz)):
            x = torch.randn(8192, 768, generator=g, device="cuda").to(dt)
            w = (1 + 0.1 * torch.randn(768, generator=g, device="cuda")
                 ).to(dt)
            gy = torch.randn(8192, 768, generator=g, device="cuda").to(dt)
            sets.append((x, w, gy, rn.rms_fwd_ref(x, w, 1e-6)[1]))
        rms[str(dt).split(".")[-1]] = sets
    return i8, rms


def check(name, i8, rms):
    from paddle_tpu_torch.ops.kernels import int8_matmul as im
    from paddle_tpu_torch.ops.kernels import rms_norm as rn
    for key, sets in i8.items():
        got = im.int8_matmul(*sets[0])
        _, ratio, _ = cs.err_and_tol(got, im.int8_matmul_ref(*sets[0]),
                                     torch.bfloat16)
        cs.check(ratio <= 1, f"{name} int8 {key}: {ratio} x its tolerance")
    for key, sets in rms.items():
        x, w, gy, inv = sets[0]
        got, want = rn.rms_bwd(x, w, inv, gy), rn.rms_bwd_ref(x, w, inv, gy)
        for a, b in zip(got, want):
            _, ratio, _ = cs.err_and_tol(a, b, x.dtype)
            cs.check(ratio <= 1, f"{name} rms {key}: {ratio} x its "
                     f"tolerance")


def main() -> int:
    if not torch.cuda.is_available():
        print("int8_rms_variants: no CUDA device", file=sys.stderr)
        return 2
    from paddle_tpu_torch.ops.kernels import _build
    from paddle_tpu_torch.ops.kernels import int8_matmul as im
    from paddle_tpu_torch.ops.kernels import rms_norm as rn
    names = sys.argv[1:] or list(PATCHES)
    libs = {n: build(n) for n in names}
    i8, rms = inputs(torch.Generator(device="cuda").manual_seed(0))
    for name, lib in libs.items():
        _build._lib = lib
        torch.cuda.synchronize()
        if not name.startswith("diag_"):
            check(name, i8, rms)
    torch.cuda.synchronize()
    for rnd in range(2):
        for name, lib in libs.items():
            _build._lib = lib
            us = {f"{what}{B}": 1e3 * cs.time_ms(im.int8_matmul, sets, 100)
                  for (what, B), sets in i8.items()}
            step8 = 12 * sum(us[f"{w}8"] for w, _, _ in SHAPES[:4]) \
                + us["head8"]
            rms_us = {k: 1e3 * cs.time_ms(
                lambda x, w, gy, inv: rn.rms_bwd(x, w, inv, gy), sets, 100)
                for k, sets in rms.items()}
            cs.emit(dict(round=rnd, variant=name, step8_us=step8,
                         int8_us=us, rms_bwd_us=rms_us))
    print(cs.card_line(), flush=True)
    cs.emit({"ok": True, "device": {"platform": "gpu",
                                    "kind": torch.cuda.get_device_name(0),
                                    "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
