"""Times the flash-attention kernels against variants of their design on
one CUDA card.

    python3 flash_variants.py [variant ...]

Each variant is the committed sources of ``paddle_tpu_torch/csrc`` with
one text patch, copied to ``build/flash_variants/<name>/`` (the sources
themselves are not touched) and built there. The script loads every
build, then times the forward and the backward (``flash_fwd`` /
``flash_bwd``: the backward's delta and dq-conversion kernels and its
scratch's zeroing included) at the two main-path shapes, the Llama's B 8,
H 12, S 1024, D 64 causal and the UNet's B 8, H 8, S 1024, D 80, in turns
(every build once, then every build again), with SDPA's forward beside
them, and checks each build's forward against the plain version. It
prints one JSON line per build and round, the card (``nvidia-smi`` name
and power limit) and last ``{"ok": true, ...}``.

Variants:
- ``base``: the sources as committed;
- ``bk64``: 64-key forward tiles (4 stages, 3 at D 128) instead of 128;
- ``exp2f``: the softmax's p by ``exp2f`` instead of the SFU's
  ``ex2.approx``, forward and backward;
- ``bwd_stages3``: a 3-stage q/do ring in the backward (D 80 and below);
- ``no_dq_reduce``: the backward without dq's bulk reduce-add, to show
  what it costs (its dq is wrong: a measurement only).
"""

from __future__ import annotations

import json
import shutil
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent
PATCHES = {
    "base": [],
    "bk64": [
        ("flash_fwd.cu", "static constexpr int kBK = 128;  // keys per stage",
         "static constexpr int kBK = 64;  // keys per stage"),
        ("flash_fwd.cu", "kStages = D > 80 ? 2 : 3;",
         "kStages = D > 80 ? 3 : 4;")],
    "exp2f": [
        ("flash_fwd.cu", "const float p0 = ex2(", "const float p0 = exp2f("),
        ("flash_fwd.cu", "const float p1 = ex2(", "const float p1 = exp2f("),
        ("flash_bwd.cu", "float pe = ex2(", "float pe = exp2f(")],
    "bwd_stages3": [
        ("flash_bwd.cu", "static constexpr int kStages = 2;",
         "static constexpr int kStages = D > 80 ? 2 : 3;")],
    "no_dq_reduce": [
        ("flash_common.cuh",
         '''  asm volatile(
      "cp.reduce.async.bulk.global.shared::cta.bulk_group.add.f32 "
      "[%0], [%1], %2;\\n" ::"l"(dst),
      "r"(smem_u32(src)), "r"(bytes)
      : "memory");''', "")],
}
SHAPES = ((8, 1024, 12, 64, True), (8, 1024, 8, 80, False))


def emit(obj):
    print(json.dumps(obj), flush=True)


def build(name):
    """The library built from the sources with ``name``'s patches."""
    from paddle_tpu_torch.ops.kernels import _build
    src = ROOT / "paddle_tpu_torch" / "csrc"
    d = ROOT / "build" / "flash_variants" / name
    if d.exists():
        shutil.rmtree(d)
    shutil.copytree(src, d)
    for f, old, new in PATCHES[name]:
        text = (d / f).read_text()
        if old not in text:
            raise RuntimeError(f"{name}: {f} no longer holds the patched "
                               f"text {old[:60]!r}")
        (d / f).write_text(text.replace(old, new))
    _build.CSRC, _build._lib = d, None
    return _build.library()


def ms(fn, iters=30):
    """Device ms per call: CUDA events around a host loop (the kernels run
    for tens of microseconds or more, so the enqueue hides behind them)."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(iters):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / iters


def main() -> int:
    if not torch.cuda.is_available():
        print("flash_variants: no CUDA device", file=sys.stderr)
        return 2
    import torch.nn.functional as F

    from paddle_tpu_torch.ops.kernels import _build
    from paddle_tpu_torch.ops.kernels import flash_attention as fa
    names = sys.argv[1:] or list(PATCHES)
    libs = {n: build(n) for n in names}
    g = torch.Generator(device="cuda").manual_seed(0)
    data = []
    for B, S, H, D, causal in SHAPES:
        q, k, v, do = (torch.randn(B, S, H, D, generator=g, device="cuda")
                       .to(torch.bfloat16) for _ in range(4))
        out, lse = fa.flash_fwd_ref(q, k, v, causal, D ** -0.5)
        data.append(((B, S, H, D, causal), q, k, v, do, out, lse))
    for rnd in range(2):
        for name, lib in libs.items():
            _build._lib = lib
            for shape, q, k, v, do, out, lse in data:
                causal, scale = shape[4], shape[3] ** -0.5
                emit(dict(round=rnd, variant=name, shape=shape,
                          fwd_ms=ms(lambda: fa.flash_fwd(q, k, v, causal,
                                                         scale)),
                          bwd_ms=ms(lambda: fa.flash_bwd(
                              q, k, v, out, lse, do, causal, scale))))
        for shape, q, k, v, do, out, lse in data:
            ql, kl, vl = (t.transpose(1, 2) for t in (q, k, v))
            emit(dict(round=rnd, variant="sdpa", shape=shape,
                      fwd_ms=ms(lambda: F.scaled_dot_product_attention(
                          ql, kl, vl, is_causal=shape[4]))))
    for name, lib in libs.items():
        _build._lib = lib
        shape, q, k, v, do, out, lse = data[0]
        got, _ = fa.flash_fwd(q, k, v, shape[4], shape[3] ** -0.5)
        err = (got.float() - out.float()).abs().max().item()
        emit(dict(variant=name, fwd_max_abs_err=err))
        if err > 0.05:
            raise RuntimeError(f"{name}: forward off by {err}")
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0], flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
