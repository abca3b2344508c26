"""Times the GroupNorm kernels under every launch route at the UNet's shapes
on one CUDA card.

    python3 group_norm_routes.py

For each of the 17 distinct (channels, HW, act) GroupNorm shapes of a
``bench_unet`` step (``chip_smoke.unet_census``: B 8, 32 groups, bf16),
the forward and the backward run under every route the kernels take
(``ops/kernels/group_norm.py`` ``route`` forced to each: clusters of K =
1, 2, 4, 8 blocks whose shared memory fits, and the streaming kernels,
K 0), each checked against the plain version with
``chip_smoke``'s tolerances and timed as a CUDA graph, with torch's
``F.group_norm`` (+ ``F.silu``) forward and backward beside them. It
prints one JSON line per shape (ms by route, the route ``route`` picks,
torch's ms), then the census-weighted per-step sums of the picked
routes, of the best route per shape and of torch, the card (``nvidia-smi``
name and power limit) and last ``{"ok": true, ...}``.
"""

from __future__ import annotations

import collections
import json
import sys

import torch


def routes_for(shape, G, dtype, backward):
    """Every K the cluster kernels take for this shape, and the streaming
    route (0)."""
    from paddle_tpu_torch.ops.kernels import group_norm as gn
    n = shape[1] // G * shape[2] * shape[3]
    esz = 2 if dtype == torch.bfloat16 else 4
    out = [0]
    for k in (1, 2, 4, 8):
        per = gn._per(n, k)
        if per * (k - 1) >= n:
            break
        if gn._smem(per, esz, shape[2] * shape[3], backward) <= gn._SMEM_MAX:
            out.append(k)
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("group_norm_routes: no CUDA device", file=sys.stderr)
        return 2
    import torch.nn.functional as F

    import chip_smoke as cs
    from paddle_tpu_torch.models.unet import UNetConfig
    from paddle_tpu_torch.ops.kernels import group_norm as gn

    card = cs.card_line()
    census = cs.unet_census(UNetConfig(), 8, 64, 77, 512)
    counts = collections.Counter(census["gn"])
    g = torch.Generator(device="cuda").manual_seed(0)
    bf, G, eps, B = torch.bfloat16, 32, 1e-5, 8
    picked = {"fwd": 0.0, "bwd": 0.0}
    best = {"fwd": 0.0, "bwd": 0.0}
    lib = {"fwd": 0.0, "bwd": 0.0}
    real_route = gn.route
    for (C, hw, act), calls in sorted(counts.items(),
                                      key=lambda kv: (kv[0][0], kv[0][1])):
        side = int(round(hw ** 0.5))
        shape = (B, C, side, side)
        n = B * C * hw
        sets = []
        for _ in range(cs.n_copies(3 * n * 2)):
            x = torch.randn(shape, generator=g, device="cuda").to(bf)
            w = (1 + 0.1 * torch.randn(C, generator=g, device="cuda")).to(bf)
            b = (0.1 * torch.randn(C, generator=g, device="cuda")).to(bf)
            gy = torch.randn(shape, generator=g, device="cuda").to(bf)
            _, mean, rstd = gn.gn_fwd_ref(x, w, b, G, eps, act)
            sets.append((x, w, b, gy, mean, rstd))
        x, w, b, gy, mean, rstd = sets[0]
        ref_out, _, _ = gn.gn_fwd_ref(x, w, b, G, eps, act)
        ref = gn.gn_bwd_ref(x, w, b, mean, rstd, gy, G, act)
        line = dict(shape=list(shape), act=act, calls=calls)
        for what, backward in (("fwd", False), ("bwd", True)):
            ms = {}
            for k in routes_for(shape, G, bf, backward):
                gn.route = lambda *a, _k=k, **kw: _k
                try:
                    if backward:
                        got = gn.gn_bwd(x, w, b, mean, rstd, gy, G, act)
                        want = ref
                        fn = lambda x, w, b, gy, m, r: gn.gn_bwd(  # noqa
                            x, w, b, m, r, gy, G, act)
                    else:
                        got = gn.gn_fwd(x, w, b, G, eps, act)[:1]
                        want = (ref_out,)
                        fn = lambda x, w, b, *_: gn.gn_fwd(  # noqa: E731
                            x, w, b, G, eps, act)
                    torch.cuda.synchronize()
                    ratio = max(cs.err_and_tol(a, r, bf)[1]
                                for a, r in zip(got, want))
                    cs.check(ratio <= 1, f"{shape} {act} {what} K {k}: "
                             f"{ratio} x the tolerance")
                    ms[f"K{k}"] = cs.time_ms(fn, sets)
                finally:
                    gn.route = real_route
            choice = f"K{real_route(shape, G, bf, backward)}"
            line[what] = ms
            line[f"{what}_route"] = choice
            picked[what] += calls * ms[choice]
            best[what] += calls * min(ms.values())

        def lib_fwd(x, w, b, *_):
            y = F.group_norm(x, G, w, b, eps)
            return F.silu(y) if act else y

        xl, wl, bl = (t.detach().requires_grad_() for t in (x, w, b))
        line["torch_fwd"] = cs.time_ms(lib_fwd, sets, iters=100)
        line["torch_bwd"] = cs.library_backward_ms(
            lib_fwd(xl, wl, bl), (xl, wl, bl), gy, 50)
        lib["fwd"] += calls * line["torch_fwd"]
        lib["bwd"] += calls * line["torch_bwd"]
        cs.emit(line)
        del sets
        torch.cuda.empty_cache()
    cs.emit(dict(per_step_ms=dict(picked=picked, best_route=best,
                                  torch=lib)))
    print(card, flush=True)
    cs.emit({"ok": True, "device": {"platform": "gpu",
                                    "kind": torch.cuda.get_device_name(0),
                                    "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
