"""The port's kernels (paddle_tpu_torch/ops/kernels) against the JAX
package's Pallas kernels, and against their own plain versions on the card.

On the CPU each wrapper runs its plain PyTorch version; the JAX side runs
its Pallas kernel in interpret mode, as the JAX package's own tests do
(tests/test_fused_kernels.py, same shapes and tolerances). The JAX imports
live inside the parity tests, so the card's test run (which has no JAX:
``pytest --noconftest -m gpu tests/test_torch_kernels.py``) can collect
this file. The ``gpu`` tests decide inside their body whether a card is
present and skip here.
"""

import numpy as np
import pytest
import torch

from paddle_tpu_torch.ops.kernels import decode_attention as da
from paddle_tpu_torch.ops.kernels import flash_attention as fa
from paddle_tpu_torch.ops.kernels import group_norm as gn
from paddle_tpu_torch.ops.kernels import int8_matmul as i8
from paddle_tpu_torch.ops.kernels import rms_norm as rn
from paddle_tpu_torch.ops.kernels import rope as rp
from paddle_tpu_torch.quantization import weight_quantize
from paddle_tpu_torch.quantization.kv_cache import quantize_kv_rows

# f32 tolerance of the JAX package's own kernel tests
_ATOL = _RTOL = 2e-5


def _t(a):
    return torch.from_numpy(np.asarray(a))


@pytest.mark.parametrize("KV,H", [(4, 4), (2, 6)])
def test_decode_attention_plain_matches_jax_scalar_pos(KV, H):
    """MHA and GQA (rep 3), scalar valid length 1, 100 and L."""
    import jax.numpy as jnp

    from paddle_tpu.ops.pallas.decode_attention import decode_attention

    rng = np.random.default_rng(0)
    B, L, D = 2, 256, 8
    q = rng.standard_normal((B, H, D)).astype(np.float32)
    kc = rng.standard_normal((B, KV, L, D)).astype(np.float32)
    vc = rng.standard_normal((B, KV, L, D)).astype(np.float32)
    for pos in (1, 100, L):
        want = np.asarray(decode_attention(jnp.asarray(q), jnp.asarray(kc),
                                           jnp.asarray(vc), pos,
                                           block_l=128))
        got = da.decode_attention(_t(q), _t(kc), _t(vc), pos).numpy()
        np.testing.assert_allclose(got, want, rtol=_RTOL, atol=_ATOL,
                                   err_msg=f"KV={KV} pos={pos}")


@pytest.mark.parametrize("quant", [False, True])
def test_decode_attention_plain_matches_jax_per_row_pos(quant):
    """Per-row valid lengths [100, 37] (the chunked serving path), f32 and
    int8 K/V quantized by each package's own quantize_kv_rows."""
    import jax.numpy as jnp

    from paddle_tpu.ops.pallas.decode_attention import decode_attention
    from paddle_tpu.quantization.kv_cache import \
        quantize_kv_rows as jax_quantize_kv_rows

    rng = np.random.default_rng(1)
    B, L, D, KV, H = 2, 256, 8, 2, 6
    q = rng.standard_normal((B, H, D)).astype(np.float32)
    kc = rng.standard_normal((B, KV, L, D)).astype(np.float32)
    vc = rng.standard_normal((B, KV, L, D)).astype(np.float32)
    pos = np.asarray([100, 37], np.int32)
    if not quant:
        want = decode_attention(jnp.asarray(q), jnp.asarray(kc),
                                jnp.asarray(vc), jnp.asarray(pos),
                                block_l=128)
        got = da.decode_attention(_t(q), _t(kc), _t(vc), _t(pos))
    else:
        jk, jv = (jax_quantize_kv_rows(jnp.asarray(kc)),
                  jax_quantize_kv_rows(jnp.asarray(vc)))
        want = decode_attention(jnp.asarray(q), jk["q"], jv["q"],
                                jnp.asarray(pos), block_l=128,
                                k_scale=jk["s"], v_scale=jv["s"])
        tk, tv = quantize_kv_rows(_t(kc)), quantize_kv_rows(_t(vc))
        got = da.decode_attention(_t(q), tk["q"], tv["q"], _t(pos),
                                  k_scale=tk["s"], v_scale=tv["s"])
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=_RTOL,
                               atol=_ATOL)


def test_decode_attention_empty_prefix_is_nan_like_jax():
    """A row with valid length 0 gives 0 / 0 = NaN in the JAX kernel
    (decode_attention.py:99) and in the port; its neighbour is finite."""
    import jax.numpy as jnp

    from paddle_tpu.ops.pallas.decode_attention import decode_attention

    rng = np.random.default_rng(2)
    B, L, D, KV, H = 2, 128, 8, 2, 4
    q = rng.standard_normal((B, H, D)).astype(np.float32)
    kc = rng.standard_normal((B, KV, L, D)).astype(np.float32)
    vc = rng.standard_normal((B, KV, L, D)).astype(np.float32)
    pos = np.asarray([0, 37], np.int32)
    want = np.asarray(decode_attention(jnp.asarray(q), jnp.asarray(kc),
                                       jnp.asarray(vc), jnp.asarray(pos),
                                       block_l=128))
    got = da.decode_attention(_t(q), _t(kc), _t(vc), _t(pos)).numpy()
    assert np.isnan(want[0]).all() and np.isnan(got[0]).all()
    np.testing.assert_allclose(got[1], want[1], rtol=_RTOL, atol=_ATOL)


@pytest.mark.parametrize("B,K,N", [
    pytest.param(8, 256, 512, id="256-512"),
    pytest.param(8, 512, 640, id="512-640"),
    pytest.param(8, 5504, 256, id="5504-256"),
    pytest.param(8, 768, 1000, id="768-1000"),
    pytest.param(33, 768, 1280, id="B33-768-1280"),
    pytest.param(64, 2048, 768, id="B64-2048-768")])
def test_int8_matmul_plain_matches_jax(B, K, N):
    """K = 5504 is the 1B down_proj contraction; N = 640 and 1000 are
    ragged against the TPU kernel's 512/1024 column tiles; 33 and 64 rows
    are admission prefills, which the kernel serves up to 64 rows. x takes
    multiples of 1/8 so every f32 partial sum is exact: the two libraries
    sum in different orders, and with arbitrary f32 inputs that order
    alone moves outputs of magnitude ~20 by ~1e-5."""
    import jax.numpy as jnp

    from paddle_tpu.ops.pallas.int8_matmul import int8_matmul

    rng = np.random.default_rng(0)
    x = (rng.integers(-16, 17, (B, K)) / 8).astype(np.float32)
    w = rng.integers(-127, 127, (K, N)).astype(np.int8)
    s = rng.uniform(0.01, 0.02, (N,)).astype(np.float32)
    want = np.asarray(int8_matmul(jnp.asarray(x), jnp.asarray(w),
                                  jnp.asarray(s)))
    got = i8.int8_matmul(_t(x), _t(w), _t(s)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_quantizers_bit_equal_jax():
    """weight_quantize and quantize_kv_rows give the JAX package's int8
    codes and scales exactly (round half to even in both)."""
    import jax.numpy as jnp

    from paddle_tpu.framework.tensor import Tensor
    from paddle_tpu.quantization import weight_quantize as jax_wq
    from paddle_tpu.quantization.kv_cache import \
        quantize_kv_rows as jax_quantize_kv_rows

    rng = np.random.default_rng(2)
    w = (rng.standard_normal((64, 96)) * 0.02).astype(np.float32)
    w[3, :] = 0.5 * w[5, :]                  # exact .5 ratios: ties
    jq, js = jax_wq(Tensor(jnp.asarray(w)))
    tq, ts = weight_quantize(_t(w))
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq.value))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js.value))
    kv = rng.standard_normal((2, 3, 16, 8)).astype(np.float32)
    jk, tk = jax_quantize_kv_rows(jnp.asarray(kv)), quantize_kv_rows(_t(kv))
    np.testing.assert_array_equal(tk["q"].numpy(), np.asarray(jk["q"]))
    np.testing.assert_array_equal(tk["s"].numpy(), np.asarray(jk["s"]))


def test_wrappers_refuse_what_the_kernel_does_not_take():
    assert da.supported(torch.zeros(2, 12, 64), torch.zeros(2, 4, 300, 64))
    assert not da.supported(torch.zeros(2, 5, 8), torch.zeros(2, 2, 256, 8))
    assert not da.supported(torch.zeros(2, 34, 8), torch.zeros(2, 2, 64, 8))
    assert not da.supported(torch.zeros(2, 4, 12), torch.zeros(2, 2, 64, 12))
    w = torch.zeros(256, 512, dtype=torch.int8)
    assert i8.supported(torch.zeros(64, 256), w)
    assert not i8.supported(torch.zeros(65, 256), w)
    assert not i8.supported(torch.zeros(8, 255), w)
    with pytest.raises(ValueError, match="cuda or cpu"):
        da.decode_attention(torch.zeros(1, 2, 8, device="meta"),
                            torch.zeros(1, 1, 8, 8, device="meta"),
                            torch.zeros(1, 1, 8, 8, device="meta"), 4)


def test_graph_launch_bookkeeping_carries_row_counts():
    """``captured_launches`` / ``add_launches`` (a CUDA graph's replay
    accounting) carry the int8 kernel's launches by row count with the
    integer counters: a capture's counts are undone, and each replay adds
    them back."""
    from paddle_tpu_torch.ops import kernels as K
    saved = (i8.launches, dict(i8.launches_by_rows), da.launches)
    try:
        i8.launches, da.launches = 5, 2
        i8.launches_by_rows.clear()
        i8.launches_by_rows[8] = 5
        before = K.launch_counts()
        assert before["int8_matmul", "launches_by_rows", 8] == 5
        # a capture: one 8-row and two 40-row int8 launches, four
        # decode-attention launches
        i8.launches += 3
        i8.launches_by_rows[8] += 1
        i8.launches_by_rows[40] = 2
        da.launches += 4
        captured = K.captured_launches(before)
        assert captured == {("int8_matmul", "launches"): 3,
                            ("int8_matmul", "launches_by_rows", 8): 1,
                            ("int8_matmul", "launches_by_rows", 40): 2,
                            ("decode_attention", "launches"): 4}
        assert (i8.launches, i8.launches_by_rows, da.launches) == \
            (5, {8: 5}, 2)
        for _ in range(2):
            K.add_launches(captured)
        assert (i8.launches, i8.launches_by_rows, da.launches) == \
            (11, {8: 7, 40: 4}, 10)
    finally:
        i8.launches, da.launches = saved[0], saved[2]
        i8.launches_by_rows.clear()
        i8.launches_by_rows.update(saved[1])


# -- GroupNorm and rope -------------------------------------------------------

@pytest.mark.parametrize("act,shape", [(None, (2, 32, 8, 8)),
                                       ("silu", (2, 96, 4, 4))])
def test_group_norm_plain_matches_jax(act, shape):
    """gn_fwd / gn_bwd (plain versions) against the Pallas kernels in
    interpret mode at UNET_TINY's widths (32 channels on 8 x 8 maps, 96 on
    4 x 4, 8 groups): out, mean and rstd at 1e-5, dx, dw and db at 1e-4;
    then the autograd unit against jax.grad of the JAX one."""
    import jax
    import jax.numpy as jnp

    from paddle_tpu.ops.fused_norm import group_norm_fused as jax_fused
    from paddle_tpu.ops.pallas import group_norm as pgn

    from paddle_tpu_torch.ops.fused_norm import group_norm_fused

    rng = np.random.default_rng(0)
    C = shape[1]
    x = (rng.standard_normal(shape) * 2 + 0.5).astype(np.float32)
    w = (1 + 0.1 * rng.standard_normal(C)).astype(np.float32)
    b = (0.1 * rng.standard_normal(C)).astype(np.float32)
    g = rng.standard_normal(shape).astype(np.float32)
    jx, jw, jb, jg = map(jnp.asarray, (x, w, b, g))
    out, mean, rstd = pgn.gn_fwd(jx, jw, jb, 8, 1e-5, act)
    want = (out, mean, rstd) + pgn.gn_bwd(jx, jw, jb, mean, rstd, jg, 8, act)
    tout, tmean, trstd = gn.gn_fwd(_t(x), _t(w), _t(b), 8, 1e-5, act)
    got = (tout, tmean, trstd) + gn.gn_bwd(_t(x), _t(w), _t(b), tmean, trstd,
                                           _t(g), 8, act)
    for name, a, c, tol in zip(("out", "mean", "rstd", "dx", "dw", "db"),
                               got, want, (1e-5,) * 3 + (1e-4,) * 3):
        c = np.asarray(c)
        np.testing.assert_allclose(a.numpy().reshape(c.shape), c, rtol=tol,
                                   atol=tol, err_msg=f"{act} {name}")
    want = jax.grad(lambda x, w, b: (jax_fused(x, w, b, 8, 1e-5, act)
                                     * jg).sum(), (0, 1, 2))(jx, jw, jb)
    tx, tw, tb = (_t(a).requires_grad_() for a in (x, w, b))
    (group_norm_fused(tx, tw, tb, 8, 1e-5, act) * _t(g)).sum().backward()
    for a, c in zip((tx, tw, tb), want):
        np.testing.assert_allclose(a.grad.numpy(), np.asarray(c), rtol=1e-4,
                                   atol=1e-4, err_msg=str(act))


def test_group_norm_routing_rule_matches_jax():
    """The port routes the JAX package's shapes: its rule equals the JAX
    ``supported`` at the SD level-0 slab and an 84 MB slab, and takes
    every GroupNorm of the full UNet at B 8 on 64 x 64 latents."""
    from paddle_tpu.ops.pallas.group_norm import supported

    for shape, groups in (((8, 320, 64, 64), 32), ((1, 320, 256, 256), 1)):
        assert gn.supported(shape, groups) == supported(shape, groups)
    assert gn.supported((8, 320, 64, 64), 32)
    assert not gn.supported((1, 320, 256, 256), 1)
    for C, side in ((320, 64), (640, 64), (960, 64), (640, 32), (960, 32),
                    (1280, 32), (1920, 32), (1280, 16), (1920, 16),
                    (2560, 16), (1280, 8), (2560, 8)):
        assert gn.supported((8, C, side, side), 32), (C, side)
    assert not gn.supported((8, 30, 4, 4), 32)
    assert not gn.supported((8, 32), 8)


def test_decode_attention_split_rule():
    """``split_for`` is a pure function of (B, KV, L): the served shape
    (B 8, KV 4, L 256) splits each cache row over 4 blocks of 64 rows (128
    blocks), L 4096 over 8; a grid that already fills the card's 132 SMs,
    or a cache too short for two 64-row chunks, is not split."""
    assert da.split_for(8, 4, 256) == 4
    assert da.split_for(8, 4, 4096) == 8
    assert da.split_for(8, 4, 200) == 2
    for B, KV in ((33, 4), (132, 1), (66, 2), (200, 8)):
        assert da.split_for(B, KV, 4096) == 1, (B, KV)
    for L in (1, 64, 127):
        assert da.split_for(8, 4, L) == 1, L
    assert da.split_for(1, 1, 128) == 2


def test_group_norm_routes_at_unet_shapes():
    """``gn.route`` is a pure function of shape and dtype: the cluster size
    K of the forward and backward of every GroupNorm shape of a bench_unet
    step (B 8, 32 groups, bf16; the act does not enter), and the streaming
    route (K 0) only for slabs too large for the clusters."""
    for (C, hw), k in (((320, 1024), 1), ((320, 4096), 2), ((640, 256), 1),
                       ((640, 1024), 1), ((640, 4096), 4), ((960, 1024), 2),
                       ((960, 4096), 8), ((1280, 64), 1), ((1280, 256), 1),
                       ((1280, 1024), 2), ((1920, 256), 1),
                       ((1920, 1024), 4), ((2560, 64), 1), ((2560, 256), 1)):
        side = int(hw ** 0.5)
        for backward in (False, True):
            assert gn.route((8, C, side, side), 32, torch.bfloat16,
                            backward) == k, (C, hw, backward)
    assert gn.route((8, 960, 64, 64), 32, torch.float32, True) == 8
    for backward in (False, True):
        assert gn.route((1, 8, 300, 300), 1, torch.bfloat16, backward) == 0


def test_group_norm_mean_shifted_no_nan():
    """tests/test_fused_kernels.py's case on the port: 1000 +- 0.01 input,
    judged against the f64 truth; the pivot-shifted plain version is finite
    and never worse than the plain composition."""
    from paddle_tpu_torch.ops.fused_norm import (group_norm_fused,
                                                 group_norm_lax)

    rng = np.random.default_rng(1)
    x = (1000.0 + 0.01 * rng.standard_normal((2, 8, 4, 4))).astype(
        np.float32)
    w, b = torch.ones(8), torch.zeros(8)
    out = group_norm_fused(_t(x), w, b, 4, 1e-5, None).numpy()
    ref = group_norm_lax(_t(x), w, b, 4, 1e-5, None).numpy()
    x64 = x.astype(np.float64).reshape(2, 4, -1)
    true = ((x64 - x64.mean(-1, keepdims=True))
            / np.sqrt(x64.var(-1, keepdims=True) + 1e-5)).reshape(x.shape)
    assert np.isfinite(out).all()
    kerr, lerr = np.abs(out - true).max(), np.abs(ref - true).max()
    assert kerr < 0.02, kerr
    assert kerr <= lerr + 1e-3, (kerr, lerr)


def _rope_case(dtype, seed):
    import jax.numpy as jnp

    rng = np.random.default_rng(seed)
    B, S, H, D = 2, 16, 3, 8
    x = rng.normal(size=(B, S, H, D))
    t = rng.normal(size=(S, D // 2))
    g = rng.normal(size=(B, S, H, D))
    return [jnp.asarray(a, dtype) for a in (x, np.cos(t), np.sin(t), g)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rope_plain_matches_jax(dtype):
    """rope_fused (its plain versions) against the Pallas kernel in
    interpret mode: the rotation and the gradients of x, cos and sin. f32
    at 1e-5. bf16: XLA rounds each product and the sum (the TPU kernel's
    arithmetic), the plain version rounds the f32 result once; half a
    spacing of each product and one of the result stay within 2^-6 of the
    terms |x1 c| + |x2 s| (of the gradients' products for the tables)."""
    import jax

    from paddle_tpu.ops.pallas import rope as prope

    jx, jc, js, jg = _rope_case(dtype, 4)
    want = prope.rope_fused(jx, jc, js)
    want_g = jax.grad(lambda x, c, s: (prope.rope_fused(x, c, s).astype(
        "float32") * jg.astype("float32")).sum(), (0, 1, 2))(jx, jc, js)
    tdt = getattr(torch, dtype)
    tx, tc, ts = (_t(np.asarray(a, np.float32)).to(tdt).requires_grad_()
                  for a in (jx, jc, js))
    tg = _t(np.asarray(jg, np.float32)).to(tdt)
    out = rp.rope_fused(tx, tc, ts)
    (out.float() * tg.float()).sum().backward()
    assert out.dtype == tdt and rp.fwd_launches == rp.bwd_launches == 0
    f = lambda a: np.asarray(a, np.float32)       # noqa: E731
    x, c, s, g = map(f, (jx, jc, js, jg))
    d2 = x.shape[-1] // 2
    ac, as_ = np.abs(c[None, :, None, :]), np.abs(s[None, :, None, :])

    def terms(v):
        v1, v2 = np.abs(v[..., :d2]), np.abs(v[..., d2:])
        return np.concatenate([v1 * ac + v2 * as_, v2 * ac + v1 * as_], -1)

    gx = np.abs(g * x)
    tterm = (gx[..., :d2] + gx[..., d2:]).sum((0, 2))
    for name, a, w, t in (("out", out, want, terms(x)),
                          ("dx", tx.grad, want_g[0], terms(g)),
                          ("dcos", tc.grad, want_g[1], tterm),
                          ("dsin", ts.grad, want_g[2], tterm)):
        tol = 1e-5 * (1 + np.abs(f(w))) if dtype == "float32" else \
            2 ** -6 * t + 1e-6
        assert (np.abs(f(a.detach().float()) - f(w)) <= tol).all(), name


# -- on the card: each kernel against its plain version ----------------------

def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")


def _close(got, want, dtype):
    """Per element. f32: atol 1e-4 on O(1) outputs. bf16: two bf16
    spacings of |ref|, floored at those of 1e-3 of the row's largest
    |ref|: each side rounds one f32 result of reassociated sums to bf16,
    so they differ by one spacing at most."""
    got, want = got.float(), want.float()
    diff = (got - want).abs()
    if dtype == torch.float32:
        tol = torch.full_like(want, 1e-4)
    else:
        a = want.abs()
        a = torch.maximum(a, 1e-3 * a.amax(-1, keepdim=True))
        a = a.clamp_min(torch.finfo(torch.float32).tiny)
        tol = 2 * torch.exp2(torch.floor(torch.log2(a)) - 7)
    assert (diff <= tol).all(), (diff.max().item(),
                                 (diff / tol).max().item())


def _close_nan(got, want, dtype):
    """``_close`` where NaN (an empty prefix's 0 / 0) must sit in the same
    places on both sides."""
    nan = torch.isnan(want)
    assert torch.equal(nan, torch.isnan(got))
    _close(got.masked_fill(nan, 0.0), want.masked_fill(nan, 0.0), dtype)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("quant", [False, True])
def test_decode_attention_kernel_matches_plain_on_card(dtype, quant):
    """Every split (``split_for`` P of 1, 2, 4 and 8), lengths of 0, 1,
    L - 1 and L and on each side of a chunk boundary (k * ceil(L / P) +-
    1), L not a multiple of P (200, 300, 1030), rep 1 to 16, D 8 to 256,
    L 4096 (several steps of the cp.async ring a block); two launches
    must give the same bits."""
    _need_card()
    from chip_smoke import same_bits
    g = torch.Generator(device="cuda").manual_seed(0)
    splits = set()
    for B, H, KV, L, D, lens in (
            (8, 12, 4, 256, 64, [1, 37, 256, 0, 63, 65, 255, 129]),
            (4, 6, 2, 300, 8, [300, 1, 74, 151]),
            (4, 16, 1, 130, 256, [130, 64, 66, 7]),
            (2, 4, 4, 64, 128, [64, 63]),
            (4, 8, 2, 200, 64, [200, 99, 101, 0]),
            (3, 8, 8, 1030, 64, [1029, 128, 130]),
            (34, 12, 4, 256, 64, [(37 * i) % 257 for i in range(34)]),
            (8, 12, 4, 4096, 64, [4096, 1, 3000, 2049, 4000, 511, 513,
                                  4095]),
            (2, 4, 4, 4096, 64, [4096, 2049]),
            (2, 16, 1, 4096, 128, [4095, 513])):
        splits.add(da.split_for(B, KV, L))
        q = torch.randn(B, H, D, generator=g, device="cuda").to(dtype)
        kf = torch.randn(B, KV, L, D, generator=g, device="cuda")
        vf = torch.randn(B, KV, L, D, generator=g, device="cuda")
        lt = torch.tensor(lens, dtype=torch.int32, device="cuda")
        if quant:
            k8, v8 = quantize_kv_rows(kf), quantize_kv_rows(vf)
            args = (q, k8["q"], v8["q"], lt)
            kw = dict(k_scale=k8["s"], v_scale=v8["s"])
        else:
            args, kw = (q, kf.to(dtype), vf.to(dtype), lt), {}
        got = da.decode_attention(*args, **kw)
        again = da.decode_attention(*args, **kw)
        torch.cuda.synchronize()
        _close_nan(got, da.decode_attention_ref(*args, **kw), dtype)
        assert same_bits(got, again), (B, H, KV, L, D)
    assert splits == {1, 2, 4, 8}, splits


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_int8_matmul_kernel_matches_plain_on_card(dtype):
    """The serving shapes at 8 rows, the head and down at every prefill
    row count, K and N off the kernel's 128-deep stages and its column
    strips (800 x 1040), and shapes off the 16-byte grid. Two calls on the
    same inputs must give the same bits (the split-K sum has a fixed
    order)."""
    _need_card()
    g = torch.Generator(device="cuda").manual_seed(0)
    for B, K, N in ((8, 768, 1280), (8, 768, 768), (8, 768, 4096),
                    (8, 2048, 768), (8, 768, 32000), (16, 768, 32000),
                    (32, 768, 32000), (48, 768, 32000), (64, 768, 32000),
                    (16, 2048, 768), (32, 2048, 768), (48, 2048, 768),
                    (64, 2048, 768), (40, 800, 1040), (64, 768, 1000),
                    (1, 100, 17), (33, 130, 48)):
        x = torch.randn(B, K, generator=g, device="cuda").to(dtype)
        w, s = weight_quantize(
            torch.randn(K, N, generator=g, device="cuda") * 0.02)
        n0 = i8.launches_by_rows.get(B, 0)
        got = i8.int8_matmul(x, w, s)
        again = i8.int8_matmul(x, w, s)
        torch.cuda.synchronize()
        assert i8.launches_by_rows[B] - n0 == 2, (B, K, N)
        _close(got, i8.int8_matmul_ref(x, w, s), dtype)
        assert torch.equal(got, again), (B, K, N)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_rms_norm_kernels_match_plain_on_card(dtype):
    """Odd row counts and widths, w in the other dtype, and fewer rows
    than the backward's blocks (100 x 768). Two backward calls must give
    the same bits (dw sums in a fixed order). Tolerances
    follow x's dtype: every output is a function of the normalized rows,
    which both sides round to x's dtype."""
    _need_card()
    g = torch.Generator(device="cuda").manual_seed(0)
    other = torch.float32 if dtype == torch.bfloat16 else torch.bfloat16
    for shape, wdt in (((8192, 768), dtype), ((100, 768), dtype),
                       ((3, 37, 200), dtype), ((5, 96), other),
                       ((2, 1, 4096), dtype), ((13, 7), dtype)):
        x = torch.randn(shape, generator=g, device="cuda").to(dtype)
        w = (1 + 0.1 * torch.randn(shape[-1], generator=g,
                                   device="cuda")).to(wdt)
        out, inv = rn.rms_fwd(x, w, 1e-6)
        ref_out, ref_inv = rn.rms_fwd_ref(x, w, 1e-6)
        gy = torch.randn(out.shape, generator=g, device="cuda").to(out.dtype)
        dx, dw = rn.rms_bwd(x, w, inv, gy)
        dx2, dw2 = rn.rms_bwd(x, w, inv, gy)
        ref_dx, ref_dw = rn.rms_bwd_ref(x, w, ref_inv, gy)
        torch.cuda.synchronize()
        for got, want in ((out, ref_out), (dx, ref_dx), (dw, ref_dw)):
            assert got.dtype == want.dtype and got.shape == want.shape
            _close(got, want, dtype)
        _close(inv, ref_inv, torch.float32)
        assert torch.equal(dx, dx2) and torch.equal(dw, dw2), shape


@pytest.mark.gpu
def test_rms_norm_fwd_check_over_seeds_on_card():
    """``chip_smoke.rms_fwd_check``, the smoke run's gate of the RMSNorm
    forward, at the served shape (8192 x 768, bf16) over 8 seeds: inv
    within the f32 tolerance of the plain inv, and the output within two
    bf16 spacings of the plain output formed from the kernel's own inv.
    The plain version's own output (it rounds twice) may sit further off
    by the rounding an inv one ulp off moves; its ratio is not gated."""
    _need_card()
    from chip_smoke import rms_fwd_check
    for seed in range(8):
        g = torch.Generator(device="cuda").manual_seed(seed)
        x = torch.randn(8192, 768, generator=g,
                        device="cuda").to(torch.bfloat16)
        w = (1 + 0.1 * torch.randn(768, generator=g, device="cuda")).to(
            torch.bfloat16)
        out, inv = rn.rms_fwd(x, w, 1e-6)
        e_out, e_inv, _ = rms_fwd_check(x, w, 1e-6, out, inv)
        assert e_out[1] <= 1 and e_inv[1] <= 1, (seed, e_out, e_inv)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_kernels_match_plain_on_card(dtype):
    """Ragged lengths (Sq and Sk off the 64- and 128-row tiles, so TMA's
    zero-filled edge is masked), Sq = 1, sq < sk causal with an offset off
    the tiles, non-causal sq > sk, every head dim (bf16 D 80: the UNet's
    level-1 heads), B*H over the card's 132 SMs, and two backward runs
    whose dq agree although bf16 dq's f32 sums land in another order each
    run. bf16 adds chip_smoke's bound for p and ds rounded at another
    point."""
    _need_card()
    from chip_smoke import err_and_tol, flash_bounds
    g = torch.Generator(device="cuda").manual_seed(0)
    for B, Sq, Sk, H, D, causal in ((2, 100, 100, 3, 64, True),
                                    (1, 77, 200, 2, 32, True),
                                    (2, 130, 70, 2, 16, False),
                                    (1, 64, 64, 2, 128, True),
                                    (1, 257, 257, 1, 64, False),
                                    (2, 200, 200, 2, 80, False),
                                    (1, 90, 150, 3, 80, True),
                                    (2, 100, 333, 2, 64, True),
                                    (1, 190, 250, 2, 128, False),
                                    (2, 1, 300, 2, 64, False),
                                    (1, 1, 77, 3, 80, True),
                                    (1, 1, 1, 2, 16, True),
                                    (4, 256, 256, 40, 64, True),
                                    (3, 300, 300, 50, 80, False)):
        if D not in fa._HEAD_DIMS[dtype]:
            continue
        q, k, v = (torch.randn(B, S, H, D, generator=g, device="cuda").to(
            dtype) for S in (Sq, Sk, Sk))
        do = torch.randn(B, Sq, H, D, generator=g, device="cuda").to(dtype)
        scale = D ** -0.5
        out, lse = fa.flash_fwd(q, k, v, causal, scale)
        ref_out, ref_lse = fa.flash_fwd_ref(q, k, v, causal, scale)
        grads = fa.flash_bwd(q, k, v, ref_out, ref_lse, do, causal, scale)
        again = fa.flash_bwd(q, k, v, ref_out, ref_lse, do, causal, scale)
        refs = fa.flash_bwd_ref(q, k, v, ref_out, ref_lse, do, causal, scale)
        torch.cuda.synchronize()
        bounds = flash_bounds(q, k, v, ref_lse, do, causal, scale)
        case = (B, Sq, Sk, H, D, causal)
        for name, got, want in zip(("out", "dq", "dk", "dv"),
                                   (out, *grads), (ref_out, *refs)):
            assert got.dtype == dtype and got.shape == want.shape
            err, ratio, _ = err_and_tol(got, want, dtype, bounds[name])
            assert ratio <= 1, (case, name, err, ratio)
        assert (lse - ref_lse).abs().max().item() <= 1e-4, case
        # dk and dv sum in a fixed order; dq within the stated tolerance
        assert torch.equal(grads[1], again[1]), case
        assert torch.equal(grads[2], again[2]), case
        err, ratio, _ = err_and_tol(again[0], grads[0], dtype)
        assert ratio <= 1, (case, "dq run to run", err, ratio)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_group_norm_kernels_match_plain_on_card(dtype):
    """Every route and split of ``gn.route``: clusters of 1, 2, 4 and 8
    blocks (cg = 10 channels over 8 blocks, so a channel spans blocks; the
    8 x 8 maps at one block a slab), the streaming route for slabs too
    large for the clusters (vectorized and one element at a time), HW not
    a multiple of 8, 3D and 5D inputs, w in the other dtype, both acts, a
    mean far from zero. Forward and backward outputs must repeat bit for
    bit over two runs."""
    _need_card()
    g = torch.Generator(device="cuda").manual_seed(0)
    other = torch.float32 if dtype == torch.bfloat16 else torch.bfloat16
    routes = set()
    for shape, G, act, wdt, shift in (
            ((1, 320, 64, 64), 32, "silu", dtype, 0),
            ((2, 320, 64, 64), 32, "silu", dtype, 0),
            ((4, 320, 64, 64), 32, "silu", dtype, 0),
            ((2, 960, 64, 64), 32, "silu", dtype, 0),
            ((8, 1280, 8, 8), 32, "silu", dtype, 0),
            ((2, 2560, 8, 8), 32, "silu", dtype, 0),
            ((2, 640, 32, 32), 32, None, dtype, 0),
            ((8, 640, 32, 32), 32, None, dtype, 0),
            ((3, 96, 7, 7), 8, "silu", other, 0),
            ((2, 64, 200), 4, None, dtype, 0),
            ((1, 64, 3, 5, 7), 4, "silu", dtype, 0),
            ((2, 32, 16, 16), 8, None, dtype, 50),
            ((1, 8, 300, 300), 1, "silu", other, 0),
            ((1, 16, 250, 250), 4, None, dtype, 0)):
        x = (torch.randn(shape, generator=g, device="cuda") + shift).to(dtype)
        C = shape[1]
        w = (1 + 0.1 * torch.randn(C, generator=g, device="cuda")).to(wdt)
        b = (0.1 * torch.randn(C, generator=g, device="cuda")).to(wdt)
        gy = torch.randn(shape, generator=g, device="cuda").to(dtype)
        routes |= {("fwd", gn.route(shape, G, dtype, False)),
                   ("bwd", gn.route(shape, G, dtype, True))}
        out, mean, rstd = gn.gn_fwd(x, w, b, G, 1e-5, act)
        again = gn.gn_fwd(x, w, b, G, 1e-5, act)
        ref_out, ref_mean, ref_rstd = gn.gn_fwd_ref(x, w, b, G, 1e-5, act)
        grads = gn.gn_bwd(x, w, b, ref_mean, ref_rstd, gy, G, act)
        grads2 = gn.gn_bwd(x, w, b, ref_mean, ref_rstd, gy, G, act)
        refs = gn.gn_bwd_ref(x, w, b, ref_mean, ref_rstd, gy, G, act)
        torch.cuda.synchronize()
        for got, want in zip((out, grads[0]), (ref_out, refs[0])):
            assert got.dtype == want.dtype and got.shape == want.shape
            _close(got, want, dtype)
        # dw and db sum B * HW products per channel in f32 in another
        # order: f32 is held to 1e-4 of their largest magnitude
        for got, want in zip(grads[1:], refs[1:]):
            assert got.dtype == want.dtype == wdt and got.shape == (C,)
            if wdt == torch.float32:
                scale = want.abs().amax().clamp_min(1)
                got, want = got / scale, want / scale
            _close(got, want, wdt)
        _close(mean, ref_mean, torch.float32)
        _close(rstd / ref_rstd, torch.ones_like(rstd), torch.float32)
        for a, r in zip((out, mean, rstd) + grads, again + grads2):
            assert torch.equal(a, r), shape
    assert routes == {(d, k) for d in ("fwd", "bwd")
                      for k in (0, 1, 2, 4, 8)}, sorted(routes)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_rope_kernel_matches_plain_on_card(dtype):
    """The 16-byte path (D/2 a multiple of 8: D 16, 64, 128, 256 and H
    not a multiple of the kernel's 4-head batches) and the element path
    (D/2 off the 8-grid: D 8, 20, 130; and x 2 bytes off 16-byte
    alignment), forward and backward."""
    _need_card()
    g = torch.Generator(device="cuda").manual_seed(0)
    for B, S, H, D, shift in ((8, 1024, 12, 64, 0), (2, 8, 3, 8, 0),
                              (1, 24, 5, 130, 0), (2, 16, 3, 20, 0),
                              (2, 32, 4, 128, 0), (1, 8, 7, 256, 0),
                              (3, 16, 2, 16, 0), (2, 16, 3, 64, 1)):
        n = B * S * H * D
        x = torch.randn(n + shift, generator=g, device="cuda").to(dtype)
        x = x[shift:].view(B, S, H, D)
        t = torch.randn(S, D // 2, generator=g, device="cuda")
        c, s = t.cos().to(dtype), t.sin().to(dtype)
        out, back = rp.rope_fwd(x, c, s), rp.rope_bwd(x, c, s)
        torch.cuda.synchronize()
        _close(out, rp.rope_ref(x, c, s), dtype)
        _close(back, rp.rope_ref(x, c, s, -1), dtype)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_decode_attention_empty_prefix_on_card(dtype):
    """Valid length 0 gives NaN in every head on the card as in the plain
    version (and the JAX kernel), however many blocks split the row (P 4
    and 8, fp and int8 K/V), and whatever a neighbouring row's length;
    the other rows hold their usual tolerance."""
    _need_card()
    g = torch.Generator(device="cuda").manual_seed(1)
    for L, lens, quant in ((256, [0, 100, 256], False),
                           (4096, [0, 1, 4096], False),
                           (4096, [4095, 0, 512], True)):
        assert da.split_for(3, 4, L) > 1
        q = torch.randn(3, 12, 64, generator=g, device="cuda").to(dtype)
        kf, vf = (torch.randn(3, 4, L, 64, generator=g, device="cuda")
                  for _ in range(2))
        lt = torch.tensor(lens, dtype=torch.int32, device="cuda")
        if quant:
            k8, v8 = quantize_kv_rows(kf), quantize_kv_rows(vf)
            args = (q, k8["q"], v8["q"], lt)
            kw = dict(k_scale=k8["s"], v_scale=v8["s"])
        else:
            args, kw = (q, kf.to(dtype), vf.to(dtype), lt), {}
        got = da.decode_attention(*args, **kw)
        torch.cuda.synchronize()
        want = da.decode_attention_ref(*args, **kw)
        empty = lens.index(0)
        assert torch.isnan(got[empty]).all()
        assert torch.isnan(want[empty]).all()
        keep = [i for i in range(3) if i != empty]
        _close(got[keep], want[keep], dtype)


@pytest.mark.gpu
def test_threefry_kernel_matches_plain_on_card():
    """Both words bit for bit: a served sampling step (8 keys x 32000
    counters), one key x 2^20, counts off the 256-thread block, a counter
    base near 2^32 (the iota wraps, as fold_in's data may), and split /
    fold_in through the kernel against the CPU plain version."""
    _need_card()
    from paddle_tpu_torch import random as rnd
    from paddle_tpu_torch.ops.kernels import threefry as tf
    keys = rnd.split(rnd.PRNGKey(7, device="cuda"), 8)
    for R, n, base in ((8, 32000, 0), (1, 2**20, 0), (3, 1, 0),
                       (3, 255, 0), (3, 257, 2**32 - 100), (8, 2, 5)):
        k = keys[:R].contiguous()
        got = tf.threefry_words(k, n, base)
        torch.cuda.synchronize()
        assert torch.equal(got, tf.threefry_words_ref(k, n, base)), (R, n)
    assert torch.equal(rnd.split(keys[3], 5).cpu(),
                       rnd.split(keys[3].cpu(), 5))
    assert torch.equal(rnd.fold_in(keys[3], 1234).cpu(),
                       rnd.fold_in(keys[3].cpu(), 1234))


def _tiny_gpu_llama():
    from paddle_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM
    return LlamaForCausalLM(LlamaConfig(
        vocab_size=512, hidden_size=256, intermediate_size=512,
        num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
        max_position_embeddings=256, dtype="bfloat16"), seed=0)


@pytest.mark.gpu
@pytest.mark.parametrize("quant", [None, "int8wk"])
def test_graph_sampled_chunk_matches_eager_on_card(quant):
    """Four chained sampled chunks (top-k 50, top-p 0.9, temperature 0.8)
    through ``decode_chunk`` (eager, capture and replay, replays) against
    the eager chunk body on a second carry: the same tokens, keys and
    carry; one graph; two threefry launches a step on each replay."""
    _need_card()
    from paddle_tpu_torch.inference.generate import (LlamaDecoder,
                                                     _sample_spec)
    from paddle_tpu_torch.ops.kernels import threefry as tf
    dec = LlamaDecoder(_tiny_gpu_llama(), max_len=64, quant=quant)
    ids = np.random.default_rng(0).integers(0, 512, (3, 5))
    sample = _sample_spec(True, 50, 0.9)
    with torch.inference_mode():
        st, ref = (dec.init_decode_state(ids, eos_token_id=7,
                                         temperature=0.8, seed=3)
                   for _ in range(2))
        d0 = dec.dispatch_count
        for i in range(4):
            tf.launches = 0
            toks, st = dec.decode_chunk(st, 5, True, 50, 0.9)
            assert tf.launches == 2 * 5, i
            want, ref = dec._chunk_steps(ref, 5, sample)
            assert torch.equal(toks, want), i
            for name in ("logits", "pos", "keys", "done"):
                assert torch.equal(getattr(st, name), getattr(ref, name)), \
                    (i, name)
        assert dec.dispatch_count - d0 == 4
        assert sum(g is not None for g in dec._chunk_graphs.values()) == 1


@pytest.mark.gpu
@pytest.mark.parametrize("quant", [None, "int8wk"])
def test_graph_admission_prefill_matches_eager_on_card(quant):
    """Four ring admission prefills of one key (bucket 16, one row: eager,
    capture and replay, replays) against the eager body on a second ring:
    the staged logits and K/V bit for bit after each; one dispatch each;
    one graph; the replays count the int8 kernel's launches. Canaries the
    size of the graph's scratch caches, allocated between the calls, keep
    their values (a replay writes only memory the graph holds)."""
    _need_card()
    from paddle_tpu_torch.inference.generate import (AdmissionRing,
                                                     LlamaDecoder)
    dec = LlamaDecoder(_tiny_gpu_llama(), max_len=64, quant=quant)
    ring = AdmissionRing.allocate(dec, 3, *dec._empty_cache(5))
    ref = AdmissionRing.allocate(dec, 3, *dec._empty_cache(5))
    rng = np.random.default_rng(1)
    d0 = dec.dispatch_count

    def leaves(c):
        return list(c.values()) if isinstance(c, dict) else [c]

    as_t = lambda a: torch.tensor(a, device="cuda")   # noqa: E731
    canaries = []
    for i, (n, row) in enumerate(((5, 0), (16, 2), (9, 1), (3, 2))):
        ids = np.zeros((1, 16), np.int64)
        ids[0, :n] = rng.integers(0, 512, n)
        i8.launches = 0
        dec.ring_admit_prefill(ids, [n], [0], ring, [row])
        got_i8 = i8.launches
        shapes = [(x.shape, x.dtype) for c in dec._empty_cache(1)
                  for x in leaves(c)]
        canaries += [torch.full(sh, 3, dtype=dt, device="cuda")
                     for sh, dt in shapes]
        i8.launches = 0
        with torch.inference_mode():
            kc, vc = dec._empty_cache(1)
            dec._ring_prefill(dec._ids(ids), as_t([n]), as_t([0]),
                              as_t([row]), kc, vc, ref)
        torch.cuda.synchronize()
        assert got_i8 == i8.launches == (9 if quant else 0), i
        assert torch.equal(ring.logits, ref.logits), i
        for a, b in ((ring.kc, ref.kc), (ring.vc, ref.vc)):
            for x, y in zip(leaves(a), leaves(b)):
                assert torch.equal(x, y), i
    torch.cuda.synchronize()
    assert all(bool((c == 3).all()) for c in canaries)
    assert dec.dispatch_count - d0 == 4
    assert sum(g is not None for g in dec._prefill_graphs.values()) == 1


@pytest.mark.gpu
@pytest.mark.parametrize("quant", [None, "int8w"])
def test_graph_fused_generate_matches_eager_on_card(quant):
    """``generate``'s fused loop as one CUDA graph a key against the
    eager loop (a second decoder over the same model whose fused route
    never captures), greedy and sampled (top-k 50, top-p 0.9,
    temperature 0.8), each without and with an eos that stops a row
    early: at prompt length 5 (the key's eager warm-up, the capture, a
    replay) and then 9 (a replay of the same graph), the same tokens bit
    for bit; prefill + 1 dispatches a call; one graph a key."""
    _need_card()
    from paddle_tpu_torch.inference.generate import LlamaDecoder
    model = _tiny_gpu_llama()
    dec = LlamaDecoder(model, max_len=64, quant=quant)
    ref = LlamaDecoder(model, max_len=64, quant=quant)
    ref._fused_graph = lambda key: None
    rng = np.random.default_rng(3)
    prompts = {S: rng.integers(0, 512, (4, S)) for S in (5, 9)}
    eos = int(np.asarray(ref.generate(prompts[5], 12))[0, 5 + 4])
    modes = [dict(), dict(eos_token_id=eos),
             dict(do_sample=True, top_k=50, top_p=0.9, temperature=0.8,
                  seed=11),
             dict(do_sample=True, top_k=50, top_p=0.9, temperature=0.8,
                  seed=11, eos_token_id=eos)]
    for kw in modes:
        for S, calls in ((5, 3), (9, 1)):
            want = np.asarray(ref.generate(prompts[S], 12, **kw))
            for _ in range(calls):
                d0 = dec.dispatch_count
                got = np.asarray(dec.generate(prompts[S], 12, **kw))
                assert dec.dispatch_count - d0 == 2
                assert np.array_equal(got, want), (kw, S)
    graphs = [g for g in dec._fused_graphs.values() if g is not None]
    assert len(graphs) == len(dec._fused_graphs) == len(modes)
    assert all(g.replays == 3 for g in graphs)
    assert not any(g is not None for g in ref._fused_graphs.values())


@pytest.mark.gpu
def test_beam_search_on_card():
    """Beam search through the model's no-cache forward on the card (the
    RMSNorm kernels): the JAX package's output shape, ids in the vocab,
    two runs equal, beam 1 equal to its own greedy no-cache argmax, and
    an eos freezing the chosen beam."""
    _need_card()
    from paddle_tpu_torch.nn.generation import beam_search
    model = _tiny_gpu_llama()
    prompt = np.random.default_rng(2).integers(0, 512, (2, 6))
    rn.fwd_launches = 0
    out = beam_search(model, prompt, beam_size=4, max_new_tokens=8)
    assert rn.fwd_launches > 0
    assert out.shape == (2, 14) and ((out >= 0) & (out < 512)).all()
    np.testing.assert_array_equal(
        out, beam_search(model, prompt, beam_size=4, max_new_tokens=8))
    ids = prompt.copy()
    with torch.inference_mode():
        for _ in range(8):
            nxt = model(ids)[:, -1].float().argmax(-1).cpu().numpy()
            ids = np.concatenate([ids, nxt[:, None]], axis=1)
    np.testing.assert_array_equal(
        beam_search(model, prompt, beam_size=1, max_new_tokens=8), ids)
    eos = int(out[0, 8])
    seq = beam_search(model, prompt[:1], beam_size=3, max_new_tokens=8,
                      eos_token_id=eos)[0, 6:]
    if (seq == eos).any():
        assert (seq[int(np.argmax(seq == eos)):] == eos).all()


@pytest.mark.gpu
def test_flash_attention_at_the_bert_shape_on_card():
    """bench_bert's attention, non-causal B 16, H 12, S 512, D 64, bf16:
    the kernels against their plain versions at chip_smoke's bf16
    tolerance (with its bound for p and ds rounded at another point)."""
    _need_card()
    from chip_smoke import err_and_tol, flash_bounds
    g = torch.Generator(device="cuda").manual_seed(1)
    B, S, H, D = 16, 512, 12, 64
    q, k, v, do = (torch.randn(B, S, H, D, generator=g, device="cuda")
                   .bfloat16() for _ in range(4))
    scale = D ** -0.5
    out, lse = fa.flash_fwd(q, k, v, False, scale)
    ref_out, ref_lse = fa.flash_fwd_ref(q, k, v, False, scale)
    grads = fa.flash_bwd(q, k, v, ref_out, ref_lse, do, False, scale)
    refs = fa.flash_bwd_ref(q, k, v, ref_out, ref_lse, do, False, scale)
    bounds = flash_bounds(q, k, v, ref_lse, do, False, scale)
    for name, got, want in zip(("out", "dq", "dk", "dv"), (out, *grads),
                               (ref_out, *refs)):
        err, ratio, _ = err_and_tol(got, want, torch.bfloat16, bounds[name])
        assert ratio <= 1, (name, err, ratio)
    assert (lse - ref_lse).abs().max().item() <= 1e-4


def _tiny_gpu_trainer(model):
    from paddle_tpu_torch.optimizer import AdamW
    from paddle_tpu_torch.parallel import ShardedTrainer
    return ShardedTrainer(model, AdamW(learning_rate=1e-3,
                                       parameters=model.parameters(),
                                       multi_precision=False),
                          lambda m, i, l: m.loss(i, l))


@pytest.mark.gpu
def test_gpt_dropout_replays_draw_new_masks_on_card():
    """A GPT at dropout 0.1, bf16, its step captured: from one state, two
    replays (step key counters c and c + 1) give different losses, and an
    eager step at counter c gives the first replay's loss bit for bit;
    the counter moves by one a step, inside the graph."""
    _need_card()
    from chip_smoke import saved_state
    from paddle_tpu_torch.models import GPTConfig, GPTForCausalLM
    model = GPTForCausalLM(GPTConfig(
        vocab_size=512, hidden_size=128, num_hidden_layers=2,
        num_attention_heads=2, intermediate_size=256,
        max_position_embeddings=128, dropout=0.1), dtype=torch.bfloat16)
    tr = _tiny_gpu_trainer(model)
    rng = np.random.default_rng(0)
    batch = [torch.as_tensor(rng.integers(0, 512, (4, 64)), device="cuda")
             for _ in range(2)]
    for _ in range(2):                      # warm-up, capture
        tr.train_step(*batch)
    assert tr._seed_dev.item() == 2
    restore = saved_state(tr)
    a = tr.train_step(*batch)
    restore(seed=False)
    b = tr.train_step(*batch)
    assert tr._seed_dev.item() == 4
    restore()
    e = tr._eager_step(*batch)
    torch.cuda.synchronize()
    assert not torch.equal(a, b), a.item()
    assert torch.equal(a, e), (a.item(), e.item())


@pytest.mark.gpu
def test_default_generator_draws_on_card():
    """Dropout outside a trainer's step: the default generator's key
    moves to the card at the first draw there and is split there by the
    threefry kernel (no host copy), the masks bit-equal to the CPU's
    under the same seed; a ``torch.cuda.graph`` capture of a dropout
    advances the key at every replay, as eager draws from the same seed
    do."""
    _need_card()
    from paddle_tpu_torch.framework import random as rng_state
    from paddle_tpu_torch.nn import functional as TF
    from paddle_tpu_torch.ops.kernels import capture
    from paddle_tpu_torch.ops.kernels import threefry as tf
    x = torch.ones(64, 256)
    rng_state.seed(3)
    want = [TF.dropout(x, p=0.5) for _ in range(2)]
    rng_state.seed(3)
    xc = x.cuda()
    n0 = tf.launches
    got = [TF.dropout(xc, p=0.5) for _ in range(2)]
    assert rng_state.get_rng_state().device.type == "cuda"
    assert tf.launches > n0
    for g, w in zip(got, want):
        assert torch.equal(g.cpu(), w)
    rng_state.seed(5)
    graph = torch.cuda.CUDAGraph()
    with capture(graph):                    # torch.cuda.graph, gc paused
        out = TF.dropout(xc, p=0.5)
    replays = []
    for _ in range(2):
        graph.replay()
        replays.append(out.clone())
    rng_state.seed(5)
    eager = [TF.dropout(xc, p=0.5) for _ in range(2)]
    torch.cuda.synchronize()
    assert not torch.equal(replays[0], replays[1])
    for r, e in zip(replays, eager):
        assert torch.equal(r, e)


@pytest.mark.gpu
def test_moe_step_graph_matches_eager_on_card():
    """The dropless MoE LM (bf16, ragged dispatch through
    ``torch._grouped_mm``) trained through a captured step: the first
    replay's loss bit-equal to an eager step from the same state, its
    gradients at cosine >= 0.999 to the eager ones, the losses falling;
    and the card's grouped product against the CPU's per-expert loop on
    the same rows within two bf16 spacings."""
    _need_card()
    from chip_smoke import _moe_lm, saved_state
    from paddle_tpu_torch.incubate.nn.moe import _ragged_dot
    model = _moe_lm(4096, 128, 256, 4, 2, "cuda")
    tr = _tiny_gpu_trainer(model)
    rng = np.random.default_rng(1)
    batch = [torch.as_tensor(rng.integers(0, 4096, (4, 64)), device="cuda")
             for _ in range(2)]
    losses = [tr.train_step(*batch).item() for _ in range(2)]
    restore = saved_state(tr)
    graph = next(iter(tr._graphs.values()))
    a = tr.train_step(*batch)
    g_graph = {n: g.float().clone() for n, g in graph.grads.items()}
    restore()
    for p in tr.params.values():
        p.grad = None
    loss = tr._loss(batch)
    loss.backward()
    assert torch.equal(a, loss.detach()), (a.item(), loss.item())
    for n, p in tr.params.items():
        x, y = g_graph[n].reshape(-1), p.grad.float().reshape(-1)
        if x.norm() > 0 or y.norm() > 0:
            cos = (x @ y / (x.norm() * y.norm())).item()
            assert cos >= 0.999, (n, cos)
    restore()
    for p in tr.params.values():
        p.grad = None
    losses += [tr.train_step(*batch).item() for _ in range(4)]
    assert losses[-1] < losses[0], losses
    x = torch.randn(100, 128, device="cuda").bfloat16()
    w = torch.randn(4, 128, 64, device="cuda").bfloat16()
    gs = torch.tensor([30, 0, 50, 20], device="cuda")
    got = _ragged_dot(x, w, gs)
    want = _ragged_dot(x.cpu().float(), w.cpu().float(), gs.cpu())
    _close(got.cpu(), want.bfloat16(), torch.bfloat16)
