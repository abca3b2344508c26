"""The port's UNet training slice against the JAX package, on the CPU.

``UNET_TINY`` (channels 32 and 64, 8 groups, 4 heads, context 32) at B 2
on 8 x 8 latents, f32, takes the same weights and inputs in both packages
(numpy seed 0, weights through ``convert.from_jax_state_dict``): the
state-dict names, the forward at 1e-4 and two ``ShardedTrainer`` steps
(losses at 1e-5, parameters at 1e-4). In the forward test
``flash_attention_min_seq`` is 16 on both sides, so the level-1
self-attention (4 x 4 = 16 keys, D 16) takes the flash path as the
full-size UNet's level 1 does. The port's GroupNorms take their kernel
route (the plain versions on CPU tensors); the JAX model runs its plain
GroupNorm (``use_fused_group_norm`` off on that side only), since the
interpret-mode Pallas GroupNorm doubles its compile time on one core.
``F.group_norm`` is held against the JAX function, Pallas kernel
included, with the flag on and off, and tests/test_torch_kernels.py holds
the GroupNorm kernels' plain versions against the Pallas kernels. The JAX
model is built once per module.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import paddle_tpu as paddle
from paddle_tpu.framework.tensor import Tensor
from paddle_tpu.models.unet import UNET_TINY as JAX_TINY
from paddle_tpu.models.unet import UNet2DConditionModel as JaxUNet
from paddle_tpu_torch.convert import from_jax_state_dict, to_numpy_state_dict
from paddle_tpu_torch.flags import flags, set_flags
from paddle_tpu_torch.models.unet import UNET_TINY, UNet2DConditionModel

B, SIDE, CTX = 2, 8, 8


def _t(a):
    return torch.from_numpy(np.array(a))


def _val(t):
    """The jax array of a paddle_tpu Tensor (or the array itself)."""
    return getattr(t, "_value", t)


def _weights(names_shapes, rng):
    """Weights uniform in +-1/sqrt(fan_in), norm scales 1 + 0.1 N, biases
    0.1 N: the GroupNorm affines are not the identity."""
    out = {}
    for n, shp in names_shapes:
        if n.endswith("bias"):
            v = 0.1 * rng.standard_normal(shp)
        elif len(shp) == 1:
            v = 1 + 0.1 * rng.standard_normal(shp)
        else:
            fan_in = shp[0] if len(shp) == 2 else int(np.prod(shp[1:]))
            v = rng.uniform(-1, 1, shp) / np.sqrt(fan_in)
        out[n] = v.astype(np.float32)
    return out


@pytest.fixture(scope="module")
def jax_unet():
    """(JAX model, numpy weights). The JAX initializers are bypassed while
    the model is built (each compiles its sampler for every new shape,
    some 10 s on one core), since the weights are set from numpy after."""
    from paddle_tpu.nn import initializer as init

    zeros = lambda self, shape, dtype="float32": jnp.asarray(  # noqa: E731
        np.zeros(shape, np.float32))
    with pytest.MonkeyPatch.context() as mp:
        for cls in (init.XavierUniform, init.KaimingUniform, init.Uniform,
                    init.Constant):
            mp.setattr(cls, "__call__", zeros)
        jm = JaxUNet(JAX_TINY)
    state = _weights([(n, tuple(p.shape)) for n, p in jm.state_dict().items()],
                     np.random.default_rng(0))
    return jm, state


@pytest.fixture
def jax_gn_off():
    paddle.set_flags({"use_fused_group_norm": False})
    yield
    paddle.set_flags({"use_fused_group_norm": True})


@pytest.fixture
def min_seq_16():
    old_t = flags.flash_attention_min_seq
    set_flags({"flash_attention_min_seq": 16})
    paddle.set_flags({"flash_attention_min_seq": 16})
    yield
    set_flags({"flash_attention_min_seq": old_t})
    paddle.set_flags({"flash_attention_min_seq": 512})


def _reset(jm, state):
    for n, p in jm.state_dict().items():
        p._set_value(jnp.asarray(state[n]))


def _port(state):
    return from_jax_state_dict(state, UNet2DConditionModel(UNET_TINY,
                                                           device="cpu"))


def _batch():
    rng = np.random.default_rng(1)
    return (rng.standard_normal((B, 4, SIDE, SIDE)).astype(np.float32),
            rng.integers(0, 1000, (B,)).astype(np.int64),
            rng.standard_normal((B, CTX, 32)).astype(np.float32),
            rng.standard_normal((B, 4, SIDE, SIDE)).astype(np.float32))


def loss_fn(m, x, t, ctx, tgt):
    """bench_unet's loss."""
    return ((m(x, t, ctx) - tgt).float() ** 2).mean()


def test_unet_state_dict_names_match_jax(jax_unet):
    """torch's Sequential / ModuleList name their children as paddle's
    Sequential / LayerList do: every name and shape agrees."""
    jm, state = jax_unet
    tm = UNet2DConditionModel(UNET_TINY, device="cpu")
    got = {n: tuple(p.shape) for n, p in tm.named_parameters()}
    want = {n: tuple(p.shape) for n, p in jm.state_dict().items()}
    assert len(want) == 140 and got == want
    assert "time_mlp.2.weight" in got and "down_blocks.1.0.1.to_kv2.weight" \
        in got and "upsamplers.0.conv.weight" in got
    assert got["down_blocks.0.0.0.conv1.weight"] == (32, 32, 3, 3)
    assert got["time_mlp.0.weight"] == (32, 128)
    assert tm.num_params() == sum(int(np.prod(s)) for s in want.values())
    assert to_numpy_state_dict(_port(state)).keys() == state.keys()


def test_unet_forward_matches_jax(jax_unet, min_seq_16, jax_gn_off):
    from paddle_tpu.autograd import tape

    jm, state = jax_unet
    _reset(jm, state)
    x, t, ctx, _ = _batch()
    params = dict(jm.state_dict())

    def fwd(values, x, t, ctx):
        originals = [(p, p._value) for p in params.values()]
        try:
            with tape.no_grad():
                for n, p in params.items():
                    p._value = values[n]
                return jm(Tensor(x), Tensor(t), Tensor(ctx))._value
        finally:
            for p, v in originals:
                p._value = v

    want = np.asarray(jax.jit(fwd)({n: p._value for n, p in params.items()},
                                   x, t, ctx))
    with torch.no_grad():
        got = _port(state)(_t(x), _t(t), _t(ctx)).numpy()
    assert got.shape == (B, 4, SIDE, SIDE)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


def test_unet_trainer_steps_match_jax(jax_unet, jax_gn_off):
    """Two steps of bench_unet's trainer (AdamW, multi_precision=False) on
    one batch: the JAX trainer's losses at 1e-5 and parameters at 1e-4.
    Attention takes the plain form on both sides here (the default
    ``flash_attention_min_seq``), which keeps the JAX step's compile
    short; the forward test covers the flash route."""
    from paddle_tpu.parallel import init_mesh
    from paddle_tpu.parallel.mesh import set_mesh
    from paddle_tpu.parallel.train import ShardedTrainer as JaxTrainer

    from paddle_tpu_torch.optimizer import AdamW
    from paddle_tpu_torch.parallel import ShardedTrainer

    jm, state = jax_unet
    _reset(jm, state)
    batch = _batch()
    mesh = init_mesh((1, 1, 1), ("dp", "sep", "mp"))
    try:
        jt = JaxTrainer(jm, paddle.optimizer.AdamW(
            learning_rate=1e-3, parameters=jm.parameters(),
            multi_precision=False),
            lambda m, x, t, c, y: ((m(x, t, c) - y).astype("float32") ** 2)
            .mean(), mesh, {})
        with mesh:
            want = [float(jt.train_step(*batch).numpy()) for _ in range(2)]
    finally:
        set_mesh(None)
    tm = _port(state)
    tt = ShardedTrainer(tm, AdamW(1e-3, parameters=tm.parameters(),
                                  multi_precision=False), loss_fn)
    got = [tt.train_step(*batch).item() for _ in range(2)]
    np.testing.assert_allclose(got, want, rtol=1e-5)
    assert got[1] < got[0]
    jstate = {n: np.asarray(p.value) for n, p in jm.state_dict().items()}
    for n, p in to_numpy_state_dict(tm).items():
        np.testing.assert_allclose(p, jstate[n], rtol=1e-4, atol=1e-4,
                                   err_msg=n)


@pytest.mark.parametrize("fused", [True, False])
def test_group_norm_functional_matches_jax(fused):
    """F.group_norm routes as the JAX function does: the GroupNorm unit
    (f32 statistics) with the flag on, the x-dtype mean/var composition
    with it off; bf16 values and f32 gradients agree."""
    import paddle_tpu.nn.functional as JF

    import paddle_tpu_torch.nn.functional as F

    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 16, 4, 4)).astype(np.float32) * 3 + 1
    w = (1 + 0.1 * rng.standard_normal(16)).astype(np.float32)
    b = (0.1 * rng.standard_normal(16)).astype(np.float32)
    g = rng.standard_normal(x.shape).astype(np.float32)
    set_flags({"use_fused_group_norm": fused})
    paddle.set_flags({"use_fused_group_norm": fused})
    try:
        want, want_g = jax.value_and_grad(
            lambda x, w, b: (_val(JF.group_norm(x, 4, w, b)) * g).sum(),
            (0, 1, 2))(*map(jnp.asarray, (x, w, b)))
        tx, tw, tb = (_t(a).requires_grad_() for a in (x, w, b))
        got = (F.group_norm(tx, 4, tw, tb) * _t(g)).sum()
        got.backward()
        xb = jnp.asarray(x, jnp.bfloat16)
        want_bf = np.asarray(_val(JF.group_norm(
            xb, 4, jnp.asarray(w, jnp.bfloat16),
            jnp.asarray(b, jnp.bfloat16))), np.float32)
        got_bf = F.group_norm(_t(x).bfloat16(), 4, _t(w).bfloat16(),
                              _t(b).bfloat16()).float().numpy()
    finally:
        set_flags({"use_fused_group_norm": True})
        paddle.set_flags({"use_fused_group_norm": True})
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-5, atol=1e-5)
    for a, c in zip((tx, tw, tb), want_g):
        np.testing.assert_allclose(a.grad.numpy(), np.asarray(c), rtol=1e-4,
                                   atol=1e-4)
    # bf16: one rounding of the f32 result with the flag on (at most one
    # spacing apart); with it off every op rounds, as in XLA (two spacings
    # of the output's largest magnitude)
    tol = 2 ** -7 * np.abs(want_bf) if fused else 2 ** -6 * np.abs(
        want_bf).max()
    assert (np.abs(got_bf - want_bf) <= tol + 1e-6).all()


def test_trainer_takes_bench_unet_numpy_batch():
    """bench_unet's batch as numpy: ml_dtypes bfloat16 latents and
    context (torch.as_tensor refuses them) and int64 timesteps reach the
    model bit for bit; a bf16 UNet trains one step on them, with a
    finite loss, and records the optimizer update's host time."""
    import ml_dtypes

    from paddle_tpu_torch.optimizer import AdamW
    from paddle_tpu_torch.parallel import ShardedTrainer

    rng = np.random.default_rng(0)
    x = rng.normal(size=(1, 4, SIDE, SIDE)).astype(ml_dtypes.bfloat16)
    t = rng.integers(0, 1000, (1,)).astype(np.int64)
    ctx = rng.normal(size=(1, CTX, 32)).astype(ml_dtypes.bfloat16)
    m = UNet2DConditionModel(UNET_TINY, device="cpu", dtype="bfloat16")
    assert {p.dtype for p in m.parameters()} == {torch.bfloat16}
    tr = ShardedTrainer(m, AdamW(1e-4, parameters=m.parameters(),
                                 multi_precision=False), loss_fn)
    seen = []
    tr.loss_fn = lambda m, *b: seen.extend(b) or loss_fn(m, *b)
    loss = tr.train_step(x, t, ctx, x)
    assert seen[0].dtype == torch.bfloat16 and seen[1].dtype == torch.int64
    np.testing.assert_array_equal(seen[0].view(torch.int16).numpy(),
                                  x.view(np.int16))
    assert torch.isfinite(loss) and tr.update_host_s > 0
    assert all(st["moment1"].dtype == torch.bfloat16
               for st in tr.opt_state.values())
