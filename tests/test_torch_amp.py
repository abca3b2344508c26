"""The port's AMP (paddle_tpu_torch/amp) and ``cross_entropy``'s options
against the JAX package's, on the CPU.

- The tiny Llama with f32 parameters under ``auto_cast(dtype=
  "bfloat16")``: the loss within two bf16 spacings of the JAX loss and
  every gradient at cosine >= 0.99 to ``jax.grad``'s (the tolerance of
  ``tests/test_torch_train.py::test_tiny_llama_bf16_loss_and_grads_match_
  jax``); two ``ShardedTrainer(amp_dtype="bfloat16")`` steps against the
  JAX trainer's at the same tolerance for the losses.
- ``auto_cast`` gives the JAX output dtypes for linear -> softmax ->
  cross_entropy, with values at bf16 tolerance, custom lists and O2.
- ``GradScaler`` gives the JAX scale sequence over a run with an inf
  step.
- ``cross_entropy``: each option against the JAX function at f32 1e-6.
"""

import numpy as np
import pytest
import torch

from paddle_tpu_torch import amp
from paddle_tpu_torch.convert import from_jax_state_dict
from paddle_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM
from paddle_tpu_torch.nn import functional as F

CFG = dict(vocab_size=256, hidden_size=64, intermediate_size=128,
           num_hidden_layers=2, num_attention_heads=4,
           num_key_value_heads=2, max_position_embeddings=64)
B, S = 2, 32


def _batch(step=0):
    rng = np.random.default_rng(11 + step)
    return (rng.integers(0, CFG["vocab_size"], (B, S)),
            rng.integers(0, CFG["vocab_size"], (B, S)))


def _models(seed=4):
    import paddle_tpu as paddle
    from paddle_tpu.models.llama import LlamaConfig as JaxConfig
    from paddle_tpu.models.llama import LlamaForCausalLM as JaxModel
    paddle.seed(seed)
    jm = JaxModel(JaxConfig(**CFG))
    state = {k: np.asarray(v.value) for k, v in jm.state_dict().items()}
    return jm, from_jax_state_dict(
        state, LlamaForCausalLM(LlamaConfig(**CFG), device="cpu"))


def _spacing(x):
    return 2.0 ** (np.floor(np.log2(abs(x))) - 7)


def test_amp_llama_loss_and_grads_match_jax():
    import jax

    from paddle_tpu.amp import auto_cast as jax_auto_cast
    from paddle_tpu.autograd import tape
    from paddle_tpu.framework.tensor import Tensor

    jm, tm = _models()
    ids, labels = _batch()
    state = dict(jm.state_dict())

    def jax_loss(params):
        originals = [(t, t._value) for t in state.values()]
        try:
            with tape.no_grad(), jax_auto_cast(dtype="bfloat16"):
                for n, t in state.items():
                    t._value = params[n]
                return jm.loss(Tensor(jax.numpy.asarray(ids)),
                               Tensor(jax.numpy.asarray(labels)))._value
        finally:
            for t, v in originals:
                t._value = v

    params = {n: t._value for n, t in state.items()}
    want_loss, want = jax.jit(jax.value_and_grad(jax_loss))(params)
    with amp.auto_cast(dtype="bfloat16"):
        loss = tm.loss(ids, labels)
    assert loss.dtype == torch.float32
    loss.backward()
    want_loss = float(want_loss)
    assert abs(loss.item() - want_loss) <= 2 * _spacing(want_loss), \
        (loss.item(), want_loss)
    for n, p in tm.named_parameters():
        assert p.dtype == torch.float32 and p.grad.dtype == torch.float32
        g = p.grad.double().reshape(-1)
        w = torch.from_numpy(np.asarray(want[n], np.float64)).reshape(-1)
        cos = float(g @ w / (g.norm() * w.norm()))
        assert cos >= 0.99, (n, cos)


def test_amp_trainer_steps_match_jax():
    """Two AdamW steps (f32 master weights) with ``amp_dtype=
    "bfloat16"`` in both trainers: each loss within two bf16 spacings of
    the JAX trainer's, and the parameters stay f32."""
    import paddle_tpu as paddle
    from paddle_tpu.parallel import init_mesh
    from paddle_tpu.parallel.mesh import set_mesh
    from paddle_tpu.parallel.train import ShardedTrainer as JaxTrainer

    from paddle_tpu_torch.optimizer import AdamW
    from paddle_tpu_torch.parallel import ShardedTrainer

    jm, tm = _models()
    mesh = init_mesh((1, 1, 1), ("dp", "sep", "mp"))
    try:
        jt = JaxTrainer(jm, paddle.optimizer.AdamW(
            1e-3, parameters=jm.parameters(), multi_precision=True),
            lambda m, i, l: m.loss(i, l), mesh, {}, amp_dtype="bfloat16")
        with mesh:
            want = [float(jt.train_step(*_batch(k)).numpy())
                    for k in range(2)]
    finally:
        set_mesh(None)
    tt = ShardedTrainer(tm, AdamW(1e-3, parameters=tm.parameters(),
                                  multi_precision=True),
                        lambda m, i, l: m.loss(i, l), amp_dtype="bfloat16")
    got = [tt.train_step(*_batch(k)).item() for k in range(2)]
    for g, w in zip(got, want):
        assert abs(g - w) <= 2 * _spacing(w), (got, want)
    assert all(p.dtype == torch.float32 for p in tm.parameters())


def test_auto_cast_dtypes_match_jax():
    """linear (white) -> softmax (black) -> cross_entropy (black): the
    JAX dtypes and values (bf16 inputs round alike: products in f32,
    one rounding), under O1, a custom black list and O2; off, nothing
    casts."""
    import jax.numpy as jnp

    import paddle_tpu as paddle
    from paddle_tpu.amp import auto_cast as jax_auto_cast
    from paddle_tpu.nn import functional as JF

    rng = np.random.default_rng(0)
    x = rng.standard_normal((4, 16)).astype(np.float32)
    w = rng.standard_normal((16, 8)).astype(np.float32) / 4
    lbl = rng.integers(0, 8, (4,))
    cases = [dict(), dict(custom_black_list={"linear"}),
             dict(level="O2"), dict(enable=False)]
    for kw in cases:
        with jax_auto_cast(dtype="bfloat16", **kw):
            jh = JF.linear(paddle.to_tensor(x), paddle.to_tensor(w))
            js = JF.softmax(jh)
            jl = JF.cross_entropy(jh, paddle.to_tensor(lbl))
        with amp.auto_cast(dtype="bfloat16", **kw):
            th = F.linear(torch.from_numpy(x), torch.from_numpy(w))
            ts = F.softmax(th)
            tl = F.cross_entropy(th, torch.from_numpy(lbl))
        for t, j in ((th, jh), (ts, js), (tl, jl)):
            assert str(t.dtype) == "torch." + str(j.value.dtype), kw
            jv = np.asarray(j.value.astype(jnp.float32))
            np.testing.assert_allclose(t.float().numpy(), jv, rtol=2 ** -7,
                                       atol=1e-6, err_msg=str(kw))
    assert not amp.is_auto_cast_enabled()
    assert amp.white_list() == paddle.amp.white_list()
    assert amp.black_list() == paddle.amp.black_list()


def test_decorate_o2_and_debugging_refused():
    m = torch.nn.Linear(3, 2)
    assert amp.decorate(m, level="O2", dtype="bfloat16") is m
    assert m.weight.dtype == torch.bfloat16
    with pytest.raises(NotImplementedError, match="item 14.1"):
        amp.debugging.check_numerics(torch.ones(2))


def test_grad_scaler_sequence_matches_jax():
    """Seven steps of a linear least-squares fit with a scaler (init 8,
    grow every 2 good steps, shrink after 1 bad), step 3's input holding
    an inf: the JAX scaler's scale after every step, the skipped update
    skipped in both, and the state dicts alike."""
    import paddle_tpu as paddle

    from paddle_tpu_torch.optimizer import SGD

    rng = np.random.default_rng(2)
    w0 = rng.standard_normal((3, 1)).astype(np.float32)
    xs = [rng.standard_normal((4, 3)).astype(np.float32) for _ in range(7)]
    xs[3][0, 0] = np.inf
    kw = dict(init_loss_scaling=8.0, incr_every_n_steps=2,
              decr_every_n_nan_or_inf=1)

    from paddle_tpu.framework.tensor import Parameter
    jw = Parameter(paddle.to_tensor(w0).value)
    jopt = paddle.optimizer.SGD(0.1, parameters=[jw])
    jsc = paddle.amp.GradScaler(**kw)
    tw = torch.nn.Parameter(torch.from_numpy(w0.copy()))
    topt = SGD(0.1, parameters=[tw])
    tsc = amp.GradScaler(**kw)
    want, got = [], []
    for x in xs:
        loss = (paddle.matmul(paddle.to_tensor(x), jw) ** 2).mean()
        jsc.scale(loss).backward()
        jsc.step(jopt)
        jopt.clear_grad()
        want.append(jsc.get_loss_scaling())
        tl = ((torch.from_numpy(x) @ tw) ** 2).mean()
        tsc.scale(tl).backward()
        tsc.step(topt)
        topt.clear_grad()
        got.append(tsc.get_loss_scaling())
    assert got == want and got[1] > got[0] and got[3] < got[2]
    assert tsc.state_dict() == jsc.state_dict()
    np.testing.assert_allclose(tw.detach().numpy(), jw.numpy(), rtol=1e-5)


CE_CASES = {
    "weight": dict(weight=True),
    "soft_label": dict(soft_label=True),
    "axis": dict(axis=1),
    "use_softmax": dict(use_softmax=False),
    "label_smoothing": dict(label_smoothing=0.1),
    "smoothing_weight_ignore": dict(label_smoothing=0.2, weight=True,
                                    ignore=True),
}


@pytest.mark.parametrize("reduction", ["mean", "sum", "none"])
@pytest.mark.parametrize("case", sorted(CE_CASES))
def test_cross_entropy_options_match_jax(case, reduction):
    import paddle_tpu as paddle
    from paddle_tpu.nn import functional as JF

    opts = dict(CE_CASES[case])
    rng = np.random.default_rng(5)
    C = 7
    x = rng.standard_normal((6, C)).astype(np.float32)
    lbl = rng.integers(0, C, (6,))
    kw = {"reduction": reduction}
    if opts.pop("ignore", False):
        lbl[1] = -100
    if opts.pop("weight", False):
        kw["weight"] = rng.uniform(0.5, 2.0, (C,)).astype(np.float32)
    if opts.get("soft_label"):
        lbl = rng.dirichlet(np.ones(C), 6).astype(np.float32)
    if opts.get("axis") == 1:
        x = rng.standard_normal((2, C, 3)).astype(np.float32)
        lbl = rng.integers(0, C, (2, 3))
    if opts.get("use_softmax") is False:
        x = rng.dirichlet(np.ones(C), 6).astype(np.float32)
    kw.update(opts)
    jkw = {k: paddle.to_tensor(v) if isinstance(v, np.ndarray) else v
           for k, v in kw.items()}
    tkw = {k: torch.from_numpy(v) if isinstance(v, np.ndarray) else v
           for k, v in kw.items()}
    want = np.asarray(JF.cross_entropy(paddle.to_tensor(x),
                                       paddle.to_tensor(lbl), **jkw).value)
    got = F.cross_entropy(torch.from_numpy(x), torch.from_numpy(lbl), **tkw)
    assert got.dtype == torch.float32 and got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)
