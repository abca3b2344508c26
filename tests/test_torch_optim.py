"""The port's schedulers, optimizers and gradient clipping
(paddle_tpu_torch/optimizer/{lr,optimizer,adam}.py, nn/clip.py) against
the JAX package's, on the CPU.

- Each of the 17 schedulers gives the JAX sequence of rates over 12
  steps exactly, and its state dict restores it.
- Each optimizer without a kernel (SGD, Momentum, Adagrad, RMSProp,
  Adadelta, Adamax, ASGD, Rprop, Lamb) is held over 3 updates of the same
  random tensors to the JAX ``update`` at f32 1e-6.
- One ``ShardedTrainer`` step with Momentum and a scheduler against the
  JAX trainer.
- Each clip class, through the eager ``Optimizer.step`` and through
  ``ShardedTrainer``, against the JAX trainer over 2 Momentum steps
  (losses at 1e-5, parameters at 1e-5 / 3e-6), one of them a clip that
  binds (``clip_norm=1e-8``); the classes on (param, grad) pairs.
"""

import numpy as np
import pytest
import torch

from paddle_tpu_torch import nn as tnn
from paddle_tpu_torch import optimizer as topt
from paddle_tpu_torch.convert import from_jax_state_dict, to_numpy_state_dict
from paddle_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM
from paddle_tpu_torch.parallel import ShardedTrainer

CFG = dict(vocab_size=256, hidden_size=64, intermediate_size=128,
           num_hidden_layers=2, num_attention_heads=4,
           num_key_value_heads=2, max_position_embeddings=64)
B, S = 2, 16

# name -> (args, kwargs); an "inner" kwarg stands for a scheduler built
# from the same package
SCHEDULERS = {
    "NoamDecay": ((64, 4), {"learning_rate": 0.5}),
    "PiecewiseDecay": (([3, 7], [0.1, 0.05, 0.01]), {}),
    "NaturalExpDecay": ((0.1, 0.3), {}),
    "InverseTimeDecay": ((0.1, 0.5), {}),
    "PolynomialDecay": ((0.1, 5), {"end_lr": 0.001, "power": 2.0,
                                   "cycle": True}),
    "LinearWarmup": ((), {"inner": ("CosineAnnealingDecay", (0.1, 8), {}),
                          "warmup_steps": 4, "start_lr": 0.0,
                          "end_lr": 0.1}),
    "ExponentialDecay": ((0.1, 0.9), {}),
    "MultiStepDecay": ((0.1, [2, 5, 9]), {"gamma": 0.5}),
    "StepDecay": ((0.1, 3), {"gamma": 0.7}),
    "LambdaDecay": ((0.1, lambda e: 0.95 ** e), {}),
    "ReduceOnPlateau": ((0.1,), {"patience": 1, "cooldown": 1,
                                 "factor": 0.5}),
    "CosineAnnealingDecay": ((0.1, 10), {"eta_min": 0.001}),
    "MultiplicativeDecay": ((0.1, lambda e: 0.9), {}),
    "OneCycleLR": ((0.1, 12), {"three_phase": False}),
    "CyclicLR": ((0.01, 0.1, 3), {"mode": "triangular2"}),
    "LinearLR": ((0.1, 8), {}),
    "CosineAnnealingWarmRestarts": ((0.1, 3), {"T_mult": 2}),
}
METRICS = [3.0, 2.0, 2.5, 2.6, 2.7, 1.0, 1.5, 1.6, 1.7, 1.8, 1.9, 2.0]


def _sched(mod, name):
    args, kw = SCHEDULERS[name]
    kw = dict(kw)
    if "inner" in kw:
        iname, iargs, ikw = kw.pop("inner")
        kw["learning_rate"] = getattr(mod, iname)(*iargs, **ikw)
    return getattr(mod, name)(*args, **kw)


def _rates(s, name):
    out = []
    for i in range(12):
        out.append(s())
        if name == "ReduceOnPlateau":
            s.step(metrics=METRICS[i])
        else:
            s.step()
    return out


def test_scheduler_set_is_the_jax_set():
    from paddle_tpu.optimizer import lr as jlr
    assert set(topt.lr.__all__) == set(jlr.__all__)
    assert set(SCHEDULERS) == set(jlr.__all__) - {"LRScheduler"}


@pytest.mark.parametrize("name", sorted(SCHEDULERS))
def test_scheduler_matches_jax(name):
    """12 rates equal the JAX scheduler's exactly (the same Python float
    arithmetic), then a state dict taken after 5 steps restores the rest
    of the sequence in a fresh scheduler."""
    from paddle_tpu.optimizer import lr as jlr
    want = _rates(_sched(jlr, name), name)
    got = _rates(_sched(topt.lr, name), name)
    assert got == want
    a = _sched(topt.lr, name)
    for i in range(5):
        a.step(metrics=METRICS[i]) if name == "ReduceOnPlateau" else a.step()
    b = _sched(topt.lr, name)
    b.set_state_dict(a.state_dict())
    assert _rates(b, name) == _rates(a, name)


# name -> (port class, JAX class name, kwargs, weight decay)
OPTIMIZERS = {
    "SGD": ({}, 0.01),
    "Momentum": ({"momentum": 0.8, "use_nesterov": True}, 0.01),
    "Adagrad": ({"epsilon": 1e-6, "initial_accumulator_value": 0.1}, 0.01),
    "RMSProp": ({"rho": 0.9, "momentum": 0.5, "centered": True}, 0.01),
    "Adadelta": ({"rho": 0.9}, 0.01),
    "Adamax": ({}, 0.01),
    "ASGD": ({"batch_num": 2}, 0.01),
    "Rprop": ({}, 0.0),
    "Lamb": ({}, 0.01),
}


def _jax_opt(name, kw):
    import paddle_tpu as paddle
    return getattr(paddle.optimizer, name)(learning_rate=0.01, **kw)


@pytest.mark.parametrize("name", sorted(OPTIMIZERS))
def test_optimizer_update_matches_jax(name):
    """Three updates of a (5, 7) parameter and a (3,) one from the same
    random gradients: the parameters and every state of the JAX name at
    f32 1e-6; ``update_many`` gives ``update``'s values."""
    import jax.numpy as jnp

    kw, wd = OPTIMIZERS[name]
    rng = np.random.default_rng(1)
    params = [rng.standard_normal(s).astype(np.float32)
              for s in ((5, 7), (3,))]
    grads = [[rng.standard_normal(p.shape).astype(np.float32)
              for p in params] for _ in range(3)]
    jo = _jax_opt(name, kw)
    to = getattr(topt, name)(learning_rate=0.01, **kw)
    jp = [jnp.asarray(p) for p in params]
    tp = [torch.from_numpy(p.copy()) for p in params]
    jst = [jo.init_state(p) for p in jp]
    tst = [to.init_state(p) for p in tp]
    assert [set(s) for s in tst] == [set(s) for s in jst]
    many = [p.clone() for p in tp]
    mst = [to.init_state(p) for p in many]
    lr = torch.tensor(0.01, dtype=torch.float32)
    for gs in grads:
        for i, g in enumerate(gs):
            jp[i], jst[i] = jo.update(jnp.asarray(g), jst[i], jp[i], 0.01, wd)
            tp[i], tst[i] = to.update(torch.from_numpy(g), tst[i], tp[i],
                                      lr, wd)
        to.update_many([torch.from_numpy(g) for g in gs], mst, many, lr, wd)
    for i in range(2):
        np.testing.assert_allclose(tp[i].numpy(), np.asarray(jp[i]),
                                   rtol=1e-6, atol=1e-6)
        assert torch.equal(many[i], tp[i])
        for k, v in jst[i].items():
            np.testing.assert_allclose(tst[i][k].numpy(), np.asarray(v),
                                       rtol=1e-6, atol=1e-6, err_msg=k)


def test_adam_lazy_mode_is_accepted():
    """``lazy_mode=True`` is taken and changes nothing, as in the JAX
    package (dense gradients)."""
    p = torch.nn.Parameter(torch.ones(4))
    a = topt.Adam(0.1, parameters=[p], lazy_mode=True)
    p.grad = torch.full((4,), 0.5)
    a.step()
    q = torch.nn.Parameter(torch.ones(4))
    b = topt.Adam(0.1, parameters=[q])
    q.grad = torch.full((4,), 0.5)
    b.step()
    assert torch.equal(p, q)


def _batch(step):
    rng = np.random.default_rng(40 + step)
    return (rng.integers(0, CFG["vocab_size"], (B, S)),
            rng.integers(0, CFG["vocab_size"], (B, S)))


def _jax_model(seed=2):
    import paddle_tpu as paddle
    from paddle_tpu.models.llama import LlamaConfig as JaxConfig
    from paddle_tpu.models.llama import LlamaForCausalLM as JaxModel
    paddle.seed(seed)
    return JaxModel(JaxConfig(**CFG))


def _port_model(state):
    return from_jax_state_dict(
        state, LlamaForCausalLM(LlamaConfig(**CFG), device="cpu"))


def _jax_run(make_opt, steps, sched_steps=False):
    """(losses, final parameters, initial parameters) of the JAX trainer
    over ``steps``."""
    from paddle_tpu.parallel import init_mesh
    from paddle_tpu.parallel.mesh import set_mesh
    from paddle_tpu.parallel.train import ShardedTrainer as JaxTrainer

    jm = _jax_model()
    init = {k: np.asarray(v.value) for k, v in jm.state_dict().items()}
    mesh = init_mesh((1, 1, 1), ("dp", "sep", "mp"))
    try:
        opt = make_opt(jm.parameters())
        jt = JaxTrainer(jm, opt, lambda m, i, l: m.loss(i, l), mesh, {})
        losses = []
        with mesh:
            for k in range(steps):
                losses.append(float(jt.train_step(*_batch(k)).numpy()))
                if sched_steps:
                    opt._lr_scheduler.step()
    finally:
        set_mesh(None)
    return losses, {k: np.asarray(v.value)
                    for k, v in jm.state_dict().items()}, init


def _hold(losses, model, want):
    np.testing.assert_allclose(losses, want[0], rtol=1e-5)
    for n, p in to_numpy_state_dict(model).items():
        np.testing.assert_allclose(p, want[1][n], rtol=1e-5, atol=3e-6,
                                   err_msg=n)


def test_momentum_trainer_step_with_scheduler_matches_jax():
    """Two ``ShardedTrainer`` steps with Momentum (Nesterov, weight
    decay) over a ``StepDecay`` stepped after each: the JAX trainer's
    losses and parameters."""
    import paddle_tpu as paddle

    want = _jax_run(lambda ps: paddle.optimizer.Momentum(
        paddle.optimizer.lr.StepDecay(0.05, 1, gamma=0.5), momentum=0.9,
        parameters=ps, use_nesterov=True, weight_decay=0.01), 2,
        sched_steps=True)
    tm = _port_model(want[2])
    opt = topt.Momentum(topt.lr.StepDecay(0.05, 1, gamma=0.5),
                        momentum=0.9, parameters=tm.parameters(),
                        use_nesterov=True, weight_decay=0.01)
    tt = ShardedTrainer(tm, opt, lambda m, i, l: m.loss(i, l))
    losses = []
    for k in range(2):
        losses.append(tt.train_step(*_batch(k)).item())
        opt._lr_scheduler.step()
    assert tt._lr[0] == 0.025
    _hold(losses, tm, want)


CLIPS = {"global": ("ClipGradByGlobalNorm", 0.5),
         "global_binding": ("ClipGradByGlobalNorm", 1e-8),
         "norm": ("ClipGradByNorm", 0.05),
         "value": ("ClipGradByValue", 1e-3)}
_JAX_CLIPPED = {}


def _jax_clipped(which):
    """The JAX trainer's 2 Momentum steps under clip ``which`` (computed
    once for both port routes). Momentum's update is linear in the
    gradient, so the clip's scale shows in every parameter (Adam's
    normalization would cancel most of it)."""
    import paddle_tpu as paddle
    if which not in _JAX_CLIPPED:
        cls, arg = CLIPS[which]
        _JAX_CLIPPED[which] = _jax_run(lambda ps: paddle.optimizer.Momentum(
            0.5, momentum=0.9, parameters=ps, weight_decay=0.01,
            grad_clip=getattr(paddle.nn, cls)(arg)), 2)
    return _JAX_CLIPPED[which]


@pytest.mark.parametrize("route", ["eager", "trainer"])
@pytest.mark.parametrize("which", sorted(CLIPS))
def test_clip_matches_jax_trainer(which, route):
    want = _jax_clipped(which)
    cls, arg = CLIPS[which]
    tm = _port_model(want[2])
    opt = topt.Momentum(0.5, momentum=0.9, parameters=tm.parameters(),
                        weight_decay=0.01, grad_clip=getattr(tnn, cls)(arg))
    losses = []
    if route == "trainer":
        tt = ShardedTrainer(tm, opt, lambda m, i, l: m.loss(i, l))
        losses = [tt.train_step(*_batch(k)).item() for k in range(2)]
    else:
        for k in range(2):
            loss = tm.loss(*_batch(k))
            loss.backward()
            opt.step()
            opt.clear_grad()
            losses.append(loss.item())
    _hold(losses, tm, want)


def test_clip_classes_on_pairs_match_jax():
    """The classes on (param, grad) pairs, a None gradient passed through:
    the JAX classes' values at f32 1e-6; bf16 gradients stay bf16, within
    one bf16 spacing of the largest value."""
    import jax.numpy as jnp

    from paddle_tpu import nn as jnn
    from paddle_tpu.framework.tensor import Tensor
    rng = np.random.default_rng(3)
    gs = [rng.standard_normal(s).astype(np.float32) for s in ((4, 3), (5,))]
    for cls, arg in CLIPS.values():
        for bf16 in (False, True):
            tg = [torch.from_numpy(g) for g in gs]
            jg = [jnp.asarray(g) for g in gs]
            if bf16:
                tg = [g.to(torch.bfloat16) for g in tg]
                jg = [g.astype(jnp.bfloat16) for g in jg]
            got = getattr(tnn, cls)(arg)(list(zip("ab", tg)) + [("c", None)])
            want = getattr(jnn, cls)(arg)(
                [("a", Tensor(jg[0])), ("b", Tensor(jg[1])), ("c", None)])
            assert got[2] == ("c", None)
            for (_, t), (_, j) in zip(got[:2], want[:2]):
                assert t.dtype == tg[0].dtype
                w = np.asarray(j.value.astype(jnp.float32))
                # bf16: one bf16 spacing of the largest |value| (the f32
                # scales may differ in the last bit and flip a rounding)
                np.testing.assert_allclose(
                    t.float().numpy(), w, rtol=1e-6,
                    atol=2 ** -7 * float(np.abs(w).max()) if bf16 else 1e-6)
