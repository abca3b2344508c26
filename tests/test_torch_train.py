"""The port's training slice against the JAX package, on the CPU.

Each piece of the port's training path (paddle_tpu_torch) takes the same
numpy inputs as its JAX counterpart: the flash-attention and RMSNorm
wrappers (their plain versions here, on CPU tensors) against the Pallas
kernels in interpret mode, as tests/test_flash_attention.py and
tests/test_fused_kernels.py run them, at those tests' tolerances; the
chunked fused lm-head CE (tests/test_review_regressions.py's
tolerances); one AdamW update; and the slice as a whole: a tiny GQA Llama
whose loss and gradients match ``jax.grad`` of the JAX model's loss, and
whose ``ShardedTrainer`` steps match the JAX trainer's. Everything runs
in f32, where the two libraries differ only in summation order.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import paddle_tpu as paddle
from paddle_tpu.models.llama import LlamaConfig as JaxConfig
from paddle_tpu.models.llama import LlamaForCausalLM as JaxModel
from paddle_tpu_torch.convert import from_jax_state_dict, to_numpy_state_dict
from paddle_tpu_torch.flags import flags, set_flags
from paddle_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM
from paddle_tpu_torch.ops.kernels import flash_attention as fa
from paddle_tpu_torch.ops.kernels import rms_norm as rn

# TINY_CONFIG: GQA (4 heads over 2 KV heads) so the K/V repeat runs
CFG = dict(vocab_size=256, hidden_size=64, intermediate_size=128,
           num_hidden_layers=2, num_attention_heads=4,
           num_key_value_heads=2, max_position_embeddings=128)
B, S = 2, 64


def _t(a):
    return torch.from_numpy(np.array(a))


def _bh(x):
    """(B, S, H, D) -> the JAX kernels' (B*H, S, D)."""
    b, s, h, d = x.shape
    return jnp.swapaxes(jnp.asarray(x), 1, 2).reshape(b * h, s, d)


# -- flash attention ---------------------------------------------------------

@pytest.mark.parametrize("sq,sk,causal,blocks", [
    (128, 128, False, None),    # one whole-sequence block: _fwd_single_kernel
    (128, 128, True, None),
    (128, 128, True, 64),       # 2 x 2 blocks: _fwd_kernel
    (64, 128, True, 64),        # sq < sk, bottom-right causal
])
def test_flash_forward_matches_jax(sq, sk, causal, blocks):
    from paddle_tpu.ops.pallas.flash_attention import _fwd

    rng = np.random.default_rng(0)
    b, h, d = 2, 2, 32
    q = rng.standard_normal((b, sq, h, d)).astype(np.float32)
    k = rng.standard_normal((b, sk, h, d)).astype(np.float32)
    v = rng.standard_normal((b, sk, h, d)).astype(np.float32)
    scale = 1.0 / np.sqrt(d)
    want_out, want_lse = _fwd(_bh(q), _bh(k), _bh(v), scale, causal,
                              blocks or sq, blocks or sk, True)
    out, lse = fa.flash_fwd(_t(q), _t(k), _t(v), causal, scale)
    want_out = np.swapaxes(np.asarray(want_out).reshape(b, h, sq, d), 1, 2)
    np.testing.assert_allclose(out.numpy(), want_out, rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(lse.numpy(),
                               np.asarray(want_lse).reshape(b, h, sq),
                               rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("causal", [False, True])
def test_flash_grads_match_jax(causal):
    """Through the autograd Function (flash_bwd's plain version) against
    jax.grad through the Pallas backward kernels, 2 x 2 blocks."""
    from paddle_tpu.ops.pallas.flash_attention import flash_attention_fn

    rng = np.random.default_rng(1)
    shape = (1, 128, 2, 32)
    q, k, v = (rng.standard_normal(shape).astype(np.float32)
               for _ in range(3))

    def loss(q, k, v):
        return jnp.sum(flash_attention_fn(q, k, v, causal=causal,
                                          block_q=64, block_k=64) ** 2)

    want = jax.grad(loss, argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))
    tq, tk, tv = (_t(a).requires_grad_() for a in (q, k, v))
    (fa.flash_attention_fn(tq, tk, tv, causal=causal) ** 2).sum().backward()
    for got, w, name in zip((tq, tk, tv), want, "qkv"):
        np.testing.assert_allclose(got.grad.numpy(), np.asarray(w),
                                   rtol=5e-4, atol=5e-4,
                                   err_msg=f"d{name}")


def test_flash_refuses_what_the_reference_refuses():
    q = torch.zeros(1, 128, 2, 32)
    with pytest.raises(ValueError, match="sk >= sq"):
        fa.flash_attention_fn(q, q[:, :64], q[:, :64], causal=True)
    with pytest.raises(ValueError, match="repeat kv heads"):
        fa.flash_attention_fn(q, q[:, :, :1], q[:, :, :1])
    assert not fa.supported(q[..., :24], q[..., :24], q[..., :24])
    assert not fa.supported(q.half(), q.half(), q.half())
    assert fa.supported(q.bfloat16()[..., :16], q.bfloat16()[..., :16],
                        q.bfloat16()[..., :16])


# -- RMSNorm -----------------------------------------------------------------

@pytest.mark.parametrize("dtype,wdtype", [
    (np.float32, np.float32), ("bfloat16", "bfloat16"),
    ("bfloat16", np.float32)])
def test_rms_forward_matches_jax(dtype, wdtype):
    from paddle_tpu.ops.pallas import rms_norm as prms

    rng = np.random.default_rng(0)
    x = jnp.asarray(rng.normal(size=(2, 8, 64)), dtype)
    w = jnp.asarray(rng.normal(size=(64,)), wdtype)
    want_out, want_inv = prms.rms_fwd(x, w, 1e-6)
    tx = _t(np.asarray(x, np.float32)).to(getattr(torch, jnp.dtype(dtype).name))
    tw = _t(np.asarray(w, np.float32)).to(getattr(torch, jnp.dtype(wdtype).name))
    out, inv = rn.rms_fwd(tx, tw, 1e-6)
    assert str(out.dtype).split(".")[1] == jnp.dtype(want_out.dtype).name
    np.testing.assert_allclose(out.float().numpy(),
                               np.asarray(want_out, np.float32),
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(inv.numpy(), np.asarray(want_inv),
                               rtol=1e-6, atol=1e-6)
    assert inv.shape == (16, 1) and inv.dtype == torch.float32


def test_rms_backward_matches_jax():
    """rms_bwd against the Pallas backward (same inv, same upstream
    gradient), and the autograd Function against jax.grad of the fused
    unit."""
    from paddle_tpu.ops.fused_norm import rms_norm_fused as jax_fused
    from paddle_tpu.ops.pallas import rms_norm as prms

    from paddle_tpu_torch.ops.fused_norm import rms_norm_fused

    rng = np.random.default_rng(1)
    x = rng.normal(size=(4, 8, 64)).astype(np.float32)
    w = rng.normal(size=(64,)).astype(np.float32)
    g = rng.normal(size=(4, 8, 64)).astype(np.float32)
    _, inv = prms.rms_fwd(jnp.asarray(x), jnp.asarray(w), 1e-6)
    want_dx, want_dw = prms.rms_bwd(jnp.asarray(x), jnp.asarray(w), inv,
                                    jnp.asarray(g))
    dx, dw = rn.rms_bwd(_t(x), _t(w), _t(np.asarray(inv)), _t(g))
    np.testing.assert_allclose(dx.numpy(), np.asarray(want_dx), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(dw.numpy(), np.asarray(want_dw), rtol=1e-5,
                               atol=1e-5)
    gx, gw = jax.grad(lambda x, w: (jax_fused(x, w, 1e-6) * g).sum(),
                      (0, 1))(jnp.asarray(x), jnp.asarray(w))
    tx, tw = _t(x).requires_grad_(), _t(w).requires_grad_()
    (rms_norm_fused(tx, tw, 1e-6) * _t(g)).sum().backward()
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(gx), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(tw.grad.numpy(), np.asarray(gw), rtol=1e-5,
                               atol=1e-5)


# -- fused lm-head CE ----------------------------------------------------------

def test_fused_ce_matches_jax():
    """ignore_index (including an in-vocab one), out-of-range labels that
    count in the denominator, and chunk 256 < V = 640 (a ragged last
    chunk): loss and both gradients."""
    from paddle_tpu.ops.fused_ce import fused_linear_cross_entropy as jax_ce

    from paddle_tpu_torch.ops.fused_ce import fused_linear_cross_entropy

    rng = np.random.default_rng(3)
    T, H, V = 12, 8, 640
    hidden = rng.standard_normal((T, H)).astype(np.float32)
    head = (rng.standard_normal((H, V)) * 0.1).astype(np.float32)
    for ignore in (-100, 0, 5):
        labels = rng.integers(0, V, (T,))
        labels[1] = ignore
        labels[4] = V + 7
        if ignore != -100:
            labels[7] = -100
        lab = jnp.asarray(labels, jnp.int32)
        l0, (gh0, gw0) = jax.value_and_grad(
            lambda h, w: jax_ce(h, w, lab, 256, ignore), (0, 1))(
                jnp.asarray(hidden), jnp.asarray(head))
        th, tw = _t(hidden).requires_grad_(), _t(head).requires_grad_()
        loss = fused_linear_cross_entropy(th, tw, _t(labels), 256, ignore)
        loss.backward()
        np.testing.assert_allclose(loss.item(), float(l0), rtol=1e-5)
        np.testing.assert_allclose(th.grad.numpy(), np.asarray(gh0),
                                   rtol=1e-4, atol=1e-6)
        np.testing.assert_allclose(tw.grad.numpy(), np.asarray(gw0),
                                   rtol=1e-4, atol=1e-6)


# -- AdamW ---------------------------------------------------------------------

@pytest.mark.parametrize("dtype,mp", [(np.float32, False), ("bfloat16", False),
                                      ("bfloat16", True)])
def test_adamw_update_matches_jax(dtype, mp):
    """Two updates of one parameter: f32, bf16 with moments in bf16, and
    bf16 with f32 moments and an f32 master weight."""
    from paddle_tpu.optimizer import AdamW as JaxAdamW

    from paddle_tpu_torch.optimizer import AdamW

    rng = np.random.default_rng(4)
    p = jnp.asarray(rng.standard_normal((16, 8)), dtype)
    gs = [jnp.asarray(rng.standard_normal((16, 8)), dtype) for _ in range(2)]
    tdt = getattr(torch, jnp.dtype(dtype).name)
    jopt = JaxAdamW(learning_rate=1e-2, weight_decay=0.01,
                    multi_precision=mp)
    topt = AdamW(learning_rate=1e-2, weight_decay=0.01, multi_precision=mp)
    jst = jopt.init_state(p)
    tp = _t(np.asarray(p, np.float32)).to(tdt)
    tst = topt.init_state(tp)
    assert sorted(tst) == sorted(jst)
    for g in gs:
        p, jst = jopt.update(g, jst, p, 1e-2, 0.01)
        tp, tst = topt.update(_t(np.asarray(g, np.float32)).to(tdt), tst, tp,
                              1e-2, 0.01)
    assert tp.dtype == tdt
    for k in jst:
        assert str(tst[k].dtype).split(".")[1] == jnp.dtype(jst[k].dtype).name
    # bf16 results may sit one bf16 spacing apart where the f32 update
    # rounds at a tie differently (XLA may fuse a multiply-add)
    tol = 1e-6 if dtype == np.float32 else 2 ** -7
    for got, want in [(tp, p)] + [(tst[k], jst[k]) for k in jst]:
        np.testing.assert_allclose(got.float().numpy(),
                                   np.asarray(want, np.float32), rtol=tol,
                                   atol=1e-7)


# -- the slice: tiny Llama, loss, gradients, trainer steps ---------------------

@pytest.fixture
def min_seq_64():
    """flash_attention_min_seq = 64 on both sides, so S = 64 takes the
    flash path in both packages."""
    old_t, old_j = flags.flash_attention_min_seq, 512
    set_flags({"flash_attention_min_seq": 64})
    paddle.set_flags({"flash_attention_min_seq": 64})
    yield
    set_flags({"flash_attention_min_seq": old_t})
    paddle.set_flags({"flash_attention_min_seq": old_j})


def _models(seed=3):
    paddle.seed(seed)
    jm = JaxModel(JaxConfig(**CFG))
    state = {k: np.asarray(v.value) for k, v in jm.state_dict().items()}
    tm = from_jax_state_dict(
        state, LlamaForCausalLM(LlamaConfig(**CFG), device="cpu"))
    return jm, tm


def _batch():
    rng = np.random.default_rng(7)
    return (rng.integers(0, CFG["vocab_size"], (B, S)),
            rng.integers(0, CFG["vocab_size"], (B, S)))


def test_tiny_llama_loss_and_grads_match_jax(min_seq_64):
    from paddle_tpu.autograd import tape
    from paddle_tpu.framework.tensor import Tensor

    jm, tm = _models()
    ids, labels = _batch()
    state = dict(jm.state_dict())

    def jax_loss(params):
        originals = [(t, t._value) for t in state.values()]
        try:
            with tape.no_grad():
                for n, t in state.items():
                    t._value = params[n]
                return jm.loss(Tensor(jnp.asarray(ids)),
                               Tensor(jnp.asarray(labels)))._value
        finally:
            for t, v in originals:
                t._value = v

    want_loss, want = jax.jit(jax.value_and_grad(jax_loss))(
        {n: t._value for n, t in state.items()})
    loss = tm.loss(ids, labels)
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(want_loss), rtol=1e-4,
                               atol=1e-4)
    grads = {n: p.grad for n, p in tm.named_parameters()}
    assert sorted(grads) == sorted(want)
    for n, g in grads.items():
        np.testing.assert_allclose(g.numpy(), np.asarray(want[n]), rtol=1e-4,
                                   atol=1e-4, err_msg=n)


def test_tiny_llama_bf16_loss_and_grads_match_jax():
    """bf16 training parity: the JAX parameters cast to bf16 in both
    packages, B 2, S 64, the plain attention (S is below
    ``flash_attention_min_seq``): the loss within two bf16 spacings of
    the JAX loss, every gradient at cosine >= 0.99 to ``jax.grad``'s."""
    from paddle_tpu.autograd import tape
    from paddle_tpu.framework.tensor import Tensor

    jm, _ = _models()
    ids, labels = _batch()
    state = dict(jm.state_dict())
    params = {n: t._value.astype(jnp.bfloat16) for n, t in state.items()}

    def jax_loss(params):
        originals = [(t, t._value) for t in state.values()]
        try:
            with tape.no_grad():
                for n, t in state.items():
                    t._value = params[n]
                return jm.loss(Tensor(jnp.asarray(ids)),
                               Tensor(jnp.asarray(labels)))._value
        finally:
            for t, v in originals:
                t._value = v

    want_loss, want = jax.jit(jax.value_and_grad(jax_loss))(params)
    tm = from_jax_state_dict(
        {n: np.asarray(v, np.float32) for n, v in params.items()},
        LlamaForCausalLM(LlamaConfig(**CFG, dtype="bfloat16"),
                         device="cpu"))
    assert all(p.dtype == torch.bfloat16 for p in tm.parameters())
    loss = tm.loss(ids, labels)
    loss.backward()
    want_loss = float(want_loss)
    spacing = 2.0 ** (np.floor(np.log2(abs(want_loss))) - 7)
    assert abs(loss.item() - want_loss) <= 2 * spacing, \
        (loss.item(), want_loss)
    for n, p in tm.named_parameters():
        g = p.grad.double().reshape(-1)
        w = torch.from_numpy(np.asarray(want[n], np.float64)).reshape(-1)
        cos = float(g @ w / (g.norm() * w.norm()))
        assert cos >= 0.99, (n, cos)


def test_tiny_llama_trainer_steps_match_jax(min_seq_64):
    """Three ShardedTrainer steps (AdamW with weight decay) on one batch:
    the same losses and parameters as the JAX trainer, then the model
    serves: its cached decoder rebuilds after the steps and gives the
    JAX decoder's greedy tokens."""
    from paddle_tpu.parallel import init_mesh
    from paddle_tpu.parallel.mesh import set_mesh
    from paddle_tpu.parallel.train import ShardedTrainer as JaxTrainer

    from paddle_tpu_torch.optimizer import AdamW
    from paddle_tpu_torch.parallel import ShardedTrainer

    jm, tm = _models()
    ids, labels = _batch()
    prompt = ids[:, :5]
    dec_before = (tm.generate(prompt, max_new_tokens=6), tm._decoder)
    mesh = init_mesh((1, 1, 1), ("dp", "sep", "mp"))
    try:
        jt = JaxTrainer(jm, paddle.optimizer.AdamW(
            learning_rate=1e-3, parameters=jm.parameters(),
            weight_decay=0.01), lambda m, i, l: m.loss(i, l), mesh, {})
        with mesh:
            want = [float(jt.train_step(ids, labels).numpy())
                    for _ in range(3)]
    finally:
        set_mesh(None)
    opt = AdamW(learning_rate=1e-3, parameters=tm.parameters(),
                weight_decay=0.01)
    tt = ShardedTrainer(tm, opt, lambda m, i, l: m.loss(i, l))
    got = [tt.train_step(ids, labels).item() for _ in range(3)]
    assert opt._step_count == 3
    np.testing.assert_allclose(got, want, rtol=1e-5)
    # Adam moves every weight by about lr a step whatever its gradient's
    # size, so a weight near zero is held to 1e-3 of its 3-step movement
    jstate = {k: np.asarray(v.value) for k, v in jm.state_dict().items()}
    for n, p in to_numpy_state_dict(tm).items():
        np.testing.assert_allclose(p, jstate[n], rtol=1e-5, atol=3e-6,
                                   err_msg=n)
    out = np.asarray(tm.generate(prompt, max_new_tokens=6))
    assert tm._decoder is not dec_before[1]
    np.testing.assert_array_equal(
        out, np.asarray(jm.generate(prompt, max_new_tokens=6)))


@pytest.fixture
def fused_rope():
    set_flags({"use_fused_rope": True})
    paddle.set_flags({"use_fused_rope": True})
    yield
    set_flags({"use_fused_rope": False})
    paddle.set_flags({"use_fused_rope": False})


def test_tiny_llama_trainer_with_fused_rope_matches_jax(fused_rope):
    """use_fused_rope on both sides: the JAX trainer runs the Pallas rope
    kernel (interpret mode) and the port its rope unit (the plain version
    on the CPU); three AdamW steps give the same losses at 1e-5.
    Attention takes the plain form on both sides (S 64 is under the
    default ``flash_attention_min_seq``), which keeps the JAX compile
    short; the other trainer test covers the flash route."""
    from paddle_tpu.parallel import init_mesh
    from paddle_tpu.parallel.mesh import set_mesh
    from paddle_tpu.parallel.train import ShardedTrainer as JaxTrainer

    from paddle_tpu_torch.optimizer import AdamW
    from paddle_tpu_torch.parallel import ShardedTrainer

    jm, tm = _models()
    ids, labels = _batch()
    mesh = init_mesh((1, 1, 1), ("dp", "sep", "mp"))
    try:
        jt = JaxTrainer(jm, paddle.optimizer.AdamW(
            learning_rate=1e-3, parameters=jm.parameters(),
            weight_decay=0.01), lambda m, i, l: m.loss(i, l), mesh, {})
        with mesh:
            want = [float(jt.train_step(ids, labels).numpy())
                    for _ in range(3)]
    finally:
        set_mesh(None)
    tt = ShardedTrainer(tm, AdamW(learning_rate=1e-3,
                                  parameters=tm.parameters(),
                                  weight_decay=0.01),
                        lambda m, i, l: m.loss(i, l))
    got = [tt.train_step(ids, labels).item() for _ in range(3)]
    np.testing.assert_allclose(got, want, rtol=1e-5)


def test_trainer_train_steps_and_refusals():
    """train_steps over stacked (K, ...) batches equals K train_steps;
    a multi-device mesh is refused; amp, grad clip and LR schedulers are
    taken as the JAX trainer takes them (a clip of another class is
    refused at the step, a learning rate that is neither a number nor an
    ``LRScheduler`` at construction, both as in the JAX package);
    use_fused_rope runs (it raised before the rope kernel was ported)."""
    from paddle_tpu_torch.optimizer import AdamW
    from paddle_tpu_torch.parallel import ShardedTrainer

    ids, labels = _batch()
    _, tm1 = _models()
    _, tm2 = _models()
    loss_fn = lambda m, i, l: m.loss(i, l)       # noqa: E731
    t1 = ShardedTrainer(tm1, AdamW(1e-3, parameters=tm1.parameters()),
                        loss_fn)
    t2 = ShardedTrainer(tm2, AdamW(1e-3, parameters=tm2.parameters()),
                        loss_fn)
    stacked = t1.train_steps(np.stack([ids, ids]), np.stack([labels, labels]))
    one_by_one = [t2.train_step(ids, labels) for _ in range(2)]
    assert stacked.shape == (2,) and t1.optimizer._step_count == 2
    np.testing.assert_array_equal(stacked.numpy(),
                                  torch.stack(one_by_one).numpy())
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        ShardedTrainer(tm1, t1.optimizer, loss_fn, mesh=4)
    from paddle_tpu_torch.optimizer.lr import StepDecay
    amp = ShardedTrainer(tm1, t1.optimizer, loss_fn, amp_dtype="bfloat16")
    assert amp.amp_dtype == "bfloat16"
    assert torch.isfinite(amp.train_step(ids, labels))
    bad_clip = ShardedTrainer(
        tm1, AdamW(1e-3, parameters=tm1.parameters(), grad_clip=object()),
        loss_fn)
    with pytest.raises(NotImplementedError, match="grad clip object"):
        bad_clip.train_step(ids, labels)
    with pytest.raises(TypeError):
        AdamW(lambda: 1e-3, parameters=tm1.parameters())
    sched = AdamW(StepDecay(1e-3, 2), parameters=tm1.parameters())
    assert sched.get_lr() == 1e-3
    with pytest.raises(RuntimeError, match="LRScheduler"):
        sched.set_lr(1e-4)
    # use_fused_rope routes rope through the rope kernel's autograd unit,
    # whose plain version on CPU tensors rotates exactly as the plain rope
    from paddle_tpu_torch.ops.kernels import rope as rp
    with torch.no_grad():
        off = tm1.loss(ids, labels)
        set_flags({"use_fused_rope": True})
        try:
            on = tm1.loss(ids, labels)
        finally:
            set_flags({"use_fused_rope": False})
    assert torch.equal(on, off) and rp.fwd_launches == 0


def test_optimizer_step_and_state_dict_follow_the_trainer():
    """The eager surface: backward, ``step`` and ``clear_grad`` move the
    parameters exactly as ``ShardedTrainer`` does, and a ``state_dict``
    carried into a new optimizer continues the same run."""
    from paddle_tpu_torch.optimizer import AdamW
    from paddle_tpu_torch.parallel import ShardedTrainer

    ids, labels = _batch()
    _, tm1 = _models()
    _, tm2 = _models()
    tr = ShardedTrainer(tm1, AdamW(1e-3, parameters=tm1.parameters(),
                                   weight_decay=0.01),
                        lambda m, i, l: m.loss(i, l))
    opt = AdamW(1e-3, parameters=tm2.parameters(), weight_decay=0.01)
    for step in range(2):
        tr.train_step(ids, labels)
        tm2.loss(ids, labels).backward()
        opt.step()
        opt.clear_grad()
        if step == 0:
            state = opt.state_dict()
            opt = AdamW(1e-3, parameters=tm2.parameters(), weight_decay=0.01)
            opt.set_state_dict(state)
    assert opt._step_count == 2
    assert all(p.grad is None for p in tm2.parameters())
    for (n, a), b in zip(tm1.named_parameters(), tm2.parameters()):
        assert torch.equal(a, b), n


def test_decoder_records_no_autograd():
    """The parameters are trainable, yet nothing the decoder returns
    carries autograd history."""
    from paddle_tpu_torch.inference.generate import LlamaDecoder

    _, tm = _models()
    assert all(p.requires_grad for p in tm.parameters())
    dec = LlamaDecoder(tm, max_len=32, device="cpu")
    ids = np.random.default_rng(0).integers(0, 256, (2, 5))
    st = dec.init_decode_state(ids)
    toks, st2 = dec.decode_chunk(st, 3)
    logits, kc, vc = dec.admit_prefill(ids, [5, 4], [0, 0])
    for t in (st.logits, st.kc, st.vc, toks, st2.logits, st2.pos, logits,
              kc, vc):
        assert not t.requires_grad and t.grad_fn is None
