"""The port's one-dispatch programs: the multi-tensor Adam / AdamW update,
the training step as one CUDA graph and the decode chunk as one CUDA graph.

On the CPU: ``update_many`` (the multi-tensor route) equals the
per-parameter ``update`` bit for bit; with the learning rate as an f32
tensor the update still matches the JAX package's ``AdamW.update``; a
trainer whose learning rate changes between steps matches the JAX
trainer; the trainer's checkpoint surface has the JAX trainer's keys and
refuses the checkpoint files with a typed error. The ``gpu`` tests hold
the Adam kernel to its plain version bit for bit, the captured training
step to the eager one and the captured decode chunk to the eager chunk;
they decide inside their body whether a card is present and skip here.
JAX is imported inside the parity tests only, so the card's run
(``pytest --noconftest -m gpu tests/test_torch_fused_update.py``), which
has no JAX, can collect this file.
"""

import os

import numpy as np
import pytest
import torch

from paddle_tpu_torch.flags import flags, set_flags
from paddle_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM
from paddle_tpu_torch.optimizer import Adam, AdamW
from paddle_tpu_torch.parallel import ShardedTrainer

# tests/test_torch_train.py's TINY config
CFG = dict(vocab_size=256, hidden_size=64, intermediate_size=128,
           num_hidden_layers=2, num_attention_heads=4,
           num_key_value_heads=2, max_position_embeddings=128)
B, S = 2, 64

_KINDS = [(torch.float32, False), (torch.bfloat16, False),
          (torch.bfloat16, True)]


def _params(dtype, device, shapes, seed=0):
    g = torch.Generator().manual_seed(seed)
    return [torch.randn(s, generator=g).to(dtype).to(device) for s in shapes]


def _grads(params, step, seed=1):
    g = torch.Generator().manual_seed(seed + step)
    return [torch.randn(p.shape, generator=g).to(p.dtype).to(p.device)
            for p in params]


@pytest.mark.parametrize("opt_cls", [Adam, AdamW])
@pytest.mark.parametrize("dtype,mp", _KINDS)
def test_update_many_equals_per_parameter_update(opt_cls, dtype, mp):
    """Three steps of ``update_many`` over several parameters (one empty)
    against ``update`` parameter by parameter: the same bits in every
    parameter and state tensor."""
    shapes = [(16, 8), (3,), (0,), (5, 7, 2)]
    opt = opt_cls(1e-2, weight_decay=0.01, multi_precision=mp)
    pa = _params(dtype, "cpu", shapes)
    pb = [p.clone() for p in pa]
    sa = [opt.init_state(p) for p in pa]
    sb = [opt.init_state(p) for p in pb]
    lr = torch.tensor(1e-2, dtype=torch.float32)
    for step in range(3):
        gs = _grads(pa, step)
        opt.update_many(gs, sa, pa, lr, 0.01)
        for i, (g, p) in enumerate(zip(gs, pb)):
            pb[i], sb[i] = opt.update(g, sb[i], p, lr, 0.01)
    for p, q, st, su in zip(pa, pb, sa, sb):
        assert p.dtype == dtype and torch.equal(p, q)
        assert sorted(st) == sorted(su)
        for k in st:
            assert st[k].dtype == su[k].dtype and torch.equal(st[k], su[k]), k


@pytest.mark.parametrize("dtype,mp", [(np.float32, False), ("bfloat16", False),
                                      ("bfloat16", True)])
def test_tensor_lr_update_matches_jax(dtype, mp):
    """``test_adamw_update_matches_jax`` with the learning rate as an f32
    0-dim tensor (the trainer's), through ``update_many``: the same
    tolerances."""
    import jax.numpy as jnp

    from paddle_tpu.optimizer import AdamW as JaxAdamW

    rng = np.random.default_rng(4)
    p = jnp.asarray(rng.standard_normal((16, 8)), dtype)
    gs = [jnp.asarray(rng.standard_normal((16, 8)), dtype) for _ in range(2)]
    tdt = getattr(torch, jnp.dtype(dtype).name)
    jopt = JaxAdamW(learning_rate=1e-2, weight_decay=0.01,
                    multi_precision=mp)
    topt = AdamW(learning_rate=1e-2, weight_decay=0.01, multi_precision=mp)
    jst = jopt.init_state(p)
    tp = torch.tensor(np.asarray(p, np.float32)).to(tdt)
    tst = topt.init_state(tp)
    lr = torch.tensor(1e-2, dtype=torch.float32)
    for g in gs:
        p, jst = jopt.update(g, jst, p, jnp.float32(1e-2), 0.01)
        topt.update_many(
            [torch.from_numpy(np.asarray(g, np.float32)).to(tdt)], [tst],
            [tp], lr, 0.01)
    tol = 1e-6 if dtype == np.float32 else 2 ** -7
    for got, want in [(tp, p)] + [(tst[k], jst[k]) for k in jst]:
        np.testing.assert_allclose(got.float().numpy(),
                                   np.asarray(want, np.float32), rtol=tol,
                                   atol=1e-7)


def _models(seed=3):
    import paddle_tpu as paddle
    from paddle_tpu.models.llama import LlamaConfig as JaxConfig
    from paddle_tpu.models.llama import LlamaForCausalLM as JaxModel

    from paddle_tpu_torch.convert import from_jax_state_dict

    paddle.seed(seed)
    jm = JaxModel(JaxConfig(**CFG))
    state = {k: np.asarray(v.value) for k, v in jm.state_dict().items()}
    tm = from_jax_state_dict(
        state, LlamaForCausalLM(LlamaConfig(**CFG), device="cpu"))
    return jm, tm


def _jax_trainer(jm, mesh):
    import paddle_tpu as paddle
    from paddle_tpu.parallel.train import ShardedTrainer as JaxTrainer

    return JaxTrainer(jm, paddle.optimizer.AdamW(
        learning_rate=1e-3, parameters=jm.parameters(), weight_decay=0.01),
        lambda m, i, l: m.loss(i, l), mesh, {})


def test_trainer_with_lr_changes_matches_jax():
    """Three AdamW steps with ``set_lr`` before the second and third (the
    trainer refills its device learning rate): the JAX trainer's losses
    and parameters at 1e-5. Attention takes the plain form on both sides
    (S 64 is under ``flash_attention_min_seq``), which keeps the JAX
    compile short."""
    from paddle_tpu.parallel import init_mesh
    from paddle_tpu.parallel.mesh import set_mesh

    from paddle_tpu_torch.convert import to_numpy_state_dict

    jm, tm = _models()
    rng = np.random.default_rng(7)
    ids = rng.integers(0, CFG["vocab_size"], (B, S))
    labels = rng.integers(0, CFG["vocab_size"], (B, S))
    lrs = (1e-3, 3e-3, 5e-4)
    mesh = init_mesh((1, 1, 1), ("dp", "sep", "mp"))
    try:
        jt = _jax_trainer(jm, mesh)
        want = []
        with mesh:
            for lr in lrs:
                jt.optimizer.set_lr(lr)
                want.append(float(jt.train_step(ids, labels).numpy()))
    finally:
        set_mesh(None)
    tt = ShardedTrainer(tm, AdamW(1e-3, parameters=tm.parameters(),
                                  weight_decay=0.01),
                        lambda m, i, l: m.loss(i, l))
    got = []
    for lr in lrs:
        tt.optimizer.set_lr(lr)
        got.append(tt.train_step(ids, labels).item())
    assert tt._lr[0] == lrs[-1] and tt._lr[1].item() == np.float32(lrs[-1])
    np.testing.assert_allclose(got, want, rtol=1e-5)
    jstate = {k: np.asarray(v.value) for k, v in jm.state_dict().items()}
    for n, p in to_numpy_state_dict(tm).items():
        np.testing.assert_allclose(p, jstate[n], rtol=1e-5, atol=3e-6,
                                   err_msg=n)


def test_trainer_checkpoint_surface_matches_jax(tmp_path):
    """``state_dict`` has the JAX trainer's keys (``model.<name>``,
    ``opt.<name>.<state>``) over copies of the trainer's tensors;
    ``save`` then ``load`` into a fresh trainer gives it every tensor of
    the state dict bit for bit (the JAX checkpoint's files), and
    ``compile_lowered``, which the JAX trainer has, raises the port's
    typed refusal naming ROADMAP item 16 (``jit/``)."""
    from paddle_tpu.parallel import init_mesh
    from paddle_tpu.parallel.mesh import set_mesh

    jm, tm = _models()
    mesh = init_mesh((1, 1, 1), ("dp", "sep", "mp"))
    try:
        want = set(_jax_trainer(jm, mesh).state_dict())
    finally:
        set_mesh(None)
    tt = ShardedTrainer(tm, AdamW(1e-3, parameters=tm.parameters()),
                        lambda m, i, l: m.loss(i, l))
    sd = tt.state_dict()
    assert set(sd) == want
    name = "model.embed_tokens.weight"
    assert torch.equal(sd[f"model.{name}"], tt.params[name])
    assert torch.equal(sd[f"opt.{name}.moment1"],
                       tt.opt_state[name]["moment1"])
    assert sd[f"opt.{name}.moment1"] is not tt.opt_state[name]["moment1"]
    rng = np.random.default_rng(7)
    ids, labels = (rng.integers(0, CFG["vocab_size"], (B, S))
                   for _ in range(2))
    tt.train_step(ids, labels)
    tt.save(str(tmp_path / "ckpt"))
    assert sorted(os.listdir(tmp_path / "ckpt")) == [
        "data_r0.npz", "meta_r0.json", "metadata.json"]
    _, tm2 = _models()
    t2 = ShardedTrainer(tm2, AdamW(1e-3, parameters=tm2.parameters()),
                        lambda m, i, l: m.loss(i, l))
    t2.load(str(tmp_path / "ckpt"))
    want_sd, got_sd = tt.state_dict(), t2.state_dict()
    assert set(got_sd) == set(want_sd)
    for k, v in want_sd.items():
        assert torch.equal(got_sd[k], v), k
    with pytest.raises(NotImplementedError,
                       match="ROADMAP.md section 1, item 16"):
        tt.compile_lowered(((B, S), "int64"))


def test_state_dicts_are_snapshots():
    """The update writes parameters and state in place, so a state dict
    taken before a step (the trainer's and the eager optimizer's) keeps
    its values after it, as the JAX package's immutable arrays do."""
    tm = LlamaForCausalLM(LlamaConfig(**CFG), device="cpu")
    rng = np.random.default_rng(7)
    ids, labels = (torch.as_tensor(rng.integers(0, CFG["vocab_size"],
                                                (B, S))) for _ in range(2))
    tt = ShardedTrainer(tm, AdamW(1e-3, parameters=tm.parameters()),
                        lambda m, i, l: m.loss(i, l))
    tt.train_step(ids, labels)
    before = {k: v.clone() for k, v in tt.state_dict().items()}
    sd = tt.state_dict()
    tt.train_step(ids, labels)
    assert not torch.equal(sd["opt.model.norm.weight.moment1"],
                           tt.opt_state["model.norm.weight"]["moment1"])
    for k, v in sd.items():
        assert torch.equal(v, before[k]), k

    opt = tt.optimizer
    tm.loss(ids, labels).backward()
    opt.step()
    osd = opt.state_dict()
    before = {k: v.clone() if isinstance(v, torch.Tensor) else v
              for k, v in osd.items()}
    tm.loss(ids, labels).backward()
    opt.step()
    assert opt._step_count == before["@step"] + 1
    for k, v in osd.items():
        if isinstance(v, torch.Tensor):
            assert torch.equal(v, before[k]), k


def test_step_key_follows_every_flag():
    """The captured step's key holds every flag's value, so a flag the
    step reads (or one added later) cannot leave a stale graph; the
    trainer keeps at most ``_STEP_GRAPHS`` keys."""
    from paddle_tpu_torch.flags import _DEFAULTS
    from paddle_tpu_torch.parallel import train as train_mod

    tm = LlamaForCausalLM(LlamaConfig(**CFG), device="cpu")
    tt = ShardedTrainer(tm, AdamW(1e-3, parameters=tm.parameters()),
                        lambda m, i, l: m.loss(i, l))
    batch = [torch.zeros((B, S), dtype=torch.int64)] * 2
    key = tt._key(batch)
    assert dict(key[-1]).keys() == _DEFAULTS.keys()
    old = flags.use_decode_attention
    set_flags({"use_decode_attention": not old})
    try:
        assert tt._key(batch) != key
    finally:
        set_flags({"use_decode_attention": old})
    assert tt._key(batch) == key
    assert train_mod._STEP_GRAPHS >= 2


# -- on the card -------------------------------------------------------------

def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")


@pytest.mark.gpu
@pytest.mark.parametrize("decoupled", [False, True])
@pytest.mark.parametrize("dtype,mp", _KINDS)
def test_adam_kernel_matches_plain_on_card(dtype, mp, decoupled):
    """Three steps of the kernel against the plain version on 90 tensors
    (more than one launch's table), of sizes 0 to 70,001 elements off the
    8-element grid, some starting off 16 bytes (the one-element path):
    every parameter, moment, master weight and beta pow bit for bit."""
    _need_card()
    from chip_smoke import adam_compare

    g = torch.Generator().manual_seed(0)
    sizes = [0, 1, 7, 8, 9, 2047, 2048, 2049, 70001] * 10
    buf = torch.randn(sum(sizes) + len(sizes), generator=g).to(dtype)
    params, off = [], 0
    for i, n in enumerate(sizes):
        off += i % 2          # odd tensors start one element off
        params.append(buf[off:off + n].clone() if i % 3 else
                      buf[off:off + n])
        off += n
    res = adam_compare([p.cuda() if i % 3 else p.to("cuda")
                        for i, p in enumerate(params)], mp, decoupled,
                       steps=3)
    assert res["launches"] == 3 * 3, res


def _tiny_gpu_llama(dtype="bfloat16"):
    # head_dim 64, as the flash kernels take; S 128 over
    # flash_attention_min_seq 64, so the step runs the flash kernels
    return LlamaForCausalLM(LlamaConfig(
        vocab_size=512, hidden_size=256, intermediate_size=512,
        num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
        max_position_embeddings=256, dtype=dtype), seed=0)


@pytest.mark.gpu
def test_captured_step_matches_eager_on_card():
    """A tiny bf16 Llama through the flash and RMSNorm kernels: three
    replays of the captured step against three eager steps from the same
    weights and state, under ``chip_smoke.py``'s gate; then
    ``train_steps`` replays and a new flag value captures again."""
    _need_card()
    from chip_smoke import graph_vs_eager, llama_loss

    old = flags.flash_attention_min_seq
    set_flags({"flash_attention_min_seq": 64})
    try:
        model = _tiny_gpu_llama()
        tr = ShardedTrainer(model, AdamW(1e-3, parameters=model.parameters(),
                                         multi_precision=False), llama_loss)
        rng = np.random.default_rng(0)
        batch = [torch.as_tensor(rng.integers(0, 512, (2, 128)),
                                 device="cuda") for _ in range(2)]
        for _ in range(2):      # the eager warm-up, then the capture
            tr.train_step(*batch)
        res = graph_vs_eager("tiny", tr, batch, steps=3)
        assert res["launches_graph"] == res["launches_eager"]
        assert res["launches_graph"]["adam.launches"] == 1
        stacked = [torch.stack([b, b]) for b in batch]
        n = tr.optimizer._step_count
        losses = tr.train_steps(*stacked)
        assert losses.shape == (2,) and tr.optimizer._step_count == n + 2
        assert bool(torch.isfinite(losses).all())
        graphs = len([g for g in tr._graphs.values() if g is not None])
        set_flags({"use_fused_rope": True})
        try:
            for _ in range(2):
                tr.train_step(*batch)
        finally:
            set_flags({"use_fused_rope": False})
        assert len([g for g in tr._graphs.values()
                    if g is not None]) == graphs + 1
    finally:
        set_flags({"flash_attention_min_seq": old})


@pytest.mark.gpu
def test_generate_rebuilds_after_steps_on_card():
    """The Adam kernel and the step's replay write the parameters through
    raw pointers and bump their version counters: after the eager
    warm-up step, the capture, a replay and an eager ``Optimizer.step``
    on the card, ``model.generate`` builds a new decoder each time, with
    a freshly built decoder's weights and tokens. A third batch shape
    drops the oldest step key (``_STEP_GRAPHS``)."""
    _need_card()
    from chip_smoke import llama_loss
    from paddle_tpu_torch.inference.generate import LlamaDecoder
    from paddle_tpu_torch.parallel import train as train_mod

    model = _tiny_gpu_llama()
    opt = AdamW(1e-3, parameters=model.parameters(), multi_precision=False)
    tr = ShardedTrainer(model, opt, llama_loss)
    rng = np.random.default_rng(0)
    batch = [torch.as_tensor(rng.integers(0, 512, (2, 64)), device="cuda")
             for _ in range(2)]
    prompt = rng.integers(0, 512, (2, 5))
    model.generate(prompt, max_new_tokens=4)

    def rebuilt():
        dec = model._decoder
        out = np.asarray(model.generate(prompt, max_new_tokens=4))
        assert model._decoder is not dec
        fresh = LlamaDecoder(model, max_len=model._decoder.max_len)
        for n, t in fresh.params.items():
            assert torch.equal(model._decoder.params[n], t), n
        np.testing.assert_array_equal(
            out, np.asarray(fresh.generate(prompt, max_new_tokens=4)))

    for _ in range(3):      # warm-up, capture and replay, replay
        tr.train_step(*batch)
        rebuilt()
    assert any(g is not None for g in tr._graphs.values())
    opt.clear_grad()
    model.loss(*batch).backward()
    opt.step()
    opt.clear_grad()
    rebuilt()
    for s_ in (32, 48):
        tr.train_step(*[b[:, :s_] for b in batch])
    assert len(tr._graphs) == train_mod._STEP_GRAPHS
    assert tr._key(batch) not in tr._graphs


@pytest.mark.gpu
@pytest.mark.parametrize("quant", [None, "int8wk"])
def test_graph_decode_chunk_matches_eager_on_card(quant):
    """Four chained chunks through ``decode_chunk`` (eager, capture and
    replay, replay, replay) against the eager chunk body on a second
    carry from the same prompt: the same tokens and carry; every state a
    chunk returned keeps its values after later replays; one dispatch a
    chunk and one graph; each replay counts its decode-attention
    launches."""
    _need_card()
    from paddle_tpu_torch.inference.generate import LlamaDecoder
    from paddle_tpu_torch.ops.kernels import decode_attention as da

    model = _tiny_gpu_llama()
    dec = LlamaDecoder(model, max_len=64, quant=quant)
    ids = np.random.default_rng(0).integers(0, 512, (3, 5))
    with torch.inference_mode():
        st = dec.init_decode_state(ids, eos_token_id=7)
        ref = dec.init_decode_state(ids, eos_token_id=7)
        d0 = dec.dispatch_count
        seen = []
        for i in range(4):
            da.launches = 0
            toks, st = dec.decode_chunk(st, 5)
            assert da.launches == 5 * 2, i
            want, ref = dec._chunk_steps(ref, 5)
            assert torch.equal(toks, want), i
            for name in ("logits", "pos", "done"):
                assert torch.equal(getattr(st, name), getattr(ref, name)), \
                    (i, name)
            seen.append((st, ref.logits.clone()))
        for s_, logits in seen:
            assert torch.equal(s_.logits, logits)
        assert dec.dispatch_count - d0 == 4
        assert sum(g is not None for g in dec._chunk_graphs.values()) == 1
