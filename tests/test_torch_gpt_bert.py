"""The port's GPT and BERT against the JAX package, on the CPU.

``GPT_TINY`` and ``BERT_TINY`` (f32) take the JAX models' weights
(``convert.from_jax_state_dict``) and the same numpy inputs: logits,
losses (the plain CE at V 256, the chunked fused head + CE at V 4096) and
gradients at the JAX tests' f32 tolerance; one ``ShardedTrainer`` run of
GPT at dropout 0.1 against the JAX trainer with
``train_rng_impl="threefry2x32"`` (the step keys, hence the masks, are the
same); and ``GPTForCausalLM.generate``: greedy tokens bit-equal, sampled
tokens equal, against both of the JAX package's routes (its one-dispatch
scan and its per-token loop).
"""

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.models.bert import BERT_TINY as J_BERT_TINY
from paddle_tpu.models.bert import BertConfig as JBertConfig
from paddle_tpu.models.bert import BertForMaskedLM as JBert
from paddle_tpu.models.gpt import GPT_TINY as J_GPT_TINY
from paddle_tpu.models.gpt import GPTConfig as JGPTConfig
from paddle_tpu.models.gpt import GPTForCausalLM as JGPT
from paddle_tpu_torch.convert import from_jax_state_dict, to_numpy_state_dict
from paddle_tpu_torch.flags import flags, set_flags
from paddle_tpu_torch.models import (BERT_TINY, GPT_TINY, BertConfig,
                                     BertForMaskedLM, GPTConfig,
                                     GPTForCausalLM)

# tests/test_moe.py:161-163's f32 tolerance for gradients
RTOL, ATOL = 1e-4, 1e-5


def _state(m):
    return {k: np.asarray(v.value) for k, v in m.state_dict().items()}


def _pair(jcls, jcfg, tcls, tcfg, seed=1):
    paddle.seed(seed)
    jm = jcls(jcfg)
    return jm, from_jax_state_dict(_state(jm), tcls(tcfg, device="cpu"))


def _ids(shape, V, seed):
    return np.random.default_rng(seed).integers(0, V, shape)


def _loss_and_grads(jm, tm, jloss, tloss):
    """The loss (eval: no dropout) and every parameter's gradient, the
    JAX side through its tape."""
    jm.eval()
    tm.eval()
    jl = jloss(jm)
    jl.backward()
    tl = tloss(tm)
    tl.backward()
    np.testing.assert_allclose(tl.item(), float(jl.numpy()), rtol=1e-5)
    jp = dict(jm.named_parameters())
    for n, p in tm.named_parameters():
        if jp[n].grad is None:      # unused (BERT's token types)
            assert p.grad is None or not p.grad.any(), n
            continue
        np.testing.assert_allclose(p.grad.numpy(), np.asarray(jp[n].grad
                                                              .numpy()),
                                   rtol=RTOL, atol=ATOL, err_msg=n)


def test_tiny_configs_and_names_match_jax():
    assert GPT_TINY == GPTConfig(**vars(J_GPT_TINY))
    assert BERT_TINY == BertConfig(**vars(J_BERT_TINY))
    jg, tg = _pair(JGPT, J_GPT_TINY, GPTForCausalLM, GPT_TINY)
    assert sorted(n for n, _ in tg.named_parameters()) == sorted(_state(jg))
    jb, tb = _pair(JBert, J_BERT_TINY, BertForMaskedLM, BERT_TINY)
    assert sorted(n for n, _ in tb.named_parameters()) == sorted(_state(jb))


def test_gpt_logits_loss_and_grads_match_jax():
    jm, tm = _pair(JGPT, J_GPT_TINY, GPTForCausalLM, GPT_TINY)
    ids, labels = _ids((2, 24), 256, 0), _ids((2, 24), 256, 1)
    np.testing.assert_allclose(
        tm(ids).detach().numpy(), np.asarray(jm(paddle.to_tensor(ids))
                                             .numpy()),
        rtol=2e-4, atol=2e-5)
    _loss_and_grads(jm, tm, lambda m: m.loss(paddle.to_tensor(ids),
                                             paddle.to_tensor(labels)),
                    lambda m: m.loss(ids, labels))


def test_bert_logits_loss_and_grads_match_jax():
    """Token types, a boolean padding mask over the keys and
    ``ignore_index`` labels (the plain CE at V 256)."""
    jm, tm = _pair(JBert, J_BERT_TINY, BertForMaskedLM, BERT_TINY)
    ids, labels = _ids((2, 16), 256, 2), _ids((2, 16), 256, 3)
    labels[:, ::3] = -100
    tt = _ids((2, 16), 2, 4)
    keep = np.ones((2, 1, 1, 16), bool)
    keep[1, ..., 12:] = False
    np.testing.assert_allclose(
        tm(ids, tt, torch.from_numpy(keep)).detach().numpy(),
        np.asarray(jm(paddle.to_tensor(ids), paddle.to_tensor(tt),
                      paddle.to_tensor(keep)).numpy()),
        rtol=2e-4, atol=2e-5)
    _loss_and_grads(
        jm, tm,
        lambda m: m.loss(paddle.to_tensor(ids), paddle.to_tensor(labels),
                         token_type_ids=paddle.to_tensor(tt),
                         attention_mask=paddle.to_tensor(keep)),
        lambda m: m.loss(ids, labels, token_type_ids=tt,
                         attention_mask=torch.from_numpy(keep)))


@pytest.mark.parametrize("family", ["gpt", "bert"])
def test_fused_lm_ce_loss_and_grads_match_jax(family):
    """V 4096 takes the chunked fused head + CE on both sides (BERT with
    ignored labels)."""
    if family == "gpt":
        cfg = dict(vocab_size=4096, hidden_size=32, num_hidden_layers=1,
                   num_attention_heads=2, intermediate_size=64,
                   max_position_embeddings=32, dropout=0.0)
        jm, tm = _pair(JGPT, JGPTConfig(**cfg), GPTForCausalLM,
                       GPTConfig(**cfg))
    else:
        cfg = dict(vocab_size=4096, hidden_size=32, num_hidden_layers=1,
                   num_attention_heads=2, intermediate_size=64,
                   max_position_embeddings=32, dropout=0.0)
        jm, tm = _pair(JBert, JBertConfig(**cfg), BertForMaskedLM,
                       BertConfig(**cfg))
    assert flags.use_fused_lm_ce
    ids, labels = _ids((2, 12), 4096, 5), _ids((2, 12), 4096, 6)
    labels[0, :4] = -100
    _loss_and_grads(jm, tm, lambda m: m.loss(paddle.to_tensor(ids),
                                             paddle.to_tensor(labels)),
                    lambda m: m.loss(ids, labels))


def _assert_noise_moved(name, port, jax_, start, lr, steps):
    """A leaf whose gradient is rounding noise: the two sides' steps
    differ in sign, not in kind. Each side moved it (an update skipped
    leaves it at its start) and by at most lr a step: Adam's
    bias-corrected |m| / sqrt(v) is 1 at the first step and at most
    1.0014 at the second (beta1 0.9, beta2 0.999), and the decoupled
    decay of a bias that starts near 0 adds less than lr 1e-4 (f32
    rounding)."""
    for side, got in (("port", port), ("jax", jax_)):
        moved = np.abs(got - start).max()
        assert 0 < moved <= lr * steps * 1.001, (name, side, moved)


def test_gpt_trainer_with_dropout_matches_jax():
    """Two AdamW steps of GPT at dropout 0.1 (embeddings and both residual
    branches) through ``ShardedTrainer``, against the JAX trainer with
    ``train_rng_impl="threefry2x32"``: the step keys (0, step counter),
    hence every mask, are the same, so the losses agree at 1e-5 and the
    parameters as in tests/test_torch_train.py. The key projection's bias
    (the middle third of ``c_attn.bias``) has a zero gradient up to
    rounding (a shift shared by every key leaves the softmax as it is),
    which Adam turns into steps of up to lr of either sign: each side is
    held to ``_assert_noise_moved``."""
    from paddle_tpu.parallel import init_mesh
    from paddle_tpu.parallel.mesh import set_mesh
    from paddle_tpu.parallel.train import ShardedTrainer as JaxTrainer

    from paddle_tpu_torch.optimizer import AdamW
    from paddle_tpu_torch.parallel import ShardedTrainer

    cfg = dict(vars(J_GPT_TINY), dropout=0.1)
    jm, tm = _pair(JGPT, JGPTConfig(**cfg), GPTForCausalLM, GPTConfig(**cfg))
    ids, labels = _ids((2, 32), 256, 7), _ids((2, 32), 256, 8)
    lr, steps = 1e-3, 2
    start = {k: v.copy() for k, v in _state(jm).items()}
    old = paddle.get_flags("train_rng_impl")["train_rng_impl"]
    paddle.set_flags({"train_rng_impl": "threefry2x32"})
    mesh = init_mesh((1, 1, 1), ("dp", "sep", "mp"))
    try:
        jt = JaxTrainer(jm, paddle.optimizer.AdamW(
            learning_rate=lr, parameters=jm.parameters(),
            weight_decay=0.01), lambda m, i, l: m.loss(i, l), mesh, {})
        with mesh:
            want = [float(jt.train_step(ids, labels).numpy())
                    for _ in range(steps)]
    finally:
        set_mesh(None)
        paddle.set_flags({"train_rng_impl": old})
    tt = ShardedTrainer(tm, AdamW(learning_rate=lr,
                                  parameters=tm.parameters(),
                                  weight_decay=0.01),
                        lambda m, i, l: m.loss(i, l))
    got = [tt.train_step(ids, labels).item() for _ in range(steps)]
    np.testing.assert_allclose(got, want, rtol=1e-5)
    assert tt._seed_dev.item() == steps
    jstate = _state(jm)
    H = cfg["hidden_size"]
    for n, p in to_numpy_state_dict(tm).items():
        if n.endswith("c_attn.bias"):
            _assert_noise_moved(n, p[H:2 * H], jstate[n][H:2 * H],
                                start[n][H:2 * H], lr, steps)
            p, jstate[n] = np.delete(p, np.s_[H:2 * H]), np.delete(
                jstate[n], np.s_[H:2 * H])
        np.testing.assert_allclose(p, jstate[n], rtol=1e-5, atol=3e-6,
                                   err_msg=n)


def test_bert_trainer_matches_jax():
    """Two AdamW steps of BERT_TINY (ignored labels, no token types: their
    embedding gets the zero gradient ``jax.grad`` gives it) through
    ``ShardedTrainer`` against the JAX trainer: losses at 1e-5, parameters
    at rtol 1e-5 and 1 % of the 2 lr they move: Adam divides each moment
    by its own size, so where a weight's two gradients nearly cancel, the
    summation-order difference of f32 gradients (1e-4 relative) moves the
    update further. Every key projection's bias has a zero gradient up to
    rounding (see the GPT trainer test) and is held to
    ``_assert_noise_moved``."""
    from paddle_tpu.parallel import init_mesh
    from paddle_tpu.parallel.mesh import set_mesh
    from paddle_tpu.parallel.train import ShardedTrainer as JaxTrainer

    from paddle_tpu_torch.optimizer import AdamW
    from paddle_tpu_torch.parallel import ShardedTrainer

    jm, tm = _pair(JBert, J_BERT_TINY, BertForMaskedLM, BERT_TINY, seed=6)
    ids, labels = _ids((2, 16), 256, 11), _ids((2, 16), 256, 12)
    labels[:, 1::4] = -100
    lr, steps = 1e-3, 2
    start = {k: v.copy() for k, v in _state(jm).items()}
    mesh = init_mesh((1, 1, 1), ("dp", "sep", "mp"))
    try:
        jt = JaxTrainer(jm, paddle.optimizer.AdamW(
            learning_rate=lr, parameters=jm.parameters()),
            lambda m, i, l: m.loss(i, l), mesh, {})
        with mesh:
            want = [float(jt.train_step(ids, labels).numpy())
                    for _ in range(steps)]
    finally:
        set_mesh(None)
    tt = ShardedTrainer(tm, AdamW(learning_rate=lr,
                                  parameters=tm.parameters()),
                        lambda m, i, l: m.loss(i, l))
    got = [tt.train_step(ids, labels).item() for _ in range(steps)]
    np.testing.assert_allclose(got, want, rtol=1e-5)
    jstate = _state(jm)
    for n, p in to_numpy_state_dict(tm).items():
        if n.endswith("k_proj.bias"):
            _assert_noise_moved(n, p, jstate[n], start[n], lr, steps)
            continue
        np.testing.assert_allclose(p, jstate[n], rtol=1e-5,
                                   atol=0.01 * lr * steps, err_msg=n)


_SAMPLED = dict(decode_strategy="sampling", temperature=3.0, top_k=20,
                top_p=0.9, seed=4)


def test_gpt_generate_matches_jax():
    """Greedy tokens bit-equal and sampled tokens (temperature 3, top-k
    20, top-p 0.9, seed 4) equal, with an eos that stops a row (the
    JAX side's one-dispatch scan), and beam search."""
    jm, tm = _pair(JGPT, J_GPT_TINY, GPTForCausalLM, GPT_TINY, seed=3)
    prompt = _ids((2, 5), 256, 9)
    for kw in (dict(), _SAMPLED):
        want = np.asarray(jm.generate(prompt, max_new_tokens=8, **kw))
        np.testing.assert_array_equal(
            tm.generate(prompt, max_new_tokens=8, **kw), want)
        eos = int(want[0, 7])
        np.testing.assert_array_equal(
            tm.generate(prompt, max_new_tokens=8, eos_token_id=eos, **kw),
            np.asarray(jm.generate(prompt, max_new_tokens=8,
                                   eos_token_id=eos, **kw)))
    np.testing.assert_array_equal(
        tm.generate(prompt, max_new_tokens=4, decode_strategy="beam_search",
                    beam_size=3),
        np.asarray(jm.generate(prompt, max_new_tokens=4,
                               decode_strategy="beam_search", beam_size=3)))
    with pytest.raises(ValueError, match="max_position_embeddings"):
        tm.generate(prompt, max_new_tokens=200)


def test_gpt_generate_per_token_route():
    """The port's one loop gives the tokens of the JAX package's
    per-token route (its ``decode_fallback`` flag), greedy and sampled,
    and stops where it stops once every row has emitted eos; the port's
    own ``decode_fallback`` flag changes nothing here, and the model's
    training mode comes back."""
    jm, tm = _pair(JGPT, J_GPT_TINY, GPTForCausalLM, GPT_TINY, seed=5)
    prompt = _ids((2, 5), 256, 10)
    for kw in (dict(), _SAMPLED):
        want = tm.generate(prompt, max_new_tokens=8, **kw)
        eos = int(want[1, 6])
        want_eos = tm.generate(prompt, max_new_tokens=8, eos_token_id=eos,
                               **kw)
        paddle.set_flags({"decode_fallback": True})
        set_flags({"decode_fallback": True})
        try:
            np.testing.assert_array_equal(
                want, np.asarray(jm.generate(prompt, max_new_tokens=8,
                                             **kw)))
            np.testing.assert_array_equal(
                want_eos, np.asarray(jm.generate(
                    prompt, max_new_tokens=8, eos_token_id=eos, **kw)))
            np.testing.assert_array_equal(
                tm.generate(prompt, max_new_tokens=8, eos_token_id=eos,
                            **kw), want_eos)
        finally:
            paddle.set_flags({"decode_fallback": False})
            set_flags({"decode_fallback": False})
    assert tm.training


def test_train_rng_impl_and_card_refusals():
    """The port's step key is threefry2x32 only: another
    ``train_rng_impl`` (the JAX default 'rbg') raises naming ROADMAP
    item 14.1 at the first step; the models default to the card."""
    from paddle_tpu_torch.optimizer import AdamW
    from paddle_tpu_torch.parallel import ShardedTrainer

    assert flags.train_rng_impl == "threefry2x32"
    tm = GPTForCausalLM(GPT_TINY, device="cpu")
    tt = ShardedTrainer(tm, AdamW(learning_rate=1e-3,
                                  parameters=tm.parameters()),
                        lambda m, i, l: m.loss(i, l))
    set_flags({"train_rng_impl": "rbg"})
    try:
        with pytest.raises(NotImplementedError, match="item 14.1"):
            tt.train_step(_ids((1, 4), 256, 0), _ids((1, 4), 256, 1))
    finally:
        set_flags({"train_rng_impl": "threefry2x32"})
    if not torch.cuda.is_available():
        for build in (lambda: GPTForCausalLM(GPT_TINY),
                      lambda: BertForMaskedLM(BERT_TINY)):
            with pytest.raises(RuntimeError, match="no CUDA device"):
                build()
