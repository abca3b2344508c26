"""Sampled decode and beam search of the port against the JAX package's,
on the CPU at the tiny GQA size of tests/test_torch_serving.py.

The same weights (the JAX model's, carried over by ``from_jax_state_dict``)
go through both packages. Sampled tokens must be equal: the fused and
per-token routes split one batch key per step, the chunked route each
row's own key, all bit-equal to ``jax.random`` (tests/test_torch_random.py),
with the same temperature / top-k / top-p filter. Where a seed gives a
flip, the rule is to keep the seed and show that the flip is a near tie of
the perturbed logits; none of these seeds does. Beam search runs the
model's no-cache forward. The JAX side runs its model compiled by
``paddle.jit.to_static`` (the JAX package's own compile of the same
forward; its eager forward takes a second a step here) at one padded
shape, so that every step of both beam tests reuses one compile: rows
and positions are padded on the right, which leaves a causal model's
logits at the real rows and positions as they were.
"""

import numpy as np
import pytest

import paddle_tpu as paddle
from paddle_tpu.inference.generate import LlamaDecoder as JaxDecoder
from paddle_tpu.models.llama import LlamaConfig as JaxConfig
from paddle_tpu.models.llama import LlamaForCausalLM as JaxModel
from paddle_tpu_torch.convert import from_jax_state_dict
from paddle_tpu_torch.flags import set_flags
from paddle_tpu_torch.inference.generate import LlamaDecoder
from paddle_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM
from paddle_tpu_torch.nn.generation import beam_search

CFG = dict(vocab_size=64, hidden_size=32, intermediate_size=64,
           num_hidden_layers=2, num_attention_heads=4,
           num_key_value_heads=2, max_position_embeddings=64)
SAMPLE = dict(do_sample=True, temperature=0.8, top_k=8, top_p=0.9)
NEW = 10


@pytest.fixture(scope="module")
def models():
    paddle.seed(0)
    jm = JaxModel(JaxConfig(**CFG))
    state = {k: np.asarray(v.value) for k, v in jm.state_dict().items()}
    tm = from_jax_state_dict(
        state, LlamaForCausalLM(LlamaConfig(**CFG), device="cpu"))
    return jm, tm


@pytest.fixture(scope="module")
def prompt():
    return np.random.default_rng(5).integers(0, 64, (2, 5))


@pytest.fixture(scope="module")
def decoders(models):
    """Per quant recipe: (JAX decoder, port decoder), built once."""
    jm, tm = models
    return {q: (JaxDecoder(jm, max_len=64, quant=q),
                LlamaDecoder(tm, max_len=64, quant=q, device="cpu"))
            for q in (None, "int8w", "int8wk")}


def _generate(dec, route, prompt, seed, fallback_flags):
    kw = dict(SAMPLE, seed=seed)
    if route == "per_token":
        fallback_flags({"decode_fallback": True})
        try:
            return np.asarray(dec.generate(prompt, NEW, **kw))
        finally:
            fallback_flags({"decode_fallback": False})
    chunk = None if route == "fused" else int(route[len("chunked"):])
    return np.asarray(dec.generate(prompt, NEW, chunk_size=chunk, **kw))


@pytest.mark.parametrize("route", ["fused", "chunked2", "chunked5",
                                   "per_token"])
@pytest.mark.parametrize("quant", [None, "int8w", "int8wk"])
def test_sampled_tokens_equal_jax(decoders, prompt, quant, route):
    """Temperature 0.8, top-k 8, top-p 0.9, seeds 1-4: the port's tokens
    equal the JAX decoder's on every route and recipe, and both packages
    take the same route (the resilience record's level)."""
    jdec, dec = decoders[quant]
    for seed in (1, 2, 3, 4):
        want = _generate(jdec, route, prompt, seed, paddle.set_flags)
        got = _generate(dec, route, prompt, seed, set_flags)
        np.testing.assert_array_equal(got, want, err_msg=f"seed {seed}")
    assert dec.last_resilience["level"] == \
        jdec.last_resilience["level"] == route.rstrip("25")


def test_sampled_decode_topk_topp(decoders):
    """tests/test_decode.py's sampling surface on the port: the same seed
    repeats, seeds differ, the top-p path runs, and temperature 1e-4 is
    greedy."""
    _, dec = decoders[None]
    p = np.array([[1, 2, 3], [4, 5, 6]])
    kw = dict(max_new_tokens=6, do_sample=True, temperature=0.8, top_k=8)
    out = np.asarray(dec.generate(p, seed=1, **kw))
    assert out.shape == (2, 9) and ((out >= 0) & (out < 64)).all()
    np.testing.assert_array_equal(out, np.asarray(dec.generate(p, seed=1,
                                                               **kw)))
    assert not np.array_equal(out, np.asarray(dec.generate(p, seed=2,
                                                           **kw)))
    assert np.asarray(dec.generate(p, 4, do_sample=True, top_p=0.9,
                                   seed=3)).shape == (2, 7)
    np.testing.assert_array_equal(
        np.asarray(dec.generate(p, 6, do_sample=True, temperature=1e-4,
                                seed=4)),
        np.asarray(dec.generate(p, 6)))


@pytest.mark.parametrize("quant", ["int8w", "int8wk"])
def test_sampled_chunk_slicing_invariance(decoders, prompt, quant):
    """Per-row keys: chunk slicing does not move a row's draws."""
    _, dec = decoders[quant]
    kw = dict(do_sample=True, top_k=8, temperature=0.9, seed=5)
    np.testing.assert_array_equal(
        np.asarray(dec.generate(prompt, 8, chunk_size=2, **kw)),
        np.asarray(dec.generate(prompt, 8, chunk_size=5, **kw)))


def test_model_generate_sampling_and_beam_routes(models, decoders, prompt):
    """``decode_strategy="sampling"`` samples by default (the JAX
    package's tokens); ``"beam_search"`` routes to ``beam_search``."""
    _, tm = models
    jdec, _ = decoders[None]
    kw = {k: v for k, v in SAMPLE.items() if k != "do_sample"}
    # the JAX model's "sampling" is its cached decoder's do_sample=True
    # fused loop: the fixture's decoder, whose compile this call reuses
    want = np.asarray(jdec.generate(prompt, NEW, do_sample=True, seed=2,
                                    **kw))
    got = np.asarray(tm.generate(prompt, NEW, decode_strategy="sampling",
                                 seed=2, **kw))
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        tm.generate(prompt, 3, decode_strategy="beam_search", beam_size=2),
        beam_search(tm, prompt, beam_size=2, max_new_tokens=3))


class _PaddedForward:
    """The JAX model's compiled forward at one (rows, positions) shape:
    ids are padded on the right with token 0 and the logits cut back to
    the real rows and positions."""

    def __init__(self, static, rows: int, length: int):
        self.static, self.rows, self.length = static, rows, length

    def __call__(self, ids):
        x = np.asarray(ids.numpy())
        n, L = x.shape
        pad = np.zeros((self.rows, self.length), x.dtype)
        pad[:n, :L] = x
        return paddle.to_tensor(
            self.static(paddle.to_tensor(pad)).value[:n, :L])


@pytest.fixture(scope="module")
def jax_static(models):
    """Room for both beam tests: 2 prompts x 4 beams, 6 + 5 positions."""
    jm, _ = models
    jm.eval()
    return _PaddedForward(paddle.jit.to_static(jm), rows=8, length=11)


def test_beam_search_k1_equals_greedy_and_backtrace_consistent(
        models, jax_static):
    """k = 1 is greedy; k = 4 equals the JAX package's beam search and is a
    valid decode (finite path log-prob); no new tokens returns the
    prompt."""
    import torch

    from paddle_tpu.nn.generation import beam_search as jax_beam_search

    _, tm = models
    prompt = np.random.default_rng(0).integers(0, 64, (2, 6))
    np.testing.assert_array_equal(
        beam_search(tm, prompt, beam_size=1, max_new_tokens=5),
        np.asarray(tm.generate(prompt, 5)))
    beam4 = beam_search(tm, prompt, beam_size=4, max_new_tokens=5)
    np.testing.assert_array_equal(
        beam4, jax_beam_search(jax_static, prompt, beam_size=4,
                               max_new_tokens=5))
    assert beam4.shape == (2, 11)
    with torch.no_grad():
        lp = torch.log_softmax(tm(beam4[:, :-1]).float(), -1)
    tgt = torch.as_tensor(beam4[:, 1:])
    path = lp[:, -5:].gather(-1, tgt[:, -5:, None]).sum((1, 2))
    assert torch.isfinite(path).all()
    np.testing.assert_array_equal(
        beam_search(tm, prompt, beam_size=2, max_new_tokens=0), prompt)
    assert tm.training   # the mode snapshot is restored


def test_beam_search_eos_freezes_beams(models, jax_static):
    """An eos freezes its beam (everything after the chosen beam's first
    eos is eos), with the JAX package's tokens."""
    from paddle_tpu.nn.generation import beam_search as jax_beam_search

    _, tm = models
    prompt = np.random.default_rng(1).integers(0, 64, (1, 4))
    out = beam_search(tm, prompt, beam_size=3, max_new_tokens=6,
                      eos_token_id=0)
    np.testing.assert_array_equal(
        out, jax_beam_search(jax_static, prompt, beam_size=3,
                             max_new_tokens=6, eos_token_id=0))
    assert out.shape[1] <= 4 + 6
    seq = out[0, 4:]
    if (seq == 0).any():
        first = int(np.argmax(seq == 0))
        assert np.all(seq[first:] == 0)
