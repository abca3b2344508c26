"""The port's LlamaDecoder (paddle_tpu_torch/inference/generate.py) against
the JAX package's, on the CPU at a tiny GQA size.

The same weights (the JAX model's, carried over by ``from_jax_state_dict``)
go through both decoders. Greedy tokens must be bit-equal for every quant
recipe and every path (fused, chunked), and the dispatch counts must move
alike. Logits are compared at f32 atol 1e-4: the two libraries sum the
matmuls in different orders.
"""

import numpy as np
import pytest

import paddle_tpu as paddle
from paddle_tpu.inference.generate import LlamaDecoder as JaxDecoder
from paddle_tpu.models.llama import LlamaConfig as JaxConfig
from paddle_tpu.models.llama import LlamaForCausalLM as JaxModel
from paddle_tpu.quantization.kv_cache import \
    QuantMismatchError as JaxQuantMismatchError
from paddle_tpu_torch.convert import from_jax_state_dict
from paddle_tpu_torch.flags import set_flags
from paddle_tpu_torch.inference.generate import LlamaDecoder
from paddle_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM
from paddle_tpu_torch.quantization.kv_cache import QuantMismatchError

# TINY_CONFIG's GQA shape (4 heads over 2 KV heads); max_len 128 keeps
# the JAX decode-attention kernel eligible (L % 128 == 0) in interpret mode
CFG = dict(vocab_size=256, hidden_size=64, intermediate_size=128,
           num_hidden_layers=2, num_attention_heads=4,
           num_key_value_heads=2, max_position_embeddings=128)
MAX_LEN = 128
NEW = 12
QUANTS = [None, "int8w", "int8wk"]


@pytest.fixture(scope="module")
def models():
    paddle.seed(3)
    jm = JaxModel(JaxConfig(**CFG))
    state = {k: np.asarray(v.value) for k, v in jm.state_dict().items()}
    tm = from_jax_state_dict(
        state, LlamaForCausalLM(LlamaConfig(**CFG), device="cpu"))
    return jm, tm


@pytest.fixture(scope="module")
def ids():
    return np.random.default_rng(5).integers(0, 256, (2, 5))


@pytest.fixture(scope="module")
def jax_ref(models, ids):
    """Per quant recipe: the JAX decoder, its fused greedy tokens and its
    dispatch delta for a fused generate (and, unquantized, for a T=3
    chunked one)."""
    jm, _ = models
    out = {}
    for quant in QUANTS:
        dec = JaxDecoder(jm, max_len=MAX_LEN, quant=quant)
        d0 = dec.dispatch_count
        toks = np.asarray(dec.generate(ids, NEW))
        d1 = dec.dispatch_count
        d_chunk3 = None
        if quant is None:
            chunked = np.asarray(dec.generate(ids, NEW, chunk_size=3))
            np.testing.assert_array_equal(chunked, toks)
            d_chunk3 = dec.dispatch_count - d1
        out[quant] = (dec, toks, d1 - d0, d_chunk3)
    return out


@pytest.mark.parametrize("quant", QUANTS)
def test_prefill_logits_match_jax(models, ids, jax_ref, quant):
    import jax.numpy as jnp

    _, tm = models
    jdec = jax_ref[quant][0]
    kc, vc = jdec._empty_cache(ids.shape[0])
    want, _, _ = jdec._prefill(jdec.params, jnp.asarray(ids), kc, vc)
    dec = LlamaDecoder(tm, max_len=MAX_LEN, quant=quant, device="cpu")
    kc, vc = dec._empty_cache(ids.shape[0])
    got = dec._prefill(dec._ids(ids), kc, vc)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4,
                               rtol=0)


@pytest.mark.parametrize("quant", QUANTS)
@pytest.mark.parametrize("chunk", [None, 1, 3])
def test_greedy_tokens_bit_equal_jax(models, ids, jax_ref, quant, chunk):
    _, tm = models
    _, want, d_fused, d_chunk3 = jax_ref[quant]
    dec = LlamaDecoder(tm, max_len=MAX_LEN, quant=quant, device="cpu")
    d0 = dec.dispatch_count
    got = dec.generate(ids, NEW, chunk_size=chunk)
    np.testing.assert_array_equal(np.asarray(got), want)
    delta = dec.dispatch_count - d0
    if chunk is None:
        assert delta == d_fused == 2
        assert got.resilience["level"] == "fused"
    else:
        assert delta == 1 + -(-NEW // chunk)
        if d_chunk3 is not None and chunk == 3:
            assert delta == d_chunk3
        assert got.resilience["level"] == "chunked"


def test_matches_kernel_routed_jax_decoder(models, ids):
    """The JAX decoder with its Pallas decode-attention kernel routed in
    (interpret mode off the TPU; a fresh decoder, since JAX reads the
    flag at trace time): chunked int8wk tokens equal the port's."""
    jm, tm = models
    paddle.set_flags({"use_decode_attention": True,
                      "decode_attention_interpret": True})
    try:
        jdec = JaxDecoder(jm, max_len=MAX_LEN, quant="int8wk")
        want = np.asarray(jdec.generate(ids, 8, chunk_size=3))
    finally:
        paddle.set_flags({"decode_attention_interpret": False})
    dec = LlamaDecoder(tm, max_len=MAX_LEN, quant="int8wk", device="cpu")
    np.testing.assert_array_equal(
        np.asarray(dec.generate(ids, 8, chunk_size=3)), want)


def test_eos_and_routing_flags(models, ids, jax_ref):
    """Greedy+eos trims like the JAX decoder; the dense attention form
    (use_decode_attention off) and the per-token fallback give the same
    tokens as the kernel route."""
    jm, tm = models
    jdec, ref = jax_ref[None][:2]
    eos = int(ref[0, ids.shape[1] + 4])
    want = np.asarray(jdec.generate(ids, NEW, eos_token_id=eos))
    dec = LlamaDecoder(tm, max_len=MAX_LEN, device="cpu")
    np.testing.assert_array_equal(
        np.asarray(dec.generate(ids, NEW, eos_token_id=eos)), want)
    np.testing.assert_array_equal(
        np.asarray(dec.generate(ids, NEW, eos_token_id=eos, chunk_size=5)),
        want)
    for flag in ({"use_decode_attention": False}, {"decode_fallback": True}):
        set_flags(flag)
        try:
            got = np.asarray(dec.generate(ids, NEW))
        finally:
            set_flags({"use_decode_attention": True,
                       "decode_fallback": False})
        np.testing.assert_array_equal(got, ref, err_msg=str(flag))


def test_model_generate_delegates(models, ids, jax_ref):
    """LlamaForCausalLM.generate builds its own decoder (max_len 64 here,
    as the JAX model's does) and gives the JAX decoder's tokens."""
    _, tm = models
    got = np.asarray(tm.generate(ids, NEW, quant="int8w"))
    np.testing.assert_array_equal(got, jax_ref["int8w"][1])
    assert tm._decoder.max_len == 64 and tm._decoder.quant == "int8w"


def test_typed_refusals_match_jax(models, ids, jax_ref):
    jm, tm = models
    with pytest.raises(JaxQuantMismatchError):
        JaxDecoder(jm, max_len=MAX_LEN, quant="int4")
    with pytest.raises(QuantMismatchError):
        LlamaDecoder(tm, max_len=MAX_LEN, quant="int4", device="cpu")
    assert issubclass(QuantMismatchError, ValueError)
    dec = LlamaDecoder(tm, max_len=MAX_LEN, device="cpu")
    jdec = jax_ref[None][0]
    # the same invalid asks raise the same types in both packages (each
    # before any compile of a new program)
    for call, match in (
            (lambda d, m: d.generate(ids, MAX_LEN), "exceeds max_len"),
            (lambda d, m: d.generate(ids, 4, num_speculative_tokens=2),
             "requires a draft_model"),
            (lambda d, m: d.generate(ids, 4, draft_quant="int8w"),
             "requires a draft_model"),
            (lambda d, m: d.init_decode_state(ids, None,
                                              num_speculative_tokens=2),
             "requires a draft_model"),
            (lambda d, m: d.init_decode_state(ids, None,
                                              speculative=[True, False]),
             "requires a draft_model"),
            (lambda d, m: m.generate(ids, 4, decode_strategy="bogus"),
             "unknown decode_strategy")):
        for d, m in ((jdec, jm), (dec, tm)):
            with pytest.raises(ValueError, match=match):
                call(d, m)
    # valid asks the port does not take yet name their ROADMAP item
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        LlamaDecoder(tm, mesh="dp:2", device="cpu")
    # LoRA routing is ported (tests/test_torch_lora.py): without stacks in
    # the params every row decodes as the base model, as in the JAX package
    st = dec.init_decode_state(ids, adapter_idx=[0] * ids.shape[0])
    np.testing.assert_array_equal(
        dec.decode_chunk(st, 4)[0].numpy(),
        np.asarray(dec.generate(ids, 4))[:, ids.shape[1]:])
    # speculative decoding is ported (tests/test_torch_speculative.py):
    # greedy speculation gives the plain greedy tokens, K from the flag
    np.testing.assert_array_equal(
        np.asarray(dec.generate(ids, 4, draft_model="skip:1")),
        np.asarray(dec.generate(ids, 4)))
    assert dec.init_decode_state(ids, draft_model="skip:1").spec["K"] == 4


def test_decode_chunk_signatures_match_jax(models, ids):
    """init_decode_state and decode_chunk take the JAX package's parameters
    with its defaults; sampling runs on the CPU; a draft length ``K`` on a
    plain carry is ignored, as in the JAX package."""
    import inspect

    def params(fn):
        return [(p.name, p.default)
                for p in inspect.signature(fn).parameters.values()]

    for name in ("init_decode_state", "decode_chunk"):
        assert params(getattr(LlamaDecoder, name)) == \
            params(getattr(JaxDecoder, name)), name
    _, tm = models
    dec = LlamaDecoder(tm, max_len=MAX_LEN, device="cpu")
    st = dec.init_decode_state(ids, None, 1.0, 0)
    toks, _ = dec.decode_chunk(st, 3, False, None, None, None)
    assert tuple(toks.shape) == (ids.shape[0], 3)
    st = dec.init_decode_state(ids, None, 0.7, 3)
    toks, _ = dec.decode_chunk(st, 3, True, 4, 0.9, None)
    assert tuple(toks.shape) == (ids.shape[0], 3)
    toks2, _ = dec.decode_chunk(st, 3, True, 4, 0.9, K=2)
    np.testing.assert_array_equal(toks2.numpy(), toks.numpy())


# A bf16 GQA Llama, the JAX parameters cast to bf16 as bench.py's decode
# benchmark does on the TPU (bench.py:1069-1071), with the JAX config's
# dtype bf16 so that its KV cache is bf16 too
BF16_CFG = dict(vocab_size=512, hidden_size=128, intermediate_size=256,
                num_hidden_layers=2, num_attention_heads=4,
                num_key_value_heads=2, max_position_embeddings=128)
BF16_NEW = 32


@pytest.fixture(scope="module")
def bf16_models():
    """(JAX model, port model), bf16, the same weights: Xavier-uniform
    matrices, N(0, 1) embeddings, unit norms, drawn with numpy. The JAX
    initializers are bypassed while the model is built (each compiles its
    sampler for every new shape)."""
    import jax.numpy as jnp

    from paddle_tpu.nn import initializer as init

    zeros = lambda self, shape, dtype="float32": jnp.zeros(  # noqa: E731
        shape, jnp.float32)
    with pytest.MonkeyPatch.context() as mp:
        for cls in (init.XavierUniform, init.Normal, init.Constant):
            mp.setattr(cls, "__call__", zeros)
        jm = JaxModel(JaxConfig(**BF16_CFG, dtype="bfloat16"))
    rng = np.random.default_rng(7)
    state = {}
    for name, p in jm.state_dict().items():
        shape = tuple(p.shape)
        if len(shape) == 1:
            v = np.ones(shape, np.float32)
        elif "embed_tokens" in name:
            v = rng.standard_normal(shape)
        else:
            v = rng.uniform(-1, 1, shape) * np.sqrt(6 / sum(shape))
        p._set_value(jnp.asarray(v, jnp.bfloat16))
        state[name] = np.asarray(p.value.astype(jnp.float32))
    tm = from_jax_state_dict(state, LlamaForCausalLM(
        LlamaConfig(**BF16_CFG, dtype="bfloat16"), device="cpu"))
    return jm, tm


@pytest.mark.parametrize("quant", QUANTS)
def test_bf16_decode_matches_jax(bf16_models, quant):
    """bf16 decode parity with the JAX decoder (4 prompts of 16 tokens, 32
    new, max_len 128). Both sides round bf16 at other points (eager
    PyTorch after each op, XLA where it fuses), so:
    - prefill logits within 4 bf16 spacings of the largest |logit| (the
      three recipes differ by 1.2-1.7 spacings);
    - the port's decode steps (the decode-attention route), teacher-forced
      on the JAX decoder's greedy tokens, pick the JAX token at >= 0.99 of
      the decisive positions (top-1 ahead by more than 2 bf16 spacings),
      as chip_smoke.py's serving gate does, with at least half of all
      positions decisive."""
    import jax.numpy as jnp
    import torch

    jm, tm = bf16_models
    ids = np.random.default_rng(5).integers(0, 512, (4, 16))
    jdec = JaxDecoder(jm, max_len=MAX_LEN, quant=quant)
    kc, vc = jdec._empty_cache(ids.shape[0])
    want, _, _ = jdec._prefill(jdec.params, jnp.asarray(ids), kc, vc)
    want = np.asarray(want, np.float32)
    toks = np.asarray(jdec.generate(ids, BF16_NEW))

    dec = LlamaDecoder(tm, max_len=MAX_LEN, quant=quant, device="cpu")
    kc, vc = dec._empty_cache(ids.shape[0])
    rows = []
    with torch.inference_mode():
        logits = dec._prefill(dec._ids(ids), kc, vc)
        got = logits.float().numpy()
        for t in range(BF16_NEW):
            rows.append(logits.float())
            tok = torch.as_tensor(toks[:, ids.shape[1] + t])
            logits = dec._fwd(tok[:, None], kc, vc, ids.shape[1] + t)
    big = np.abs(want).max()
    spacing = 2.0 ** (np.floor(np.log2(big)) - 7)
    assert np.abs(got - want).max() <= 4 * spacing, \
        (np.abs(got - want).max(), big)

    forced = torch.stack(rows, 1)                       # (B, NEW, V)
    top = forced.topk(2, dim=-1).values
    sp = torch.exp2(torch.floor(torch.log2(top[..., 0].abs())) - 7)
    decisive = top[..., 0] - top[..., 1] > 2 * sp
    hit = forced.argmax(-1) == torch.as_tensor(toks[:, ids.shape[1]:])
    assert int(decisive.sum()) >= decisive.numel() // 2
    assert hit[decisive].float().mean().item() >= 0.99, \
        (hit[decisive].float().mean().item(), int(decisive.sum()))
