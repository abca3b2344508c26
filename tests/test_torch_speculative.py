"""Speculative decoding and serving of the port against the JAX package's,
on the CPU at the tiny GQA size of tests/test_decode.py.

The same weights (the JAX model's, carried over by ``from_jax_state_dict``)
go through both packages, with the contracts of tests/test_decode.py,
tests/test_quantized_decode.py, tests/test_serving.py and
tests/test_lora_serving.py: the fused speculative ``generate`` is two
prefills and ONE decode dispatch; sampled, a separate 1-layer draft
(fused, with an eos) and the same draft quantized int8w (chunked, with
top-k and top-p) give the JAX package's tokens and acceptance counts,
and the skip:1 draft gives the JAX engine's acceptance counts; greedy
speculation, with any draft, gives the plain greedy tokens (greedy
speculation is invisible in the JAX package, and the JAX engine's greedy
speculative tokens are compared below); the
per-round fallback and every chunk slicing give the fused route's
tokens; the argument refusals are the same. The engine serves
speculatively with the JAX engine's tokens, dispatch accounting,
cumulative acceptance records and adaptive K trace, with rows opted out
by ``submit(speculative=False)`` among them. Each JAX route
compiles once, in a module fixture; the JAX models are built with their
initializers bypassed. The JAX imports live inside the fixtures, so the
card's test run (``pytest --noconftest -m gpu``, no JAX) can collect this
file; its ``gpu`` test decides inside its body whether a card is present
and skips here.
"""

import numpy as np
import pytest
import torch

from paddle_tpu_torch.convert import from_jax_state_dict
from paddle_tpu_torch.flags import flags, set_flags
from paddle_tpu_torch.inference.generate import LlamaDecoder
from paddle_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM
from paddle_tpu_torch.serving import ServingEngine

CFG = dict(vocab_size=64, hidden_size=32, intermediate_size=64,
           num_hidden_layers=2, num_attention_heads=4,
           num_key_value_heads=2, max_position_embeddings=64)
SPEC = dict(draft_model="skip:1", num_speculative_tokens=2)
# the fused route's sampled JAX reference draws at a temperature; the
# chunked one adds top-k and top-p (``SAMPLED_TOPKP``)
SAMPLED = dict(do_sample=True, temperature=0.9, seed=2)
SAMPLED_TOPKP = dict(SAMPLED, top_k=8, top_p=0.9)


def _jax_model(seed, **over):
    """A JAX model with weights drawn by numpy (normal(0, 0.02) matrices,
    unit norms): the JAX initializers are bypassed while it is built, as
    tests/test_torch_decode.py does (each compiles its sampler for every
    new shape)."""
    import jax.numpy as jnp

    from paddle_tpu.models.llama import LlamaConfig as JaxConfig
    from paddle_tpu.models.llama import LlamaForCausalLM as JaxModel
    from paddle_tpu.nn import initializer as init

    zeros = lambda self, shape, dtype="float32": jnp.zeros(  # noqa: E731
        shape, jnp.float32)
    with pytest.MonkeyPatch.context() as mp:
        for cls in (init.XavierUniform, init.Normal, init.Constant):
            mp.setattr(cls, "__call__", zeros)
        jm = JaxModel(JaxConfig(**{**CFG, **over}))
    rng = np.random.default_rng(seed)
    for p in jm.state_dict().values():
        shape = tuple(p.shape)
        p._set_value(jnp.asarray(
            np.ones(shape, np.float32) if len(shape) == 1
            else rng.normal(0, 0.02, shape).astype(np.float32)))
    return jm


def _port(jm, **over):
    state = {k: np.asarray(v.value) for k, v in jm.state_dict().items()}
    return from_jax_state_dict(state, LlamaForCausalLM(
        LlamaConfig(**{**CFG, **over}), device="cpu"))


@pytest.fixture(scope="module")
def models():
    """(JAX model, port model, port 1-layer draft, JAX 1-layer draft):
    the drafts hold the same weights."""
    jm = _jax_model(8)
    jd = _jax_model(10, num_hidden_layers=1)
    return jm, _port(jm), _port(jd, num_hidden_layers=1), jd


@pytest.fixture(scope="module")
def prompt():
    return np.random.default_rng(0).integers(0, 64, (3, 5))


@pytest.fixture(scope="module")
def port(models):
    tm = models[1]
    return (LlamaDecoder(tm, max_len=40, device="cpu"),
            LlamaDecoder(tm, max_len=40, quant="int8w", device="cpu"))


@pytest.fixture(scope="module")
def jax_ref(models, prompt, port):
    """The JAX decoder's sampled speculative outputs, each route compiled
    once (the separate draft fused, with an eos; the int8w separate
    draft chunked, with top-k and top-p): route name ->
    (tokens, dispatch delta, last_spec_stats); and
    the port's plain greedy tokens with the eos they reach (the port's
    greedy tokens are held to the JAX decoder's in
    tests/test_torch_decode.py, its greedy speculative serving to the JAX
    engine's below)."""
    from paddle_tpu.inference.generate import LlamaDecoder as JaxDecoder
    dec = JaxDecoder(models[0], max_len=40)
    plain = np.asarray(port[0].generate(prompt, 8))
    eos = int(plain[0, 7])
    out = {"plain": (plain, None, None), "eos": eos}
    draft = dict(draft_model=models[3], num_speculative_tokens=3)
    runs = {
        "draft_sampled_eos": (8, dict(draft, eos_token_id=eos, **SAMPLED)),
        "draft_int8w_chunked": (10, dict(draft, draft_quant="int8w",
                                         chunk_size=3, **SAMPLED_TOPKP)),
    }
    for name, (n, kw) in runs.items():
        d0 = dec.dispatch_count
        toks = np.asarray(dec.generate(prompt, n, **kw))
        out[name] = (toks, dec.dispatch_count - d0, dec.last_spec_stats)
    return out


def _fallback(fn):
    set_flags({"decode_fallback": True})
    try:
        return np.asarray(fn())
    finally:
        set_flags({"decode_fallback": False})


def test_fused_speculative_matches_jax(models, prompt, jax_ref, port):
    """Two prefills and ONE decode dispatch: skip:1, K 2, greedy gives the
    plain greedy tokens; the separate 1-layer draft, K 3, sampled with an
    eos, the JAX package's tokens and acceptance counts; the per-round
    fallback (more than 3 dispatches) gives the same tokens."""
    dec, _ = port
    eos = jax_ref["eos"]
    plain = jax_ref["plain"][0]
    draft = dict(draft_model=models[2], num_speculative_tokens=3)
    for name, kw in (("greedy", SPEC),
                     ("draft_sampled_eos", dict(draft, eos_token_id=eos,
                                                **SAMPLED))):
        d0 = dec.dispatch_count
        got = np.asarray(dec.generate(prompt, 8, **kw))
        assert dec.dispatch_count - d0 == 3, name
        assert dec.last_resilience["level"] == "speculative"
        stats = dec.last_spec_stats
        assert stats["num_speculative_tokens"] == \
            kw["num_speculative_tokens"]
        if name == "greedy":
            np.testing.assert_array_equal(got, plain)
        else:
            want, disp, jstats = jax_ref[name]
            assert disp == 3
            np.testing.assert_array_equal(got, want)
            assert stats == jstats
        d0 = dec.dispatch_count
        np.testing.assert_array_equal(
            _fallback(lambda: dec.generate(prompt, 8, **kw)), got,
            err_msg=name)
        assert dec.dispatch_count - d0 > 3


@pytest.mark.parametrize("kw", [
    {}, dict(do_sample=True, temperature=0.7, seed=1),
    dict(do_sample=True, top_p=0.9, seed=3)], ids=["greedy", "temp", "topp"])
@pytest.mark.parametrize("eos", [False, True])
def test_fused_speculative_modes_match_fallback(prompt, jax_ref, port, kw,
                                                eos):
    """The mode sweep of tests/test_decode.py (greedy, temperature, top-p;
    with and without a live eos): fused and per-round fallback give the
    same tokens, greedy the plain ones."""
    dec, _ = port
    kw = dict(kw, **SPEC)
    if eos:
        kw["eos_token_id"] = jax_ref["eos"]
    fused = np.asarray(dec.generate(prompt, 8, **kw))
    np.testing.assert_array_equal(
        _fallback(lambda: dec.generate(prompt, 8, **kw)), fused)
    if not kw.get("do_sample"):
        np.testing.assert_array_equal(
            fused, np.asarray(dec.generate(prompt, 8, **{
                k: v for k, v in kw.items() if k == "eos_token_id"})))


def test_separate_and_quantized_drafts(models, prompt, jax_ref, port):
    """tests/test_decode.py's and tests/test_quantized_decode.py's draft
    contracts: a separate 1-layer draft (K 3) and the same draft
    quantized int8w (the target untouched) give the plain greedy tokens;
    skip:1 under an int8w target gives the int8w target's
    plain greedy tokens; three dispatches each. Sampled, the int8w draft
    (chunked, top-k and top-p) gives the JAX decoder's tokens, dispatches
    and acceptance counts (the unquantized draft's sampled comparison is
    in ``test_fused_speculative_matches_jax``); its weights are int8 and
    the target's are not."""
    tdraft = models[2]
    dec, qdec = port
    draft = dict(draft_model=tdraft, num_speculative_tokens=3)
    for name, d, kw, want in (
            ("draft", dec, draft, jax_ref["plain"][0]),
            ("draft_int8w", dec, dict(draft, draft_quant="int8w"),
             jax_ref["plain"][0]),
            ("skip_int8w", qdec, SPEC,
             np.asarray(qdec.generate(prompt, 8)))):
        d0 = d.dispatch_count
        got = np.asarray(d.generate(prompt, 8, **kw))
        assert d.dispatch_count - d0 == 3, name
        np.testing.assert_array_equal(got, want, err_msg=name)
        assert 0 <= d.last_spec_stats["acceptance_len_mean"] <= 3
    want, disp, jstats = jax_ref["draft_int8w_chunked"]
    d0 = dec.dispatch_count
    got = np.asarray(dec.generate(prompt, 10, chunk_size=3, **dict(
        draft, draft_quant="int8w", **SAMPLED_TOPKP)))
    assert dec.dispatch_count - d0 == disp
    np.testing.assert_array_equal(got, want)
    assert dec.last_spec_stats == jstats
    dp = dec._spec_engines["model", id(tdraft), "int8w"]["params"]
    assert dp["head:int8"].dtype == torch.int8
    assert all(f"model.layers.0.{w}.weight:int8" in dp
               for w in ("self_attn.qkv", "self_attn.o_proj",
                         "mlp.gate_up", "mlp.down_proj"))
    assert not any(k.endswith(":int8") for k in dec.params)


def test_chunked_speculative_slicing_and_stats(prompt, jax_ref, port):
    """Every chunk slicing T in {1, 3, 12} gives the fused route's greedy
    tokens with at most ceil(12 / T) chunks after the 2 prefills, and
    ``last_spec_stats`` counts every re-entry (never the last chunk only);
    the sampled chunked route's JAX comparison is in
    ``test_separate_and_quantized_drafts``."""
    dec, _ = port
    fused = np.asarray(dec.generate(prompt, 12, **SPEC))
    fstats = dec.last_spec_stats
    for T in (1, 3, 12):
        d0 = dec.dispatch_count
        got = np.asarray(dec.generate(prompt, 12, chunk_size=T, **SPEC))
        np.testing.assert_array_equal(got, fused, err_msg=f"T={T}")
        assert dec.dispatch_count - d0 <= 2 + -(-12 // T), T
        stats = dec.last_spec_stats
        assert stats["rounds"] >= fstats["rounds"], T
        assert stats["accepted_drafts"] >= fstats["accepted_drafts"], T


def test_decode_chunk_on_a_speculative_carry(prompt, port):
    """``decode_chunk`` on a speculative carry runs exactly T rounds: a
    (B, T (K + 1) + 1) buffer, each row's ``nv`` in [T, T (K + 1) + 1],
    and the valid tokens chained over chunks are the fused route's;
    ``K=`` overrides the draft length for one chunk."""
    dec, _ = port
    fused = np.asarray(dec.generate(prompt, 12, **SPEC))[:, 5:]
    st = dec.init_decode_state(prompt, **SPEC)
    assert st.tok.tolist() == [-1] * 3 and st.spec["K"] == 2
    got = [[] for _ in range(3)]
    for K in (2, 1, 2):
        toks, st = dec.decode_chunk(st, 2, K=K)
        assert tuple(toks.shape) == (3, 2 * (K + 1) + 1)
        for b in range(3):
            n = int(st.nv[b])
            assert 2 <= n <= 2 * (K + 1) + 1
            got[b] += toks[b, :n].tolist()
    for b in range(3):
        n = min(len(got[b]), 12)
        np.testing.assert_array_equal(got[b][:n], fused[b, :n])


def test_speculative_validation_errors(models):
    """tests/test_decode.py's refusals, the same types and messages in
    both packages (a full-size model stands in as a separate draft)."""
    from paddle_tpu.inference.generate import LlamaDecoder as JaxDecoder
    jm, tm = models[:2]
    p = np.array([[1, 2, 3]])
    bad = (_jax_model(11, vocab_size=32),
           LlamaForCausalLM(LlamaConfig(**{**CFG, "vocab_size": 32}),
                            device="cpu"))
    decs = (JaxDecoder(jm, max_len=20),
            LlamaDecoder(tm, max_len=20, device="cpu"))
    for kw, match in (
            (dict(draft_model="skip:0"), "skip"),
            (dict(draft_model="skip:2"), "skip"),
            (dict(draft_model="tiny"), "draft_model must be"),
            (dict(draft_model="skip:1", num_speculative_tokens=0), ">= 1"),
            (dict(num_speculative_tokens=2), "requires a draft_model"),
            (dict(draft_quant="int8w"), "requires a draft_model"),
            (dict(draft_model="skip:1", num_speculative_tokens=2,
                  draft_quant="int8w"), "quantize the target"),
            (dict(draft_model=1, num_speculative_tokens=2,
                  draft_quant="int4"), "draft_quant"),
            (dict(draft_model=2), "vocab")):
        for j, dec in enumerate(decs):
            kw2 = dict(kw)
            if kw2.get("draft_model") == 1:
                kw2["draft_model"] = (jm, tm)[j]
            elif kw2.get("draft_model") == 2:
                kw2["draft_model"] = bad[j]
            with pytest.raises(ValueError, match=match):
                dec.generate(p, max_new_tokens=4, **kw2)
    for dec in decs:
        with pytest.raises(ValueError, match="slack"):
            dec.generate(p, max_new_tokens=17, draft_model="skip:1",
                         num_speculative_tokens=2)


def test_model_generate_surface_and_flag_default(models, prompt, jax_ref):
    """``model.generate(draft_model=)`` threads the draft through and
    sizes the cache with K slots of slack; with no K the
    ``decode_speculative_tokens`` flag gives it."""
    tm = models[1]
    plain = np.asarray(tm.generate(prompt, 6))
    np.testing.assert_array_equal(plain, jax_ref["plain"][0][:, :11])
    np.testing.assert_array_equal(
        np.asarray(tm.generate(prompt, 6, max_len=13, **SPEC)), plain)
    with pytest.raises(ValueError, match="max_len"):
        tm.generate(prompt, 6, max_len=12, **SPEC)
    assert flags.decode_speculative_tokens == 4
    set_flags({"decode_speculative_tokens": 2})
    try:
        np.testing.assert_array_equal(
            np.asarray(tm.generate(prompt, 6, draft_model="skip:1")), plain)
        assert tm._decoder.last_spec_stats["num_speculative_tokens"] == 2
    finally:
        set_flags({"decode_speculative_tokens": 4})


def _mixed_requests(rng, n, dec):
    """tests/test_serving.py's mix with prompts of at most 8 tokens (one
    admission bucket): every third request with a reachable eos."""
    reqs = []
    for i in range(n):
        p = rng.integers(0, 64, (int(rng.integers(2, 9)),))
        nt = int(rng.integers(2, 12))
        eos = None
        if i % 3 == 0 and nt >= 4:
            eos = int(np.asarray(dec.generate(p[None], nt))[0,
                                                           len(p) + nt // 2])
        reqs.append((p, nt, eos))
    return reqs


@pytest.fixture(scope="module")
def engines(models):
    """(JAX decoder, port decoder) at the serving tests' max_len."""
    from paddle_tpu.inference.generate import LlamaDecoder as JaxDecoder
    jm, tm = models[:2]
    return (JaxDecoder(jm, max_len=64),
            LlamaDecoder(tm, max_len=64, device="cpu"))


def test_engine_speculative_parity_stats_and_accounting(engines):
    """tests/test_serving.py's tentpole contract against the JAX engine,
    with ``adaptive_k`` (K 3 at most, each distinct K its own chunk
    program) and every third request opted out by
    ``submit(speculative=False)`` (tests/test_lora_serving.py's per-row
    switch: the row rides the same chunk verify-free): the same tokens
    as the JAX speculative engine and as the port's plain engine, the
    same K trace chunk by chunk, the dispatch identity (prefills + draft
    prefills + chunks), no host scatters, the JAX engine's
    ``metrics()["speculative"]`` and ring dicts, per-request cumulative
    records equal to the JAX engine's and summing to the engine's
    rounds, and no accepted draft in an opted-out row."""
    from paddle_tpu.serving import ServingEngine as JaxEngine
    jdec, dec = engines
    reqs = _mixed_requests(np.random.default_rng(11), 6, dec)
    spec = dict(draft_model="skip:1", num_speculative_tokens=3,
                adaptive_k=True)
    opt = [(None, False, True)[i % 3] for i in range(len(reqs))]
    outs = []
    for E, d, kw in ((JaxEngine, jdec, spec), (ServingEngine, dec, spec),
                     (ServingEngine, dec, {})):
        eng = E(d, num_slots=3, chunk_size=4, **kw)
        d0 = d.dispatch_count
        ids = [eng.submit(p, n, eos_token_id=e,
                          speculative=o if kw else None)
               for (p, n, e), o in zip(reqs, opt)]
        trace = []      # the K each chunk dispatches with
        while len(eng.scheduler) or eng.scheduler.slots.occupied():
            sp = eng.metrics()["speculative"]
            trace.append(None if sp is None else sp["k_now"])
            eng.step()
        m = eng.metrics()
        assert d.dispatch_count - d0 == m["prefill_dispatches"] \
            + m["draft_prefill_dispatches"] + m["chunk_dispatches"]
        assert m["step_dispatches"] == 0
        assert m["admission_ring"]["host_scattered"] == 0
        outs.append((eng, [eng.result(r) for r in ids], trace))
    (je, jres, jtr), (te, tres, ttr), (pe, pres, _) = outs
    assert ttr == jtr and len(ttr) > 1
    for a, b, c in zip(jres, tres, pres):
        np.testing.assert_array_equal(np.asarray(b), np.asarray(a))
        np.testing.assert_array_equal(np.asarray(b), np.asarray(c))
        assert b.resilience["serving"]["speculative"] == \
            a.resilience["serving"]["speculative"]
    m, jm_ = te.metrics(), je.metrics()
    assert set(m) == set(jm_)
    for k in ("speculative", "admission_ring", "draft_prefill_dispatches",
              "prefill_dispatches", "chunk_dispatches"):
        assert m[k] == jm_[k], k
    assert m["draft_prefill_dispatches"] == len(reqs)
    assert pe.metrics()["speculative"] is None
    assert te.status()["speculative"] == je.status()["speculative"]
    sp = m["speculative"]
    assert sp["adaptive_k"] is True
    assert sp["rounds"] == sum(r.resilience["serving"]["speculative"]
                               ["rounds"] for r in tres) > 0
    recs = [r.resilience["serving"]["speculative"] for r in tres]
    assert all(rec["accepted_drafts"] == 0
               for rec, o in zip(recs, opt) if o is False)
    assert any(rec["accepted_drafts"] > 0
               for rec, o in zip(recs, opt) if o is not False)
    assert pres[0].resilience["serving"]["speculative"] is None


def test_engine_speculative_sampled_shape_invariance(engines):
    """Sampled speculative serving draws from per-row keys: a 3-slot T=3
    engine and a 1-slot T=7 engine give the same tokens, with every
    second request opted out of speculation."""
    _, dec = engines
    rng = np.random.default_rng(12)
    reqs = [(rng.integers(0, 64, (int(rng.integers(2, 8)),)),
             int(rng.integers(3, 9)), i, 0.7 + 0.2 * (i % 3))
            for i in range(5)]
    outs = []
    for slots, T in ((3, 3), (1, 7)):
        eng = ServingEngine(dec, num_slots=slots, chunk_size=T,
                            do_sample=True, top_k=8, **SPEC)
        ids = [eng.submit(p, n, seed=s, temperature=t,
                          speculative=s % 2 == 0)
               for p, n, s, t in reqs]
        res = eng.drain()
        outs.append([np.asarray(res[r]) for r in ids])
    for a, b in zip(*outs):
        np.testing.assert_array_equal(a, b)


def test_engine_speculative_refusals(engines):
    """Both engines refuse the same asks: ``adaptive_k`` without a draft,
    a draft with a prefix cache, a request past the cache's slack;
    ``submit(speculative=True)`` needs a draft."""
    from paddle_tpu.serving import ServingEngine as JaxEngine
    for E, d in zip((JaxEngine, ServingEngine), engines):
        with pytest.raises(ValueError, match="adaptive_k"):
            E(d, num_slots=3, chunk_size=4, adaptive_k=True)
        with pytest.raises(ValueError, match="prefix cache"):
            E(d, num_slots=3, chunk_size=4, prefix_cache=True, **SPEC)
        eng = E(d, num_slots=3, chunk_size=4, draft_model="skip:1",
                num_speculative_tokens=3)
        with pytest.raises(ValueError, match="exceeds"):
            eng.submit(np.arange(50) % 64, 12)
        with pytest.raises(ValueError, match="draft_model-equipped"):
            E(d, num_slots=2, chunk_size=4).submit(np.arange(4), 3,
                                                   speculative=True)


@pytest.mark.gpu
@pytest.mark.parametrize("sampled", [False, True])
def test_graph_speculative_chunk_matches_eager_on_card(sampled):
    """Four chained speculative chunks (skip:1, K 2; greedy, or top-k 50
    and top-p 0.9) through ``decode_chunk`` (eager, capture and replay,
    replays) against the eager chunk body on a second carry: the same
    buffers, valid counts and carry; one graph; one dispatch each."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    from paddle_tpu_torch.inference.generate import _sample_spec
    model = LlamaForCausalLM(LlamaConfig(
        vocab_size=512, hidden_size=256, intermediate_size=512,
        num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
        max_position_embeddings=256, dtype="bfloat16"), seed=0)
    dec = LlamaDecoder(model, max_len=96)
    ids = np.random.default_rng(0).integers(0, 512, (3, 5))
    kw = dict(top_k=50, top_p=0.9) if sampled else {}
    sample = _sample_spec(sampled, kw.get("top_k"), kw.get("top_p"))
    with torch.inference_mode():
        st, ref = (dec.init_decode_state(ids, eos_token_id=7,
                                         temperature=0.8, seed=3, **SPEC)
                   for _ in range(2))
        d0 = dec.dispatch_count
        for i in range(4):
            toks, st = dec.decode_chunk(st, 3, sampled, **kw)
            want, ref = dec._spec_chunk_steps(ref, 3, 2, sample)
            assert torch.equal(toks, want), i
            for name in ("logits", "pos", "keys", "done", "tok", "nv",
                         "spec_rounds", "spec_accepted"):
                assert torch.equal(getattr(st, name), getattr(ref, name)), \
                    (i, name)
        assert dec.dispatch_count - d0 == 4
        assert sum(g is not None for g in dec._chunk_graphs.values()) == 1
