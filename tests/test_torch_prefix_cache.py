"""The port's prefix cache (paddle_tpu_torch/serving/prefix_cache.py) and
its host-scatter admission route against the JAX package's, on the CPU at
the tiny GQA size of tests/test_prefix_cache.py (block 4).

The same weights go through the JAX engine and the port's, with the
contracts of tests/test_prefix_cache.py: the digest ladder is the same
string for string; the slab pool evicts, pins and dedupes alike over the
same operations; a full hit admits with zero prefill dispatches, a
partial hit prefills only its suffix, a one-token divergence misses, and
each request's tokens, hit class, saved tokens and admission dispatches
equal the JAX engine's, with the same ``metrics()["prefix_cache"]``,
``status()["prefix_cache"]`` and ``metrics()["admission_ring"]`` (None:
the cache turns the ring off). Batched same-bucket admission and
cache-aware ordering count alike. The JAX imports live inside the
fixtures and tests, so the card's test run (``pytest --noconftest -m
gpu``, no JAX) can collect this file; its ``gpu`` test decides inside its
body whether a card is present and skips here.
"""

import numpy as np
import pytest
import torch

from paddle_tpu_torch.convert import from_jax_state_dict
from paddle_tpu_torch.inference.generate import LlamaDecoder
from paddle_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM
from paddle_tpu_torch.serving import (PrefixCache, ServingEngine,
                                      prefix_digests)
from paddle_tpu_torch.serving.scheduler import Request, Scheduler

CFG = dict(vocab_size=64, hidden_size=32, intermediate_size=64,
           num_hidden_layers=2, num_attention_heads=4,
           num_key_value_heads=2, max_position_embeddings=64)
BLOCK = 4
CACHE_KW = dict(prefix_cache=True, prefix_cache_bytes=1 << 30,
                prefix_block_tokens=BLOCK)


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


@pytest.fixture(scope="module")
def decoders():
    """(JAX decoder, port decoder) over the same weights."""
    from paddle_tpu.inference.generate import LlamaDecoder as JaxDecoder
    jm = _jax_model(0)
    state = {k: np.asarray(v.value) for k, v in jm.state_dict().items()}
    tm = from_jax_state_dict(
        state, LlamaForCausalLM(LlamaConfig(**CFG), device="cpu"))
    return (JaxDecoder(jm, max_len=64),
            LlamaDecoder(tm, max_len=64, device="cpu"))


def _mix():
    """A shared 8-token prefix (2 blocks): the leader p1, a suffix variant
    p2 (partial hit), p1 diverged inside block 0 (miss) and a cold p3."""
    rng = np.random.default_rng(3)
    pre = rng.integers(0, 64, (8,))
    p1 = np.concatenate([pre, rng.integers(0, 64, (3,))])
    p2 = np.concatenate([pre, rng.integers(0, 64, (5,))])
    p_div = p1.copy()
    p_div[1] = (p_div[1] + 1) % 64
    return p1, p2, p_div, rng.integers(0, 64, (11,))


def _serve(E, dec, rounds, **kw):
    """Submit each round's prompts (6 new tokens) and drain before the
    next round, so that later rounds can hit. Returns the engine, the
    results in submit order and the decoder's dispatch delta."""
    eng = E(dec, num_slots=2, chunk_size=4, **kw)
    d0 = dec.dispatch_count
    out = []
    for prompts in rounds:
        ids = [eng.submit(p, 6) for p in prompts]
        res = eng.drain()
        out += [res[r] for r in ids]
    return eng, out, dec.dispatch_count - d0


def test_prefix_digests_ladder_matches_jax():
    from paddle_tpu.serving import prefix_digests as jax_digests
    rng = np.random.default_rng(0)
    for toks in (np.arange(10), np.arange(8), rng.integers(0, 64, (13,)),
                 np.array([5])):
        for block in (1, 4, 64):
            assert prefix_digests(toks, block) == jax_digests(toks, block)
    assert prefix_digests(np.arange(9), 4, adapter="a@1") == \
        jax_digests(np.arange(9), 4, adapter="a@1")
    assert [L for L, _ in prefix_digests(np.arange(10), 4)] == [10, 8, 4]
    for fn in (prefix_digests, jax_digests):
        with pytest.raises(ValueError, match="at least 1"):
            fn(np.zeros((0,)), 4)
        with pytest.raises(ValueError, match="block_tokens"):
            fn(np.arange(3), 0)


def _fake_slab(nbytes=1024):
    kc = np.zeros((nbytes // 4,), np.float32)
    return kc, kc.copy(), np.zeros((1, 4), np.float32)


def test_pool_eviction_pinning_dedupe_follow_jax():
    """The same operations on the JAX ``PrefixCache`` and the port's:
    LRU eviction under the byte budget, refcount pins that outlast a
    budget below them, dedupe of identical full prefixes; every lookup
    verdict and the final ``stats()`` and ``snapshot()`` are equal."""
    from paddle_tpu.serving import PrefixCache as JaxCache
    one = sum(a.nbytes for a in _fake_slab())
    rng = np.random.default_rng(0)
    toks = [rng.integers(0, 64, (8,)) for _ in range(5)]

    def drive(cls):
        verdicts = []
        c = cls(bytes_budget=2 * one, block_tokens=4)
        slabs = [c.insert(t, *_fake_slab(), bucket=8) for t in toks[:3]]
        verdicts += [c.lookup(t).kind for t in toks[:3]]
        c.lookup(toks[1])
        c.insert(toks[3], *_fake_slab(), bucket=8)
        verdicts += [c.lookup(t).kind for t in toks[:4]]
        s = c.insert(toks[3], *_fake_slab(), bucket=8)     # dedupe
        verdicts.append(s is c.insert(toks[3], *_fake_slab(), bucket=8))
        c.pin(s)
        c.bytes_budget = 1
        c._evict_to_budget()
        verdicts.append(c.lookup(toks[3]).kind)            # pinned
        verdicts.append(c.insert(toks[4], *_fake_slab(), bucket=8))
        c.unpin(s)
        verdicts.append(c.lookup(toks[3]).kind)
        with pytest.raises(RuntimeError, match="unpin"):
            c.unpin(s)
        verdicts.append(c.lookup(np.concatenate([toks[0], [1]])).kind)
        return verdicts, c.stats(), c.snapshot(), slabs
    jv, js, jsnap, _ = drive(JaxCache)
    tv, ts, tsnap, _ = drive(PrefixCache)
    assert tv == jv
    assert ts == js and tsnap == jsnap
    assert ts["evictions"] >= 3 and ts["pinned"] == 0


def test_hit_classes_match_jax_engine(decoders):
    """Leader, then a full hit and a partial hit, then a one-token
    divergence and a cold prompt: the JAX engine's tokens, hit classes,
    saved tokens, admission dispatches and dispatch ledger; a full hit
    moves no prefill count; the pool's stats and status equal the JAX
    engine's, and the ring's dict is None (host-scatter route)."""
    from paddle_tpu.serving import ServingEngine as JaxEngine
    jdec, dec = decoders
    p1, p2, p_div, p3 = _mix()
    rounds = ([p1], [p1, p2], [p_div, p3])
    je, jres, jdisp = _serve(JaxEngine, jdec, rounds, **CACHE_KW)
    te, tres, tdisp = _serve(ServingEngine, dec, rounds, **CACHE_KW)
    keys = ("prefix_hit", "prefill_tokens_saved", "admission_dispatches")
    for a, b in zip(jres, tres):
        np.testing.assert_array_equal(np.asarray(b), np.asarray(a))
        assert set(b.resilience["serving"]) == set(a.resilience["serving"])
        for k in keys:
            assert b.resilience["serving"][k] == a.resilience["serving"][k]
    assert [r.resilience["serving"]["prefix_hit"] for r in tres] == \
        ["miss", "full", "partial", "miss", "miss"]
    assert tres[1].resilience["serving"]["admission_dispatches"] == 0
    assert tres[2].resilience["serving"]["prefill_tokens_saved"] == 8
    assert tdisp == jdisp
    for r, p in zip(tres, (p1, p1, p2, p_div, p3)):
        np.testing.assert_array_equal(
            np.asarray(r), np.asarray(dec.generate(p[None], 6)))
    m, jm_ = te.metrics(), je.metrics()
    assert set(m) == set(jm_)
    for k in ("prefix_cache", "admission_ring", "prefill_dispatches",
              "chunk_dispatches", "admission_dispatches_saved",
              "prefill_tokens_saved", "batched_admission_groups",
              "admission_cache_reordered"):
        assert m[k] == jm_[k], k
    assert m["admission_ring"] is None
    assert m["prefill_dispatches"] == 4 and te.host_scattered == 5
    assert set(m["admission_p50_s"]) == {"full", "partial", "miss"}
    assert te.status()["prefix_cache"] == je.status()["prefix_cache"]
    assert set(te.status()) == set(je.status())
    eng0 = ServingEngine(dec, num_slots=2, chunk_size=4)
    assert eng0.status()["prefix_cache"] is None
    assert eng0.metrics()["prefix_cache"] is None


def test_cached_admission_sampled_per_row_keys(decoders):
    """Sampled rows draw from their request's key on every admission
    route: a cached 2-slot T=3 engine (full and partial hits) and a
    cache-less 1-slot T=7 engine give the same tokens."""
    _, dec = decoders
    p1, p2, _, _ = _mix()
    reqs = [(p1, 6, 3, 0.8), (p1, 6, 3, 0.8), (p2, 7, 4, 1.1),
            (p1, 5, 9, 0.7)]
    outs = []
    for kw, slots, T in ((CACHE_KW, 2, 3), ({}, 1, 7)):
        eng = ServingEngine(dec, num_slots=slots, chunk_size=T,
                            do_sample=True, top_k=8, **kw)
        ids = []
        for p, n, s, t in reqs:
            ids.append(eng.submit(p, n, seed=s, temperature=t))
            eng.drain()
        outs.append([np.asarray(eng.result(r)) for r in ids])
        if kw:
            m = eng.metrics()["prefix_cache"]
            assert m["engine_hits_full"] >= 1
            assert m["engine_hits_partial"] >= 1
    for a, b in zip(*outs):
        np.testing.assert_array_equal(a, b)


def test_batched_admission_matches_jax_engine(decoders):
    """With the cache, two cold prompts of one bucket admit with ONE
    prefill dispatch, then a full and a partial hit: tokens, hit classes,
    admission dispatches, prefill count, dispatches saved and batched
    groups equal the JAX engine's. Without it (the ring route), four
    same-bucket requests take one prefill, with their solo tokens."""
    from paddle_tpu.serving import ServingEngine as JaxEngine
    jdec, dec = decoders
    p1, p2, _, p3 = _mix()
    rounds = ([p1, p3], [p1, p2])
    keys = ("prefix_hit", "admission_dispatches", "prefill_tokens_saved")
    got = []
    for E, d in ((JaxEngine, jdec), (ServingEngine, dec)):
        eng, res, disp = _serve(E, d, rounds, batch_admission=True,
                                **CACHE_KW)
        got.append(([np.asarray(r) for r in res],
                    [[r.resilience["serving"][k] for k in keys]
                     for r in res], eng.metrics(), disp))
    (ja, jr, jm_, jd), (ta, tr, tm_, td) = got
    for a, b in zip(ja, ta):
        np.testing.assert_array_equal(b, a)
    assert tr == jr and td == jd
    for k in ("prefill_dispatches", "batched_admission_groups",
              "admission_dispatches_saved", "prefix_cache"):
        assert tm_[k] == jm_[k], k
    assert [r[1] for r in tr] == [1, 0, 0, 1]
    assert tm_["prefill_dispatches"] == 2
    assert tm_["batched_admission_groups"] == 1
    rng = np.random.default_rng(7)
    same = [rng.integers(0, 64, (5,)) for _ in range(4)]
    eng = ServingEngine(dec, num_slots=4, chunk_size=4, batch_admission=True)
    ids = [eng.submit(p, 5, seed=i) for i, p in enumerate(same)]
    res = eng.drain()
    m = eng.metrics()
    assert m["prefill_dispatches"] == 1
    assert m["admission_dispatches_saved"] == 3
    assert m["admission_ring"]["staged"] == 4
    assert sorted(res[r].resilience["serving"]["admission_dispatches"]
                  for r in ids) == [0, 0, 0, 1]
    for r, p in zip(ids, same):
        np.testing.assert_array_equal(
            np.asarray(res[r]), np.asarray(dec.generate(p[None], 5)))


def test_cache_aware_ordering_matches_jax():
    """``_cache_aware_pops`` over the same queue and cache probe: the same
    requests in the same order, the same ``cache_reordered`` count, FIFO
    kept inside each digest group and across priority tiers."""
    from paddle_tpu.serving.scheduler import Request as JaxRequest
    from paddle_tpu.serving.scheduler import Scheduler as JaxScheduler
    groups = ["a", "b", None, "a", "c", "b", "a", None, "c", "b"]
    live = {"b", "c"}
    picked = []
    for S, R in ((JaxScheduler, JaxRequest), (Scheduler, Request)):
        s = S(4, policy="priority", cache_aware=True)
        s.cache_probe = live.__contains__
        for i, g in enumerate(groups):
            s.push(R(id=i, prompt=np.arange(3), max_new_tokens=2,
                     priority=int(i >= 7), prefix_group=g,
                     submit_time=1.0 + i))
        order = []
        while len(s):
            adm = s.admissions()
            order.append([r.id for _, r in adm])
            for slot, _ in adm:
                s.slots.release(slot)
        picked.append((order, s.cache_reordered))
    assert picked[0] == picked[1]
    assert picked[1][1] > 0


def test_engine_pins_inflight_slab_against_eviction(decoders):
    """A slab with a request in flight on it survives a byte budget below
    it; at the request's finish it becomes evictable; a 1-byte budget
    keeps nothing and every admission misses; tokens stay the solo
    generate's."""
    _, dec = decoders
    p1 = _mix()[0]
    solo = np.asarray(dec.generate(p1[None], 16))
    eng = ServingEngine(dec, num_slots=2, chunk_size=2, prefix_cache=True,
                        prefix_cache_bytes=1, prefix_block_tokens=BLOCK)
    a, b = eng.submit(p1, 8), eng.submit(p1, 8)
    res = eng.drain()
    for r in (a, b):
        np.testing.assert_array_equal(np.asarray(res[r]), solo[:, :19])
    st = eng.prefix_cache.stats()
    assert st["pinned"] == 0 and len(eng.prefix_cache) == 0
    assert st["evictions"] >= 1
    eng2 = ServingEngine(dec, num_slots=2, chunk_size=2, **CACHE_KW)
    eng2.submit(p1, 8)
    eng2.drain()
    b = eng2.submit(p1, 16)
    eng2.step()
    slot = eng2.scheduler.slots.entries[0]
    assert slot is not None and slot.pinned_slab is not None
    cache = eng2.prefix_cache
    cache.bytes_budget = 1
    cache._evict_to_budget()
    assert cache.lookup(p1).kind == "full"
    eng2.drain()
    assert cache.stats()["pinned"] == 0
    cache._evict_to_budget()
    assert cache.lookup(p1).kind == "miss"
    np.testing.assert_array_equal(np.asarray(eng2.result(b)), solo)


def test_prefill_extract_and_load_prefix_slab(decoders):
    """A slab payload extracted by one engine admits as a full hit in
    another: zero prefill dispatches there, the solo tokens; a recipe
    mismatch is refused."""
    from paddle_tpu_torch.quantization.kv_cache import QuantMismatchError
    _, dec = decoders
    p1 = _mix()[0]
    src = ServingEngine(dec, num_slots=2, chunk_size=4)
    payload = src.prefill_extract(p1)
    assert src.prefill_dispatches == 1 and payload["bucket"] == 16
    eng = ServingEngine(dec, num_slots=2, chunk_size=4, **CACHE_KW)
    eng.load_prefix_slab(payload)
    r = eng.submit(p1, 6)
    res = eng.drain()
    assert eng.prefill_dispatches == 0
    assert res[r].resilience["serving"]["prefix_hit"] == "full"
    np.testing.assert_array_equal(np.asarray(res[r]),
                                  np.asarray(dec.generate(p1[None], 6)))
    with pytest.raises(QuantMismatchError):
        eng.load_prefix_slab(dict(payload, quant="int8wk"))
    with pytest.raises(ValueError, match="prefix cache"):
        src.load_prefix_slab(payload)


def test_prefix_cache_refusals_match_jax(decoders):
    """The argument refusals of both engines: a non-bool, non-cache
    ``prefix_cache``, a zero block, ``ring_slots`` with a cache, a draft
    model with a cache; the flags' default leaves the cache off; a mesh
    is not ported."""
    from paddle_tpu.serving import ServingEngine as JaxEngine
    jdec, dec = decoders
    for E, d in ((JaxEngine, jdec), (ServingEngine, dec)):
        with pytest.raises(TypeError, match="prefix_cache"):
            E(d, num_slots=2, chunk_size=4, prefix_cache=42)
        with pytest.raises(ValueError, match="block_tokens"):
            E(d, num_slots=2, chunk_size=4, prefix_cache=True,
              prefix_block_tokens=0)
        with pytest.raises(ValueError, match="ring_slots"):
            E(d, num_slots=2, chunk_size=4, ring_slots=2, **CACHE_KW)
        with pytest.raises(ValueError, match="prefix cache"):
            E(d, num_slots=2, chunk_size=4, draft_model="skip:1",
              **CACHE_KW)
        assert E(d, num_slots=2, chunk_size=4).prefix_cache is None
    with pytest.raises(NotImplementedError, match="mesh"):
        PrefixCache(bytes_budget=10).bind_mesh({"dp": 2})


@pytest.mark.gpu
def test_graph_suffix_prefill_slab_survives_allocations_on_card():
    """A prefix-cache engine on the card: after the leader, suffix
    prefills of one (rows, bucket) key run eagerly, then capture, then
    replay, each on its own slab loaded into the graph's caches. Between
    the calls, canaries the size of those caches fill freed memory; each
    replay's logits and cache row equal an eager prefill of the same
    suffix on the loaded slab, and the canaries keep their values."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    model = LlamaForCausalLM(LlamaConfig(
        vocab_size=512, hidden_size=256, intermediate_size=512,
        num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
        max_position_embeddings=256), seed=0)
    dec = LlamaDecoder(model, max_len=64)
    ref = LlamaDecoder(model, max_len=64)
    eng = ServingEngine(dec, num_slots=2, chunk_size=4, **CACHE_KW)
    rng = np.random.default_rng(1)
    pre = rng.integers(0, 512, (8,))
    eng.submit(np.concatenate([pre, rng.integers(0, 512, (3,))]), 3)
    eng.drain()
    slab = eng.prefix_cache.lookup(pre).slab
    ops = eng._slab_ops
    canaries = []
    for i in range(4):
        ids = np.zeros((1, 8), np.int64)
        ids[0, :5] = rng.integers(0, 512, 5)

        def prepare(kc, vc):
            ops.load(kc, vc, slab.kc, slab.vc, 0)
        with torch.inference_mode():
            lg, kc, vc = dec.admit_prefill(ids, [5], [8], prepare=prepare)
            lg, kc = lg.clone(), kc.clone()
            want, wkc, _ = ref.admit_prefill(ids, [5], [8],
                                             *ref._empty_cache(1),
                                             prepare=prepare)
            canaries.append(torch.full_like(kc, 3.0))
        torch.cuda.synchronize()
        assert torch.allclose(lg, want, atol=1e-4, rtol=1e-4), i
        assert torch.allclose(kc, wkc, atol=1e-4, rtol=1e-4), i
    assert all(bool((c == 3.0).all()) for c in canaries)
    n, replays = 0, 0
    for k, g in dec._prefill_graphs.items():
        if g is not None and k[0] == "admit" and k[1:3] == (1, 8):
            n, replays = n + 1, replays + g.replays
    assert n == 1 and replays == 3
