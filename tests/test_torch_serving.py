"""The port's ServingEngine (paddle_tpu_torch/serving/engine.py) against the
JAX package's, on the CPU at a tiny GQA size.

The same mixed requests as tests/test_serving.py (mixed prompt lengths and
budgets, every third with a reachable eos, 3 slots, T=4) go through the JAX
engine and the port's over the same weights: tokens are bit-equal per
request, the prefill and chunk dispatch counts equal, and the port's
decoder ``dispatch_count`` moves by exactly prefills + chunks. The port's
engine also matches the port's solo ``generate``. Both engines admit
through their device admission ring (the JAX engine's default route), and
``metrics()["admission_ring"]`` is the same dict. Sampled serving draws
each row from the key of its request's seed: the tokens equal the JAX
engine's, request by request, and do not depend on the engine's shape.
"""

import numpy as np
import pytest

import paddle_tpu as paddle
from paddle_tpu.inference.generate import LlamaDecoder as JaxDecoder
from paddle_tpu.models.llama import LlamaConfig as JaxConfig
from paddle_tpu.models.llama import LlamaForCausalLM as JaxModel
from paddle_tpu.serving import ServingEngine as JaxEngine
from paddle_tpu_torch.convert import from_jax_state_dict
from paddle_tpu_torch.inference.generate import LlamaDecoder
from paddle_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM
from paddle_tpu_torch.quantization.kv_cache import QuantMismatchError
from paddle_tpu_torch.serving import ServingEngine

CFG = dict(vocab_size=64, hidden_size=32, intermediate_size=64,
           num_hidden_layers=2, num_attention_heads=4,
           num_key_value_heads=2, max_position_embeddings=64)


@pytest.fixture(scope="module")
def models():
    paddle.seed(0)
    jm = JaxModel(JaxConfig(**CFG))
    state = {k: np.asarray(v.value) for k, v in jm.state_dict().items()}
    tm = from_jax_state_dict(
        state, LlamaForCausalLM(LlamaConfig(**CFG), device="cpu"))
    return jm, tm


def _mixed_requests(rng, n, eos_every, dec):
    """tests/test_serving.py's mix: every ``eos_every``-th request gets a
    reachable eos id (its solo greedy mid-stream token, from the port's
    decoder: its greedy tokens equal the JAX decoder's)."""
    reqs = []
    for i in range(n):
        p = rng.integers(0, 64, (int(rng.integers(2, 12)),))
        nt = int(rng.integers(2, 12))
        eos = None
        if i % eos_every == 0 and nt >= 4:
            ref = np.asarray(dec.generate(p[None], nt))
            eos = int(ref[0, len(p) + nt // 2])
        reqs.append((p, nt, eos))
    return reqs


@pytest.mark.parametrize("quant", [None, "int8wk"])
def test_engine_matches_jax_engine(models, quant):
    jm, tm = models
    dec = LlamaDecoder(tm, max_len=64, quant=quant, device="cpu")
    reqs = _mixed_requests(np.random.default_rng(4), 8, 3, dec)
    jeng = JaxEngine(JaxDecoder(jm, max_len=64, quant=quant), num_slots=3,
                     chunk_size=4)
    jids = [jeng.submit(p, n, eos_token_id=e) for p, n, e in reqs]
    want = jeng.drain()

    eng = ServingEngine(dec, num_slots=3, chunk_size=4)
    d0 = dec.dispatch_count
    ids = [eng.submit(p, n, eos_token_id=e) for p, n, e in reqs]
    got = eng.drain()
    for a, b in zip(jids, ids):
        np.testing.assert_array_equal(np.asarray(got[b]),
                                      np.asarray(want[a]))
    m, jm_ = eng.metrics(), jeng.metrics()
    assert m["prefill_dispatches"] == jm_["prefill_dispatches"] == len(reqs)
    assert m["chunk_dispatches"] == jm_["chunk_dispatches"]
    assert m["step_dispatches"] == 0
    assert dec.dispatch_count - d0 == \
        m["prefill_dispatches"] + m["chunk_dispatches"]
    assert set(m) == set(jm_)
    ring = m["admission_ring"]
    assert ring == jm_["admission_ring"]
    assert ring["host_scattered"] == eng.host_scattered == 0
    assert ring["staged"] == ring["scattered"] == len(reqs)
    assert m["requests_completed"] == len(reqs)
    rec = got[ids[0]].resilience
    assert rec["level"] == "chunked" and rec["serving"]["chunks"] >= 1

    # the port's engine against the port's solo generate
    for (p, n, e), rid in zip(reqs, ids):
        np.testing.assert_array_equal(
            np.asarray(got[rid]),
            np.asarray(dec.generate(p[None], n, eos_token_id=e)))


def test_engine_priority_and_refusals(models):
    _, tm = models
    dec = LlamaDecoder(tm, max_len=64, device="cpu")
    eng = ServingEngine(dec, num_slots=1, chunk_size=4, policy="priority")
    p = np.arange(4) % 64
    low = eng.submit(p, 3, priority=9)
    high = eng.submit(p + 1, 3, priority=0)
    finished = []
    while len(finished) < 2:
        finished.extend(rid for rid, _ in eng.step())
    assert finished == [high, low]

    with pytest.raises(QuantMismatchError):
        ServingEngine(dec, quant="int8wk")
    with pytest.raises(ValueError, match="exceeds"):
        eng.submit(np.arange(60), 8)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        ServingEngine(dec, mesh="dp:2")
    # the router's arguments are ported (tests/test_torch_router.py)
    assert ServingEngine(dec, request_keyed_rng=True,
                         replica_tag="r1").request_keyed_rng
    # every argument still refused is one of the JAX engine's, and the
    # value that leaves it off is the JAX engine's default
    import inspect

    from paddle_tpu_torch.serving import engine as port_engine
    params = inspect.signature(JaxEngine.__init__).parameters
    for name, (_, off) in port_engine._LATER_ENGINE.items():
        assert params[name].default == off, name
    # the prefix cache and speculative serving are ported: the engine
    # takes them (tests/test_torch_prefix_cache.py and
    # tests/test_torch_speculative.py hold them to the JAX engine)
    assert ServingEngine(dec, prefix_cache=True).prefix_cache is not None
    assert ServingEngine(dec, draft_model="skip:1").metrics()[
        "speculative"]["num_speculative_tokens"] == 4
    assert eng.submit(p, 3, on_tokens=lambda *a: None, rng_request_id=3,
                      rng_tokens_emitted=1) == high + 1
    with pytest.raises(TypeError, match="unexpected"):
        eng.submit(p, 3, bogus=1)
    # the reference's ring check, before any device work
    jm, _ = models
    with pytest.raises(ValueError, match="ring_slots must be >= 1"):
        JaxEngine(JaxDecoder(jm, max_len=64), ring_slots=0)
    with pytest.raises(ValueError, match="ring_slots must be >= 1"):
        ServingEngine(dec, ring_slots=0)


def _sampled_requests(rng, n):
    """tests/test_serving.py's sampled mix: (prompt, budget, seed,
    temperature 0.7 / 0.9 / 1.1)."""
    return [(rng.integers(0, 64, (int(rng.integers(2, 8)),)),
             int(rng.integers(3, 9)), i, 0.7 + 0.2 * (i % 3))
            for i in range(n)]


def _serve(eng, reqs):
    ids = [eng.submit(p, n, seed=s, temperature=t) for p, n, s, t in reqs]
    res = eng.drain()
    return [np.asarray(res[r]) for r in ids]


@pytest.mark.parametrize("quant", [None, "int8wk"])
def test_sampled_engine_matches_jax_engine(models, quant):
    """do_sample with top-k 8 and top-p 0.9 over 3 slots, T=3: tokens equal
    the JAX engine's request by request, with the same dispatch and ring
    accounting."""
    jm, tm = models
    reqs = _sampled_requests(np.random.default_rng(5), 6)
    kw = dict(num_slots=3, chunk_size=3, do_sample=True, top_k=8, top_p=0.9)
    jeng = JaxEngine(JaxDecoder(jm, max_len=64, quant=quant), **kw)
    want = _serve(jeng, reqs)
    dec = LlamaDecoder(tm, max_len=64, quant=quant, device="cpu")
    eng = ServingEngine(dec, **kw)
    d0 = dec.dispatch_count
    got = _serve(eng, reqs)
    for j, (a, b) in enumerate(zip(got, want)):
        np.testing.assert_array_equal(a, b, err_msg=f"request {j}")
    m = eng.metrics()
    assert m["admission_ring"] == jeng.metrics()["admission_ring"]
    assert m["chunk_dispatches"] == jeng.metrics()["chunk_dispatches"]
    assert dec.dispatch_count - d0 == \
        m["prefill_dispatches"] + m["chunk_dispatches"]


def test_engine_sampled_fixed_keys_row_independent(models):
    """Sampled outputs are keyed by the request's seed alone: a 3-slot T=3
    engine and a 1-slot T=7 engine give the same tokens, and so does
    ``generate(chunk_size=4)`` of a request alone."""
    _, tm = models
    dec = LlamaDecoder(tm, max_len=64, device="cpu")
    reqs = _sampled_requests(np.random.default_rng(5), 6)
    outs = [_serve(ServingEngine(dec, num_slots=slots, chunk_size=T,
                                 do_sample=True, top_k=8), reqs)
            for slots, T in ((3, 3), (1, 7))]
    for a, b in zip(*outs):
        np.testing.assert_array_equal(a, b)
    p, n, s, t = reqs[0]
    np.testing.assert_array_equal(
        np.asarray(dec.generate(p[None], n, do_sample=True, top_k=8,
                                seed=s, temperature=t, chunk_size=4)),
        outs[0][0])


def test_engine_admission_ring_full_backpressure(models):
    """A ring smaller than the slot count: when a step frees more slots
    than the ring holds, the spill is re-queued (not dropped, not host-
    scattered) and ``full`` says so; the ring's accounting equals the JAX
    engine's and the tokens equal solo generates."""
    jm, tm = models
    rng = np.random.default_rng(13)
    reqs = [(rng.integers(0, 64, (4,)), 4 + i % 3) for i in range(8)]
    dec = LlamaDecoder(tm, max_len=64, device="cpu")
    solo = [np.asarray(dec.generate(p[None], n)) for p, n in reqs]
    eng = ServingEngine(dec, num_slots=4, chunk_size=4, ring_slots=2)
    ids = [eng.submit(p, n) for p, n in reqs]
    res = eng.drain()
    for i, rid in enumerate(ids):
        np.testing.assert_array_equal(np.asarray(res[rid]), solo[i])
    jeng = JaxEngine(JaxDecoder(jm, max_len=64), num_slots=4, chunk_size=4,
                     ring_slots=2)
    for p, n in reqs:
        jeng.submit(p, n)
    jeng.drain()
    ring = eng.metrics()["admission_ring"]
    assert ring == jeng.metrics()["admission_ring"]
    assert ring["slots"] == 2 and ring["full"] > 0
    assert ring["host_scattered"] == 0
    assert ring["staged"] == ring["scattered"] == len(reqs)

