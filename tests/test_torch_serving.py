"""The port's ServingEngine (paddle_tpu_torch/serving/engine.py) against the
JAX package's, on the CPU at a tiny GQA size.

The same mixed requests as tests/test_serving.py (mixed prompt lengths and
budgets, every third with a reachable eos, 3 slots, T=4) go through the JAX
engine and the port's over the same weights: tokens are bit-equal per
request, the prefill and chunk dispatch counts equal, and the port's
decoder ``dispatch_count`` moves by exactly prefills + chunks. The port's
engine also matches the port's solo ``generate``.
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
    assert eng.host_scattered == len(reqs)
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
    for kw in ({"prefix_cache": True}, {"ring_slots": 2},
               {"draft_model": "skip:1"}, {"adapter_store": object()},
               {"do_sample": True}):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            ServingEngine(dec, **kw)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        eng.submit(p, 3, deadline_s=1.0)
    with pytest.raises(TypeError, match="unexpected"):
        eng.submit(p, 3, bogus=1)
