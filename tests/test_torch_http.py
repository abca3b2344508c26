"""The port's streaming HTTP front-end (paddle_tpu_torch/serving/http)
against the JAX package's, on the CPU in f32.

Both frontends serve two bundles (``main`` with LoRA adapters, ``alt``)
over the same weights and the same adapter deltas, on real sockets. The
same requests go to each: the bodies' tokens, the streaming lines (the
chunk cadence), the status codes and refusal kinds, the telemetry
endpoints' codes and the graceful drain must be equal, and the tokens
equal a direct engine's. The counterparts of tests/test_http_frontend.py
and of tests/test_lora_serving.py:224 (the engine's ``on_tokens``
flushes). The JAX imports live inside the fixtures.
"""

import json
import threading
import urllib.error
import urllib.request

import numpy as np
import pytest

from paddle_tpu_torch.convert import from_jax_state_dict
from paddle_tpu_torch.inference.generate import LlamaDecoder
from paddle_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM
from paddle_tpu_torch.serving import AdapterStore, ServingEngine
from paddle_tpu_torch.serving.http import HttpFrontend

pytestmark = pytest.mark.serving

CFG = dict(vocab_size=64, hidden_size=32, intermediate_size=64,
           num_hidden_layers=2, num_attention_heads=4,
           num_key_value_heads=2, max_position_embeddings=64)
H, F = 32, 64


def _deltas(dec, seed=7):
    rng = np.random.default_rng(seed)
    proj = []
    for li in range(2):
        pre = f"model.layers.{li}."
        proj += [(pre + "self_attn.qkv.weight", H,
                  int(dec.params[pre + "self_attn.qkv.weight"].shape[-1])),
                 (pre + "self_attn.o_proj.weight", H, H),
                 (pre + "mlp.gate_up.weight", H, 2 * F),
                 (pre + "mlp.down_proj.weight", F, H)]
    return {n: {pn: (0.05 * rng.standard_normal((din, 2 + j)),
                     0.05 * rng.standard_normal((2 + j, dout)))
                for pn, din, dout in proj}
            for j, n in enumerate(["tenantA", "tenantB"])}


def _side(dec, Store, Engine, Frontend, deltas):
    store = Store()
    for n, d in deltas.items():
        store.register(n, d)
    main = Engine(dec, num_slots=4, chunk_size=4, adapter_store=store)
    alt = Engine(dec, num_slots=2, chunk_size=4, adapter_store=store)
    ref = Engine(dec, num_slots=4, chunk_size=4, adapter_store=store)
    fe = Frontend({"main": main, "alt": alt}, port=0)
    return dict(fe=fe, base=f"http://127.0.0.1:{fe.start()}", ref=ref,
                main=main, dec=dec, store=store, Engine=Engine)


@pytest.fixture(scope="module")
def served():
    """``(jax, port)``: each a live frontend, a direct reference engine
    and the bundle engines, over the same weights and deltas."""
    import paddle_tpu as paddle
    from paddle_tpu.inference.generate import LlamaDecoder as JaxDecoder
    from paddle_tpu.models.llama import LlamaConfig as JaxConfig
    from paddle_tpu.models.llama import LlamaForCausalLM as JaxModel
    from paddle_tpu.serving import ServingEngine as JaxEngine
    from paddle_tpu.serving.http import HttpFrontend as JaxFrontend
    from paddle_tpu.serving.lora import AdapterStore as JaxStore

    paddle.seed(0)
    jm = JaxModel(JaxConfig(**CFG))
    state = {k: np.asarray(v.value) for k, v in jm.state_dict().items()}
    tm = from_jax_state_dict(
        state, LlamaForCausalLM(LlamaConfig(**CFG), device="cpu"))
    jdec = JaxDecoder(jm, max_len=64)
    deltas = _deltas(jdec)
    sides = (_side(jdec, JaxStore, JaxEngine, JaxFrontend, deltas),
             _side(LlamaDecoder(tm, max_len=64, device="cpu"),
                   AdapterStore, ServingEngine, HttpFrontend, deltas))
    yield sides
    for s in sides:
        s["fe"].stop()


def _post(base, body, stream=False, timeout=120):
    req = urllib.request.Request(
        base + "/v1/generate", data=json.dumps(body).encode(),
        headers={"Content-Type": "application/json"}, method="POST")
    try:
        r = urllib.request.urlopen(req, timeout=timeout)
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read() or b"{}")
    if stream:
        return r.status, [json.loads(ln) for ln in r.read().splitlines()
                          if ln]
    return r.status, json.loads(r.read())


def _get(base, path):
    try:
        r = urllib.request.urlopen(base + path, timeout=30)
        return r.status, r.read().decode()
    except urllib.error.HTTPError as e:
        return e.code, e.read().decode()


def _concurrent(base, bodies, stream=False):
    results = {}

    def go(i, b):
        results[i] = _post(base, b, stream=stream)

    ths = [threading.Thread(target=go, args=(i, b))
           for i, b in enumerate(bodies)]
    for t in ths:
        t.start()
    for t in ths:
        t.join()
    return [results[i] for i in range(len(bodies))]


def test_unary_parity_mixed_tenants_concurrent_matches_jax(served):
    """Three concurrent requests (base and two adapters): the bodies
    equal the JAX frontend's and the direct engine's tokens, served by
    chunk dispatches only."""
    rng = np.random.default_rng(1)
    prompts = [rng.integers(0, 64, (6,)).tolist() for _ in range(3)]
    ads = [None, "tenantA", "tenantB"]
    bodies = [{"prompt": p, "max_new_tokens": 8, "adapter": a}
              for p, a in zip(prompts, ads)]
    got = []
    for s in served:
        rids = [s["ref"].submit(np.asarray(p), max_new_tokens=8, adapter=a)
                for p, a in zip(prompts, ads)]
        refs = s["ref"].drain(max_steps=50)
        c0 = s["main"].metrics()["chunk_dispatches"]
        res = _concurrent(s["base"], bodies)
        for (code, doc), rid in zip(res, rids):
            assert code == 200, (code, doc)
            want = np.asarray(refs[rid]).reshape(-1)
            assert doc["tokens"] == [int(t) for t in want]
        # no per-token steps, and no more chunks than the three rows
        # served one after another (8 tokens at chunk 4: 2 each); how
        # many they shared depends on when each arrived
        dm = s["main"].metrics()
        assert dm["chunk_dispatches"] - c0 <= 6
        assert dm["step_dispatches"] == 0
        got.append([(c, {k: d[k] for k in ("tokens", "generated", "model",
                                           "prompt_tokens")})
                    for c, d in res])
    assert got[1] == got[0]


def test_streaming_chunk_cadence_matches_jax(served):
    """A streamed request: one JSON line per chunk harvest that grew the
    row, the last flagged final; the lines equal the JAX frontend's line
    for line, and their tokens the direct engine's."""
    rng = np.random.default_rng(2)
    p = rng.integers(0, 64, (6,)).tolist()
    got = []
    for s in served:
        rid = s["ref"].submit(np.asarray(p), max_new_tokens=8,
                              adapter="tenantA")
        want = np.asarray(s["ref"].drain(max_steps=50)[rid]).reshape(-1)
        code, lines = _post(s["base"], {"prompt": p, "max_new_tokens": 8,
                                        "adapter": "tenantA",
                                        "stream": True}, stream=True)
        assert code == 200 and lines[-1].get("final") is True
        assert "error" not in lines[-1] and len(lines) >= 2
        assert sum((ln["tokens"] for ln in lines), []) == \
            [int(t) for t in want[6:]]
        got.append([(ln["tokens"], ln.get("final", False)) for ln in lines])
    assert got[1] == got[0]


def test_streams_and_unary_at_once_match_jax(served):
    """Four streams and four unary requests sent together: each stream's
    lines concatenate to its tokens, and every body equals the JAX
    frontend's."""
    rng = np.random.default_rng(6)
    bodies = [{"prompt": rng.integers(0, 64, (5,)).tolist(),
               "max_new_tokens": int(rng.integers(4, 10)),
               "stream": i % 2 == 0} for i in range(8)]
    got = []
    for s in served:
        res = {}

        def go(i, b, base=s["base"]):
            res[i] = _post(base, b, stream=b["stream"])

        ths = [threading.Thread(target=go, args=(i, b))
               for i, b in enumerate(bodies)]
        for t in ths:
            t.start()
        for t in ths:
            t.join()
        out = []
        for i, b in enumerate(bodies):
            code, doc = res[i]
            assert code == 200
            if b["stream"]:
                toks = sum((ln["tokens"] for ln in doc), [])
                assert doc[-1]["final"] is True
                out.append(toks)
            else:
                out.append(doc["generated"])
        got.append(out)
    assert got[1] == got[0]


def test_typed_refusals_and_bundle_routing_match_jax(served):
    """400 unknown adapter, 404 unknown bundle, 429 deadline shed, 400
    bad request; ``model`` picks the bundle. Codes, kinds and tokens as
    the JAX frontend's."""
    p = list(range(5))
    asks = [{"prompt": p, "max_new_tokens": 4, "adapter": "ghost"},
            {"prompt": p, "max_new_tokens": 4, "model": "nope"},
            {"prompt": p, "max_new_tokens": 4, "deadline_s": -1.0},
            {"max_new_tokens": 4},
            {"prompt": p, "max_new_tokens": 6, "model": "alt"},
            {"prompt": p, "max_new_tokens": 6, "model": "main"}]
    got = []
    for s in served:
        out = []
        for a in asks:
            code, doc = _post(s["base"], a)
            out.append((code, doc.get("kind"), doc.get("model"),
                        doc.get("tokens")))
        got.append(out)
    assert got[1] == got[0]
    assert [g[:2] for g in got[1][:4]] == [
        (400, "unknown_adapter"), (404, "unknown_model"), (429, "shed"),
        (400, "bad_request")]
    assert got[1][4][3] == got[1][5][3]


def test_telemetry_endpoints_match_jax(served):
    """``/metrics``, ``/statusz``, ``/healthz`` and unknown paths answer
    as the JAX frontend's: the request counter and the per-adapter row
    counters in the scrape, the bundles and the adapter index in the
    status."""
    got = []
    for s in served:
        code_m, body = _get(s["base"], "/metrics")
        code_s, st = _get(s["base"], "/statusz")
        doc = json.loads(st)
        code_h, hz = _get(s["base"], "/healthz")
        got.append(dict(
            codes=(code_m, code_s, code_h, _get(s["base"], "/nope")[0],
                   _get(s["base"], "/tracez")[0]),
            requests="serving_http_requests" in body.replace(".", "_"),
            tenant="tenantA" in body,
            bundles=sorted(doc["http_frontend"]["bundles"]),
            index=doc["main"]["adapters"]["adapters"]["tenantA"]["index"],
            healthy=json.loads(hz)["ok"]))
    assert got[1] == got[0]
    assert got[1]["codes"] == (200, 200, 200, 404, 200)


def test_engine_streaming_chunk_flushes_match_jax(served):
    """``on_tokens`` fires at every chunk harvest that grew the row, then
    once with ``final=True``; the flushes concatenate to the generated
    tail and the streaming TTFT lands under its class; flush for flush
    as the JAX engine."""
    got = []
    for s in served:
        rng = np.random.default_rng(5)
        eng = s["Engine"](s["dec"], num_slots=2, chunk_size=4,
                          adapter_store=s["store"])
        flushes = []
        p = rng.integers(0, 64, (6,))
        rid = eng.submit(p, max_new_tokens=8, adapter="tenantB",
                         latency_class="interactive",
                         on_tokens=lambda r, t, fin: flushes.append(
                             (np.asarray(t).tolist(), fin)))
        out = eng.drain(max_steps=50)
        assert [f for _, f in flushes] == [False, True]
        assert sum((t for t, _ in flushes), []) == \
            np.asarray(out[rid])[0, 6:].tolist()
        ttft = eng.metrics()["stream_ttft_p50_s"]
        assert ttft["interactive"] >= 0.0
        got.append((flushes, sorted(ttft)))
    assert got[1] == got[0]


def test_zz_graceful_drain_matches_jax(served):
    """Runs last (module fixture): drain flips ``/healthz`` to 503 and new
    generates to 503 draining, as the JAX frontend's."""
    got = []
    for s in served:
        assert s["fe"].drain(timeout_s=30) is True
        code, body = _get(s["base"], "/healthz")
        code2, doc = _post(s["base"], {"prompt": [1, 2, 3],
                                       "max_new_tokens": 4})
        got.append((code, json.loads(body)["draining"], code2,
                    doc["kind"]))
    assert got[1] == got[0] == [(503, True, 503, "draining")][0]
