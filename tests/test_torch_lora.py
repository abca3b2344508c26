"""Multi-tenant LoRA serving of the port against the JAX package's, on the
CPU at tests/test_lora_serving.py's tiny GQA size (vocab 64, hidden 32, 2
layers, 4 / 2 heads, max_len 64, tenants A / B / C of ranks 2 / 3 / 2).

The same weights (tests/test_lora_serving.py's model, carried over by
``from_jax_state_dict``) and the same adapter deltas (numpy, registered
in both packages' ``AdapterStore``) go through both packages, with the
contracts of tests/test_lora_serving.py: the store's indices, tags,
revisions, stacks and typed errors; ``_mm`` with per-row adapter indices
on a dense and an int8 base; a mixed batch of tenants through
``init_decode_state(adapter_idx=)`` and ``decode_chunk`` (greedy, chunk
slicing, sampled); the engine with mixed tenants (tokens, one chunk
dispatch a chunk, no host scatter, the ``adapters`` dicts); the typed
refusals; a hot swap refused under an in-flight row, then applied; the
prefix cache keyed by ``name@rev``; speculative serving with adapters;
and an int8w base with fp16 stacks at the JAX test's teacher-forced
gate. Every JAX scenario runs
once, in the module fixture ``jax_ref``, on one JAX decoder whose params
carry the stacks from the start (each program compiles once). The JAX
imports live inside fixtures and tests, so the card's test run
(``pytest --noconftest -m gpu``, no JAX) can collect this file; its
``gpu`` test decides inside its body whether a card is present and skips
here.
"""

import numpy as np
import pytest
import torch

from paddle_tpu_torch.convert import from_jax_state_dict
from paddle_tpu_torch.inference import generate as gen
from paddle_tpu_torch.inference.generate import LlamaDecoder
from paddle_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM
from paddle_tpu_torch.serving import (AdapterStore, AdapterVersionError,
                                      ServingEngine, UnknownAdapterError)

CFG = dict(vocab_size=64, hidden_size=32, intermediate_size=64,
           num_hidden_layers=2, num_attention_heads=4,
           num_key_value_heads=2, max_position_embeddings=64)
H, FF, QKV = 32, 64, 64          # hidden, intermediate, fused qkv width
TENANTS = ["tenantA", "tenantB", "tenantC"]
MAX_LEN = 64
SLOTS, T = 5, 4
AIDX = np.array([0, 1, 2, 3, 1])
ADS = [None, "tenantA", "tenantB", "tenantC", "tenantA"]
SPEC = dict(draft_model="skip:1", num_speculative_tokens=2)


def _proj():
    """(fused param name, d_in, d_out) of every projection the adapters
    target."""
    out = []
    for li in range(CFG["num_hidden_layers"]):
        pre = f"model.layers.{li}."
        out += [(pre + "self_attn.qkv.weight", H, QKV),
                (pre + "self_attn.o_proj.weight", H, H),
                (pre + "mlp.gate_up.weight", H, 2 * FF),
                (pre + "mlp.down_proj.weight", FF, H)]
    return out


def _deltas(seed, scale=0.05, ranks=(2, 3, 2)):
    """Per tenant, ``{param: (A, B)}`` numpy deltas (mixed ranks: the
    stacks zero-pad to the largest)."""
    rng = np.random.default_rng(seed)
    return {n: {pn: (scale * rng.standard_normal((din, r)),
                     scale * rng.standard_normal((r, dout)))
                for pn, din, dout in _proj()}
            for n, r in zip(TENANTS, ranks)}


def _store(cls, deltas, dtype="float32"):
    store = cls(dtype=dtype)
    for n, d in deltas.items():
        store.register(n, d)
    return store


@pytest.fixture(scope="module")
def models():
    """tests/test_lora_serving.py's model (``paddle.seed(0)``, the JAX
    initializers), and the port's with its weights; the deltas of
    ``_deltas(7)`` are that test's ``_make_store`` deltas, so the int8
    gate runs on that test's model and tenants."""
    import paddle_tpu as paddle
    from paddle_tpu.models.llama import LlamaConfig as JaxConfig
    from paddle_tpu.models.llama import LlamaForCausalLM as JaxModel

    paddle.seed(0)
    jm = JaxModel(JaxConfig(**CFG))
    state = {k: np.asarray(v.value) for k, v in jm.state_dict().items()}
    tm = from_jax_state_dict(state, LlamaForCausalLM(LlamaConfig(**CFG),
                                                     device="cpu"))
    return jm, tm


@pytest.fixture(scope="module")
def prompts():
    rng = np.random.default_rng(0)
    # rows 0-3 of the batch are tests/test_lora_serving.py's int8-gate
    # prompts
    batch = np.concatenate([np.random.default_rng(13).integers(0, 64, (4, 6)),
                            rng.integers(0, 64, (1, 6))])
    return dict(batch=batch,
                engine=[rng.integers(0, 64, (6,)) for _ in range(5)],
                swap=rng.integers(0, 64, (6,)),
                prefix=rng.integers(0, 64, (16,)),
                suffix=rng.integers(0, 64, (8,)))


def _dec(tm, deltas=None, quant=None, dtype="float32"):
    """A port decoder on the CPU, with the stacks of ``deltas`` merged
    into its params when given."""
    d = LlamaDecoder(tm, max_len=MAX_LEN, quant=quant, device="cpu")
    if deltas is not None:
        d.params.update({k: torch.from_numpy(v) for k, v in
                         _store(AdapterStore, deltas, dtype).stacks()
                         .items()})
    return d


def _serve(eng, reqs):
    """Submit ``(prompt, n, adapter)`` requests and drain: the tokens of
    each, in submission order."""
    ids = [eng.submit(p, n, adapter=a) for p, n, a in reqs]
    res = eng.drain(max_steps=60)
    return [np.asarray(res[r]) for r in ids]


def _swap_run(eng, p, new_deltas, store):
    """The hot-swap drill: a tenantA row in flight, ``update``, the typed
    refusal, the drain, the apply, then a request through the new
    revision. Returns (refusal fields, first tokens, pending flag,
    applied, second tokens, metrics adapters)."""
    rid = eng.submit(p, 8, adapter="tenantA")
    eng.step()                       # in flight, pinned to rev 0
    store.update("tenantA", new_deltas)
    with pytest.raises(Exception) as ei:
        eng.apply_adapter_swap()
    e = ei.value
    pending = eng.status()["adapters"]["swap_pending"]
    first = np.asarray(eng.drain(max_steps=60)[rid])
    applied = eng.apply_adapter_swap()
    rid = eng.submit(p, 6, adapter="tenantA")
    second = np.asarray(eng.drain(max_steps=60)[rid])
    return ((type(e).__name__, str(e), e.adapter, e.pinned_rev,
             e.store_rev), first, pending, applied, second,
            eng.metrics()["adapters"])


def _prefix_reqs(prompts):
    """The prefix scenario's rounds (a drain between them): the prompt as
    base; as tenantA (another tenant's content: a miss); then as tenantA
    (a full hit), as base (a full hit), its first block with another
    suffix as tenantA (a partial hit) and as tenantB (a miss)."""
    p, suffix = prompts["prefix"], prompts["suffix"]
    part = np.concatenate([p[:8], suffix])
    return [[(p, 6, None)], [(p, 6, "tenantA")],
            [(p, 6, "tenantA"), (p, 6, None), (part, 6, "tenantA"),
             (p, 6, "tenantB")]]


def _prefix_run(eng, rounds):
    out = []
    for reqs in rounds:
        ids = [eng.submit(p, n, adapter=a) for p, n, a in reqs]
        res = eng.drain(max_steps=60)
        out += [(np.asarray(res[r]),
                 res[r].resilience["serving"]["prefix_hit"]) for r in ids]
    return out


def _engine_reqs(prompts):
    return [(p, 8, a) for p, a in zip(prompts["engine"], ADS)]


@pytest.fixture(scope="module")
def jax_ref(models, prompts):
    """Every JAX scenario, each program compiled once on one decoder
    whose params carry the tenants' stacks from the start."""
    import jax.numpy as jnp

    from paddle_tpu.inference.generate import LlamaDecoder as JaxDecoder
    from paddle_tpu.inference.generate import _forward_cached
    from paddle_tpu.serving import ServingEngine as JaxEngine
    from paddle_tpu.serving.lora import AdapterStore as JaxStore

    jm = models[0]
    store = _store(JaxStore, _deltas(7))
    dec = JaxDecoder(jm, max_len=MAX_LEN)
    dec.params.update({k: jnp.asarray(v) for k, v in store.stacks().items()})
    out = {}
    st = dec.init_decode_state(prompts["batch"], adapter_idx=AIDX)
    toks = []
    for n in (3, 5):
        t, st = dec.decode_chunk(st, n)
        toks.append(np.asarray(t))
    out["greedy"] = np.concatenate(toks, axis=1)
    st = dec.init_decode_state(prompts["batch"], adapter_idx=AIDX,
                               temperature=0.9, seed=5)
    out["sampled"] = np.asarray(dec.decode_chunk(st, 8, do_sample=True,
                                                 top_k=8)[0])
    # the int8 gate: the f32 tenants' greedy sequences and teacher-forced
    # logits, and those of an int8w base with fp16 stacks
    seqs = np.concatenate([prompts["batch"], out["greedy"]], axis=1)[:4]
    dq = JaxDecoder(jm, max_len=MAX_LEN, quant="int8w")
    dq.params.update({k: jnp.asarray(v) for k, v in
                      _store(JaxStore, _deltas(7), "float16").stacks()
                      .items()})
    for tag, d in (("tf_logits", dec), ("tf_logits_int8w", dq)):
        kc, vc = d._empty_cache(4)
        lg, _, _ = _forward_cached(d.params, d.cfg,
                                   jnp.asarray(seqs[:, :-1]), kc, vc, 0,
                                   MAX_LEN, return_all=True,
                                   aidx=jnp.asarray(AIDX[:4], jnp.int32))
        out[tag] = np.asarray(lg)
    out["tf_seqs"] = seqs

    eng = JaxEngine(dec, num_slots=SLOTS, chunk_size=T, adapter_store=store)
    d0 = dec.dispatch_count
    out["engine"] = _serve(eng, _engine_reqs(prompts))
    out["engine_metrics"], out["engine_status"] = eng.metrics(), eng.status()
    out["engine_dispatches"] = dec.dispatch_count - d0

    swap_store = _store(JaxStore, _deltas(9))
    eng = JaxEngine(dec, num_slots=SLOTS, chunk_size=T,
                    adapter_store=swap_store)
    out["swap"] = _swap_run(eng, prompts["swap"],
                            _deltas(11, 0.03, (2, 2, 2))["tenantA"],
                            swap_store)

    eng = JaxEngine(dec, num_slots=SLOTS, chunk_size=T, adapter_store=store,
                    prefix_cache=True, prefix_cache_bytes=1 << 24,
                    prefix_block_tokens=8)
    out["prefix"] = _prefix_run(eng, _prefix_reqs(prompts))
    out["prefix_metrics"] = eng.metrics()

    eng = JaxEngine(dec, num_slots=SLOTS, chunk_size=T, adapter_store=store,
                    **SPEC)
    out["spec"] = _serve(eng, _engine_reqs(prompts))
    out["spec_metrics"] = eng.metrics()
    return out


# -- the store ----------------------------------------------------------------

def test_store_contract_matches_jax():
    """The same indices, tags, revisions and version bumps, bit-equal
    stacks (zero base row, zero rank padding), ``describe``, and the same
    typed errors with the same messages."""
    from paddle_tpu.serving.lora import AdapterStore as JaxStore
    from paddle_tpu.serving.lora import AdapterVersionError as JaxVersion
    from paddle_tpu.serving.lora import UnknownAdapterError as JaxUnknown

    deltas = _deltas(7)
    stores = [_store(cls, deltas) for cls in (JaxStore, AdapterStore)]
    qkv = _proj()[0][0]
    shapes = {pn: ((9, 9) if "layers.0.self_attn.qkv" in pn else (di, do))
              for pn, di, do in _proj()}

    def errors(store, unknown):
        calls = (
            (lambda: store.index("nope"), unknown),
            (lambda: store.revision("nope"), unknown),
            (lambda: store.update("ghost", {}), unknown),
            (lambda: store.register("tenantA", {qkv: (np.zeros((H, 2)),
                                                      np.zeros((2, QKV)))}),
             ValueError),
            (lambda: store.register("tenantZ", {}), ValueError),
            (lambda: store.register("tenantZ", {qkv: (np.zeros((H, 2)),
                                                      np.zeros((3, QKV)))}),
             ValueError),
            (lambda: store.register("tenantZ", {qkv: (np.zeros(H),
                                                      np.zeros((3, QKV)))}),
             ValueError),
            (lambda: store.stacks(param_shapes=shapes), ValueError),
            (lambda: store.stacks(param_shapes={}), ValueError))
        out = []
        for call, typ in calls:
            with pytest.raises(typ) as ei:
                call()
            out.append(str(ei.value))
        return out

    assert issubclass(UnknownAdapterError, ValueError)
    assert issubclass(AdapterVersionError, RuntimeError)
    e = AdapterVersionError("m", adapter="a", pinned_rev=0, store_rev=1)
    je = JaxVersion("m", adapter="a", pinned_rev=0, store_rev=1)
    assert (e.adapter, e.pinned_rev, e.store_rev) == \
        (je.adapter, je.pinned_rev, je.store_rev)
    assert errors(stores[1], UnknownAdapterError) == \
        errors(stores[0], JaxUnknown)
    for s in stores:
        s.update("tenantB", dict(deltas["tenantB"]))
    views = []
    for s in stores:
        views.append((
            [s.index(n) for n in [None] + TENANTS],
            [s.tag(n) for n in [None] + TENANTS],
            [s.revision(n) for n in TENANTS], s.version, len(s),
            "tenantA" in s, s.names(), s.param_names(), s.max_rank(),
            s.describe()))
    assert views[0] == views[1]
    assert views[1][0] == [0, 1, 2, 3] and views[1][2] == [0, 1, 0]
    for dtype in (None, "float16"):
        want = stores[0].stacks(dtype=dtype)
        got = stores[1].stacks(dtype=dtype)
        assert sorted(got) == sorted(want)
        for k in want:
            assert got[k].dtype == want[k].dtype
            np.testing.assert_array_equal(got[k], want[k])
            assert not np.any(got[k][0])
    a = stores[1].stacks()["lora." + qkv + ".A"]
    assert a.shape == (4, H, 3) and not np.any(a[1, :, 2:])


# -- the per-row delta --------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("int8", [False, True])
def test_mm_with_adapter_rows_matches_jax(dtype, int8):
    """``_mm(x, p, name, aidx)`` on 2-D and 3-D x, over a dense or int8
    base, bit-equal to the JAX package's. The inputs are chosen so that
    every product and sum is exact in f32 (x in eighths, weights and
    deltas in 64ths, the int8 scale 1/128), so each side's only rounding
    is the final cast, which both make the same way."""
    import jax.numpy as jnp
    import ml_dtypes

    from paddle_tpu.inference.generate import _mm as jax_mm

    rng = np.random.default_rng(3)
    name = "model.layers.0.mlp.gate_up.weight"
    din, dout = H, 2 * FF
    deltas = {n: {name: (rng.integers(-8, 9, (din, r)) / 64,
                         rng.integers(-8, 9, (r, dout)) / 64)}
              for n, r in zip(TENANTS, (2, 3, 2))}
    stacks = _store(AdapterStore, deltas).stacks()
    if int8:
        base = {name + ":int8": rng.integers(-127, 128, (din, dout))
                .astype(np.int8),
                name + ":scale": np.full((dout,), 1 / 128, np.float32)}
    else:
        base = {name: (rng.integers(-64, 65, (din, dout)) / 64)
                .astype(np.float32)}
    npdt = ml_dtypes.bfloat16 if dtype == "bfloat16" else np.float32
    tdt = getattr(torch, dtype)
    # a dense base weight takes x's dtype; int8 codes, the f32 scale and
    # the f32 stacks stay as they are
    params = {**base, **stacks}
    jp = {k: jnp.asarray(v.astype(npdt) if k == name else v)
          for k, v in params.items()}
    tp = {k: torch.from_numpy(v).to(tdt) if k == name
          else torch.from_numpy(v) for k, v in params.items()}
    aidx = np.array([0, 1, 2, 3, 1])
    for shape in ((5, din), (5, 3, din)):
        x = (rng.integers(-16, 17, shape) / 8).astype(np.float32)
        want = np.asarray(jax_mm(jnp.asarray(x.astype(npdt)), jp, name,
                                 aidx=jnp.asarray(aidx, jnp.int32)),
                          np.float32)
        got = gen._mm(torch.from_numpy(x).to(tdt), tp, name,
                      torch.from_numpy(aidx))
        assert got.dtype == tdt
        np.testing.assert_array_equal(got.float().numpy(), want)
        # row 0 (the base) equals the product without adapters
        plain = gen._mm(torch.from_numpy(x).to(tdt), tp, name)
        assert torch.equal(got[0], plain[0])


# -- the decoder --------------------------------------------------------------

def test_mixed_batch_greedy_and_chunk_slicing_match_jax(models, prompts,
                                                        jax_ref):
    """Rows on base and three tenants (one repeated) through
    ``init_decode_state(adapter_idx=)`` and chunks of 3 then 5 steps: the
    JAX decoder's tokens bit for bit, the same as one 8-step chunk; the
    prefill is one counted dispatch; the base row equals a decoder
    without adapters."""
    dec = _dec(models[1], _deltas(7))
    d0 = dec.dispatch_count
    st = dec.init_decode_state(prompts["batch"], adapter_idx=AIDX)
    assert dec.dispatch_count - d0 == 1
    assert st.adapter_idx.tolist() == AIDX.tolist()
    toks = []
    for n in (3, 5):
        t, st = dec.decode_chunk(st, n)
        toks.append(t.numpy())
    toks = np.concatenate(toks, axis=1)
    np.testing.assert_array_equal(toks, jax_ref["greedy"])
    t8, _ = dec.decode_chunk(dec.init_decode_state(prompts["batch"],
                                                   adapter_idx=AIDX), 8)
    np.testing.assert_array_equal(t8.numpy(), toks)
    base = np.asarray(_dec(models[1]).generate(prompts["batch"][:1], 8))
    np.testing.assert_array_equal(toks[0], base[0, 6:])


def test_mixed_batch_sampled_matches_jax(models, prompts, jax_ref):
    """Sampled mixed rows (temperature 0.9, seed 5, top-k 8): the JAX
    decoder's draws, row by row."""
    dec = _dec(models[1], _deltas(7))
    st = dec.init_decode_state(prompts["batch"], adapter_idx=AIDX,
                               temperature=0.9, seed=5)
    t, _ = dec.decode_chunk(st, 8, do_sample=True, top_k=8)
    np.testing.assert_array_equal(t.numpy(), jax_ref["sampled"])


def test_int8w_base_fp16_stacks_quality_gate(models, jax_ref):
    """The cheap-tenant recipe: an int8w base with fp16 stacks, teacher-
    forced over the JAX f32 tenants' greedy sequences (tests/
    test_lora_serving.py's model, tenants and gate prompts), agrees with
    the JAX f32 logits' top-1 at >= 0.99 of the generated positions (that
    test's gate), and with the JAX package's own int8w + fp16 logits at
    every position (within 1e-4); its weights are int8 and its stacks
    fp16."""
    dq = _dec(models[1], _deltas(7), quant="int8w", dtype="float16")
    assert dq.params["model.layers.0.mlp.down_proj.weight:int8"].dtype == \
        torch.int8
    assert dq.params["lora.model.layers.0.mlp.down_proj.weight.A"].dtype \
        == torch.float16
    seqs = jax_ref["tf_seqs"][:, :-1]
    lq, _, _ = dq.admit_prefill(seqs, [seqs.shape[1]] * 4, [0] * 4,
                                return_all=True, aidx=AIDX[:4])
    lq = lq.numpy()
    k = jax_ref["tf_seqs"].shape[1] - 8 - 1     # the generated positions
    agree = float((jax_ref["tf_logits"].argmax(-1) == lq.argmax(-1))
                  [:, k:].mean())
    assert agree >= 0.99, agree
    want = jax_ref["tf_logits_int8w"]
    np.testing.assert_array_equal(lq.argmax(-1), want.argmax(-1))
    np.testing.assert_allclose(lq, want, rtol=0, atol=1e-4)


# -- the engine ---------------------------------------------------------------

def test_engine_mixed_tenants_match_jax_engine(models, prompts, jax_ref):
    """Base and three tenants in flight together: the JAX engine's tokens,
    chunk dispatches and ``adapters`` dicts; one chunk dispatch a chunk
    through the device ring (no host scatter, no per-token step); the
    dispatch identity."""
    dec = _dec(models[1])
    store = _store(AdapterStore, _deltas(7))
    eng = ServingEngine(dec, num_slots=SLOTS, chunk_size=T,
                        adapter_store=store)
    d0 = dec.dispatch_count
    got = _serve(eng, _engine_reqs(prompts))
    for j, (a, b) in enumerate(zip(got, jax_ref["engine"])):
        np.testing.assert_array_equal(a, b, err_msg=f"request {j}")
    m, jm = eng.metrics(), jax_ref["engine_metrics"]
    assert m["chunk_dispatches"] == jm["chunk_dispatches"] == 2
    assert m["prefill_dispatches"] == jm["prefill_dispatches"]
    assert m["step_dispatches"] == 0
    assert m["admission_ring"] == jm["admission_ring"]
    assert m["admission_ring"]["host_scattered"] == 0
    assert dec.dispatch_count - d0 == jax_ref["engine_dispatches"] == \
        m["prefill_dispatches"] + m["chunk_dispatches"]
    assert m["adapters"] == jm["adapters"]
    assert m["adapters"]["rows_by_adapter"] == {
        "base": 1, "tenantA": 2, "tenantB": 1, "tenantC": 1}
    assert eng.status()["adapters"] == jax_ref["engine_status"]["adapters"]
    assert set(eng.status()) == set(jax_ref["engine_status"])
    rec = eng.result(1).resilience["serving"]
    assert (rec["adapter"], rec["adapter_rev"]) == ("tenantA", 0)


def test_engine_typed_refusals_match_jax(models):
    """An unknown adapter name, and a name sent to an engine without a
    store, are ``UnknownAdapterError`` at submit with the JAX engine's
    messages; a store targeting a matrix the model lacks is refused when
    the engine is built."""
    from paddle_tpu.inference.generate import LlamaDecoder as JaxDecoder
    from paddle_tpu.serving import ServingEngine as JaxEngine
    from paddle_tpu.serving.lora import AdapterStore as JaxStore
    from paddle_tpu.serving.lora import UnknownAdapterError as JaxUnknown

    jdec = JaxDecoder(models[0], max_len=MAX_LEN)
    dec = _dec(models[1])
    msgs = []
    for Eng, Store, Dec, Unknown in (
            (JaxEngine, JaxStore, jdec, JaxUnknown),
            (ServingEngine, AdapterStore, dec, UnknownAdapterError)):
        eng = Eng(Dec, num_slots=2, chunk_size=T,
                  adapter_store=_store(Store, _deltas(7)))
        plain = Eng(Dec, num_slots=2, chunk_size=T)
        bad = Store()
        bad.register("x", {"model.layers.9.mlp.down_proj.weight":
                           (np.zeros((FF, 2)), np.zeros((2, H)))})
        row = []
        for call, typ in (
                (lambda: eng.submit(np.arange(4), 4, adapter="ghost"),
                 Unknown),
                (lambda: plain.submit(np.arange(4), 4, adapter="tenantA"),
                 Unknown),
                (lambda: Eng(Dec, num_slots=2, adapter_store=bad),
                 ValueError)):
            with pytest.raises(typ) as ei:
                call()
            row.append(str(ei.value))
        msgs.append(row)
        assert plain.metrics()["adapters"] is None
        assert plain.status()["adapters"] is None
    assert msgs[0] == msgs[1]
    assert "no AdapterStore" in msgs[1][1]


def test_hot_swap_refused_then_applied_matches_jax(models, prompts,
                                                   jax_ref):
    """``update`` while a tenantA row is in flight: ``apply_adapter_swap``
    raises ``AdapterVersionError`` (pinned rev 0, store rev 1) with the JAX
    engine's message, the swap is pending while the row drains with its
    rev-0 tokens, then applies; a request after it decodes through rev 1.
    Tokens, refusal and ``adapters`` metrics equal the JAX engine's."""
    store = _store(AdapterStore, _deltas(9))
    eng = ServingEngine(_dec(models[1]), num_slots=SLOTS, chunk_size=T,
                        adapter_store=store)
    got = _swap_run(eng, prompts["swap"],
                    _deltas(11, 0.03, (2, 2, 2))["tenantA"], store)
    want = jax_ref["swap"]
    assert got[0] == want[0]
    assert got[0][0] == "AdapterVersionError" and got[0][3:] == (0, 1)
    np.testing.assert_array_equal(got[1], want[1])
    assert got[2] is want[2] is True
    assert got[3] is want[3] is True
    np.testing.assert_array_equal(got[4], want[4])
    assert got[5] == want[5] and got[5]["swaps"] == 1
    assert not eng.status()["adapters"]["swap_pending"]
    assert eng.status()["adapters"]["adapters"]["tenantA"]["rev"] == 1


def test_prefix_cache_with_adapters_matches_jax(models, prompts, jax_ref):
    """The prefix cache keys an adapter's prompts by ``name@rev``: the
    same prompt under another tenant misses, under its own tenant (or as
    base) hits in full, a shared first block under the same tenant hits
    partially. Hit classes, tokens and the cache's counts equal the JAX
    engine's; admission is by host row copy."""
    eng = ServingEngine(_dec(models[1]), num_slots=SLOTS, chunk_size=T,
                        adapter_store=_store(AdapterStore, _deltas(7)),
                        prefix_cache=True, prefix_cache_bytes=1 << 24,
                        prefix_block_tokens=8)
    got = _prefix_run(eng, _prefix_reqs(prompts))
    want = jax_ref["prefix"]
    assert [c for _, c in got] == [c for _, c in want] == \
        ["miss", "miss", "full", "full", "partial", "miss"]
    for j, ((a, _), (b, _)) in enumerate(zip(got, want)):
        np.testing.assert_array_equal(a, b, err_msg=f"request {j}")
    m, jm = eng.metrics(), jax_ref["prefix_metrics"]
    for k in ("prefill_dispatches", "chunk_dispatches",
              "prefill_tokens_saved", "adapters"):
        assert m[k] == jm[k], k
    assert eng.host_scattered == 6 and m["admission_ring"] is None


def test_speculative_serving_with_adapters_matches_jax(models, prompts,
                                                       jax_ref):
    """skip:1, K 2 with mixed tenants: the draft stays base and the verify
    takes each row's deltas, so greedy tokens are the plain engine's; they
    equal the JAX speculative engine's, with its dispatch and acceptance
    counts."""
    dec = _dec(models[1])
    eng = ServingEngine(dec, num_slots=SLOTS, chunk_size=T,
                        adapter_store=_store(AdapterStore, _deltas(7)),
                        **SPEC)
    d0 = dec.dispatch_count
    got = _serve(eng, _engine_reqs(prompts))
    for j, (a, b, c) in enumerate(zip(got, jax_ref["spec"],
                                      jax_ref["engine"])):
        np.testing.assert_array_equal(a, b, err_msg=f"request {j}")
        np.testing.assert_array_equal(a, c, err_msg=f"request {j}")
    m, jm = eng.metrics(), jax_ref["spec_metrics"]
    for k in ("prefill_dispatches", "draft_prefill_dispatches",
              "chunk_dispatches", "speculative", "admission_ring",
              "adapters"):
        assert m[k] == jm[k], k
    assert dec.dispatch_count - d0 == m["prefill_dispatches"] + \
        m["draft_prefill_dispatches"] + m["chunk_dispatches"]


# -- on the card --------------------------------------------------------------

@pytest.mark.gpu
def test_lora_chunk_graph_and_hot_swap_on_card():
    """A LoRA chunk replayed from its CUDA graph equals the eager chunk
    body bit for bit (eager warm-up, capture and replay, replays); then an
    engine serves a tenant, the tenant's deltas are updated and applied,
    and the next request decodes through the new stacks: its tokens equal
    an eager-chunk engine's over the same stacks, differ from the old
    revision's, and come from a graph keyed on the new stacks (the old
    graph, which holds the old stacks, is never replayed over the new
    ones)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    model = LlamaForCausalLM(LlamaConfig(
        vocab_size=512, hidden_size=256, intermediate_size=512,
        num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
        max_position_embeddings=256, dtype="bfloat16"), seed=0)
    dec = LlamaDecoder(model, max_len=64)
    qkv = dec.params["model.layers.0.self_attn.qkv.weight"].shape[1]

    def deltas(seed):
        rng = np.random.default_rng(seed)
        shapes = []
        for li in range(2):
            pre = f"model.layers.{li}."
            shapes += [(pre + "self_attn.qkv.weight", 256, qkv),
                       (pre + "self_attn.o_proj.weight", 256, 256),
                       (pre + "mlp.gate_up.weight", 256, 1024),
                       (pre + "mlp.down_proj.weight", 512, 256)]
        return {pn: (0.2 * rng.standard_normal((a, 4)),
                     0.2 * rng.standard_normal((4, b)))
                for pn, a, b in shapes}

    store = AdapterStore()
    store.register("a", deltas(1))
    store.register("b", deltas(2))
    dec.params.update({k: torch.from_numpy(v).cuda()
                       for k, v in store.stacks().items()})
    ids = np.random.default_rng(0).integers(0, 512, (3, 5))
    with torch.inference_mode():
        st, ref = (dec.init_decode_state(ids, adapter_idx=[0, 1, 2])
                   for _ in range(2))
        for i in range(4):
            toks, st = dec.decode_chunk(st, 5)
            want, ref = dec._chunk_steps(ref, 5)
            assert torch.equal(toks, want), i
            for name in ("logits", "pos", "done", "adapter_idx"):
                assert torch.equal(getattr(st, name), getattr(ref, name)), \
                    (i, name)
    assert sum(g is not None for g in dec._chunk_graphs.values()) == 1

    def serve(eng):
        rid = eng.submit(ids[0], 16, adapter="a")
        return np.asarray(eng.drain()[rid])

    def eager():
        """An engine over the same store whose decoder runs its chunks
        eagerly (``_chunk_steps``)."""
        edec = LlamaDecoder(model, max_len=64)

        def chunk(st, steps, *args):
            edec.dispatch_count += 1
            return edec._chunk_steps(st, steps, *args)
        edec._chunk_decode = chunk
        return ServingEngine(edec, num_slots=4, chunk_size=4,
                             adapter_store=store)

    eng = ServingEngine(dec, num_slots=4, chunk_size=4, adapter_store=store)
    before = [serve(eng) for _ in range(3)]   # eager, captured, replayed
    keys0 = set(dec._chunk_graphs)
    for b in before:
        np.testing.assert_array_equal(b, before[0])
    np.testing.assert_array_equal(before[0], serve(eager()))
    store.update("a", deltas(3))
    assert eng.apply_adapter_swap() is True
    after = [serve(eng) for _ in range(3)]
    for a in after:
        np.testing.assert_array_equal(a, after[0])
    np.testing.assert_array_equal(after[0], serve(eager()))
    assert not np.array_equal(after[0], before[0])
    new = set(dec._chunk_graphs) - keys0
    assert any(dec._chunk_graphs[k] is not None for k in new)
