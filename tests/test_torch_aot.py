"""The port's AOT bundles (paddle_tpu_torch/inference/aot.py, bundle.py and
the engine's bundle backend) against the JAX package's, on the CPU at a
tiny GQA size (2 layers, hidden 64, f32).

Each bundle is exported once per module by both packages with the same
arguments over the same weights. The port's ``bundle.json`` has the JAX
package's keys, buckets, caches and ``decode_mode`` (apart from the sha256
digests and its ``program_format`` marker); both packages read each
other's entry framing; tokens from ``AotPredictor.generate`` and from
``ServingEngine(AotPredictor(dir))`` equal the JAX package's bundles'
bit for bit (greedy, eos, sampled at runtime temperatures, speculative
with its acceptance counts and its ladder, int8w and int8wk), with the
same dispatch counts and typed refusals; predict outputs agree within the
JAX test's 1e-5. A fresh interpreter serves a bundle without importing
the port's model or decoder modules.
"""

import io
import json
import os
import subprocess
import sys
import textwrap
import time
import types
import zipfile

import numpy as np
import pytest
import torch

from paddle_tpu_torch.convert import from_jax_state_dict
from paddle_tpu_torch.flags import set_flags
from paddle_tpu_torch.inference import (AotPredictor, Config,
                                        create_predictor,
                                        export_decoder_bundle,
                                        export_predict_bundle,
                                        load_compiled, read_meta,
                                        save_compiled)
from paddle_tpu_torch.inference.aot import (ForeignProgramError,
                                            PickledArchiveError)
from paddle_tpu_torch.inference.bundle import BundleDeviceError
from paddle_tpu_torch.inference.generate import LlamaDecoder
from paddle_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM
from paddle_tpu_torch.quantization.kv_cache import QuantMismatchError
from paddle_tpu_torch.runtime.resilience import (CorruptBundleError,
                                                 fault_injector)
from paddle_tpu_torch.serving import ServingEngine

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CFG = dict(vocab_size=64, hidden_size=64, intermediate_size=128,
           num_hidden_layers=2, num_attention_heads=4,
           num_key_value_heads=2, max_position_embeddings=64)
MAX_LEN = 32
# bundle name -> (quant recipe, export arguments), as the JAX tests use them
SPECS = {
    "chunked": (None, dict(prompt_lens=[4, 8], decode_steps=[9],
                           batch_sizes=[2], chunk_sizes=[4])),
    "sampled": (None, dict(prompt_lens=[5], decode_steps=[9],
                           batch_sizes=[2], do_sample=True, temperature=0.8,
                           top_k=8)),
    "spec": (None, dict(prompt_lens=[5], decode_steps=[8], batch_sizes=[2],
                        draft_model="skip:1", num_speculative_tokens=2)),
    "int8w": ("int8w", dict(prompt_lens=[5], decode_steps=[5],
                            batch_sizes=[1, 3])),
    "int8wk": ("int8wk", dict(prompt_lens=[5], decode_steps=[5],
                              batch_sizes=[1])),
}


@pytest.fixture(scope="module")
def jx():
    """The JAX package's side, imported here: the card's machine, where
    the ``gpu`` test runs, has no JAX."""
    import paddle_tpu as paddle
    from paddle_tpu import nn
    from paddle_tpu.inference import AotPredictor, export_predict_bundle
    from paddle_tpu.inference import read_meta
    from paddle_tpu.models.llama import LlamaConfig, LlamaForCausalLM
    from paddle_tpu.serving import ServingEngine
    return types.SimpleNamespace(
        paddle=paddle, nn=nn, Predictor=AotPredictor,
        export_predict=export_predict_bundle, read_meta=read_meta,
        Config=LlamaConfig, Model=LlamaForCausalLM, Engine=ServingEngine)


@pytest.fixture(scope="module")
def models(jx):
    jx.paddle.seed(0)
    jm = jx.Model(jx.Config(**CFG))
    state = {k: np.asarray(v.value) for k, v in jm.state_dict().items()}
    tm = from_jax_state_dict(
        state, LlamaForCausalLM(LlamaConfig(**CFG), device="cpu"))
    return jm, tm


# The bundles are exported by three interpreters side by side (they share
# only files): this one exports the port's "chunked" bundle, a second the
# port's others from the same weights, a third the JAX package's from the
# same seeded model. Each writes a bundle's bundle.json last.
_PORT_EXPORTS = textwrap.dedent("""
    import json
    import sys
    import numpy as np
    from paddle_tpu_torch.convert import from_jax_state_dict
    from paddle_tpu_torch.inference import export_decoder_bundle
    from paddle_tpu_torch.inference.generate import LlamaDecoder
    from paddle_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM
    cfg, specs, max_len, out, weights = json.loads(sys.argv[1])
    model = from_jax_state_dict(dict(np.load(weights)), LlamaForCausalLM(
        LlamaConfig(**cfg), device="cpu"))
    for name, (quant, kw) in specs.items():
        export_decoder_bundle(LlamaDecoder(model, max_len=max_len,
                                           quant=quant, device="cpu"),
                              out + "/" + name, **kw)
    print("EXPORTED")
""")
_JAX_EXPORTS = textwrap.dedent("""
    import json
    import sys
    import jax
    jax.config.update("jax_platforms", "cpu")
    import paddle_tpu as paddle
    from paddle_tpu.inference import export_decoder_bundle
    from paddle_tpu.inference.generate import LlamaDecoder
    from paddle_tpu.models.llama import LlamaConfig, LlamaForCausalLM
    cfg, specs, max_len, out, _ = json.loads(sys.argv[1])
    paddle.seed(0)
    model = LlamaForCausalLM(LlamaConfig(**cfg))
    for name, (quant, kw) in specs.items():
        export_decoder_bundle(LlamaDecoder(model, max_len=max_len,
                                           quant=quant), out + "/" + name,
                              **kw)
    print("EXPORTED")
""")


def _wait_for(path, proc):
    deadline = time.monotonic() + 600
    while not os.path.exists(path):
        if proc.poll() is not None or time.monotonic() > deadline:
            out, err = proc.communicate()
            pytest.fail(f"exports: {out[-500:]} {err[-3000:]}")
        time.sleep(0.05)


@pytest.fixture(scope="module")
def bundle(jx, models, tmp_path_factory):
    """``bundle(name)``: each bundle of ``SPECS`` exported once, by both
    packages, with one predictor each (``pdir``, ``jdir``, ``dec``,
    ``pred``, ``jpred``)."""
    _, tm = models
    root = tmp_path_factory.mktemp("bundles")
    weights = str(root / "weights.npz")
    np.savez(weights, **{k: v.detach().numpy()
                         for k, v in tm.state_dict().items()})
    others = {k: v for k, v in SPECS.items() if k != "chunked"}
    procs = {}
    for who, code, specs in (("port", _PORT_EXPORTS, others),
                             ("jax", _JAX_EXPORTS, SPECS)):
        (root / who).mkdir()
        procs[who] = subprocess.Popen(
            [sys.executable, "-c", code,
             json.dumps([CFG, specs, MAX_LEN, str(root / who), weights])],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    made = {}

    def get(name):
        if name not in made:
            quant, kw = SPECS[name]
            b = types.SimpleNamespace(
                pdir=str(root / "port" / name), jdir=str(root / "jax" / name),
                dec=LlamaDecoder(tm, max_len=MAX_LEN, quant=quant,
                                 device="cpu"))
            if name == "chunked":
                export_decoder_bundle(b.dec, b.pdir, **kw)
            else:
                _wait_for(os.path.join(b.pdir, "bundle.json"), procs["port"])
            _wait_for(os.path.join(b.jdir, "bundle.json"), procs["jax"])
            b.pred = AotPredictor(b.pdir, device="cpu")
            b.jpred = jx.Predictor(b.jdir)
            made[name] = b
        return made[name]
    yield get
    for proc in procs.values():
        out, err = proc.communicate(timeout=600)
        assert "EXPORTED" in out, err[-3000:]


def _meta(d):
    with open(os.path.join(d, "bundle.json")) as f:
        return json.load(f)


def _prompt(seed, B, S):
    return np.random.default_rng(seed).integers(0, 64, (B, S))


@pytest.fixture(autouse=True)
def _no_backoff():
    set_flags({"resilience_backoff_s": 0.0})
    yield
    set_flags({"resilience_backoff_s": 0.5})
    fault_injector.clear()


# -- the AOT framing ---------------------------------------------------------

def test_framing_crosses_the_packages_and_refusals_are_typed(jx, bundle,
                                                             fresh,
                                                             tmp_path):
    b = bundle("chunked")
    pdir, jdir = b.pdir, b.jdir
    # both packages read both packages' files: JAX's chunk entry carries
    # its self-description, its prefill entry none (format 1); every port
    # entry carries its own, with the program format
    jchunk = os.path.join(jdir, "decode_chunk_b2_t4.aot")
    pchunk = os.path.join(pdir, "decode_chunk_b2_t4.aot")
    assert read_meta(jchunk) == jx.read_meta(jchunk) == {
        "entry": "decode_chunk", "batch": 2, "chunk": 4,
        "admit_ring": False, "spec_chunk": False}
    assert read_meta(os.path.join(jdir, "prefill_b2_s8.aot")) is None
    pm = read_meta(pchunk)
    assert jx.read_meta(pchunk) == pm
    assert {k: pm[k] for k in ("entry", "batch", "chunk", "admit_ring",
                               "spec_chunk")} == read_meta(jchunk)
    assert pm["program_format"] == "torch.export"
    assert dict(pm["route"])["use_decode_attention"] is True
    assert read_meta(os.path.join(pdir, "decode_b2_n9.aot"))["steps"] == 9
    # a JAX program is refused typed, naming its format, by the loader
    # and by the predictor
    with pytest.raises(ForeignProgramError, match="StableHLO"):
        load_compiled(jchunk)
    with pytest.raises(ForeignProgramError, match="StableHLO"):
        AotPredictor(jdir, device="cpu")
    # a bundle for the other device type is refused typed
    meta = _meta(pdir)
    meta["program_format"]["device"] = "cuda"
    cdir = tmp_path / "cuda_bundle"
    cdir.mkdir()
    (cdir / "bundle.json").write_text(json.dumps(meta))
    with pytest.raises(BundleDeviceError, match="cuda"):
        AotPredictor(str(cdir), device="cpu")
    # a flipped byte: the manifest's digest refuses it at load
    raw = bytearray(open(pchunk, "rb").read())
    flipped = tmp_path / "flipped.aot"
    raw[len(raw) // 2] ^= 0x01
    flipped.write_bytes(bytes(raw))
    with pytest.raises(CorruptBundleError, match="sha256"):
        load_compiled(str(flipped), meta["manifest"]["decode_chunk_b2_t4.aot"])
    # a truncated metadata block, in both packages
    trunc = tmp_path / "trunc.aot"
    trunc.write_bytes(b"PTPU-AOT2\n" + (500).to_bytes(4, "big") + b"{}")
    for rm in (read_meta, jx.read_meta):
        with pytest.raises(ValueError, match="truncated"):
            rm(str(trunc))
    # archives that torch.export.load would unpickle from are refused
    # before anything is deserialized
    small = str(tmp_path / "small.aot")
    save_compiled(torch.nn.Linear(4, 4), (torch.zeros(2, 4),), small)
    head, blob = open(small, "rb").read().split(b"PK\x03\x04", 1)
    src = zipfile.ZipFile(io.BytesIO(b"PK\x03\x04" + blob))

    def rewrite(name, edit=None, extra=None):
        buf = io.BytesIO()
        with zipfile.ZipFile(buf, "w") as out:
            for n in src.namelist():
                data = src.read(n)
                if edit is not None and n.endswith(edit[0]):
                    data = edit[1](data)
                out.writestr(n, data)
            if extra is not None:
                out.writestr(src.namelist()[0].split("/")[0] + "/" + extra,
                             b"x")
        p = tmp_path / name
        p.write_bytes(head + buf.getvalue())
        return str(p)

    for path in (
            rewrite("pickled.aot", ("weights_config.json", lambda d: d.replace(
                b'"use_pickle": false', b'"use_pickle": true'))),
            rewrite("inputs.aot", ("sample_inputs/model.pt",
                                   lambda d: b"\x80\x02N.")),
            rewrite("extra.aot", extra="data/constants/custom_obj_0")):
        with pytest.raises(PickledArchiveError):
            load_compiled(path)
    x = torch.randn(2, 4)
    lin = load_compiled(small)
    assert lin(x).shape == (2, 4)


# -- predict bundles ---------------------------------------------------------

def _twin_nets(jx):
    """The JAX test's Sequential(Linear(8, 16), ReLU, Linear(16, 4)) and a
    torch one with its weights."""
    jx.paddle.seed(0)
    jnn = jx.nn
    jnet = jnn.Sequential(jnn.Linear(8, 16), jnn.ReLU(), jnn.Linear(16, 4))
    jnet.eval()
    tnet = torch.nn.Sequential(torch.nn.Linear(8, 16), torch.nn.ReLU(),
                               torch.nn.Linear(16, 4))
    js = {k: np.asarray(v.value) for k, v in jnet.state_dict().items()}
    with torch.no_grad():
        for i in (0, 2):
            tnet[i].weight.copy_(torch.from_numpy(js[f"{i}.weight"].T))
            tnet[i].bias.copy_(torch.from_numpy(js[f"{i}.bias"]))
    return jnet, tnet


def test_predict_bundle_matches_jax(jx, tmp_path):
    jnet, tnet = _twin_nets(jx)
    x = np.random.default_rng(0).standard_normal((4, 8)).astype(np.float32)
    expect = jnet(jx.paddle.to_tensor(x)).numpy()
    kw = dict(input_names=["features"], output_names=["logits"],
              extra_batch_sizes=[2])
    jdir, pdir = str(tmp_path / "jax"), str(tmp_path / "port")
    jx.export_predict(jnet, [x], jdir, **kw)
    export_predict_bundle(tnet, [x], pdir, **kw)
    jm, pm = _meta(jdir), _meta(pdir)
    assert set(pm) - {"program_format"} == set(jm)
    for k in ("kind", "inputs", "outputs", "buckets",
              "output_batch_major"):
        assert pm[k] == jm[k], k
    assert set(pm["manifest"]) == set(jm["manifest"])
    assert pm["program_format"]["device"] == "cpu"

    cfg = Config()
    cfg.disable_gpu()
    cfg.set_aot_bundle(pdir)
    cfg.enable_warmup()
    pred = create_predictor(cfg)
    assert pred.get_input_names() == ["features"]
    assert pred.get_output_names() == ["logits"]
    pred.get_input_handle("features").copy_from_cpu(x)
    pred.run()
    out = pred.get_output_handle("logits").copy_to_cpu()
    np.testing.assert_allclose(out, expect, rtol=1e-5, atol=1e-5)
    # the second bucket, then a batch of 3 padded to 4 and trimmed
    np.testing.assert_allclose(pred.run([x[:2]])[0], expect[:2],
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(pred.run([x[:3]])[0], expect[:3],
                               rtol=1e-5, atol=1e-5)
    assert pred._aot.padded_calls == 1
    # a float64 feed is cast to the bucket's dtype
    np.testing.assert_allclose(pred.run([x.astype(np.float64)])[0], expect,
                               rtol=1e-5, atol=1e-5)
    with pytest.raises(ValueError, match="bucket"):
        pred.run([np.zeros((3, 9), np.float32)])
    rep = pred.memory_report()
    assert rep["artifact_bytes"] == sum(rep["entries_bytes"].values()) > 0
    # a live layer through the same surface
    lcfg = Config()
    lcfg.disable_gpu()
    lcfg.set_layer(tnet)
    np.testing.assert_allclose(create_predictor(lcfg).run([x])[0], expect,
                               rtol=1e-5, atol=1e-5)
    with pytest.raises(NotImplementedError, match="jit"):
        create_predictor(Config("model/path"))


class _WithTable(torch.nn.Module):
    """A batch output beside a non-batch (8, 3) one whose leading dim
    equals the padded batch."""

    def __init__(self):
        super().__init__()
        self.fc = torch.nn.Linear(4, 4)
        self.table = torch.nn.Parameter(torch.full((8, 3), 2.0))

    def forward(self, x):
        return self.fc(x), self.table * 1.0


def test_padded_run_passes_non_batch_outputs_through(tmp_path):
    net = _WithTable()
    x8 = np.random.default_rng(0).standard_normal((8, 4)).astype(np.float32)
    d = str(tmp_path / "b")
    export_predict_bundle(net, [x8], d, input_names=["x"],
                          output_names=["y", "table"])
    meta = _meta(d)
    assert meta["output_batch_major"] == [True, False]
    pred = AotPredictor(d, device="cpu", allow_bucket_padding=True)
    out = pred.run({"x": x8[:3]})
    assert out["y"].shape == (3, 4) and out["table"].shape == (8, 3)
    with torch.no_grad():
        ref = net(torch.from_numpy(x8[:3]))[0].numpy()
    np.testing.assert_allclose(out["y"], ref, rtol=1e-5, atol=1e-6)
    meta.pop("output_batch_major")
    with open(os.path.join(d, "bundle.json"), "w") as f:
        json.dump(meta, f)
    legacy = AotPredictor(d, device="cpu")
    with pytest.raises(ValueError, match="batch-axis metadata"):
        legacy.run({"x": x8[:3]})
    assert legacy.run({"x": x8})["y"].shape == (8, 4)
    strict = AotPredictor(d, device="cpu", allow_bucket_padding=False)
    with pytest.raises(ValueError, match="no shape bucket"):
        strict.run({"x": x8[:3]})


# -- decoder bundles ---------------------------------------------------------

@pytest.mark.parametrize("name", list(SPECS))
def test_bundle_json_matches_jax(bundle, name):
    pdir, jdir = bundle(name).pdir, bundle(name).jdir
    pm, jm = _meta(pdir), _meta(jdir)
    assert set(pm) == set(jm) | {"program_format"}
    assert pm["program_format"] == {"format": "torch.export",
                                    "device": "cpu",
                                    "torch": torch.__version__}
    for key in jm:
        if key == "manifest":
            assert set(pm[key]) == set(jm[key])
            assert sorted(os.listdir(pdir)) == sorted(os.listdir(jdir))
        else:
            assert pm[key] == jm[key], key


def test_greedy_bundle_matches_jax_and_limits(bundle, models):
    b = bundle("chunked")
    dec, pred, jpred = b.dec, b.pred, b.jpred
    pred.warmup()                  # every entry once, on zeros
    ids = _prompt(1, 2, 8)
    want = np.asarray(jpred.generate(ids, max_new_tokens=10))
    got = pred.generate(ids, max_new_tokens=10)
    np.testing.assert_array_equal(np.asarray(got), want)
    np.testing.assert_array_equal(np.asarray(got),
                                  np.asarray(dec.generate(ids, 10)))
    assert got.resilience["level"] == "fused"
    # eos as a runtime input: an early stop trims as the JAX bundle does
    eos = int(want[0, 7])
    np.testing.assert_array_equal(
        np.asarray(pred.generate(ids, 10, eos_token_id=eos)),
        np.asarray(jpred.generate(ids, 10, eos_token_id=eos)))
    np.testing.assert_array_equal(
        np.asarray(pred.generate(ids, 10, eos_token_id=-1)), want)
    # a batch of 1 pads to the batch-2 bucket and trims
    padded = pred.padded_calls
    one = pred.generate(ids[:1, :], 10)
    np.testing.assert_array_equal(np.asarray(one), want[:1])
    assert pred.padded_calls == padded + 1
    with pytest.raises(ValueError, match="max_len"):
        pred.generate(ids, max_new_tokens=40)
    with pytest.raises(ValueError, match="prefill bucket"):
        pred.generate(_prompt(3, 2, 6), 4)
    with pytest.raises(ValueError, match="capacity"):
        pred.generate(ids, 11)
    with pytest.raises(ValueError, match="do_sample"):
        pred.generate(ids, 4, do_sample=True)
    # KV bytes per batch bucket as the JAX predictor sizes them
    assert pred.memory_report()["kv_cache_bytes_per_batch"] == \
        jpred.memory_report()["kv_cache_bytes_per_batch"]
    # a live model through the predictor surface decodes in-process
    cfg = Config()
    cfg.disable_gpu()
    cfg.set_layer(models[1])
    np.testing.assert_array_equal(
        np.asarray(create_predictor(cfg).generate(ids, 10, max_len=MAX_LEN)),
        want)


def test_multiple_batches_and_int8w_match_jax(bundle):
    b = bundle("int8w")
    dec, pred, jpred = b.dec, b.pred, b.jpred
    assert pred.quant_recipe == jpred.quant_recipe == "int8w"
    for B in (1, 2, 3):            # 2 pads to the batch-3 bucket
        ids = _prompt(B, B, 5)
        got = np.asarray(pred.generate(ids, 6))
        np.testing.assert_array_equal(got, np.asarray(dec.generate(ids, 6)))
    np.testing.assert_array_equal(got, np.asarray(jpred.generate(ids, 6)))
    pred.generate(ids, 6, quant="int8w")
    for ask in ("none", "int8wk"):
        with pytest.raises(QuantMismatchError):
            pred.generate(ids, 6, quant=ask)


def test_sampled_bundle_matches_jax_at_runtime_temperatures(bundle,
                                                            tmp_path):
    b = bundle("sampled")
    pdir, pred, jpred = b.pdir, b.pred, b.jpred
    ids = _prompt(4, 2, 5)
    for temp in (None, 0.5, 1.3):
        got = np.asarray(pred.generate(ids, 10, do_sample=True,
                                       temperature=temp, seed=3))
        np.testing.assert_array_equal(
            got, np.asarray(jpred.generate(ids, 10, do_sample=True,
                                           temperature=temp, seed=3)))
    assert not np.array_equal(
        got, np.asarray(pred.generate(ids, 10, do_sample=True,
                                      temperature=1.3, seed=4)))
    with pytest.raises(ValueError, match="do_sample"):
        pred.generate(ids, 4)
    # metadata recording a baked temperature refuses another one
    meta = _meta(pdir)
    meta["decode_mode"]["temperature"] = 0.8
    del meta["decode_mode"]["default_temperature"]
    legacy = tmp_path / "legacy"
    legacy.mkdir()
    (legacy / "bundle.json").write_text(json.dumps(meta))
    with pytest.raises(ValueError, match="re-export"):
        AotPredictor(str(legacy), device="cpu").generate(
            ids, 8, do_sample=True, temperature=1.3, seed=3)


def test_speculative_bundle_matches_jax_with_its_ladder(bundle, tmp_path):
    b = bundle("spec")
    dec, pred, jpred = b.dec, b.pred, b.jpred
    ids = _prompt(5, 2, 5)
    want = np.asarray(jpred.generate(ids, 8))
    got = pred.generate(ids, 8)
    np.testing.assert_array_equal(np.asarray(got), want)
    assert pred.last_spec_stats == jpred.last_spec_stats
    assert pred.last_spec_stats["rounds"] > 0
    assert got.resilience["level"] == "speculative"
    eos = int(want[0, 9])
    np.testing.assert_array_equal(
        np.asarray(pred.generate(ids, 8, eos_token_id=eos)),
        np.asarray(jpred.generate(ids, 8, eos_token_id=eos)))
    assert pred.last_spec_stats == jpred.last_spec_stats
    with pytest.raises(ValueError, match="capacity"):
        pred.generate(ids, 9)
    # the speculative entry dies: both step down to the plain entry
    fault_injector.configure([{"kind": "dispatch_error",
                               "site": "bundle.spec_decode", "call": 1,
                               "times": 1000}])
    out = pred.generate(ids, 8)
    fault_injector.clear()
    np.testing.assert_array_equal(np.asarray(out), want)
    assert out.resilience["level"] == "fused"
    assert out.resilience["degradations"][0]["from_level"] == "speculative"
    assert pred.last_spec_stats is None
    # the export's own refusals
    with pytest.raises(ValueError, match="requires a draft_model"):
        export_decoder_bundle(dec, str(tmp_path / "bad"), prompt_lens=[5],
                              decode_steps=[8], batch_sizes=[2],
                              num_speculative_tokens=2)
    with pytest.raises(ValueError, match="overshoot"):
        export_decoder_bundle(dec, str(tmp_path / "bad2"), prompt_lens=[5],
                              decode_steps=[30], batch_sizes=[2],
                              draft_model="skip:1", num_speculative_tokens=2)


# -- the engine over a bundle ------------------------------------------------

def _mixed(seed, n):
    rng = np.random.default_rng(seed)
    return [(rng.integers(0, 64, (int(rng.integers(2, 9)),)),
             int(rng.integers(3, 9))) for _ in range(n)]


def test_engine_over_bundle_matches_jax_engine(jx, bundle):
    b = bundle("chunked")
    dec, pred = b.dec, b.pred
    reqs = _mixed(6, 6)
    jeng = jx.Engine(b.jpred, num_slots=2, chunk_size=4)
    jids = [jeng.submit(p, n) for p, n in reqs]
    want = jeng.drain()
    eng = ServingEngine(pred, num_slots=2, chunk_size=4)
    assert eng.scheduler.prompt_buckets == [4, 8]
    ids = [eng.submit(p, n) for p, n in reqs]
    got = eng.drain()
    for a, b, (p, n) in zip(jids, ids, reqs):
        np.testing.assert_array_equal(np.asarray(got[b]),
                                      np.asarray(want[a]))
        np.testing.assert_array_equal(np.asarray(got[b]),
                                      np.asarray(dec.generate(p[None], n)))
    m, jm = eng.metrics(), jeng.metrics()
    for k in ("prefill_dispatches", "chunk_dispatches", "step_dispatches"):
        assert m[k] == jm[k], k
    assert m["prefill_dispatches"] == len(reqs)
    assert m["admission_ring"] == jm["admission_ring"] is None
    assert eng.host_scattered == len(reqs)
    # the JAX engine's typed refusals
    for kw, match in ((dict(draft_model="skip:1"), "speculative serving"),
                      (dict(adapter_store=object()), "LoRA adapter"),
                      (dict(do_sample=True), "do_sample"),
                      (dict(chunk_size=3), "no chunked decode bucket"),
                      (dict(quant="int8wk"), None)):
        args = dict(num_slots=2, chunk_size=4)
        args.update(kw)
        err = QuantMismatchError if match is None else ValueError
        with pytest.raises(err, match=match):
            ServingEngine(pred, **args)
    with pytest.raises(ValueError, match="chunk_sizes"):
        ServingEngine(bundle("sampled").pred, num_slots=2, chunk_size=4,
                      do_sample=True, top_k=8)
    with pytest.raises(NotImplementedError, match="mesh"):
        ServingEngine(pred, num_slots=2, chunk_size=4, mesh="dp:2")


def test_engine_over_bundle_prefix_cache_and_rung(bundle):
    """JAX ``tests/test_prefix_cache.py::test_bundle_prefix_cache_serving``
    at the bundle's buckets 4 / 8 (block 4): a full hit and a partial hit
    (the suffix through the bucket-4 admit entry's ``pos0``); then
    ``tests/test_serving.py``'s per-token rung drill on the bundle's
    ``bundle.chunk`` site. Tokens equal the solo ``generate``, which the
    tests above hold to the JAX package."""
    b = bundle("chunked")
    dec = b.dec
    rng = np.random.default_rng(10)
    pre = rng.integers(0, 64, (4,))
    p1 = np.concatenate([pre, rng.integers(0, 64, (3,))])
    p2 = np.concatenate([pre, rng.integers(0, 64, (2,))])
    eng = ServingEngine(b.pred, num_slots=2, chunk_size=4, prefix_cache=True,
                        prefix_cache_bytes=1 << 30, prefix_block_tokens=4)
    assert b.pred.meta["decode_mode"]["chunked"]["admit_pos0"] is True
    a = eng.submit(p1, 5)
    eng.drain()
    d0 = eng.prefill_dispatches
    x = eng.submit(p1, 5)           # full hit
    y = eng.submit(p2, 5)           # partial: the suffix via pos0
    res = eng.drain()
    solo1 = np.asarray(dec.generate(p1[None], 5))
    np.testing.assert_array_equal(np.asarray(eng.result(a)), solo1)
    np.testing.assert_array_equal(np.asarray(res[x]), solo1)
    np.testing.assert_array_equal(np.asarray(res[y]),
                                  np.asarray(dec.generate(p2[None], 5)))
    assert res[x].resilience["serving"]["prefix_hit"] == "full"
    assert res[x].resilience["serving"]["admission_dispatches"] == 0
    assert res[y].resilience["serving"]["prefix_hit"] == "partial"
    assert eng.prefill_dispatches - d0 == 1

    reqs = _mixed(7, 5)
    fault_injector.configure([{"kind": "dispatch_error",
                               "site": "bundle.chunk", "call": 2,
                               "times": 1000}])
    eng = ServingEngine(b.pred, num_slots=2, chunk_size=4)
    ids = [eng.submit(p, n) for p, n in reqs]
    out = eng.drain()
    fault_injector.clear()
    for rid, (p, n) in zip(ids, reqs):
        np.testing.assert_array_equal(np.asarray(out[rid]),
                                      np.asarray(dec.generate(p[None], n)))
    m = eng.metrics()
    assert m["degradations"] >= 1
    assert m["step_dispatches"] >= eng.chunk_size
    assert out[ids[-1]].resilience["level"] == "per_token"
    assert out[ids[-1]].resilience["degradations"]


def test_int8wk_bundle_and_refusals_match_jax(bundle):
    b = bundle("int8wk")
    dec, pred, jpred = b.dec, b.pred, b.jpred
    assert pred.meta["caches"]["1"]["dtype"] == "int8"
    ids = _prompt(8, 1, 5)
    want = np.asarray(jpred.generate(ids, 6))
    np.testing.assert_array_equal(np.asarray(pred.generate(ids, 6)), want)
    np.testing.assert_array_equal(want, np.asarray(dec.generate(ids, 6)))
    for ask in ("fp32", "int8w"):
        with pytest.raises(QuantMismatchError):
            pred.generate(ids, 6, quant=ask)
    assert pred.memory_report()["kv_cache_bytes_per_batch"] == \
        jpred.memory_report()["kv_cache_bytes_per_batch"]
    with pytest.raises(ValueError, match="chunk_sizes"):
        ServingEngine(pred, num_slots=1, chunk_size=3, quant="int8wk")
    # an unquantized bundle refuses a quantized ask, and vice versa
    plain = bundle("chunked").pred
    with pytest.raises(QuantMismatchError):
        plain.generate(_prompt(9, 2, 8), 4, quant="int8wk")
    with pytest.raises(QuantMismatchError):
        ServingEngine(plain, num_slots=2, chunk_size=4, quant="int8w")


# -- a fresh process ---------------------------------------------------------

_FRESH = textwrap.dedent("""
    import sys
    import numpy as np
    from paddle_tpu_torch.inference import Config, create_predictor
    cfg = Config()
    cfg.disable_gpu()
    cfg.set_aot_bundle(sys.argv[1])
    pred = create_predictor(cfg)
    out = pred.generate(np.load(sys.argv[2]), max_new_tokens=10)
    np.testing.assert_array_equal(out, np.load(sys.argv[3]))
    bad = [m for m in sys.modules if m in (
        "paddle_tpu_torch.models.llama",
        "paddle_tpu_torch.inference.generate",
        "paddle_tpu_torch.inference.entries")
        or m.split(".")[0] in ("jax", "paddle_tpu")]
    assert not bad, bad
    print("FRESH_OK")
""")


@pytest.fixture(scope="module")
def fresh(bundle, tmp_path_factory):
    """A fresh interpreter serving the chunked bundle, started in the
    background as soon as the bundle exists (it shares nothing with this
    process but the files)."""
    b = bundle("chunked")
    d = tmp_path_factory.mktemp("fresh")
    ids = _prompt(11, 2, 8)
    np.save(d / "ids.npy", ids)
    np.save(d / "want.npy", np.asarray(b.dec.generate(ids, 10)))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = ROOT
    proc = subprocess.Popen(
        [sys.executable, "-c", _FRESH, b.pdir, str(d / "ids.npy"),
         str(d / "want.npy")], env=env, cwd=ROOT, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)
    yield proc
    if proc.poll() is None:
        proc.kill()
    proc.communicate()


def test_fresh_process_serves_without_model_code(fresh):
    """A fresh interpreter loads the bundle through ``Config`` /
    ``create_predictor`` and generates the in-process decoder's tokens
    without importing the model code or the decoder."""
    out, err = fresh.communicate(timeout=300)
    assert "FRESH_OK" in out, err[-3000:]


# -- on the card -------------------------------------------------------------

@pytest.mark.gpu
def test_bundle_graphs_equal_eager_entries_on_card(tmp_path):
    """On the card each entry key's first call runs eagerly and later ones
    replay a CUDA graph of the loaded program: the replays give the eager
    call's tokens (generate, sampled generate, a speculative bundle's
    rounds, the engine's chunks and admissions), launch the kernels
    inside the programs, and equal the in-process decoder's."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from paddle_tpu_torch.ops.kernels import decode_attention as da
    from paddle_tpu_torch.ops.kernels import int8_matmul as i8
    from paddle_tpu_torch.ops.kernels import threefry as tf
    cfg = LlamaConfig(vocab_size=512, hidden_size=128, intermediate_size=256,
                      num_hidden_layers=2, num_attention_heads=4,
                      num_key_value_heads=2, max_position_embeddings=256,
                      dtype="bfloat16")
    model = LlamaForCausalLM(cfg, seed=0)
    ids = _prompt(12, 4, 16) % 512
    for quant, kw in ((None, dict(chunk_sizes=[4])),
                      ("int8wk", dict(chunk_sizes=[4])),
                      (None, dict(do_sample=True, top_k=50, top_p=0.9)),
                      (None, dict(draft_model="skip:1",
                                  num_speculative_tokens=4))):
        dec = LlamaDecoder(model, max_len=128, quant=quant)
        d = str(tmp_path / f"b{len(os.listdir(tmp_path))}")
        export_decoder_bundle(dec, d, prompt_lens=[16, 32],
                              decode_steps=[16], batch_sizes=[4], **kw)
        pred = AotPredictor(d)
        sample = kw.get("do_sample", False)
        runtime = dict(temperature=0.8, seed=3) if sample else {}
        want = np.asarray(dec.generate(
            ids, 16, **{k: v for k, v in kw.items() if k != "chunk_sizes"},
            **runtime))
        before = (da.launches, i8.launches, tf.launches)
        outs = [np.asarray(pred.generate(ids, 16, do_sample=sample,
                                         **runtime)) for _ in range(3)]
        for o in outs:
            np.testing.assert_array_equal(o, want)
        assert pred.graph_replays > 0
        assert da.launches > before[0]
        assert (i8.launches > before[1]) == (quant is not None)
        assert (tf.launches > before[2]) == sample
        if "chunk_sizes" in kw:
            # the first drain runs each key eagerly, then captures; the
            # second replays: the same tokens as an in-process engine
            # admitting by the same host route over the same buckets
            rng = np.random.default_rng(1)
            reqs = [(rng.integers(0, 512, int(rng.integers(4, 30))),
                     int(rng.integers(4, 20))) for _ in range(8)]
            ref = ServingEngine(dec, num_slots=4, chunk_size=4,
                                prefix_cache=True, prompt_buckets=[16, 32],
                                cache_aware_admission=False)
            eng = ServingEngine(pred, num_slots=4, chunk_size=4)
            drains = []
            for e in (ref, eng, eng):
                rids = [e.submit(p, n) for p, n in reqs]
                out = e.drain()
                drains.append([np.asarray(out[r]) for r in rids])
            for a, b, c in zip(*drains):
                np.testing.assert_array_equal(b, a)
                np.testing.assert_array_equal(c, a)
        del pred
        torch.cuda.empty_cache()
