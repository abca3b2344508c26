"""The port's distributed checkpoints (paddle_tpu_torch/distributed/
checkpoint.py, ``ShardedTrainer.save`` / ``load``) against the JAX
package's, on the CPU.

- A port checkpoint loads in the JAX package and a JAX one in the port,
  f32, bf16 and int32 alike, bit for bit.
- A JAX checkpoint written in slices from a 2-way sharded CPU mesh loads
  whole into the port.
- A flipped byte in the data file raises ``CorruptCheckpointError`` in
  both packages.
- A port trainer resumed from ``save`` gives the uninterrupted trainer's
  losses bit for bit; a JAX trainer's checkpoint resumed by the port's
  trainer gives the JAX trainer's next loss within 1e-5 (f32).
"""

import os

import numpy as np
import pytest
import torch

from paddle_tpu_torch.distributed import checkpoint as ckpt
from paddle_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM
from paddle_tpu_torch.optimizer import AdamW
from paddle_tpu_torch.parallel import ShardedTrainer
from paddle_tpu_torch.runtime.resilience import CorruptCheckpointError

CFG = dict(vocab_size=256, hidden_size=64, intermediate_size=128,
           num_hidden_layers=2, num_attention_heads=4,
           num_key_value_heads=2, max_position_embeddings=64)
B, S = 2, 16


def _values():
    rng = np.random.default_rng(0)
    return {"w": rng.standard_normal((6, 5)).astype(np.float32),
            "h": rng.standard_normal((7,)).astype(np.float32),
            "n": rng.integers(-9, 9, (3, 2)).astype(np.int32),
            "s": np.float32(0.5)}


def _port_tensors(vals):
    out = {k: torch.from_numpy(np.array(v)) for k, v in vals.items()}
    out["h"] = out["h"].to(torch.bfloat16)
    return out


def _jax_tensors(vals):
    import jax.numpy as jnp

    from paddle_tpu.framework.tensor import Tensor
    out = {k: Tensor(jnp.asarray(v)) for k, v in vals.items()}
    out["h"] = Tensor(jnp.asarray(vals["h"]).astype(jnp.bfloat16))
    return out


def _jax_numpy(t):
    v = np.asarray(t.value)
    return v.astype(np.float32) if v.dtype.name == "bfloat16" else v


def test_checkpoints_cross_both_ways(tmp_path):
    """The same values through each package's save and the other's load:
    the same files, every tensor bit for bit (bf16 as its bits)."""
    from paddle_tpu.distributed import checkpoint as jckpt

    vals = _values()
    src = _port_tensors(vals)
    ckpt.save_state_dict(src, str(tmp_path / "port"))
    jdst = {k: type(v)(v.value * 0) for k, v in _jax_tensors(vals).items()}
    jckpt.load_state_dict(jdst, str(tmp_path / "port"))
    for k, t in src.items():
        assert str(jdst[k].value.dtype) == str(t.dtype).replace("torch.",
                                                                "")
        np.testing.assert_array_equal(_jax_numpy(jdst[k]),
                                      t.float().numpy() if k == "h"
                                      else t.numpy(), err_msg=k)

    jckpt.save_state_dict(_jax_tensors(vals), str(tmp_path / "jax"))
    assert (sorted(os.listdir(tmp_path / "jax"))
            == sorted(os.listdir(tmp_path / "port")))
    dst = {k: torch.zeros_like(v) for k, v in src.items()}
    ckpt.load_state_dict(dst, str(tmp_path / "jax"))
    for k, t in src.items():
        assert dst[k].dtype == t.dtype and torch.equal(dst[k], t), k


def test_sharded_jax_checkpoint_loads_whole(tmp_path):
    """A JAX checkpoint saved from a 2-way sharded mesh stores each
    tensor as two slices; the port assembles them whole."""
    from paddle_tpu.distributed import checkpoint as jckpt
    from paddle_tpu.parallel import Replicate, Shard, init_mesh, shard_tensor
    from paddle_tpu.parallel.mesh import set_mesh

    x = np.arange(48, dtype=np.float32).reshape(8, 6)
    y = np.arange(30, dtype=np.float32).reshape(5, 6) / 7
    mesh = init_mesh((2,), ("mp",))
    try:
        jckpt.save_state_dict({"x": shard_tensor(x, mesh, [Shard(0)]),
                               "y": shard_tensor(y, mesh, [Shard(1)]),
                               "z": shard_tensor(x, mesh, [Replicate()])},
                              str(tmp_path))
    finally:
        set_mesh(None)
    import json
    with open(tmp_path / "metadata.json") as f:
        meta = json.load(f)["tensors"]
    assert len(meta["x"]["storage"]) == 2 and len(meta["y"]["storage"]) == 2
    dst = {"x": torch.zeros(8, 6), "y": torch.zeros(5, 6),
           "z": torch.zeros(8, 6)}
    ckpt.load_state_dict(dst, str(tmp_path))
    np.testing.assert_array_equal(dst["x"].numpy(), x)
    np.testing.assert_array_equal(dst["y"].numpy(), y)
    np.testing.assert_array_equal(dst["z"].numpy(), x)


def test_flipped_byte_refused_by_both_packages(tmp_path):
    from paddle_tpu.distributed import checkpoint as jckpt

    vals = _values()
    ckpt.save_state_dict(_port_tensors(vals), str(tmp_path))
    data = tmp_path / "data_r0.npz"
    raw = bytearray(data.read_bytes())
    raw[len(raw) // 2] ^= 0x10
    data.write_bytes(bytes(raw))
    dst = {k: torch.zeros_like(v) for k, v in _port_tensors(vals).items()}
    with pytest.raises(CorruptCheckpointError, match="sha256"):
        ckpt.load_state_dict(dst, str(tmp_path))
    assert all(not v.any() for v in dst.values())
    jdst = _jax_tensors(vals)
    with pytest.raises(jckpt.CorruptCheckpointError, match="sha256"):
        jckpt.load_state_dict(jdst, str(tmp_path))
    os.remove(tmp_path / "metadata.json")
    with pytest.raises(CorruptCheckpointError):
        ckpt.load_state_dict(dst, str(tmp_path))


def _batch(step):
    rng = np.random.default_rng(100 + step)
    return (rng.integers(0, CFG["vocab_size"], (B, S)),
            rng.integers(0, CFG["vocab_size"], (B, S)))


def _port_trainer(state=None):
    from paddle_tpu_torch.convert import from_jax_state_dict
    m = LlamaForCausalLM(LlamaConfig(**CFG), device="cpu", seed=1)
    if state is not None:
        m = from_jax_state_dict(state, m)
    return ShardedTrainer(m, AdamW(1e-3, parameters=m.parameters(),
                                   weight_decay=0.01),
                          lambda mm, i, l: mm.loss(i, l))


def test_resumed_port_trainer_is_bit_equal(tmp_path):
    """Four steps straight against two, ``save``, a fresh trainer that
    ``load``s, and two more: the last two losses and every tensor of the
    state dict are bit-equal."""
    t1 = _port_trainer()
    want = [t1.train_step(*_batch(k)).item() for k in range(4)]
    t2 = _port_trainer()
    for k in range(2):
        t2.train_step(*_batch(k))
    t2.save(str(tmp_path))
    t3 = _port_trainer()
    t3.model.apply(lambda mod: [p.data.zero_() for p in
                                mod.parameters(recurse=False)])
    t3.load(str(tmp_path))
    got = [t3.train_step(*_batch(k)).item() for k in (2, 3)]
    assert got == want[2:]
    for k, v in t1.state_dict().items():
        assert torch.equal(t3.state_dict()[k], v), k


def test_jax_trainer_checkpoint_resumes_in_port(tmp_path):
    """A JAX trainer's checkpoint after two steps, loaded by the port's
    trainer: its next step's loss is the JAX trainer's third, within
    1e-5 (f32), and so are its parameters after it."""
    import paddle_tpu as paddle
    from paddle_tpu.models.llama import LlamaConfig as JaxConfig
    from paddle_tpu.models.llama import LlamaForCausalLM as JaxModel
    from paddle_tpu.parallel import init_mesh
    from paddle_tpu.parallel.mesh import set_mesh
    from paddle_tpu.parallel.train import ShardedTrainer as JaxTrainer

    from paddle_tpu_torch.convert import to_numpy_state_dict

    paddle.seed(5)
    jm = JaxModel(JaxConfig(**CFG))
    mesh = init_mesh((1, 1, 1), ("dp", "sep", "mp"))
    try:
        jt = JaxTrainer(jm, paddle.optimizer.AdamW(
            learning_rate=1e-3, parameters=jm.parameters(),
            weight_decay=0.01), lambda m, i, l: m.loss(i, l), mesh, {})
        with mesh:
            for k in range(2):
                jt.train_step(*_batch(k))
            jt.save(str(tmp_path))
            want = float(jt.train_step(*_batch(2)).numpy())
    finally:
        set_mesh(None)
    tt = _port_trainer()
    tt.load(str(tmp_path))
    got = tt.train_step(*_batch(2)).item()
    np.testing.assert_allclose(got, want, rtol=1e-5)
    jstate = {k: np.asarray(v.value) for k, v in jm.state_dict().items()}
    for n, p in to_numpy_state_dict(tt.model).items():
        np.testing.assert_allclose(p, jstate[n], rtol=1e-5, atol=3e-6,
                                   err_msg=n)
