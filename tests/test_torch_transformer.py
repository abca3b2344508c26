"""The port's functional ops, RNG and transformer layers against the JAX
package, on the CPU.

``layer_norm``, ``gelu``, ``embedding`` and ``dropout`` take the same
numpy inputs in both packages; dropout's masks (``dropout``,
``dropout2d``, attention dropout) are bit-equal after ``seed(s)`` on both
sides, and the ``Generator`` splits as the JAX one does.
``MultiHeadAttention``, the encoder and decoder layers and ``Transformer``
take the JAX layers' weights (``convert.from_jax_state_dict``) and give
their outputs and gradients (through the JAX package's tape) at the JAX
tests' f32 tolerance, with attention dropout on in training where the
masks are drawn from one seed on both sides.
"""

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.framework.random as jax_rng
import paddle_tpu.nn as jnn
import paddle_tpu.nn.functional as JF
from paddle_tpu_torch import nn as tnn
from paddle_tpu_torch.convert import from_jax_state_dict
from paddle_tpu_torch.framework import random as rng_state
from paddle_tpu_torch.nn import functional as TF

# the JAX package's own f32 tolerances for layers (tests/test_moe.py:46)
RTOL, ATOL = 2e-4, 2e-5


def _np(t):
    return np.asarray(t.numpy() if hasattr(t, "numpy") else t)


def _state(m):
    return {k: np.asarray(v.value) for k, v in m.state_dict().items()}


def _x(shape, seed=0):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def _seed_both(s):
    paddle.seed(s)
    rng_state.seed(s)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_layer_norm_matches_jax(dtype):
    """f32 statistics for bf16 input, rounded before the affine: the same
    bits as the JAX function in bf16, 1e-6 in f32."""
    x, w, b = _x((4, 6, 32)), 1 + 0.1 * _x((32,), 1), 0.1 * _x((32,), 2)
    jx = paddle.to_tensor(x).astype(dtype)
    want = JF.layer_norm(jx, 32, paddle.to_tensor(w).astype(dtype),
                         paddle.to_tensor(b).astype(dtype), 1e-5)
    tdt = getattr(torch, dtype)
    got = TF.layer_norm(torch.from_numpy(x).to(tdt), 32,
                        torch.from_numpy(w).to(tdt),
                        torch.from_numpy(b).to(tdt), 1e-5)
    assert got.dtype == tdt
    want = np.asarray(want.astype("float32").numpy())
    if dtype == "float32":
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)
    else:
        # x rounds to bf16 before the affine on both sides; the products
        # may round once more apart: one bf16 spacing
        np.testing.assert_allclose(got.float().numpy(), want, rtol=2 ** -7,
                                   atol=2 ** -7)


@pytest.mark.parametrize("approximate", [False, True])
def test_gelu_and_relu_match_jax(approximate):
    x = 3 * _x((257,))
    np.testing.assert_allclose(
        TF.gelu(torch.from_numpy(x), approximate=approximate).numpy(),
        _np(JF.gelu(paddle.to_tensor(x), approximate=approximate)),
        rtol=1e-6, atol=1e-6)
    np.testing.assert_array_equal(TF.relu(torch.from_numpy(x)).numpy(),
                                  _np(JF.relu(paddle.to_tensor(x))))


def test_embedding_with_padding_idx_matches_jax():
    """Rows at ``padding_idx`` are zeros and pass no gradient, the layers
    start with that row zeroed, and the weights are normal(0, 1)."""
    w = _x((10, 8))
    ids = np.array([[1, 3, 0, 3], [9, 0, 2, 2]])
    want = _np(JF.embedding(paddle.to_tensor(ids), paddle.to_tensor(w),
                            padding_idx=3))
    tw = torch.from_numpy(w).requires_grad_()
    got = TF.embedding(torch.from_numpy(ids), tw, padding_idx=3)
    np.testing.assert_array_equal(got.detach().numpy(), want)
    got.sum().backward()
    assert (tw.grad[3] == 0).all() and (tw.grad[0] == 2).all()
    layer = tnn.Embedding(1000, 64, padding_idx=3, device="cpu")
    assert (layer.weight[3] == 0).all()
    assert abs(layer.weight.std().item() - 1.0) < 0.05


@pytest.mark.parametrize("p,mode,axis", [
    (0.1, "upscale_in_train", None), (0.5, "upscale_in_train", None),
    (0.3, "downscale_in_infer", None), (0.3, "upscale_in_train", 1),
    (0.3, "upscale_in_train", [0, 2])])
def test_dropout_masks_are_the_jax_masks(p, mode, axis):
    """After ``seed(s)`` on both sides, three draws in a row give the JAX
    package's outputs bit for bit (the global generator splits as the JAX
    one does); in eval, ``downscale_in_infer`` scales by 1 - p."""
    x = _x((4, 5, 33))
    _seed_both(11)
    for _ in range(3):
        want = _np(JF.dropout(paddle.to_tensor(x), p=p, mode=mode,
                              axis=axis))
        got = TF.dropout(torch.from_numpy(x), p=p, mode=mode, axis=axis)
        np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        TF.dropout(torch.from_numpy(x), p=p, training=False,
                   mode=mode).numpy(),
        _np(JF.dropout(paddle.to_tensor(x), p=p, training=False,
                       mode=mode)))


def test_dropout2d_and_generator_state_match_jax():
    x = _x((2, 6, 4, 4))
    _seed_both(4)
    want = _np(JF.dropout2d(paddle.to_tensor(x), p=0.5))
    got = TF.dropout2d(torch.from_numpy(x), p=0.5).numpy()
    np.testing.assert_array_equal(got, want)
    assert ((got == 0).all(axis=(2, 3)) | (got != 0).all(axis=(2, 3))).all()
    np.testing.assert_array_equal(
        rng_state.get_rng_state().numpy().astype(np.uint32),
        np.asarray(__import__("jax").random.key_data(
            jax_rng.get_rng_state())))
    keys = rng_state.split_key(3)
    jkeys = jax_rng.split_key(3)
    import jax
    for k, jk in zip(keys, jkeys):
        np.testing.assert_array_equal(k.numpy().astype(np.uint32),
                                      np.asarray(jax.random.key_data(jk)))


def test_pushed_key_drives_the_draws():
    """While a key is pushed, draws split it (as the JAX trainer's traced
    key) and leave the global generator alone."""
    import jax
    x = _x((3, 40))
    _seed_both(0)
    before = rng_state.get_rng_state().clone()
    rng_state.push_trace_key(torch.tensor([0, 7], dtype=torch.int32))
    jax_rng.push_trace_key(jax.random.key(np.uint32(7),
                                          impl="threefry2x32"))
    try:
        for _ in range(2):
            np.testing.assert_array_equal(
                TF.dropout(torch.from_numpy(x), p=0.2).numpy(),
                _np(JF.dropout(paddle.to_tensor(x), p=0.2)))
    finally:
        rng_state.pop_trace_key()
        jax_rng.pop_trace_key()
    assert torch.equal(rng_state.get_rng_state(), before)
    assert not rng_state.in_trace()


def _grads_of(jlayer, tlayer, inputs, call_j, call_t):
    """Outputs and input / parameter gradients of sum(out * r) on both
    sides (r a fixed random cotangent)."""
    jin = [paddle.to_tensor(a, stop_gradient=False) for a in inputs]
    jout = call_j(jlayer, *jin)
    r = _x(tuple(jout.shape), 99)
    paddle.sum(jout * paddle.to_tensor(r)).backward()
    tin = [torch.from_numpy(a).requires_grad_() for a in inputs]
    tout = call_t(tlayer, *tin)
    (tout * torch.from_numpy(r)).sum().backward()
    np.testing.assert_allclose(tout.detach().numpy(), _np(jout), rtol=RTOL,
                               atol=ATOL)
    for a, b in zip(tin, jin):
        np.testing.assert_allclose(a.grad.numpy(), _np(b.grad), rtol=RTOL,
                                   atol=ATOL)
    jp = dict(jlayer.named_parameters())
    for n, p in tlayer.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), _np(jp[n].grad),
                                   rtol=RTOL, atol=ATOL, err_msg=n)


@pytest.mark.parametrize("dropout", [0.0, 0.2])
def test_multi_head_attention_matches_jax(dropout):
    """Cross-attention with kdim / vdim, an additive mask, and attention
    dropout in training from one seed on both sides."""
    paddle.seed(1)
    jl = jnn.MultiHeadAttention(32, 4, dropout=dropout, kdim=24, vdim=16)
    tl = from_jax_state_dict(_state(jl), tnn.MultiHeadAttention(
        32, 4, dropout=dropout, kdim=24, vdim=16, device="cpu"))
    mask = np.where(np.random.default_rng(3).random((6, 5)) < 0.3, -1e9,
                    0.0).astype(np.float32)
    _seed_both(8)
    _grads_of(jl, tl, [_x((2, 6, 32)), _x((2, 5, 24), 1), _x((2, 5, 16), 2)],
              lambda m, q, k, v: m(q, k, v, attn_mask=paddle.to_tensor(mask)),
              lambda m, q, k, v: m(q, k, v, attn_mask=torch.from_numpy(mask)))


@pytest.mark.parametrize("activation,normalize_before,dropout", [
    ("relu", False, 0.0), ("gelu", True, 0.1)])
def test_encoder_and_decoder_layers_match_jax(activation, normalize_before,
                                              dropout):
    """Post- and pre-norm layers, with every dropout (residual, act and
    attention) live in training from one seed on both sides."""
    paddle.seed(2)
    je = jnn.TransformerEncoderLayer(32, 4, 64, dropout, activation,
                                     normalize_before=normalize_before)
    te = from_jax_state_dict(_state(je), tnn.TransformerEncoderLayer(
        32, 4, 64, dropout, activation, normalize_before=normalize_before,
        device="cpu"))
    _seed_both(3)
    _grads_of(je, te, [_x((2, 7, 32))], lambda m, s: m(s),
              lambda m, s: m(s))
    jd = jnn.TransformerDecoderLayer(32, 4, 64, dropout, activation,
                                     normalize_before=normalize_before)
    td = from_jax_state_dict(_state(jd), tnn.TransformerDecoderLayer(
        32, 4, 64, dropout, activation, normalize_before=normalize_before,
        device="cpu"))
    _seed_both(4)
    _grads_of(jd, td, [_x((2, 5, 32)), _x((2, 7, 32), 1)],
              lambda m, t, mem: m(t, mem), lambda m, t, mem: m(t, mem))


def test_transformer_matches_jax():
    """The whole encoder-decoder (2 + 2 layers, deep-copied as in the JAX
    package, pre-norm with final norms) under the causal mask of
    ``generate_square_subsequent_mask``, in eval: outputs and gradients."""
    paddle.seed(5)
    jm = jnn.Transformer(32, 4, 2, 2, 64, dropout=0.1,
                         normalize_before=True)
    tm = from_jax_state_dict(_state(jm), tnn.Transformer(
        32, 4, 2, 2, 64, dropout=0.1, normalize_before=True, device="cpu"))
    assert sorted(n for n, _ in tm.named_parameters()) == sorted(_state(jm))
    assert torch.equal(tm.encoder.layers[0].linear1.weight,
                       tm.encoder.layers[1].linear1.weight)
    jm.eval()
    tm.eval()
    jmask = jnn.Transformer.generate_square_subsequent_mask(6)
    tmask = tnn.Transformer.generate_square_subsequent_mask(6, device="cpu")
    np.testing.assert_array_equal(tmask.numpy(), _np(jmask))
    _grads_of(jm, tm, [_x((2, 8, 32)), _x((2, 6, 32), 1)],
              lambda m, s, t: m(s, t, tgt_mask=jmask),
              lambda m, s, t: m(s, t, tgt_mask=tmask))
