"""The port's ``jax.random`` (paddle_tpu_torch/random.py) against JAX's.

Keys, split, fold_in, random bits and uniforms must be bit-equal to JAX
0.9 with ``jax_threefry_partitionable`` on and 64-bit types off (this
environment's configuration, the JAX package's); the port's keys hold the
uint32 words as int32, so ``.numpy().astype(np.uint32)`` is JAX's key. On
the CPU the threefry wrapper runs its plain version.

Gumbel noise is ``-log(-log(u))`` over bit-equal uniforms u; JAX's log and
torch's differ by one f32 ulp at some inputs, and ``-log(y)`` turns an ulp
of y into an absolute error of about an ulp of 1, which is many ulps of a
value near 0. So each log stage is held to 2 ulps of its own value, and
the noise to 2 ulps of max(|noise|, 1). Categorical draws must give equal
indices.
"""

import jax
import numpy as np
import pytest
import torch

from paddle_tpu_torch import random as rnd
from paddle_tpu_torch.ops.kernels import threefry as tf

SHAPES = [(3,), (8, 64), (2, 5, 7)]
SEEDS = [0, 1, 42, 2**31 - 1, 2**31, -1, 2**33 + 7]


def _u32(t):
    return np.asarray(t).astype(np.uint32)


def _ulps(a, b):
    """Distance in f32 ulps, elementwise (same-sign finite values)."""
    return np.abs(np.asarray(a, np.float32).view(np.int32).astype(np.int64)
                  - np.asarray(b, np.float32).view(np.int32))


@pytest.mark.parametrize("seed", SEEDS)
def test_prng_key_bit_equal(seed):
    np.testing.assert_array_equal(_u32(rnd.PRNGKey(seed, device="cpu")),
                                  np.asarray(jax.random.PRNGKey(seed)))


def test_prng_key_defaults_to_the_card():
    """Like every entry point of the port, a key is made on the card
    unless the caller asks for the CPU; with no card that ask raises."""
    if torch.cuda.is_available():
        assert rnd.PRNGKey(3).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            rnd.PRNGKey(3)
    assert rnd.PRNGKey(3, device="cpu").device.type == "cpu"


@pytest.mark.parametrize("n", [1, 2, 3, 8])
def test_split_bit_equal(n):
    for seed in (3, 2**31 + 5):
        want = np.asarray(jax.random.split(jax.random.PRNGKey(seed), n))
        got = _u32(rnd.split(rnd.PRNGKey(seed, device="cpu"), n))
        np.testing.assert_array_equal(got, want)


def test_fold_in_and_batched_split_bit_equal():
    k = jax.random.PRNGKey(3)
    tk = rnd.PRNGKey(3, device="cpu")
    for d in (0, 7, 2**31 + 5, 2**32 - 1):
        np.testing.assert_array_equal(_u32(rnd.fold_in(tk, d)),
                                      np.asarray(jax.random.fold_in(k, d)))
    ks = np.asarray(jax.random.split(k, 5))
    got = _u32(rnd.split_rows(torch.from_numpy(ks.view(np.int32).copy()),
                              3))
    np.testing.assert_array_equal(
        got, np.asarray(jax.vmap(lambda x: jax.random.split(x, 3))(ks)))


@pytest.mark.parametrize("shape", SHAPES + [()])
def test_random_bits_and_uniform_bit_equal(shape):
    k, tk = jax.random.PRNGKey(11), rnd.PRNGKey(11, device="cpu")
    np.testing.assert_array_equal(_u32(rnd.random_bits(tk, shape)),
                                  np.asarray(jax.random.bits(k, shape)))
    tiny = float(np.finfo(np.float32).tiny)
    for lo, hi in ((0.0, 1.0), (tiny, 1.0), (-2.0, 3.0), (0.5, 0.75)):
        want = np.asarray(jax.random.uniform(k, shape, minval=lo,
                                             maxval=hi))
        got = rnd.uniform(tk, shape, lo, hi).numpy()
        np.testing.assert_array_equal(got.view(np.uint32),
                                      want.view(np.uint32),
                                      err_msg=str((lo, hi)))


@pytest.mark.parametrize("shape", SHAPES)
def test_gumbel_within_two_ulps(shape):
    import jax.numpy as jnp

    k, tk = jax.random.PRNGKey(5), rnd.PRNGKey(5, device="cpu")
    u = np.asarray(jax.random.uniform(
        k, shape, minval=float(np.finfo(np.float32).tiny), maxval=1.0))
    y_j = np.asarray(-jnp.log(jnp.asarray(u)))
    y_t = (-torch.log(torch.from_numpy(u.copy()))).numpy()
    assert _ulps(y_j, y_t).max() <= 2
    want = np.asarray(jax.random.gumbel(k, shape))
    got = rnd.gumbel(tk, shape).numpy()
    np.testing.assert_array_equal(want, np.asarray(-jnp.log(y_j)))
    spacing = np.spacing(np.maximum(np.abs(want), 1.0).astype(np.float32))
    assert (np.abs(got - want) <= 2 * spacing).all(), \
        np.max(np.abs(got - want) / spacing)


@pytest.mark.parametrize("shape", [(64,), (4, 64), (3, 8, 100)])
def test_categorical_equal_indices(shape):
    logits = np.random.default_rng(0).standard_normal(shape) \
        .astype(np.float32)
    for seed in range(4):
        want = np.asarray(jax.random.categorical(jax.random.PRNGKey(seed),
                                                 logits))
        got = rnd.categorical(rnd.PRNGKey(seed, device="cpu"),
                              torch.from_numpy(logits)).numpy()
        np.testing.assert_array_equal(got, want)
    if len(shape) == 2:
        ks = np.asarray(jax.random.split(jax.random.PRNGKey(9), shape[0]))
        want = np.asarray(jax.vmap(jax.random.categorical)(ks, logits))
        got = rnd.categorical_rows(torch.from_numpy(ks.view(np.int32)
                                                    .copy()),
                                   torch.from_numpy(logits)).numpy()
        np.testing.assert_array_equal(got, want)


def test_threefry_wrapper_refuses_bad_input():
    with pytest.raises(ValueError, match="int32"):
        tf.threefry_words(torch.zeros((2, 2), dtype=torch.int64), 4)
    with pytest.raises(ValueError, match="counter count"):
        tf.threefry_words(torch.zeros((2, 2), dtype=torch.int32), 0)
    # the kernel's words are the plain version's; base offsets the iota
    keys = rnd.split(rnd.PRNGKey(1, device="cpu"), 3)
    np.testing.assert_array_equal(
        tf.threefry_words(keys, 5, base=4)[:, 1:],
        tf.threefry_words(keys, 9)[:, 5:])
