"""The port's threefry equals ``jax.random`` word for word (partitionable
threefry, the JAX default)."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from tile_match_tpu_torch import random as trandom

torch.set_num_threads(1)


def _keys(seed, n):
    """n raw JAX keys and the same words as the port's int64 keys."""
    keys = jax.random.split(jax.random.PRNGKey(seed), n)
    return keys, torch.from_numpy(np.asarray(keys).astype(np.int64))


def test_partitionable_threefry_is_on():
    assert jax.config.jax_threefry_partitionable


@pytest.mark.parametrize("seed", [0, 1, 12345, -7])
def test_prng_key(seed):
    want = np.asarray(jax.random.PRNGKey(seed))
    assert np.array_equal(trandom.PRNGKey(seed, "cpu").numpy(), want)


@pytest.mark.parametrize("num", [2, 130])
def test_split(num):
    jk, tk = _keys(3, 17)
    want = np.asarray(jax.vmap(lambda k: jax.random.split(k, num))(jk))
    got = trandom.split(tk, num).numpy()
    assert got.shape == (17, num, 2)
    assert np.array_equal(got, want)


def test_split_single_key():
    k = jax.random.PRNGKey(11)
    got = trandom.split(trandom.PRNGKey(11, "cpu"), 130).numpy()
    assert np.array_equal(got, np.asarray(jax.random.split(k, 130)))


@pytest.mark.parametrize("data", [0, 1, 63, 2**31 - 1])
def test_fold_in(data):
    jk, tk = _keys(5, 33)
    want = np.asarray(jax.vmap(lambda k: jax.random.fold_in(k, data))(jk))
    assert np.array_equal(trandom.fold_in(tk, data).numpy(), want)


def test_fold_in_per_board_data():
    jk, tk = _keys(6, 40)
    data = np.arange(40, dtype=np.int32) * 3
    want = np.asarray(jax.vmap(jax.random.fold_in)(jk, jnp.asarray(data)))
    got = trandom.fold_in(tk, torch.from_numpy(data)).numpy()
    assert np.array_equal(got, want)


@pytest.mark.parametrize("shape,lo,hi", [((10, 10), 1, 5), ((6, 6), 1, 4), ((7, 9), 1, 7), ((20, 20), 0, 1000)])
def test_randint(shape, lo, hi):
    jk, tk = _keys(7, 130)
    want = np.asarray(jax.vmap(lambda k: jax.random.randint(k, shape, lo, hi, jnp.int32))(jk))
    got = trandom.randint(tk, shape, lo, hi)
    assert got.dtype == torch.int32
    assert np.array_equal(got.numpy(), want)


def test_random_bits():
    jk, tk = _keys(8, 9)
    want = np.asarray(jax.vmap(lambda k: jax.random.bits(k, (5, 7), jnp.uint32))(jk))
    assert np.array_equal(trandom.random_bits(tk, (5, 7)).numpy(), want.astype(np.int64))


@pytest.mark.parametrize("n", [25, 36, 100, 400])
def test_permutation(n):
    jk, tk = _keys(9, 24)
    want = np.asarray(jax.vmap(lambda k: jax.random.permutation(k, n))(jk))
    got = trandom.permutation(tk, n).numpy()
    assert np.array_equal(got, want)
    assert np.array_equal(np.sort(got, axis=-1), np.broadcast_to(np.arange(n), got.shape))
