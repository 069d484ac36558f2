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


@pytest.mark.parametrize("lo,hi", [(None, None), (-0.5, 2.25), (float(np.finfo(np.float32).tiny), 1.0)])
@pytest.mark.parametrize("shape", [(1,), (1000,), (37, 19), (4, 5, 6)])
def test_uniform_word_for_word(shape, lo, hi):
    k = jax.random.PRNGKey(12)
    tk = torch.from_numpy(np.asarray(k).astype(np.int64))
    kw = {} if lo is None else dict(minval=lo, maxval=hi)
    want = np.asarray(jax.random.uniform(k, shape, **kw))
    got = trandom.uniform(tk, shape, **kw)
    assert got.dtype == torch.float32 and tuple(got.shape) == shape
    assert np.array_equal(got.numpy().view(np.uint32), want.view(np.uint32))


@pytest.mark.parametrize("B,A,p", [(1, 24, 0.3), (130, 40, 0.1), (257, 180, 0.2), (64, 7, 0.9)])
def test_categorical_equals_jax(B, A, p):
    """The Gumbel draw's uniforms word for word and the argmax board for
    board, over masks with rows that have no effective action."""
    rng = np.random.default_rng(B * A)
    mask = rng.random((B, A)) < p
    mask[::5] = False
    logits = np.where(mask, 0.0, -np.inf).astype(np.float32)
    k = jax.random.PRNGKey(B + A)
    tk = torch.from_numpy(np.asarray(k).astype(np.int64))
    tiny = float(np.finfo(np.float32).tiny)
    u_want = np.asarray(jax.random.uniform(k, (B, A), minval=tiny, maxval=1.0))
    u_got = trandom.uniform(tk, (B, A), minval=tiny, maxval=1.0).numpy()
    assert np.array_equal(u_got.view(np.uint32), u_want.view(np.uint32))
    want = np.asarray(jax.random.categorical(k, jnp.asarray(logits), axis=-1))
    got = trandom.categorical(tk, torch.from_numpy(logits), axis=-1).numpy()
    assert np.array_equal(got, want)
    assert mask[np.arange(B), got][mask.any(-1)].all()


def test_categorical_over_real_logits():
    k = jax.random.PRNGKey(4)
    tk = torch.from_numpy(np.asarray(k).astype(np.int64))
    logits = np.random.default_rng(3).normal(size=(300, 12)).astype(np.float32)
    want = np.asarray(jax.random.categorical(k, jnp.asarray(logits)))
    assert np.array_equal(trandom.categorical(tk, torch.from_numpy(logits)).numpy(), want)


@pytest.mark.parametrize("hi", [1, 7, 1000, 65537, 100_000, 2**31 - 1])
def test_randint_tensor_maxval(hi):
    """``maxval`` as an int32 tensor (a replay buffer's size) draws what
    the int does, spans above 2**16 included."""
    k = jax.random.PRNGKey(21)
    tk = torch.from_numpy(np.asarray(k).astype(np.int64))
    want = np.asarray(jax.random.randint(k, (500,), 0, jnp.int32(hi), dtype=jnp.int32))
    assert np.array_equal(trandom.randint(tk, (500,), 0, hi).numpy(), want)
    got = trandom.randint(tk, (500,), 0, torch.tensor(hi, dtype=torch.int32))
    assert got.dtype == torch.int32 and np.array_equal(got.numpy(), want)


def test_randint_empty_span_draws_minval():
    k = jax.random.PRNGKey(2)
    tk = torch.from_numpy(np.asarray(k).astype(np.int64))
    want = np.asarray(jax.random.randint(k, (8,), 0, jnp.maximum(jnp.int32(0), 0), dtype=jnp.int32))
    assert np.array_equal(trandom.randint(tk, (8,), 0, torch.tensor(0)).numpy(), want)
