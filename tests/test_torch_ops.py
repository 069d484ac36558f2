"""The port's board ops equal ``jax.vmap`` of the JAX package's, exactly,
on 6x6, 7x9 and 10x10 boards made from a numpy seed."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from tile_match_tpu.config import EnvConfig as JaxConfig
from tile_match_tpu.ops import board_ops as jb
from tile_match_tpu.ops import effective as je
from tile_match_tpu.ops import lines as jl
from tile_match_tpu.ops import runs as jr
from tile_match_tpu_torch.config import EnvConfig
from tile_match_tpu_torch.ops import board_ops as tb
from tile_match_tpu_torch.ops import effective as te
from tile_match_tpu_torch.ops import lines as tl
from tile_match_tpu_torch.ops import runs as tr

torch.set_num_threads(1)

SHAPES = [(6, 6, 3), (7, 9, 4), (10, 10, 4)]
B = 130


def _cfgs(R, C, K, specials=False):
    kw = {} if specials else dict(colourless_specials=(), colour_specials=())
    return JaxConfig.create(R, C, K, 10, **kw), EnvConfig.create(R, C, K, 10, **kw)


def _colour(R, C, K, seed, lo=1):
    rng = np.random.default_rng(seed)
    return rng.integers(lo, K + 1, size=(B, R, C)).astype(np.int32)


def _eq(got, want):
    got = got.numpy() if torch.is_tensor(got) else got
    want = np.asarray(want)
    assert got.shape == want.shape
    assert np.array_equal(got, want)


@pytest.mark.parametrize("R,C,K", SHAPES)
@pytest.mark.parametrize("axis", [0, 1])
def test_colour_run_extents(R, C, K, axis):
    colour = _colour(R, C, K, seed=R + axis, lo=0)  # zeros never join runs
    want = jax.vmap(lambda x: jr.colour_run_extents(x, axis))(jnp.asarray(colour))
    got = tr.colour_run_extents(torch.from_numpy(colour), axis - 2)
    for g, w in zip(got, want):
        _eq(g, w)


@pytest.mark.parametrize("R,C,K", SHAPES)
@pytest.mark.parametrize("axis", [0, 1])
def test_true_run_extents(R, C, K, axis):
    flag = np.random.default_rng(R * C + axis).random((B, R, C)) < 0.6
    want = jax.vmap(lambda x: jr.true_run_extents(x, axis))(jnp.asarray(flag))
    got = tr.true_run_extents(torch.from_numpy(flag), axis - 2)
    for g, w in zip(got, want):
        _eq(g, w)


@pytest.mark.parametrize("R,C,K", SHAPES)
def test_line_union_mask(R, C, K):
    jc, tc = _cfgs(R, C, K)
    colour = _colour(R, C, K, seed=11 * R)
    want = jax.vmap(lambda x: jl.line_union_mask(jc, x))(jnp.asarray(colour))
    _eq(tl.line_union_mask(tc, torch.from_numpy(colour)), want)


@pytest.mark.parametrize("R,C,K", SHAPES)
def test_run_member_and_has_any_line(R, C, K):
    jc, tc = _cfgs(R, C, K)
    colour = _colour(R, C, K + 2, seed=13 * R)  # more colours: some line-free
    x = jnp.asarray(colour)
    t = torch.from_numpy(colour)
    _eq(tl.run_member_mask(tc, t), jax.vmap(lambda c: jl.run_member_mask(jc, c))(x))
    has = jax.vmap(lambda c: jl.has_any_line(jc, c, jnp.ones_like(c)))(x)
    _eq(tl.has_any_line(tc, t), has)
    assert not np.asarray(has).all()


@pytest.mark.parametrize("R,C,K", SHAPES)
def test_first_line_info(R, C, K):
    jc, tc = _cfgs(R, C, K)
    colour = _colour(R, C, K + 1, seed=17 * R)
    want = jax.vmap(lambda c: jl.first_line_info(jc, c))(jnp.asarray(colour))
    got = tl.first_line_info(tc, torch.from_numpy(colour))
    for g, w in zip(got, want):
        _eq(g, w)


@pytest.mark.parametrize("R,C,K", SHAPES)
def test_swap_cells(R, C, K):
    rng = np.random.default_rng(R)
    colour = _colour(R, C, K, seed=19)
    kind = rng.integers(-1, 5, size=(B, R, C)).astype(np.int32)
    down = rng.random(B) < 0.5
    r1 = np.where(down, rng.integers(0, R - 1, B), rng.integers(0, R, B))
    c1 = np.where(down, rng.integers(0, C, B), rng.integers(0, C - 1, B))
    c1s = np.stack([r1, c1], 1).astype(np.int32)
    c2s = np.stack([r1 + down, c1 + ~down], 1).astype(np.int32)
    want = jax.vmap(jb.swap_cells)(
        jnp.asarray(colour), jnp.asarray(kind), jnp.asarray(c1s), jnp.asarray(c2s)
    )
    got = tb.swap_cells(
        torch.from_numpy(colour), torch.from_numpy(kind),
        torch.from_numpy(c1s), torch.from_numpy(c2s),
    )
    for g, w in zip(got, want):
        _eq(g, w)


@pytest.mark.parametrize("R,C,K", SHAPES)
def test_gravity_and_refill(R, C, K):
    rng = np.random.default_rng(23 * R)
    colour = _colour(R, C, K, seed=23)
    kind = rng.integers(-1, 5, size=(B, R, C)).astype(np.int32)
    holes = rng.random((B, R, C)) < 0.3
    colour[holes] = 0
    kind[holes] = 0
    colour[(kind == -1)] = 0  # cookies are colourless but not empty
    jcol, jkind = jax.vmap(jb.gravity)(jnp.asarray(colour), jnp.asarray(kind))
    tcol, tkind = tb.gravity(torch.from_numpy(colour), torch.from_numpy(kind))
    _eq(tcol, jcol)
    _eq(tkind, jkind)

    grid = _colour(R, C, K, seed=29)
    want = jax.vmap(jb.apply_refill)(jcol, jkind, jnp.asarray(grid))
    got = tb.apply_refill(tcol, tkind, torch.from_numpy(grid))
    for g, w in zip(got, want):
        _eq(g, w)


@pytest.mark.parametrize("R,C,K", SHAPES)
def test_apply_shuffle(R, C, K):
    colour = _colour(R, C, K, seed=31)
    kind = np.random.default_rng(31).integers(-1, 5, size=(B, R, C)).astype(np.int32)
    keys = jax.random.split(jax.random.PRNGKey(R), B)
    perm = np.array(jax.vmap(lambda k: jax.random.permutation(k, R * C))(keys))
    want = jax.vmap(jb.apply_shuffle)(
        jnp.asarray(colour), jnp.asarray(kind), jnp.asarray(perm.astype(np.int32))
    )
    got = tb.apply_shuffle(
        torch.from_numpy(colour), torch.from_numpy(kind), torch.from_numpy(perm)
    )
    for g, w in zip(got, want):
        _eq(g, w)


@pytest.mark.parametrize("R,C,K", SHAPES)
def test_apply_reroll_rows(R, C, K):
    colour = _colour(R, C, K, seed=37)
    grid = _colour(R, C, K, seed=41)
    bound = np.random.default_rng(43).integers(-1, R, B).astype(np.int32)
    want = jax.vmap(jb.apply_reroll_rows)(
        jnp.asarray(colour), jnp.asarray(bound), jnp.asarray(grid)
    )
    got = tb.apply_reroll_rows(
        torch.from_numpy(colour), torch.from_numpy(bound), torch.from_numpy(grid)
    )
    _eq(got, want)


@pytest.mark.parametrize("R,C,K", SHAPES)
def test_draw_colour_grid(R, C, K):
    jc, tc = _cfgs(R, C, K)
    keys = jax.random.split(jax.random.PRNGKey(47), B)
    want = jax.vmap(lambda k: jb.draw_colour_grid(k, jc))(keys)
    got = tb.draw_colour_grid(torch.from_numpy(np.asarray(keys).astype(np.int64)), tc)
    _eq(got, want)


@pytest.mark.parametrize("R,C,K", SHAPES)
@pytest.mark.parametrize("specials", [False, True])
def test_effective_mask_settled(R, C, K, specials):
    """The formula, on arbitrary boards (lined or not, any kinds)."""
    jc, tc = _cfgs(R, C, K, specials=specials)
    colour = _colour(R, C, K + 1, seed=53 * R)
    if specials:
        kind = np.random.default_rng(59).integers(-1, 5, size=(B, R, C)).astype(np.int32)
    else:
        kind = np.ones((B, R, C), np.int32)
    want = jax.vmap(lambda c, k: je.effective_mask_settled(jc, c, k))(
        jnp.asarray(colour), jnp.asarray(kind)
    )
    got = te.effective_mask_settled(tc, torch.from_numpy(colour), torch.from_numpy(kind))
    assert got.dtype == torch.bool
    _eq(got, want)
