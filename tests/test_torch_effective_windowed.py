"""The windowed effective mask of the Gym adapter equals the JAX package's
``effective_mask`` exactly — on random boards (which hold lines, so
pre-existing runs in a window count), on boards with sprinkled specials,
and on non-square shapes — and equals ``effective_mask_settled`` on
line-free boards; ``possible_move`` and ``num_empty`` follow."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from tests.test_torch_specials import sprinkled
from tile_match_tpu.config import EnvConfig as JaxConfig
from tile_match_tpu.ops import board_ops as jbo
from tile_match_tpu.ops import effective as jeff
from tile_match_tpu_torch import engine as te
from tile_match_tpu_torch import random as trandom
from tile_match_tpu_torch.config import EnvConfig
from tile_match_tpu_torch.ops import board_ops as tbo
from tile_match_tpu_torch.ops import effective as teff

torch.set_num_threads(1)

SHAPES = [(6, 6, 3), (5, 8, 3), (9, 4, 2), (10, 10, 4), (2, 7, 3), (7, 2, 3), (3, 3, 2)]


def _jax_mask(R, C, K, colour, kind):
    jc = JaxConfig.create(R, C, K)
    return np.asarray(jax.vmap(lambda c, k: jeff.effective_mask(jc, c, k))(jnp.asarray(colour),
                                                                          jnp.asarray(kind)))


@pytest.mark.parametrize("R,C,K", SHAPES)
def test_effective_mask_matches_jax(R, C, K):
    rng = np.random.default_rng(R * 100 + C)
    plain = rng.integers(1, K + 1, size=(24, R, C)).astype(np.int32)
    dotted, dkind = sprinkled(R, C, K, 24, seed=R * C, n_max=8)
    colour = np.concatenate([plain, dotted])
    kind = np.concatenate([np.ones_like(plain), dkind])
    tc = EnvConfig.create(R, C, K)
    got = teff.effective_mask(tc, torch.from_numpy(colour), torch.from_numpy(kind))
    want = _jax_mask(R, C, K, colour, kind)
    assert got.dtype == torch.bool and got.shape == (48, tc.num_actions)
    assert np.array_equal(got.numpy(), want)
    assert np.array_equal(teff.possible_move(tc, torch.from_numpy(colour), torch.from_numpy(kind)).numpy(),
                          want.any(-1))
    assert 0 < want.mean() < 1


@pytest.mark.parametrize("R,C,K", [(6, 6, 3), (5, 8, 4), (10, 10, 4)])
def test_windowed_equals_settled_on_line_free_boards(R, C, K):
    tc = EnvConfig.create(R, C, K)
    keys = trandom.split(trandom.PRNGKey(R + C, "cpu"), 32)
    colour, kind, _key, mask, _gave_up = te.generate_board(tc, keys)
    kind = kind.clone()
    # specials on the line-free boards: kind changes no colour run
    rng = np.random.default_rng(R)
    cells = torch.from_numpy(rng.integers(0, R * C, size=(32, 3)))
    kind.view(32, -1).scatter_(1, cells, torch.from_numpy(rng.choice([2, 3, 4], size=(32, 3))).int())
    got = teff.effective_mask(tc, colour, kind)
    assert torch.equal(got, teff.effective_mask_settled(tc, colour, kind))
    assert np.array_equal(got.numpy(), _jax_mask(R, C, K, colour.numpy(), kind.numpy()))


def test_num_empty_matches_jax():
    rng = np.random.default_rng(0)
    colour = rng.integers(0, 3, size=(16, 5, 6)).astype(np.int32)
    kind = np.where(colour == 0, rng.choice([0, -1], size=colour.shape), 1).astype(np.int32)
    want = np.asarray(jax.vmap(jbo.num_empty)(jnp.asarray(colour), jnp.asarray(kind)))
    got = tbo.num_empty(torch.from_numpy(colour), torch.from_numpy(kind))
    assert got.dtype == torch.int32 and np.array_equal(got.numpy(), want)
