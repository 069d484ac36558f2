"""The port's config, derived sizes and action table equal the JAX
package's for the five configs of bench.py."""

import dataclasses

import numpy as np
import pytest
import torch

from tile_match_tpu import config as jconfig
from tile_match_tpu.state import action_table as jax_action_table
from tile_match_tpu_torch import config as tconfig
from tile_match_tpu_torch.state import action_table

torch.set_num_threads(1)

# bench.py:61-67 — (R, C, colours, moves, colourless, colour)
BENCH_CONFIGS = [
    (5, 5, 3, 10, (), ()),
    (10, 10, 4, 30, (), ()),
    (10, 10, 4, 30, (), ("vertical_laser", "horizontal_laser", "bomb")),
    (10, 10, 4, 30, ("cookie",), ("vertical_laser", "horizontal_laser", "bomb")),
    (20, 20, 6, 100, ("cookie",), ("vertical_laser", "horizontal_laser", "bomb")),
]
DERIVED = (
    "colourless_specials", "colour_specials", "any_special", "flat_size",
    "num_actions", "line_len_max", "lines_max", "match_coords_max",
    "matches_max", "stack_max", "activation_steps_max",
)


@pytest.mark.parametrize("idx", range(len(BENCH_CONFIGS)))
def test_config_and_action_table_match_jax(idx):
    R, C, K, M, cl, co = BENCH_CONFIGS[idx]
    j = jconfig.EnvConfig.create(R, C, K, M, colourless_specials=cl, colour_specials=co)
    t = tconfig.EnvConfig.create(R, C, K, M, colourless_specials=cl, colour_specials=co)
    assert dataclasses.asdict(t) == dataclasses.asdict(j)
    for name in DERIVED:
        assert getattr(t, name) == getattr(j, name), name
    for got, want in zip(action_table(t), jax_action_table(j)):
        assert got.dtype == want.dtype and np.array_equal(got, want)
    assert hash(t) == hash(tconfig.EnvConfig.create(R, C, K, M, colourless_specials=cl, colour_specials=co))


def test_constants_match_jax():
    assert tconfig.TILE_TYPES == jconfig.TILE_TYPES
    for name in ("KIND_EMPTY", "KIND_NORMAL", "KIND_V_LASER", "KIND_H_LASER", "KIND_BOMB", "KIND_COOKIE"):
        assert getattr(tconfig, name) == getattr(jconfig, name)


def test_unknown_special_is_refused():
    with pytest.raises(ValueError):
        tconfig.EnvConfig.create(6, 6, 4, colour_specials=("rocket",))
