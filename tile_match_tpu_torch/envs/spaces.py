"""Gymnasium space construction for tile-match configs.

Kept separate from the adapter class so batched/native front-ends can reuse
the same space definitions.  Bounds follow the reference contract
(`tile_match_env.py:52-77`): channel 0 (colour) spans ``0..num_colours``;
channel 1 (kind) spans ``-num_colourless_specials..num_colour_specials+2``
(``+1`` normal, ``+1`` empty); ``num_moves_left`` is ``Discrete(num_moves+1)``.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

import gymnasium as gym
from gymnasium.spaces import Box, Discrete

from ..config import EnvConfig


def board_box(cfg: EnvConfig, seed: Optional[int] = None) -> Box:
    """Box space for the raw (2, R, C) int32 board observation."""
    shape = (cfg.num_rows, cfg.num_cols)
    kind_floor = -len(cfg.colourless_specials)
    kind_ceil = len(cfg.colour_specials) + 2
    lo = np.stack(
        [np.zeros(shape, np.int32), np.full(shape, kind_floor, np.int32)]
    )
    hi = np.stack(
        [
            np.full(shape, cfg.num_colours, np.int32),
            np.full(shape, kind_ceil, np.int32),
        ]
    )
    return Box(low=lo, high=hi, shape=(2, *shape), dtype=np.int32, seed=seed)


def moves_left_space(cfg: EnvConfig, seed: Optional[int] = None) -> Discrete:
    return Discrete(cfg.num_moves + 1, seed=seed)


def dict_observation_space(
    cfg: EnvConfig, seed: Optional[int] = None
) -> gym.spaces.Dict:
    """The Dict observation contract shared by every front-end."""
    return gym.spaces.Dict(
        {
            "board": board_box(cfg, seed),
            "num_moves_left": moves_left_space(cfg, seed),
        }
    )


def action_discrete(cfg: EnvConfig, seed: Optional[int] = None) -> Discrete:
    """Discrete action space over the 2RC-R-C swap enumeration."""
    return Discrete(cfg.num_actions, seed=seed)


def make_spaces(
    cfg: EnvConfig, seed: Optional[int] = None
) -> Tuple[gym.spaces.Dict, Discrete]:
    return dict_observation_space(cfg, seed), action_discrete(cfg, seed)
