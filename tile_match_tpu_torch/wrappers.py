"""Observation and reward wrappers (counterpart of
``tile_match_tpu.wrappers``).

The original game's ``OneHotWrapper`` (`wrappers.py:16-69`) and
``ProportionRewardWrapper`` (`wrappers.py:71-77`) for the Gym adapter, on
host numpy observations, and ``one_hot_board``, the same encoding of a
batch of boards as one torch function on their device.  The wrapper
classes need gymnasium (None without it); ``one_hot_board`` does not.
"""

from __future__ import annotations

from collections import OrderedDict

import numpy as np
import torch

from .config import EnvConfig

# Hard-coded global special-id maps (`wrappers.py:9-10`): specials have fixed
# ids regardless of which are enabled.
COLOURLESS_SPECIALS = {"cookie": -1}
COLOUR_SPECIALS = {"vertical_laser": 2, "horizontal_laser": 3, "bomb": 4}
_GLOBAL_NUM_COLOURLESS = len(COLOURLESS_SPECIALS)
_GLOBAL_NUM_COLOUR = len(COLOUR_SPECIALS)


def _enabled_type_slices(colourless_specials, colour_specials) -> np.ndarray:
    """Slice indices into the global type one-hot for the enabled specials.

    `wrappers.py:40-46`: kind k maps to slice k + 1 (shift by the number of
    global colourless specials); the enabled slices are selected sorted.
    """
    ids = [
        idx
        for special, idx in {**COLOURLESS_SPECIALS, **COLOUR_SPECIALS}.items()
        if special in colour_specials or special in colourless_specials
    ]
    return np.array(sorted(ids)) + _GLOBAL_NUM_COLOURLESS


def one_hot_board(cfg: EnvConfig, board: torch.Tensor) -> torch.Tensor:
    """One-hot encoding of boards (`wrappers.py:54-69`): int32[B, 2, R, C]
    -> float32[B, num_colours + enabled specials, R, C].  First the colour
    planes 1..K (no plane for colourless cells), then one plane per enabled
    special in global-id order: cookie, vertical laser, horizontal laser,
    bomb."""
    colour, kind = board[:, 0], board[:, 1]
    ids = torch.arange(1, cfg.num_colours + 1, device=board.device, dtype=colour.dtype)
    planes = [colour[:, None] == ids[None, :, None, None]]
    specials = [k for k, on in ((-1, cfg.cookie), (2, cfg.vertical_laser),
                                (3, cfg.horizontal_laser), (4, cfg.bomb)) if on]
    if specials:
        sp = torch.tensor(specials, device=board.device, dtype=kind.dtype)
        planes.append(kind[:, None] == sp[None, :, None, None])
    return torch.cat(planes, dim=1).to(torch.float32)


# ---------------------------------------------------------------------------
# Gymnasium wrappers (optional dependency)
# ---------------------------------------------------------------------------
try:  # pragma: no cover - import guard
    import gymnasium as gym
    from gymnasium import ObservationWrapper, RewardWrapper
    from gymnasium.spaces import Box

    class OneHotWrapper(ObservationWrapper):
        """`wrappers.py:16-69`: Dict obs with one-hot board planes."""

        def __init__(self, env):
            super().__init__(env)
            u = self.unwrapped
            self.num_colours = u.num_colours
            self.num_rows = u.num_rows
            self.num_cols = u.num_cols
            self.num_colour_specials = u.num_colour_specials
            self.num_colourless_specials = u.num_colourless_specials
            n_planes = (
                self.num_colours
                + self.num_colour_specials
                + self.num_colourless_specials
            )
            self.board_obs_space = Box(
                low=0,
                high=1,
                dtype=np.int32,
                shape=(n_planes, self.num_rows, self.num_cols),
            )
            self.observation_space = gym.spaces.Dict(
                {
                    "board": self.board_obs_space,
                    "num_moves_left": u.observation_space["num_moves_left"],
                }
            )
            self.type_slices = _enabled_type_slices(
                u.colourless_specials, u.colour_specials
            )
            self.num_type_slices = len(self.type_slices)

        def observation(self, obs) -> dict:
            board = obs["board"]
            return OrderedDict(
                [
                    ("board", self._one_hot_encode_board(board)),
                    ("num_moves_left", obs["num_moves_left"]),
                ]
            )

        def _one_hot_encode_board(self, board: np.ndarray) -> np.ndarray:
            colour, kind = board[0], board[1]
            colour_ohe = (
                colour[None, :, :]
                == (1 + np.arange(self.num_colours))[:, None, None]
            ).astype(np.float64)
            out = colour_ohe
            if self.num_type_slices > 0:
                # global type one-hot has planes for kinds -1,0,1,2,3,4 at
                # slices kind+1; select the enabled specials' slices.
                enabled_kinds = self.type_slices - _GLOBAL_NUM_COLOURLESS
                type_ohe = (
                    kind[None, :, :] == enabled_kinds[:, None, None]
                ).astype(np.float64)
                out = np.concatenate([out, type_ohe], axis=0)
            return out

    class ProportionRewardWrapper(RewardWrapper):
        """`wrappers.py:71-77`: reward normalised by board area."""

        def __init__(self, env):
            super().__init__(env)
            self.flat_size = self.unwrapped.num_rows * self.unwrapped.num_cols

        def reward(self, reward: float):
            return reward / self.flat_size

except ImportError:  # pragma: no cover
    OneHotWrapper = None
    ProportionRewardWrapper = None
