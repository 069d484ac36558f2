"""Gymnasium front-end over the parity and threefry engines (counterpart
of ``tile_match_tpu.envs.gym_env``).

A drop-in for the original game's ``TileMatchEnv`` (`tile_match_env.py:
14-150`): the same constructor signature, Dict observation, info keys,
reward (the raw elimination count) and step-before-reset raise, plus
``device`` at the end — None means the CUDA card, and no card raises.  The
game state lives in an engine chosen by ``rng_mode``:

* ``"numpy"`` (default): :class:`~tile_match_tpu_torch.parity.ParityEngine`,
  the original game's trajectories bit for bit under the same seed;
* ``"threefry"``: :class:`ThreefryDriver`, the batched engine on one board,
  which launches the port's CUDA kernels on the card.
"""

from __future__ import annotations

from collections import OrderedDict
from typing import List, Optional, Tuple, Union

import numpy as np

import gymnasium as gym

from .. import register_envs
from ..config import EnvConfig
from ..state import action_table
from . import spaces as _spaces

#: info-dict field order of the reference step() (`tile_match_env.py:103-109`).
_STEP_STATS = (
    "is_combination_match",
    "num_new_specials",
    "num_specials_activated",
    "shuffled",
)


def _make_engine(cfg: EnvConfig, rng_mode: str, seed, device):
    if rng_mode == "numpy":
        from ..parity import ParityEngine

        return ParityEngine(cfg, np.random.default_rng(seed), device)
    if rng_mode == "threefry":
        from ._threefry_driver import ThreefryDriver

        return ThreefryDriver(cfg, seed, device)
    raise ValueError(f"unknown rng_mode: {rng_mode}")


class TileMatchEnv(gym.Env):
    metadata = {"render_modes": ["string", "human", "rgb_array"], "render_fps": 2}

    def __init__(
        self,
        num_rows: int,
        num_cols: int,
        num_colours: int,
        num_moves: int,
        colourless_specials: List[str],
        colour_specials: List[str],
        seed: Optional[int] = 1,
        render_mode: str = "string",
        rng_mode: str = "numpy",
        device=None,
    ) -> None:
        cfg = EnvConfig.create(
            num_rows, num_cols, num_colours, num_moves,
            colourless_specials, colour_specials,
        )
        self.cfg = cfg
        self.seed = seed
        self.rng_mode = rng_mode
        self.render_mode = render_mode
        self.timer: Optional[int] = None

        # mirror the reference's public attribute surface
        self.num_rows, self.num_cols = num_rows, num_cols
        self.num_colours = num_colours
        self.num_moves = num_moves
        self.num_actions = cfg.num_actions
        self.colourless_specials = list(colourless_specials)
        self.colour_specials = list(colour_specials)
        self.num_colour_specials = len(colour_specials)
        self.num_colourless_specials = len(colourless_specials)

        self.engine = _make_engine(cfg, rng_mode, seed, device)
        self._init_renderer()

        self.observation_space, self.action_space = _spaces.make_spaces(cfg, seed)
        starts, ends = action_table(cfg)
        self._action_to_coords = tuple(
            (tuple(map(int, a)), tuple(map(int, b)))
            for a, b in zip(starts, ends)
        )

    # -- engine-facing helpers ------------------------------------------------

    def _init_renderer(self) -> None:
        self.renderer = None
        self._palette = None
        if self.render_mode == "string":
            from ..rendering.string_renderer import default_colour_map

            self._palette = default_colour_map(self.num_colours, self.seed)
        elif self.render_mode in ("human", "rgb_array"):
            from ..rendering.pygame_renderer import Renderer

            self.renderer = Renderer(
                self.num_rows, self.num_cols, self.num_colours, self.num_moves,
                render_fps=self.metadata["render_fps"],
                render_mode=self.render_mode,
            )

    def _moves_left(self) -> int:
        return self.num_moves - self.timer

    def _observe(self) -> "OrderedDict":
        return OrderedDict(
            [("board", self.engine.board), ("num_moves_left", self._moves_left())]
        )

    def _live_actions(self) -> List[int]:
        # done episodes report no effective actions (reference behaviour)
        if self.timer == self.num_moves:
            return []
        return np.flatnonzero(self.engine.effective_mask()).tolist()

    # -- gym protocol ----------------------------------------------------------

    def set_seed(self, seed: int) -> None:
        self.action_space.seed(seed)
        self.observation_space.seed(seed)
        self.engine.reseed(seed)

    def reset(
        self, seed: Optional[int] = None, options: Optional[dict] = None
    ) -> Tuple[dict, dict]:
        if seed is not None:
            self.set_seed(seed)
        super().reset(seed=seed)  # gym bookkeeping only; engine owns the RNG
        self.engine.generate_board()
        self.timer = 0
        return self._observe(), {"effective_actions": self._live_actions()}

    def step(self, action: int) -> Tuple[dict, int, bool, bool, dict]:
        if self.timer is None or self.timer >= self.num_moves:
            raise Exception("You must call reset before calling step")
        stats = self.engine.move(*self._action_to_coords[action])
        self.timer += 1
        reward = int(stats[0])
        casts = (bool, int, int, bool)  # field types per reference info dict
        info = {k: f(v) for k, f, v in zip(_STEP_STATS, casts, stats[1:])}
        info["effective_actions"] = self._live_actions()
        done = self.timer == self.num_moves
        return self._observe(), reward, done, False, info

    def render(self) -> Union[None, np.ndarray]:
        if self.render_mode != "string":
            return self.renderer.render(self.engine.board, self._moves_left())
        from ..rendering.string_renderer import render_ansi

        print(render_ansi(self.engine.board, self._palette))
        return None

    def close(self) -> None:
        if self.renderer is not None:
            self.renderer.close()

    # -- reference-style aliases (migration compatibility) ---------------------
    # convenience for parity with reference examples accessing env.board
    @property
    def board(self):
        return self.engine

    _get_obs = _observe
    _get_effective_actions = _live_actions


register_envs()
