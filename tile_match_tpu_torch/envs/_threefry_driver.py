"""The threefry engine behind the Gym adapter, one board at a time
(counterpart of ``tile_match_tpu.envs._threefry_driver``).

``ThreefryDriver`` has ``ParityEngine``'s surface and runs the batched
engine on a batch of one board: ``generate_board`` and ``engine_move``, so
every move launches the port's kernels on a CUDA device — K1 without
specials, K2 and K3 with them.  The key is the port's pair of threefry
words; it starts from ``PRNGKey(seed)``, ``PRNGKey(0)`` when ``seed`` is
None.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import random as trandom
from ..config import EnvConfig
from ..cuda_build import resolve_device
from ..engine import engine_move, generate_board
from ..ops.effective import effective_mask
from ..parity import action_index
from ..state import action_table


class ThreefryDriver:
    def __init__(self, cfg: EnvConfig, seed, device=None):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.key = trandom.PRNGKey(0 if seed is None else seed, self.device)
        self._board = np.zeros((2, cfg.num_rows, cfg.num_cols), np.int32)
        self._board[1] = 1
        c1, c2 = action_table(cfg)
        self._c1 = torch.as_tensor(c1, device=self.device)
        self._c2 = torch.as_tensor(c2, device=self.device)

    def reseed(self, seed: int) -> None:
        self.key = trandom.PRNGKey(seed, self.device)

    @property
    def colour(self) -> np.ndarray:
        return self._board[0]

    @property
    def kind(self) -> np.ndarray:
        return self._board[1]

    @property
    def board(self) -> np.ndarray:
        """The live [2, R, C] buffer (edits are honoured)."""
        return self._board

    def _tensors(self):
        return (
            torch.tensor(self.colour, device=self.device)[None],
            torch.tensor(self.kind, device=self.device)[None],
        )

    def _set(self, colour, kind) -> None:
        self._board[0] = colour[0].cpu().numpy()
        self._board[1] = kind[0].cpu().numpy()

    def generate_board(self) -> None:
        colour, kind, key, _mask, _gave_up = generate_board(self.cfg, self.key[None])
        self._set(colour, kind)
        self.key = key[0]

    def _mask(self) -> torch.Tensor:
        return effective_mask(self.cfg, *self._tensors())

    def effective_mask(self) -> np.ndarray:
        return self._mask()[0].cpu().numpy()

    def possible_move(self) -> bool:
        return bool(self.effective_mask().any())

    def move(self, coord1, coord2):
        """Returns (eliminations, is_combination, new specials, activated,
        shuffled); a move that does nothing keeps the board and the key."""
        a = action_index(self.cfg, coord1, coord2)
        if a is None:
            raise ValueError(f"Invalid move: {coord1}, {coord2}")
        cur_mask = self._mask()  # the windowed mask, as in the original game
        eff = cur_mask[:, a]
        colour, kind, key, elim, comb, new, act, shuf, _post, _trunc, _trips = engine_move(
            self.cfg, *self._tensors(), self.key[None], self._c1[a][None], self._c2[a][None],
            eff, cur_mask,
        )
        self._set(colour, kind)
        self.key = key[0]
        return int(elim[0]), bool(comb[0]), int(new[0]), int(act[0]), bool(shuf[0])
