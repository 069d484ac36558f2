"""Bit-exact numpy-RNG parity mode (counterpart of ``tile_match_tpu.parity``).

The original game draws every random number from one ``np.random.
Generator``, in order, across generate, re-roll, shuffle and refill
(`board.py:97, 116, 129, 239`).  Threefry cannot reproduce that stream, so
``ParityEngine`` keeps the game loop on the host and issues the same numpy
calls in the same order, while every board transform runs as the port's
torch ops on ``device``, as a batch of one board: swap, combination and
gravity, one cascade trip (lines, classify, resolve, gravity), refill,
the first line's row, shuffle, the row re-roll and the windowed
effective mask.  It runs the full machinery on every trip and launches no
CUDA kernel of the port.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from .config import EnvConfig
from .cuda_build import resolve_device
from .ops.board_ops import (
    apply_refill,
    apply_reroll_rows,
    apply_shuffle,
    gravity,
    num_empty,
    swap_cells,
)
from .ops.classify import process_colour_lines
from .ops.combination import combination_match
from .ops.effective import effective_mask
from .ops.lines import first_line_info, get_colour_lines
from .ops.resolve import resolve_colour_matches
from .state import action_table


@functools.lru_cache(maxsize=None)
def _action_ids(cfg: EnvConfig) -> dict:
    c1, c2 = action_table(cfg)
    return {(tuple(a), tuple(b)): i for i, (a, b) in enumerate(zip(c1.tolist(), c2.tolist()))}


def action_index(cfg: EnvConfig, coord1, coord2):
    """The action that swaps coord1 with coord2, or None."""
    key = ((int(coord1[0]), int(coord1[1])), (int(coord2[0]), int(coord2[1])))
    return _action_ids(cfg).get(key)


class ParityEngine:
    """Host-driven engine with the original game's numpy RNG consumption."""

    def __init__(self, cfg: EnvConfig, np_random: np.random.Generator, device=None):
        self.cfg = cfg
        self.np_random = np_random
        self.device = resolve_device(device)
        # one live [2, R, C] buffer: code written against the original game
        # edits ``env.board.board[0]`` in place, and every call reads it
        self._board = np.zeros((2, cfg.num_rows, cfg.num_cols), np.int32)
        self._board[1] = 1
        self.num_specials_activated = 0
        self.num_new_specials = 0

    def reseed(self, seed: int) -> None:
        """`tile_match_env.py:79-82`: replace the board's generator."""
        self.np_random = np.random.default_rng(seed)

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

    def _t(self, a) -> torch.Tensor:
        """A host array as a batch of one on the device."""
        return torch.tensor(np.asarray(a), device=self.device)[None]

    def _tensors(self):
        return self._t(self.colour), self._t(self.kind)

    def _set(self, colour, kind) -> None:
        self._board[0] = colour[0].cpu().numpy()
        self._board[1] = kind[0].cpu().numpy()

    def effective_mask(self) -> np.ndarray:
        return effective_mask(self.cfg, *self._tensors())[0].cpu().numpy()

    def possible_move(self) -> bool:
        return bool(self.effective_mask().any())

    def _draw_grid(self, n_cells) -> np.ndarray:
        return self.np_random.integers(1, self.cfg.num_colours + 1, int(n_cells)).astype(np.int32)

    def _refill(self) -> None:
        """`board.py:231-241`: draw exactly one colour per empty cell, in
        row-major order."""
        empty = (self.colour == 0) & (self.kind == 0)
        n = int(empty.sum())
        if n > 0:
            grid = np.zeros_like(self.colour)
            grid[empty] = self._draw_grid(n)
            self._set(*apply_refill(*self._tensors(), self._t(grid)))

    def _shuffle(self) -> None:
        """`board.py:114-118`."""
        perm = np.arange(self.cfg.flat_size)
        self.np_random.shuffle(perm)
        self._set(*apply_shuffle(*self._tensors(), self._t(perm)))

    def _line_info(self):
        has, top = first_line_info(self.cfg, self._t(self.colour))
        return bool(has[0]), int(top[0])

    def _remove_colour_lines(self, top_row: int) -> None:
        """`board.py:120-131`: re-roll rows 0..top+1 until no line remains."""
        R, C = self.cfg.num_rows, self.cfg.num_cols
        has, top = True, top_row
        while has:
            bound = min(R - 1, top + 1)
            grid = np.zeros_like(self.colour)
            grid[: bound + 1, :] = self._draw_grid((bound + 1) * C).reshape(bound + 1, C)
            bound_t = torch.tensor([bound], device=self.device)
            self._board[0] = apply_reroll_rows(self._t(self.colour), bound_t, self._t(grid))[0].cpu().numpy()
            has, top = self._line_info()

    def _playability_loop(self, has_lines: bool, top: int) -> bool:
        """`board.py:102-109, 381-391`: re-roll lines, shuffle dead boards."""
        shuffled = False
        while (not self.possible_move()) or has_lines:
            if has_lines:
                self._remove_colour_lines(top)
            else:
                shuffled = True
                self._shuffle()
            has_lines, top = self._line_info()
        return shuffled

    def generate_board(self) -> None:
        """`board.py:95-112`."""
        cfg = self.cfg
        self._board[1] = 1
        self._board[0] = self._draw_grid(cfg.flat_size).reshape(cfg.num_rows, cfg.num_cols)
        self._playability_loop(*self._line_info())

    def move(self, coord1, coord2):
        """`board.py:330-395`.  Returns the original game's stats:
        (eliminations, is_combination, new specials, activated, shuffled)."""
        cfg = self.cfg
        self.num_specials_activated = 0
        self.num_new_specials = 0
        num_eliminations = 0
        is_comb = False

        a = action_index(cfg, coord1, coord2)
        if a is None:
            raise ValueError(f"Invalid move: {coord1}, {coord2}")
        if not self.effective_mask()[a]:
            return 0, False, 0, 0, False

        c1 = self._t(np.asarray(coord1, np.int32))
        c2 = self._t(np.asarray(coord2, np.int32))
        self._set(*swap_cells(*self._tensors(), c1, c2))

        k1 = self.kind[coord1[0], coord1[1]]
        k2 = self.kind[coord2[0], coord2[1]]
        if (k1 not in (0, 1) and k2 not in (0, 1)) or k1 < 0 or k2 < 0:
            is_comb = True
            colour, kind, act, _ovf = combination_match(cfg, *self._tensors(), c1, c2)
            # eliminations are the empty cells before gravity (`board.py:362`)
            num_eliminations += int(num_empty(colour, kind)[0])
            self._set(*gravity(colour, kind))
            self.num_specials_activated += int(act[0])
            self._refill()

        while True:
            colour, kind = self._tensors()
            matches = process_colour_lines(cfg, colour, get_colour_lines(cfg, colour))
            if int(matches.count[0]) == 0:
                break
            colour, kind, act, new, _ovf = resolve_colour_matches(cfg, colour, kind, matches)
            # counted before gravity (`board.py:374`)
            num_eliminations += int(num_empty(colour, kind)[0])
            self._set(*gravity(colour, kind))
            self.num_specials_activated += int(act[0])
            self.num_new_specials += int(new[0])
            self._refill()

        num_eliminations += self.num_new_specials
        shuffled = self._playability_loop(False, 0)
        return (
            num_eliminations,
            is_comb,
            self.num_new_specials,
            self.num_specials_activated,
            shuffled,
        )
