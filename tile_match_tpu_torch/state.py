"""Batched environment state and the action <-> coordinate table.

Counterpart of ``tile_match_tpu.state``.  Where the JAX package holds one
board per ``EnvState`` and vmaps over a batch, every tensor here carries the
batch as its leading dimension:

* ``colour`` / ``kind``: int32[B, R, C]
* ``timer``: int32[B]
* ``key``: int64[B, 2], the two raw threefry words of each board's key
  (uint32 values held in int64, see ``random.py``).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .config import EnvConfig


@dataclasses.dataclass
class EnvState:
    colour: torch.Tensor  # int32[B, R, C]
    kind: torch.Tensor  # int32[B, R, C]
    timer: torch.Tensor  # int32[B]
    key: torch.Tensor  # int64[B, 2] threefry words

    @property
    def board(self) -> torch.Tensor:
        """Layout of the original game's board: int32[B, 2, R, C]."""
        return torch.stack([self.colour, self.kind], dim=1)


@dataclasses.dataclass
class StepInfo:
    """Per-board counterpart of the original game's info dict."""

    is_combination_match: torch.Tensor  # bool[B]
    num_new_specials: torch.Tensor  # int32[B]
    num_specials_activated: torch.Tensor  # int32[B]
    shuffled: torch.Tensor  # bool[B]
    effective_actions: torch.Tensor  # bool[B, A]
    truncated: torch.Tensor  # bool[B]: a capacity or iteration cap fired
    cascade_trips: torch.Tensor  # int32[B]


def action_table(cfg: EnvConfig) -> tuple[np.ndarray, np.ndarray]:
    """Static action -> (coord1, coord2) table, int32[A, 2] each.

    The first C*(R-1) actions are down-swaps ((r,c),(r+1,c)) in row-major
    order; the remaining R*(C-1) are right-swaps ((r,c),(r,c+1)) in
    row-major order (`board.py:78-93` of the original game).
    """
    R, C = cfg.num_rows, cfg.num_cols
    c1 = []
    c2 = []
    for i in range(cfg.num_actions):
        if i < C * (R - 1):
            r, c = divmod(i, C)
            c1.append((r, c))
            c2.append((r + 1, c))
        else:
            j = i - C * (R - 1)
            r, c = divmod(j, C - 1)
            c1.append((r, c))
            c2.append((r, c + 1))
    return np.asarray(c1, dtype=np.int32), np.asarray(c2, dtype=np.int32)
