"""The action <-> coordinate table and the batched state of the reference.

``EnvState`` holds a batch of boards, the batch first: ``colour`` and
``kind`` int32[B, R, C], ``timer`` int32[B], ``key`` int64[B, 2] (the two
raw threefry words of each board's key, uint32 values in int64).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .config import EnvConfig


@dataclasses.dataclass
class EnvState:
    colour: torch.Tensor
    kind: torch.Tensor
    timer: torch.Tensor
    key: torch.Tensor


def action_table(cfg: EnvConfig) -> tuple[np.ndarray, np.ndarray]:
    """Static action -> (coord1, coord2) table, int32[A, 2] each: the
    C*(R-1) down-swaps ((r,c),(r+1,c)) row-major, then the R*(C-1)
    right-swaps ((r,c),(r,c+1)) row-major (`board.py:78-93` of the
    original game)."""
    R, C = cfg.num_rows, cfg.num_cols
    c1, c2 = [], []
    for i in range(cfg.num_actions):
        if i < C * (R - 1):
            r, c = divmod(i, C)
            c1.append((r, c))
            c2.append((r + 1, c))
        else:
            r, c = divmod(i - C * (R - 1), C - 1)
            c1.append((r, c))
            c2.append((r, c + 1))
    return np.asarray(c1, dtype=np.int32), np.asarray(c2, dtype=np.int32)
