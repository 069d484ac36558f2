"""Elementary board operations on batches (counterpart of
``tile_match_tpu.ops.board_ops``).

The original game's in-place mutators — swap (`board.py:729-732`), gravity
(`board.py:217-229`), refill (`board.py:231-241`) and shuffle
(`board.py:114-118`) — as functions of int32[B, R, C] boards that return
new tensors.  Randomness is
passed in as value grids; ``draw_colour_grid`` draws one from threefry.
"""

from __future__ import annotations

import torch

from . import random as trandom
from .config import EnvConfig


def swap_cells(colour, kind, coord1, coord2):
    """Swap both channels at two coordinates per board; coords int[B, 2]."""
    B, R, C = colour.shape
    f1 = (coord1[:, 0].long() * C + coord1[:, 1].long())[:, None]
    f2 = (coord2[:, 0].long() * C + coord2[:, 1].long())[:, None]

    def sw(ch):
        flat = ch.reshape(B, R * C).clone()
        a = flat.gather(1, f1)
        b = flat.gather(1, f2)
        flat.scatter_(1, f1, b)
        flat.scatter_(1, f2, a)
        return flat.reshape(B, R, C)

    return sw(colour), sw(kind)


def gravity(colour, kind):
    """Push empty cells (both channels zero) to the top of each column,
    keeping the order of the empties and of the tiles (a stable two-way
    partition): an empty cell lands at the number of empties above it, a
    tile at the column's empty count plus the number of tiles above it."""
    empty = (colour == 0) & (kind == 0)
    e = empty.to(torch.int64)
    n_empty = e.sum(dim=1, keepdim=True)
    csum_e = e.cumsum(dim=1)
    csum_t = (1 - e).cumsum(dim=1)
    dest = torch.where(empty, csum_e - 1, n_empty + csum_t - 1)
    return (
        torch.empty_like(colour).scatter_(1, dest, colour),
        torch.empty_like(kind).scatter_(1, dest, kind),
    )


def apply_refill(colour, kind, fill_grid):
    """Replace empty cells with colours from ``fill_grid`` (kind becomes 1)."""
    empty = (colour == 0) & (kind == 0)
    return (
        torch.where(empty, fill_grid, colour),
        torch.where(empty, torch.ones_like(kind), kind),
    )


def apply_shuffle(colour, kind, perm):
    """Permute both channels of each board by one flat permutation
    int[B, R*C]: cell i takes the value of cell perm[i]."""
    B, R, C = colour.shape
    perm = perm.long()
    return (
        colour.reshape(B, R * C).gather(1, perm).reshape(B, R, C),
        kind.reshape(B, R * C).gather(1, perm).reshape(B, R, C),
    )


def draw_colour_grid(keys, cfg: EnvConfig):
    """Uniform colour grids in 1..num_colours: int32[B, R, C] from keys
    int64[B, 2] (``jax.random.randint(key, (R, C), 1, K + 1)`` per board)."""
    return trandom.randint(
        keys, (cfg.num_rows, cfg.num_cols), 1, cfg.num_colours + 1
    )
