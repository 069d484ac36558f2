"""Effective-move masks (counterpart of ``tile_match_tpu.ops.effective``).

``effective_mask`` is the original game's ``is_move_effective``
(`board.py:735-787`) for every action of arbitrary boards: both cells
special, or either a cookie, or — after the swap — a run of three equal
colours anywhere inside the clipped window [min-2, max+2] around the two
cells whose last (rightmost or bottom) cell has kind >= 0.  A run in the
window that the swap does not touch counts too, as in the original game.
The reference takes it for every mask: on a settled board it is the
settled mask, and it assumes nothing of how the board came to be.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from .config import EnvConfig
from .state import action_table


@functools.lru_cache(maxsize=None)
def _window_tables(cfg: EnvConfig, device: torch.device):
    """Per action, the cells of its 6x6 window after the swap and its 48
    candidate runs: (run cells int64[A, 48, 3], run inside the board and
    the window bool[A, 48], coord1 and coord2 cells int64[A])."""
    R, C = cfg.num_rows, cfg.num_cols
    c1, c2 = action_table(cfg)
    A = len(c1)
    r_lo = np.minimum(c1[:, 0], c2[:, 0]) - 2
    c_lo = np.minimum(c1[:, 1], c2[:, 1]) - 2
    r_hi = np.maximum(c1[:, 0], c2[:, 0]) + 2
    c_hi = np.maximum(c1[:, 1], c2[:, 1]) + 2
    rows = np.broadcast_to(r_lo[:, None, None] + np.arange(6)[None, :, None], (A, 6, 6))
    cols = np.broadcast_to(c_lo[:, None, None] + np.arange(6)[None, None, :], (A, 6, 6))
    in_board = (rows >= 0) & (rows < R) & (cols >= 0) & (cols < C)
    in_win = (rows <= r_hi[:, None, None]) & (cols <= c_hi[:, None, None])
    valid = (in_board & in_win).reshape(A, 36)
    flat = (np.clip(rows, 0, R - 1) * C + np.clip(cols, 0, C - 1)).reshape(A, 36)
    flat1 = c1[:, 0] * C + c1[:, 1]
    flat2 = c2[:, 0] * C + c2[:, 1]
    # the swap: coord1 sits at window position (2, 2) = 14, coord2 at
    # (3, 2) = 20 for the C*(R-1) down-swaps and (2, 3) = 15 for the rest
    n_down = C * (R - 1)
    flat[:, 14] = flat2
    flat[:n_down, 20] = flat1[:n_down]
    flat[n_down:, 15] = flat1[n_down:]
    starts = [i * 6 + j for i in range(6) for j in range(4)]
    tri = [(p, p + 1, p + 2) for p in starts]  # horizontal runs
    tri += [(p, p + 6, p + 12) for p in range(24)]  # vertical runs
    tri = np.asarray(tri)
    runs = flat[:, tri]  # [A, 48, 3]
    run_ok = valid[:, tri].all(-1)

    def put(a):
        return torch.as_tensor(np.ascontiguousarray(a), device=device)

    return put(runs.astype(np.int64)), put(run_ok), put(flat1.astype(np.int64)), put(
        flat2.astype(np.int64)
    )


def effective_mask(cfg: EnvConfig, colour, kind) -> torch.Tensor:
    """bool[B, A]: which swaps would do anything, on any board."""
    runs, run_ok, flat1, flat2 = _window_tables(cfg, colour.device)
    B = colour.shape[0]
    col = colour.reshape(B, -1)
    kin = kind.reshape(B, -1)
    k1, k2 = kin[:, flat1], kin[:, flat2]
    both_special = (k1 != 0) & (k1 != 1) & (k2 != 0) & (k2 != 1)
    any_cookie = (k1 < 0) | (k2 < 0)
    a, b, c = col[:, runs[..., 0]], col[:, runs[..., 1]], col[:, runs[..., 2]]
    run3 = (a == b) & (b == c) & run_ok & (kin[:, runs[..., 2]] >= 0)
    return both_special | any_cookie | run3.any(-1)
