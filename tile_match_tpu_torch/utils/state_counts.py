"""State-space enumeration in batches on a device (counterpart of
``tile_match_tpu.utils.state_counts``).

Counterpart of ``utils/utils.py:6-31`` of the original game, which
enumerates all colours^(R*C) boards and checks each one in a
multiprocessing pool.  Here the validity predicate (no colour lines and at
least one effective move) is the port's batched ``has_any_line`` and
``effective_mask`` over enumerated boards in large batches.

Counts the original game's code gives (``tests/test_utils_models.py``):
(3,3,2): 102/102 · (3,2,2): 18/36 · (3,2,3): 198/576 · (4,3,2): 378/378 ·
(3,3,3): 8514/9750.
"""

from __future__ import annotations

import numpy as np
import torch

from ..config import EnvConfig
from ..cuda_build import resolve_device
from ..ops.effective import effective_mask
from ..ops.lines import has_any_line


def is_valid_states(cfg: EnvConfig, colours, device=None):
    """colours: int[B, R, C] of all-normal boards -> (no lines and a
    possible move bool[B], no lines bool[B]) as numpy; computed on
    ``device`` (the card unless the caller names another)."""
    device = resolve_device(device)
    colour = torch.as_tensor(np.asarray(colours), dtype=torch.int32, device=device)
    kind = torch.ones_like(colour)
    no_lines = ~has_any_line(cfg, colour)
    has_move = effective_mask(cfg, colour, kind).any(-1)
    return (no_lines & has_move).cpu().numpy(), no_lines.cpu().numpy()


def compute_num_states(
    num_rows: int,
    num_cols: int,
    num_colours: int,
    batch_size: int = 1 << 14,
    num_moves: int = 10,
    device=None,
):
    """(#boards with no lines and a possible move, #boards with no lines).

    Enumerates colours^(R*C) boards in batches; the base-K digits of each
    board come from its flat index (no host-side product())."""
    cfg = EnvConfig(num_rows, num_cols, num_colours, num_moves)
    flat = num_rows * num_cols
    total = num_colours**flat
    n_move, n_nolines = 0, 0
    powers = num_colours ** np.arange(flat, dtype=np.int64)
    for start in range(0, total, batch_size):
        idx = np.arange(start, min(start + batch_size, total), dtype=np.int64)
        digits = (idx[:, None] // powers[None, :]) % num_colours
        colours = (digits + 1).astype(np.int32).reshape(-1, num_rows, num_cols)
        a, b = is_valid_states(cfg, colours, device)
        n_move += int(a.sum())
        n_nolines += int(b.sum())
    return n_move, n_nolines


def get_tabular_obs(board: np.ndarray, num_moves_left: int) -> tuple:
    """Hashable tabular key: flattened board + moves left.

    The original game's version (`utils/utils.py:28-31`) returns the raw
    board instead of the flattened tuple; this one returns the tuple."""
    flat = np.asarray(board).flatten().tolist()
    flat.append(int(num_moves_left))
    return tuple(flat)
