"""Effective-move mask of settled boards (counterpart of
``tile_match_tpu.ops.effective.effective_mask_settled``).

Exact ``is_move_effective`` semantics (`board.py:735-787` of the original
game) on boards with no >= 3 run: a post-swap run must pass through a
swapped cell, which leaves, per swapped cell, the 3 perpendicular stencils
and the 1 parallel stencil pointing away from the partner — 8 stencils per
action.  Each stencil also ANDs the kind >= 0 of its last (rightmost or
bottom) cell, the cookie-end quirk of the original game.

The windowed ``effective_mask`` for arbitrary boards belongs to the Gym
adapter and is not ported yet.
"""

from __future__ import annotations

import torch

from ..config import EnvConfig


def _padded(x: torch.Tensor, fill: int) -> torch.Tensor:
    B, R, C = x.shape
    p = torch.full((B, R + 6, C + 6), fill, dtype=x.dtype, device=x.device)
    p[:, 3 : 3 + R, 3 : 3 + C] = x
    return p


def effective_mask_settled(cfg: EnvConfig, colour, kind) -> torch.Tensor:
    """bool[B, A] in action-table order: C*(R-1) down-swaps row-major, then
    R*(C-1) right-swaps row-major."""
    B, R, C = colour.shape
    pc = _padded(colour, -1)  # out of board never matches a colour
    pk = _padded(kind, 1)  # out-of-board kind is never read unmasked

    def sh(dr, dc):
        return pc[:, 3 + dr : 3 + dr + R, 3 + dc : 3 + dc + C]

    def shk(dr, dc):
        return pk[:, 3 + dr : 3 + dr + R, 3 + dc : 3 + dc + C]

    def cell_terms(Bc, kB, dr, dc, away):
        """Stencils through the swapped cell at offset (dr, dc), which holds
        post-swap colour ``Bc`` and kind ``kB``, leaving out the stencils
        that contain the partner cell."""
        horiz = [
            (sh(dr, dc - 2) == Bc) & (sh(dr, dc - 1) == Bc) & (kB >= 0),
            (sh(dr, dc - 1) == Bc) & (sh(dr, dc + 1) == Bc) & (shk(dr, dc + 1) >= 0),
            (sh(dr, dc + 1) == Bc) & (sh(dr, dc + 2) == Bc) & (shk(dr, dc + 2) >= 0),
        ]
        vert = [
            (sh(dr - 2, dc) == Bc) & (sh(dr - 1, dc) == Bc) & (kB >= 0),
            (sh(dr - 1, dc) == Bc) & (sh(dr + 1, dc) == Bc) & (shk(dr + 1, dc) >= 0),
            (sh(dr + 1, dc) == Bc) & (sh(dr + 2, dc) == Bc) & (shk(dr + 2, dc) >= 0),
        ]
        if away == "up":
            return horiz + [vert[0]]
        if away == "down":
            return horiz + [vert[2]]
        if away == "left":
            return vert + [horiz[0]]
        return vert + [horiz[2]]

    def swap_mask(dr2, dc2, away1, away2):
        """bool[B, R, C] indexed by coord1 = (r, c); coord2 = (r+dr2, c+dc2)."""
        A = colour  # coord1's pre-swap colour = coord2's post-swap colour
        Bc = sh(dr2, dc2)
        kA = kind
        kB = shk(dr2, dc2)
        terms = cell_terms(Bc, kB, 0, 0, away1) + cell_terms(A, kA, dr2, dc2, away2)
        m = terms[0]
        for t in terms[1:]:
            m = m | t
        if cfg.any_special:
            spec1 = (kA != 0) & (kA != 1)
            spec2 = (kB != 0) & (kB != 1)
            m = m | (spec1 & spec2) | (kA < 0) | (kB < 0)
        return m

    down = swap_mask(1, 0, "up", "down")
    right = swap_mask(0, 1, "left", "right")
    return torch.cat(
        [down[:, : R - 1, :].reshape(B, -1), right[:, :, : C - 1].reshape(B, -1)],
        dim=1,
    )
