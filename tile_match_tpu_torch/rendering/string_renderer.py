"""ANSI string rendering of boards (`tile_match_env.py:127-143` equivalent),
as a pure function usable for debugging batched envs too."""

from __future__ import annotations

import numpy as np

_KIND_GLYPH = {-1: "O", 0: ".", 1: " ", 2: "|", 3: "-", 4: "*"}


def render_ansi(board: np.ndarray, colour_map: np.ndarray) -> str:
    """256-colour terminal rendering of the kind channel, tinted by colour.

    Produces the reference's interactive ``render_mode="string"`` look
    (`tile_match_env.py:127-143` behaviour): a dashed frame, black cell
    background, and each cell showing its kind id in the palette colour
    assigned to its colour id.
    """
    board = np.asarray(board)
    colour, kind = board[0], board[1]
    n_cols = colour.shape[1]
    bar = " " + "-" * (n_cols * 2 + 1)
    out = [bar]
    for row_colour, row_kind in zip(colour, kind):
        cells = "".join(
            f"\033[48;5;16m\033[38;5;{colour_map[cid]}m{kid}\033[0m\033[48;5;16m "
            f"\033[0m"
            for cid, kid in zip(row_colour, row_kind)
        )
        out.append("| \033[48;5;16m" + cells + "|")
    out.append(bar)
    return "\n".join(out)


def default_colour_map(num_colours: int, seed) -> np.ndarray:
    """Palette of distinct xterm-256 colour ids, one per colour (+empty)."""
    return np.random.default_rng(seed).choice(
        range(105, 230), size=num_colours + 1, replace=False
    )


def board_to_string(board: np.ndarray, colour_offset: int = 1) -> str:
    """Human-readable grid: colour digit + special glyph per cell."""
    board = np.asarray(board)
    colour, kind = board[0], board[1]
    R, C = colour.shape
    lines = [" " + "-" * (C * 3 + 1)]
    for r in range(R):
        cells = []
        for c in range(C):
            g = _KIND_GLYPH.get(int(kind[r, c]), "?")
            cells.append(f"{int(colour[r, c])}{g}")
        lines.append("| " + " ".join(cells) + " |")
    lines.append(" " + "-" * (C * 3 + 1))
    return "\n".join(lines)
