"""Side-by-side board printing with difference highlighting (the port's
copy of ``tile_match_tpu.utils.print_board_diffs``, which imports no JAX
but lives in a package that does).

Debug-observability counterpart of the original game's
``utils/print_board_diffs.py:11-82`` — returns strings (printing optional)
and works on either a single channel or a full [2, R, C] board.
"""

from __future__ import annotations

import numpy as np

_RESET = "\033[0m"
_HIGHLIGHT = "\033[48;5;1m"


def _fmt_cell(v: int, highlight: bool) -> str:
    colour_code = 31 + (int(v) % 6)
    s = f"\033[1;{colour_code}m{int(v):2}{_RESET}"
    return f"{_HIGHLIGHT}{s}{_RESET}" if highlight else s


def format_boards(left: np.ndarray, right: np.ndarray, gap: int = 5) -> str:
    """Two grids side by side with an arrow between them."""
    left = np.asarray(left)
    right = np.asarray(right)
    R, C = left.shape
    bar = " " + "-" * (C * 3 + 1)
    out = [bar + " " * (gap + 1) + bar]
    for r in range(R):
        mid = " -> " if r == R // 2 else " " * 4
        lcells = " ".join(_fmt_cell(v, False) for v in left[r])
        rcells = " ".join(_fmt_cell(v, False) for v in right[r])
        out.append(f"| {lcells} |{mid:^{gap}}| {rcells} |")
    out.append(bar + " " * (gap + 1) + bar)
    return "\n".join(out)


def highlight_board_diff(
    board: np.ndarray, expected: np.ndarray, gap: int = 5, prnt: bool = False
) -> str:
    """Like format_boards but cells differing from ``expected`` are
    highlighted on the left grid."""
    board = np.asarray(board)
    expected = np.asarray(expected)
    if board.ndim == 3:  # full [2, R, C] board: diff both channels
        return "\n".join(
            highlight_board_diff(board[i], expected[i], gap, prnt)
            for i in range(board.shape[0])
        )
    R, C = board.shape
    bar = " " + "─" * (C * 3 + 1)
    out = [bar + " " * (gap + 1) + bar]
    for r in range(R):
        lcells = " ".join(
            _fmt_cell(board[r, c], board[r, c] != expected[r, c]) for c in range(C)
        )
        rcells = " ".join(_fmt_cell(v, False) for v in expected[r])
        out.append(f"│ {lcells} │{'':^{gap}}│ {rcells} │")
    out.append(bar + " " * (gap + 1) + bar)
    s = "\n".join(out)
    if prnt:
        print(s)
    return s
