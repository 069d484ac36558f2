"""Static environment configuration (counterpart of ``tile_match_tpu.config``).

The same frozen, hashable dataclass as the JAX package: the same fields,
defaults, ``create()`` constructor and derived sizes, so a config built from
the same arguments describes the same game in both packages.  It lives here
again because importing ``tile_match_tpu.config`` imports JAX.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence, Tuple

# Tile-kind encoding (`board.py:18-25` of the original game):
#   colour channel: 0 = colourless (empty cell or cookie), 1..num_colours
#   kind  channel : 0 empty, 1 normal, 2 vertical laser, 3 horizontal laser,
#                   4 bomb, -1 cookie.
KIND_EMPTY = 0
KIND_NORMAL = 1
KIND_V_LASER = 2
KIND_H_LASER = 3
KIND_BOMB = 4
KIND_COOKIE = -1

TILE_TYPES = {
    "empty": KIND_EMPTY,
    "normal": KIND_NORMAL,
    "vertical_laser": KIND_V_LASER,
    "horizontal_laser": KIND_H_LASER,
    "bomb": KIND_BOMB,
    "cookie": KIND_COOKIE,
}

# Match classification codes (`board.py:269-327`): what a classified match
# creates.  A cookie match creates a cookie tile (KIND_COOKIE).
MATCH_NONE = 0
MATCH_NORMAL = 1
MATCH_V_LASER = 2
MATCH_H_LASER = 3
MATCH_BOMB = 4
MATCH_COOKIE = 5

_COLOURLESS_SPECIAL_NAMES = ("cookie",)
_COLOUR_SPECIAL_NAMES = ("vertical_laser", "horizontal_laser", "bomb")


@dataclasses.dataclass(frozen=True)
class EnvConfig:
    """Frozen, hashable static config."""

    num_rows: int
    num_cols: int
    num_colours: int
    num_moves: int = 30
    cookie: bool = True
    vertical_laser: bool = True
    horizontal_laser: bool = True
    bomb: bool = True

    # bounded-iteration caps
    max_cascades: int = 64
    max_regen_iters: int = 256
    max_activation_steps: int = 0  # 0 -> auto (derived from board size)
    max_lines: int = 0  # 0 -> auto; override of lines_max
    max_stack: int = 0  # 0 -> auto; override of stack_max

    # When True, every capacity-cap truncation point of the specials
    # machinery (line queue, classify append and emission, activation stack
    # and step budget) raises a RuntimeError instead of truncating; the
    # checks read one flag back from the device each (see
    # ``debug.checked_step``).
    debug_checks: bool = False

    @classmethod
    def create(
        cls,
        num_rows: int,
        num_cols: int,
        num_colours: int,
        num_moves: int = 30,
        colourless_specials: Sequence[str] = ("cookie",),
        colour_specials: Sequence[str] = (
            "vertical_laser",
            "horizontal_laser",
            "bomb",
        ),
        **kwargs,
    ) -> "EnvConfig":
        """Constructor taking special-name lists, as the original game does."""
        specials = set(colourless_specials) | set(colour_specials)
        unknown = specials - set(_COLOURLESS_SPECIAL_NAMES) - set(_COLOUR_SPECIAL_NAMES)
        if unknown:
            raise ValueError(f"Unknown specials: {sorted(unknown)}")
        return cls(
            num_rows=num_rows,
            num_cols=num_cols,
            num_colours=num_colours,
            num_moves=num_moves,
            cookie="cookie" in specials,
            vertical_laser="vertical_laser" in specials,
            horizontal_laser="horizontal_laser" in specials,
            bomb="bomb" in specials,
            **kwargs,
        )

    @property
    def colourless_specials(self) -> Tuple[str, ...]:
        return ("cookie",) if self.cookie else ()

    @property
    def colour_specials(self) -> Tuple[str, ...]:
        out = []
        if self.vertical_laser:
            out.append("vertical_laser")
        if self.horizontal_laser:
            out.append("horizontal_laser")
        if self.bomb:
            out.append("bomb")
        return tuple(out)

    @property
    def any_special(self) -> bool:
        return self.cookie or self.vertical_laser or self.horizontal_laser or self.bomb

    @property
    def flat_size(self) -> int:
        return self.num_rows * self.num_cols

    @property
    def num_actions(self) -> int:
        # all vertical + horizontal adjacent swaps
        return 2 * self.num_rows * self.num_cols - self.num_rows - self.num_cols

    @property
    def line_len_max(self) -> int:
        return max(self.num_rows, self.num_cols)

    @property
    def lines_max(self) -> int:
        return self.max_lines or (self.num_rows + self.num_cols)

    @property
    def match_coords_max(self) -> int:
        return self.line_len_max + 3

    @property
    def matches_max(self) -> int:
        return 2 * self.lines_max

    @property
    def stack_max(self) -> int:
        return self.max_stack or (self.flat_size + 8)

    @property
    def activation_steps_max(self) -> int:
        if self.max_activation_steps:
            return self.max_activation_steps
        return 4 * self.flat_size + 16
