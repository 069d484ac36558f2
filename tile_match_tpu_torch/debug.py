"""Debug-mode invariant checks (counterpart of ``tile_match_tpu.debug``).

``validate_state`` checks one board's structural invariants on the host;
``checked_step`` runs a batched step with ``debug_checks`` on and checks
the post-step invariants.  The JAX package builds the latter on
``checkify``, which has no torch counterpart: here every check is an
explicit test of a flag read back from the device, and the first that
fails raises a ``RuntimeError`` with the JAX package's message.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .config import EnvConfig
from .ops.effective import possible_move
from .ops.lines import has_any_line


def validate_state(cfg: EnvConfig, colour, kind, after_reset: bool = True):
    """Host-side structural invariants of one board int[R, C]; raises
    AssertionError with context."""
    colour = np.asarray(colour)
    kind = np.asarray(kind)
    assert colour.shape == (cfg.num_rows, cfg.num_cols)
    assert ((colour >= 0) & (colour <= cfg.num_colours)).all(), "colour range"
    assert np.isin(kind, [-1, 0, 1, 2, 3, 4]).all(), "kind range"
    # channel coupling: coloured <=> normal/colour-special; colourless <=>
    # empty/cookie (`board.py:7-25` contract)
    assert ((colour > 0) == (kind > 0)).all(), "colour/kind coupling"
    if after_reset:
        assert not ((colour == 0) & (kind == 0)).any(), "no empty cells"
        tc = torch.as_tensor(colour, dtype=torch.int32)[None]
        tk = torch.as_tensor(kind, dtype=torch.int32)[None]
        assert not bool(has_any_line(cfg, tc)), "board has matches"
        assert bool(possible_move(cfg, tc, tk)), "no possible move"


def checked_step(cfg: EnvConfig):
    """A step that raises on a broken invariant.

    Returns fn(state, action) -> (next_state, reward, done, info) for a
    batched ``EnvState`` and actions int[B], as ``engine.step``.  The step
    runs with ``debug_checks=True``, so every capacity-cap truncation point
    of the specials machinery (line-queue overflow, classify append drop,
    activation stack overflow / step-budget truncation) raises instead of
    truncating; cascade/regeneration-cap truncation is caught by the
    post-step invariants checked here (colour/kind coupling, leftover
    matches, no possible move on a board not done).

    The JAX package's ``checked_step`` returns ``(err, out)`` and leaves
    ``err.throw()`` to the caller; torch has no functional error value, so
    this one raises ``RuntimeError`` itself, on the first failed check.
    """
    from .engine import step

    cfg = dataclasses.replace(cfg, debug_checks=True)

    def _step(state, action):
        next_state, reward, done, info = step(cfg, state, action)
        colour, kind = next_state.colour, next_state.kind
        if not bool(((colour > 0) == (kind > 0)).all()):
            raise RuntimeError("colour/kind coupling violated")
        if bool(has_any_line(cfg, colour).any()):
            raise RuntimeError("matches remain after step")
        if not bool((possible_move(cfg, colour, kind) | done).all()):
            raise RuntimeError("no possible move after step")
        return next_state, reward, done, info

    return _step
