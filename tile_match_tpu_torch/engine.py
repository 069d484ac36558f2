"""The core engine on batches of boards (counterpart of
``tile_match_tpu.engine``, no-specials configs).

``Board.move`` / ``Board.generate_board`` and ``TileMatchEnv.step/reset`` of
the original game (`board.py:95-112, 330-395`, `tile_match_env.py:84-112`)
as functions of a batched ``EnvState``.  The JAX package runs one board per
call under ``vmap`` with ``lax.while_loop``s; here every function takes the
whole batch, and each per-board loop is a masked batch loop: an iteration
splits keys, draws and updates only the boards still in the loop, so a board
that has left it consumes no random numbers and its state is exactly what
the per-board loop would leave.

The specials machinery (classify, resolve, activate, combination) is not
ported yet: configs with any special enabled raise ``NotImplementedError``.
"""

from __future__ import annotations

import functools
from typing import Tuple

import torch

from . import random as trandom
from .config import EnvConfig
from .ops.board_ops import apply_shuffle, draw_colour_grid, swap_cells
from .ops.cascade import fused_cascade
from .ops.effective import effective_mask_settled
from .ops.lines import has_any_line, run_member_mask
from .state import EnvState, StepInfo, action_table


def _check_supported(cfg: EnvConfig) -> None:
    if cfg.any_special:
        raise NotImplementedError(
            "special tiles are not ported yet (ROADMAP Queue 1 item 7, "
            "specials machinery); use a config with no specials"
        )
    if cfg.debug_checks:
        raise NotImplementedError(
            "debug_checks is not ported yet (ROADMAP Queue 1 item 9, gates "
            "and telemetry)"
        )


def _split_where(go: torch.Tensor, key: torch.Tensor):
    """``key, sub = split(key)`` on the boards where ``go``; the others keep
    their key.  Returns (new key, sub)."""
    both = trandom.split(key)
    return torch.where(go[:, None], both[:, 0], key), both[:, 1]


def _clear_lines(cfg, colour, key, has_lines, tot):
    """Redraw the cells of every >= 3 run until the board is line-free or
    the shared ``max_regen_iters`` budget ``tot`` runs out; one key split
    per iteration."""
    while True:
        go = has_lines & (tot < cfg.max_regen_iters)
        if not bool(go.any()):
            return colour, key, has_lines, tot
        key, k = _split_where(go, key)
        redraw = go[:, None, None] & run_member_mask(cfg, colour)
        colour = torch.where(redraw, draw_colour_grid(k, cfg), colour)
        has_lines = torch.where(go, has_any_line(cfg, colour), has_lines)
        tot = tot + go.to(torch.int32)


def make_playable(
    cfg: EnvConfig, colour, kind, key, init_has_lines, mask0=None, skip=None
):
    """The regenerate/playability loop of ``generate_board`` and of the end
    of a move (`board.py:102-109, 381-391`).

    Phase 1 clears lines (``_clear_lines``).  Then, while a board has no
    effective move or still has lines, it shuffles (one key split, then
    ``permutation(k, R*C)``) and clears lines again.  Both phases share the
    ``max_regen_iters`` cap.  ``mask0``: the incoming board's mask when the
    caller has it (only valid for line-free boards).  ``skip``: boards that
    run no iteration at all (the caller discards their outputs).

    Returns (colour, kind, key, shuffled, mask, gave_up); a board that gave
    up — still unplayable or lined at the cap — gets an all-false mask.
    """
    B = colour.shape[0]
    cap = cfg.max_regen_iters
    tot = torch.zeros(B, dtype=torch.int32, device=colour.device)
    if skip is not None:
        tot = torch.where(skip, cap, tot)
    colour, key, has_lines, tot = _clear_lines(cfg, colour, key, init_has_lines, tot)
    mask = effective_mask_settled(cfg, colour, kind) if mask0 is None else mask0
    shuffled = torch.zeros(B, dtype=torch.bool, device=colour.device)
    while True:
        go = ((~mask.any(-1)) | has_lines) & (tot < cap)
        if not bool(go.any()):
            break
        key, k = _split_where(go, key)
        perm = trandom.permutation(k, cfg.flat_size)
        s_colour, s_kind = apply_shuffle(colour, kind, perm)
        g3 = go[:, None, None]
        colour = torch.where(g3, s_colour, colour)
        kind = torch.where(g3, s_kind, kind)
        has_lines = torch.where(go, has_any_line(cfg, colour), has_lines)
        colour, key, has_lines, tot = _clear_lines(
            cfg, colour, key, has_lines, tot + go.to(torch.int32)
        )
        mask = torch.where(go[:, None], effective_mask_settled(cfg, colour, kind), mask)
        shuffled = shuffled | go
    gave_up = (~mask.any(-1)) | has_lines
    mask = mask & ~gave_up[:, None]
    return colour, kind, key, shuffled, mask, gave_up


def generate_board(cfg: EnvConfig, keys):
    """Fresh all-normal boards, redrawn and shuffled until line-free with at
    least one effective move (`board.py:95-112`).  Returns (colour, kind,
    key, mask, gave_up)."""
    _check_supported(cfg)
    both = trandom.split(keys)
    key, k = both[:, 0], both[:, 1]
    colour = draw_colour_grid(k, cfg)
    kind = torch.ones_like(colour)
    colour, kind, key, _, mask, gave_up = make_playable(
        cfg, colour, kind, key, has_any_line(cfg, colour)
    )
    return colour, kind, key, mask, gave_up


def engine_move(cfg: EnvConfig, colour, kind, key, coord1, coord2, eff, cur_mask):
    """``Board.move`` (`board.py:330-395`) for no-specials boards.

    Boards where ``eff`` is False are no-ops: board, key and ``cur_mask``
    come back unchanged.  An effective move swaps, does ``key, sub =
    split(key)`` once, runs the cascade (``fused_cascade``: the CUDA kernel
    on a card, the plain version on the CPU) and the playability loop.

    Returns (colour, kind, key, eliminations, is_comb, new_specials,
    activated, shuffled, post_mask, truncated, trips).
    """
    _check_supported(cfg)
    B = colour.shape[0]
    e1, e3 = eff[:, None], eff[:, None, None]
    sw_colour, _ = swap_cells(colour, kind, coord1, coord2)
    moved = torch.where(e3, sw_colour, colour)
    both = trandom.split(key)
    key_moved, sub = both[:, 0], both[:, 1].contiguous()

    # Non-effective boards go through unchanged and line-free: 0 trips.
    c_colour, elim, trips, trunc, kmask = fused_cascade(cfg, moved, sub)

    # no specials: kind is all-normal before and after the cascade
    p_colour, p_kind, p_key, p_shuffled, p_mask, p_gave_up = make_playable(
        cfg, c_colour, kind, key_moved,
        torch.zeros(B, dtype=torch.bool, device=colour.device),
        mask0=kmask, skip=~eff,
    )
    zero = torch.zeros(B, dtype=torch.int32, device=colour.device)
    return (
        torch.where(e3, p_colour, colour),
        torch.where(e3, p_kind, kind),
        torch.where(e1, p_key, key),
        torch.where(eff, elim, zero),
        torch.zeros(B, dtype=torch.bool, device=colour.device),
        zero,
        zero,
        eff & p_shuffled,
        torch.where(e1, p_mask, cur_mask),
        eff & (trunc | p_gave_up),
        torch.where(eff, trips, zero),
    )


def reset(cfg: EnvConfig, keys) -> Tuple[EnvState, StepInfo]:
    """``TileMatchEnv.reset`` for a batch of keys int64[B, 2]."""
    colour, kind, key, mask, gave_up = generate_board(cfg, keys)
    B = colour.shape[0]
    dev = colour.device
    zero = torch.zeros(B, dtype=torch.int32, device=dev)
    false = torch.zeros(B, dtype=torch.bool, device=dev)
    state = EnvState(colour=colour, kind=kind, timer=zero, key=key)
    info = StepInfo(
        is_combination_match=false,
        num_new_specials=zero,
        num_specials_activated=zero,
        shuffled=false,
        effective_actions=mask,
        truncated=gave_up,
        cascade_trips=zero,
    )
    return state, info


@functools.lru_cache(maxsize=None)
def _action_coords(cfg: EnvConfig, device: torch.device):
    c1, c2 = action_table(cfg)
    return torch.from_numpy(c1).to(device), torch.from_numpy(c2).to(device)


def step(
    cfg: EnvConfig,
    state: EnvState,
    action,
    eff_mask=None,
    compute_post_mask: bool = True,
) -> Tuple[EnvState, torch.Tensor, torch.Tensor, StepInfo]:
    """``TileMatchEnv.step`` for a batch: returns (next_state, reward int32[B],
    done bool[B], info).  Reward is the raw elimination count.

    ``eff_mask``: the current boards' effective-action mask, when the caller
    has it (the previous step's info carries it).  ``compute_post_mask``:
    when False, ``info.effective_actions`` is the raw post-move mask, not
    zeroed on done (the auto-resetting batched env substitutes it).
    """
    c1_tab, c2_tab = _action_coords(cfg, state.colour.device)
    a = action.long()
    mask_before = (
        effective_mask_settled(cfg, state.colour, state.kind)
        if eff_mask is None
        else eff_mask
    )
    eff = mask_before.gather(1, a[:, None])[:, 0]

    (
        colour, kind, key, elim, comb, new, act, shuffled, post_mask, trunc,
        trips,
    ) = engine_move(
        cfg, state.colour, state.kind, state.key, c1_tab[a], c2_tab[a], eff,
        mask_before,
    )

    timer = state.timer + 1
    done = timer >= cfg.num_moves
    next_state = EnvState(colour=colour, kind=kind, timer=timer, key=key)
    mask_after = post_mask & ~done[:, None] if compute_post_mask else post_mask
    info = StepInfo(
        is_combination_match=comb,
        num_new_specials=new,
        num_specials_activated=act,
        shuffled=shuffled,
        effective_actions=mask_after,
        truncated=trunc,
        cascade_trips=trips,
    )
    return next_state, elim, done, info


def observe(cfg: EnvConfig, state: EnvState):
    """Dict-style observation (`tile_match_env.py:114-115`)."""
    return {
        "board": state.board,
        "num_moves_left": cfg.num_moves - state.timer,
    }
