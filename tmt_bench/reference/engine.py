"""The game's step on a batch of boards, written down plainly.

Each function follows the per-board JAX engine of the game
(``Board.move`` / ``Board.generate_board`` and ``TileMatchEnv.step/reset``
of the original game, `board.py:95-112, 330-395`, `tile_match_env.py:84-112`)
on a batch, with no kernel and no shortcut:

* the cascade is the plain loop: while a board has a line and fewer than
  ``max_cascades`` trips, one trip (with specials: detect, classify,
  resolve, gravity, refill; without: delete the union of the lines,
  gravity, refill), trip ``t`` refilling from ``fold_in(sub, t)``;
* every mask is the original game's ``is_move_effective`` on the board as
  it stands (``effective.effective_mask``);
* a move that is not effective leaves its board, key and mask alone.

A loop over boards runs as a masked batch loop: an iteration touches only
the boards still in it, so a board that has left it draws no random
numbers and keeps the state the per-board loop would leave.
"""

from __future__ import annotations

import torch

from . import random as trandom
from .board_ops import apply_refill, apply_shuffle, draw_colour_grid, gravity, swap_cells
from .classify import process_colour_lines
from .combination import combination_match, is_combination
from .config import EnvConfig
from .effective import effective_mask
from .lines import get_colour_lines, has_any_line, line_union_mask, run_member_mask
from .resolve import resolve_colour_matches
from .state import EnvState, action_table


def _split_where(go, key):
    """``key, sub = split(key)`` on the boards where ``go``; the others
    keep their key."""
    both = trandom.split(key)
    return torch.where(go[:, None], both[:, 0], key), both[:, 1]


def _clear_lines(cfg, colour, key, has_lines, tot):
    """Redraw the cells of every >= 3 run until the board is line-free or
    the shared ``max_regen_iters`` budget ``tot`` runs out."""
    while True:
        go = has_lines & (tot < cfg.max_regen_iters)
        if not bool(go.any()):
            return colour, key, has_lines, tot
        key, k = _split_where(go, key)
        redraw = go[:, None, None] & run_member_mask(cfg, colour)
        colour = torch.where(redraw, draw_colour_grid(k, cfg), colour)
        has_lines = torch.where(go, has_any_line(cfg, colour), has_lines)
        tot = tot + go.to(torch.int32)


def make_playable(cfg: EnvConfig, colour, kind, key, has_lines):
    """Clear lines, then shuffle (and clear again) while a board has no
    effective move or still has a line, all within ``max_regen_iters``
    iterations.  Returns (colour, kind, key, shuffled, mask, gave_up); a
    board that gave up gets an all-false mask."""
    B = colour.shape[0]
    cap = cfg.max_regen_iters
    tot = torch.zeros(B, dtype=torch.int32, device=colour.device)
    colour, key, has_lines, tot = _clear_lines(cfg, colour, key, has_lines, tot)
    mask = effective_mask(cfg, colour, kind)
    shuffled = torch.zeros(B, dtype=torch.bool, device=colour.device)
    while True:
        go = ((~mask.any(-1)) | has_lines) & (tot < cap)
        if not bool(go.any()):
            break
        key, k = _split_where(go, key)
        s_colour, s_kind = apply_shuffle(colour, kind, trandom.permutation(k, cfg.flat_size))
        g3 = go[:, None, None]
        colour = torch.where(g3, s_colour, colour)
        kind = torch.where(g3, s_kind, kind)
        has_lines = torch.where(go, has_any_line(cfg, colour), has_lines)
        colour, key, has_lines, tot = _clear_lines(
            cfg, colour, key, has_lines, tot + go.to(torch.int32)
        )
        mask = torch.where(go[:, None], effective_mask(cfg, colour, kind), mask)
        shuffled = shuffled | go
    gave_up = (~mask.any(-1)) | has_lines
    return colour, kind, key, shuffled, mask & ~gave_up[:, None], gave_up


def generate_board(cfg: EnvConfig, keys):
    """Fresh all-normal boards, redrawn and shuffled until line-free with
    an effective move.  Returns (colour, kind, key, mask, gave_up)."""
    both = trandom.split(keys)
    colour = draw_colour_grid(both[:, 1], cfg)
    kind = torch.ones_like(colour)
    colour, kind, key, _, mask, gave_up = make_playable(
        cfg, colour, kind, both[:, 0], has_any_line(cfg, colour)
    )
    return colour, kind, key, mask, gave_up


def cascade(cfg: EnvConfig, colour, kind, sub):
    """Trips until line-free or ``max_cascades``.  Returns (colour, kind,
    elim, activated, new, truncated, trips)."""
    B = colour.shape[0]
    dev = colour.device
    elim = torch.zeros(B, dtype=torch.int32, device=dev)
    act, new, trips = elim.clone(), elim.clone(), elim.clone()
    trunc = torch.zeros(B, dtype=torch.bool, device=dev)
    for t in range(cfg.max_cascades):
        idx = has_any_line(cfg, colour).nonzero()[:, 0]
        if idx.numel() == 0:
            break
        c, k = colour[idx], kind[idx]
        if cfg.any_special:
            lines = get_colour_lines(cfg, c)
            matches = process_colour_lines(cfg, c, lines)
            c, k, a, n, r_ovf = resolve_colour_matches(cfg, c, k, matches)
            act.index_add_(0, idx, a)
            new.index_add_(0, idx, n)
            trunc.index_copy_(0, idx, trunc[idx] | matches.ovf | r_ovf)
        else:
            gone = line_union_mask(cfg, c)
            c = torch.where(gone, 0, c)
            k = torch.where(gone, 0, k)
        elim.index_add_(0, idx, cfg.flat_size - k.flatten(1).count_nonzero(-1).to(torch.int32))
        c, k = gravity(c, k)
        c, k = apply_refill(c, k, draw_colour_grid(trandom.fold_in(sub[idx], t), cfg))
        colour = colour.index_copy(0, idx, c)
        kind = kind.index_copy(0, idx, k)
        trips.index_add_(0, idx, torch.ones_like(idx, dtype=torch.int32))
    return colour, kind, elim, act, new, trunc | has_any_line(cfg, colour), trips


def combination_branch(cfg: EnvConfig, colour, kind, key, coord1, coord2):
    """The combination match (`board.py:357-366`), gravity, and a refill
    from ``key, k = split(key)``.  Returns (colour, kind, key, elim,
    activated, ovf)."""
    colour, kind, act, ovf = combination_match(cfg, colour, kind, coord1, coord2)
    elim = cfg.flat_size - kind.flatten(1).count_nonzero(-1).to(torch.int32)
    colour, kind = gravity(colour, kind)
    both = trandom.split(key)
    colour, kind = apply_refill(colour, kind, draw_colour_grid(both[:, 1], cfg))
    return colour, kind, both[:, 0], elim, act, ovf


def _move(cfg: EnvConfig, colour, kind, key, coord1, coord2):
    """``Board.move`` of boards whose move is effective."""
    B = colour.shape[0]
    dev = colour.device
    colour, kind = swap_cells(colour, kind, coord1, coord2)
    elim = torch.zeros(B, dtype=torch.int32, device=dev)
    act = elim.clone()
    trunc = torch.zeros(B, dtype=torch.bool, device=dev)
    comb = trunc.clone()
    if cfg.any_special:
        comb = is_combination(kind, coord1, coord2)
        ci = comb.nonzero()[:, 0]
        if ci.numel():
            c, k, kk, e, a, o = combination_branch(
                cfg, colour[ci], kind[ci], key[ci], coord1[ci], coord2[ci]
            )
            colour, kind, key = colour.index_copy(0, ci, c), kind.index_copy(0, ci, k), key.index_copy(0, ci, kk)
            elim, act, trunc = elim.index_copy(0, ci, e), act.index_copy(0, ci, a), trunc.index_copy(0, ci, o)
    both = trandom.split(key)
    colour, kind, e, a, new, t, trips = cascade(cfg, colour, kind, both[:, 1])
    false = torch.zeros(B, dtype=torch.bool, device=dev)
    colour, kind, key, shuffled, mask, gave_up = make_playable(cfg, colour, kind, both[:, 0], false)
    # new specials filled holes: they count as eliminations (`board.py:378`)
    return (colour, kind, key, elim + e + new, comb, new, act + a, shuffled, mask,
            trunc | t | gave_up, trips)


def reset(cfg: EnvConfig, keys):
    """``TileMatchEnv.reset`` for keys int64[B, 2]: (state, mask, gave_up)."""
    colour, kind, key, mask, gave_up = generate_board(cfg, keys)
    timer = torch.zeros(colour.shape[0], dtype=torch.int32, device=colour.device)
    return EnvState(colour, kind, timer, key), mask, gave_up


def step(cfg: EnvConfig, state: EnvState, action, mask):
    """``TileMatchEnv.step`` for a batch whose current masks are ``mask``
    bool[B, A], auto-resetting every finished episode from
    ``generate_board(split(key)[1])``.  Returns (next state, info): a dict
    of the reward float32[B], done, the next mask (the new episode's where
    done), and the move's counts and flags."""
    c1_tab, c2_tab = (torch.from_numpy(t).to(state.colour.device) for t in action_table(cfg))
    a = action.long()
    coord1, coord2 = c1_tab[a], c2_tab[a]
    eff = mask.gather(1, a[:, None])[:, 0]
    B = state.colour.shape[0]
    dev = state.colour.device
    colour, kind, key = state.colour, state.kind, state.key
    zero = torch.zeros(B, dtype=torch.int32, device=dev)
    false = torch.zeros(B, dtype=torch.bool, device=dev)
    elim, new, act, trips = zero, zero, zero, zero
    comb, shuffled, trunc = false, false, false
    next_mask = mask
    ei = eff.nonzero()[:, 0]
    if ei.numel():
        out = _move(cfg, colour[ei], kind[ei], key[ei], coord1[ei], coord2[ei])
        colour, kind, key = (x.index_copy(0, ei, o) for x, o in zip((colour, kind, key), out[:3]))
        elim, comb, new, act, shuffled, next_mask, trunc, trips = (
            x.index_copy(0, ei, o) for x, o in zip(
                (elim, comb, new, act, shuffled, next_mask, trunc, trips), out[3:]))
    timer = state.timer + 1
    done = timer >= cfg.num_moves
    di = done.nonzero()[:, 0]
    if di.numel():
        c, k, kk, m, _ = generate_board(cfg, trandom.split(key[di])[:, 1])
        colour, kind, key = colour.index_copy(0, di, c), kind.index_copy(0, di, k), key.index_copy(0, di, kk)
        timer = timer.index_fill(0, di, 0)
        next_mask = next_mask.index_copy(0, di, m)
    info = {
        "reward": elim.to(torch.float32), "done": done, "mask": next_mask,
        "is_combination_match": comb, "num_new_specials": new,
        "num_specials_activated": act, "shuffled": shuffled, "truncated": trunc,
        "cascade_trips": trips,
    }
    return EnvState(colour, kind, timer, key), info
