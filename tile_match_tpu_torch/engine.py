"""The core engine on batches of boards (counterpart of
``tile_match_tpu.engine``).

``Board.move`` / ``Board.generate_board`` and ``TileMatchEnv.step/reset`` of
the original game (`board.py:95-112, 330-395`, `tile_match_env.py:84-112`)
as functions of a batched ``EnvState``.  The JAX package runs one board per
call under ``vmap`` with ``lax.while_loop``s; here every function takes the
whole batch, and each per-board loop is a masked batch loop: an iteration
splits keys, draws and updates only the boards still in the loop, so a board
that has left it consumes no random numbers and its state is exactly what
the per-board loop would leave.

The cascade of a move runs on the kernels: without specials K1
(``ops.cascade.fused_cascade``), which also hands back the settled mask;
with specials, after the combination branch (K5,
``ops.combination.combination_trip``; its plain version
``combination_branch``), ``fused_specials_cascade`` —
K2 (``ops.cascade_sp.cascade_sp_chunk``) takes every board's simple trips,
K4 (``ops.trip_sp.specials_trip``) the full-machinery trips of the others
(detect, classify, resolve, gravity, refill; its plain version
``specials_cascade_trip``) — and the settled mask is K3
(``ops.mask_sp.settled_mask_sp``).  Every other settled mask — of a fresh
board, of a shuffled one, of a step called without one — is K3 too, with
specials or without.  On CUDA tensors these are the CUDA kernels, on CPU
tensors their plain versions.  Every special set runs;
without the bomb K2 takes its no-bomb case table.
"""

from __future__ import annotations

import functools
from typing import Tuple

import torch

from . import random as trandom
from .config import EnvConfig
from .ops.board_ops import apply_refill, apply_shuffle, draw_colour_grid, gravity, swap_cells
from .ops.cascade import fused_cascade
from .ops.cascade_sp import cascade_sp_chunk
from .ops.classify import process_colour_lines
from .ops.combination import combination_match, combination_trip, is_combination
from .ops.lines import get_colour_lines, has_any_line, run_member_mask
from .ops.mask_sp import settled_mask_sp
from .ops.resolve import resolve_colour_matches
from .ops.trip_sp import specials_trip
from .profiling import span
from .state import EnvState, StepInfo, action_table


def _split_where(go: torch.Tensor, key: torch.Tensor):
    """``key, sub = split(key)`` on the boards where ``go``; the others keep
    their key.  Returns (new key, sub)."""
    both = trandom.split(key)
    return torch.where(go[:, None], both[:, 0], key), both[:, 1]


def _going(go: torch.Tensor, count: list) -> int:
    """The boards in ``go``, as the loops' one reduction and host read an
    iteration; when any, adds the iteration and its boards to ``count``
    [loops, live] (the ``playable`` span's counts)."""
    n = int(go.sum())
    if n:
        count[0] += 1
        count[1] += n
    return n


def _clear_lines(cfg, colour, key, has_lines, tot, count):
    """Redraw the cells of every >= 3 run until the board is line-free or
    the shared ``max_regen_iters`` budget ``tot`` runs out; one key split
    per iteration, counted into ``count`` (``_going``)."""
    while True:
        go = has_lines & (tot < cfg.max_regen_iters)
        if not _going(go, count):
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

    Runs in span ``playable`` with ``boards``, ``loops`` (the iterations of
    both loops) and ``live`` (the boards still going, summed over them).
    """
    B = colour.shape[0]
    cap = cfg.max_regen_iters
    count = [0, 0]
    with span("playable", boards=B) as sp:
        tot = torch.zeros(B, dtype=torch.int32, device=colour.device)
        if skip is not None:
            tot = torch.where(skip, cap, tot)
        colour, key, has_lines, tot = _clear_lines(cfg, colour, key, init_has_lines, tot, count)
        mask = settled_mask_sp(cfg, colour, kind) if mask0 is None else mask0
        shuffled = torch.zeros(B, dtype=torch.bool, device=colour.device)
        while True:
            go = ((~mask.any(-1)) | has_lines) & (tot < cap)
            if not _going(go, count):
                break
            key, k = _split_where(go, key)
            perm = trandom.permutation(k, cfg.flat_size)
            s_colour, s_kind = apply_shuffle(colour, kind, perm)
            g3 = go[:, None, None]
            colour = torch.where(g3, s_colour, colour)
            kind = torch.where(g3, s_kind, kind)
            has_lines = torch.where(go, has_any_line(cfg, colour), has_lines)
            colour, key, has_lines, tot = _clear_lines(
                cfg, colour, key, has_lines, tot + go.to(torch.int32), count
            )
            mask = torch.where(go[:, None], settled_mask_sp(cfg, colour, kind), mask)
            shuffled = shuffled | go
        gave_up = (~mask.any(-1)) | has_lines
        mask = mask & ~gave_up[:, None]
        sp.set(loops=count[0], live=count[1])
    return colour, kind, key, shuffled, mask, gave_up


def generate_board(cfg: EnvConfig, keys):
    """Fresh all-normal boards, redrawn and shuffled until line-free with at
    least one effective move (`board.py:95-112`).  Returns (colour, kind,
    key, mask, gave_up), in span ``regenerate`` with ``boards``."""
    with span("regenerate", boards=keys.shape[0]):
        both = trandom.split(keys)
        key, k = both[:, 0], both[:, 1]
        colour = draw_colour_grid(k, cfg)
        kind = torch.ones_like(colour)
        colour, kind, key, _, mask, gave_up = make_playable(
            cfg, colour, kind, key, has_any_line(cfg, colour)
        )
    return colour, kind, key, mask, gave_up


def specials_cascade_trip_grid(cfg: EnvConfig, colour, kind, grid):
    """One full cascade trip (`board.py:369-376`) with its refill grid given:
    detect -> classify -> resolve -> gravity -> refill(grid).  Returns
    (colour, kind, elim, activated, new, ovf), the counts int32[B]."""
    lines = get_colour_lines(cfg, colour)
    matches = process_colour_lines(cfg, colour, lines)
    colour, kind, act_d, new_d, r_ovf = resolve_colour_matches(cfg, colour, kind, matches)
    elim_d = cfg.flat_size - kind.flatten(1).count_nonzero(-1).to(torch.int32)
    colour, kind = gravity(colour, kind)
    colour, kind = apply_refill(colour, kind, grid)
    return colour, kind, elim_d, act_d, new_d, matches.ovf | r_ovf


def specials_cascade_trip(cfg: EnvConfig, colour, kind, sub, it):
    """``specials_cascade_trip_grid`` refilling trip ``it`` (int or int[B])
    from ``draw_colour_grid(fold_in(sub, it))``: K4's plain version
    (``ops.trip_sp.specials_trip``)."""
    grid = draw_colour_grid(trandom.fold_in(sub, it), cfg)
    return specials_cascade_trip_grid(cfg, colour, kind, grid)


# Telemetry of ``fused_specials_cascade``, summed over its calls since the
# last ``reset_cascade_stats()``: loop rounds and trips run by the full
# machinery.  Host integers, so that the counts hold across devices; each
# board's freeze reasons are in ``last_cascade``.
cascade_stats: dict = {}


def reset_cascade_stats() -> None:
    cascade_stats.update(rounds=0, full_trips=0)


reset_cascade_stats()

# Per-board telemetry of the last call of ``fused_specials_cascade`` (the
# JAX package's ``with_stats``): ``reasons`` int32[B], the OR of each
# board's K2 reason bits over the cascade; ``full_trips`` int32[B], each
# board's trips run by the full machinery; ``rounds``, the loop's rounds
# (a host int; the JAX loop compacts at most 128 or 256 frozen boards a
# round, this one runs every frozen board, so the two counts differ).
last_cascade: dict = {}


def fused_specials_cascade(cfg: EnvConfig, colour, kind, sub_keys):
    """The cascade of a move with specials, for a batch: colour, kind
    int32[B, R, C] (no empty cell), sub_keys int64[B, 2].

    Each round launches K2 (``cascade_sp_chunk``) on every board still
    cascading — it runs each board's simple trips and freezes a board whose
    next trip is not simple — then runs one full trip on every frozen board
    (K4, ``specials_trip``).  Every round moves each cascading board at
    least one trip forward — K2 runs a simple trip or freezes the board,
    and a frozen board takes its full trip — so the loop ends within
    ``max_cascades`` rounds.  Each round runs in span ``cascade_round``
    with ``boards``, the boards K2 takes, and ``frozen``, those K4 takes;
    the span ends on the read of the next round's boards, so it holds the
    wait for its own device work.

    Returns (colour, kind, elim, activated, new, trips, truncated), adds
    to ``cascade_stats`` and replaces ``last_cascade``.
    """
    B = colour.shape[0]
    T = cfg.max_cascades
    dev = colour.device
    zero = torch.zeros(B, dtype=torch.int32, device=dev)
    trips, elim, act, new = zero.clone(), zero.clone(), zero.clone(), zero.clone()
    trunc = torch.zeros(B, dtype=torch.bool, device=dev)
    active = has_any_line(cfg, colour)
    idx = active.nonzero()[:, 0]
    board_reasons, board_full, rounds = zero.clone(), zero.clone(), 0
    while idx.numel():
        with span("cascade_round", boards=idx.numel()) as sp:
            zn = torch.zeros(idx.numel(), dtype=torch.int32, device=dev)
            c2, k2, t2, e2, n2, a2, fz, act2, r2 = cascade_sp_chunk(
                cfg, colour[idx].contiguous(), kind[idx].contiguous(),
                sub_keys[idx].contiguous(), trips[idx].contiguous(), zn, zn, limit=T,
            )
            colour = colour.index_copy(0, idx, c2)
            kind = kind.index_copy(0, idx, k2)
            trips = trips.index_copy(0, idx, t2)
            elim.index_add_(0, idx, e2)
            new.index_add_(0, idx, n2)
            act.index_add_(0, idx, a2)
            still = act2 & (t2 < T)

            fidx = idx[fz > 0]
            sp.set(frozen=fidx.numel())
            if fidx.numel():
                c3, k3, e3, a3, n3, o3 = specials_trip(
                    cfg, colour[fidx], kind[fidx], sub_keys[fidx], trips[fidx]
                )
                colour = colour.index_copy(0, fidx, c3)
                kind = kind.index_copy(0, fidx, k3)
                trips.index_add_(0, fidx, torch.ones_like(e3))
                elim.index_add_(0, fidx, e3)
                act.index_add_(0, fidx, a3)
                new.index_add_(0, fidx, n3)
                trunc[fidx] |= o3
                still[fz > 0] = has_any_line(cfg, c3) & (trips[fidx] < T)
            active = torch.zeros_like(active).index_copy_(0, idx, still)
            board_reasons[idx] |= r2
            board_full.index_add_(0, fidx, torch.ones_like(fidx, dtype=torch.int32))
            rounds += 1
            cascade_stats["rounds"] += 1
            cascade_stats["full_trips"] += fidx.numel()
            idx = active.nonzero()[:, 0]
    last_cascade.update(reasons=board_reasons, full_trips=board_full, rounds=rounds)
    return colour, kind, elim, act, new, trips, trunc | has_any_line(cfg, colour)


def combination_branch(cfg: EnvConfig, colour, kind, key, coord1, coord2, comb):
    """The combination match of the boards where ``comb`` (`board.py:
    357-366`): the match, gravity, and a refill from ``key, k = split(key)``.
    Returns (colour, kind, key, elim, activated, ovf); other boards come
    back unchanged with zero counts.  K5's plain version
    (``ops.combination.combination_trip``)."""
    B = colour.shape[0]
    dev = colour.device
    elim = torch.zeros(B, dtype=torch.int32, device=dev)
    act = torch.zeros_like(elim)
    ovf = torch.zeros(B, dtype=torch.bool, device=dev)
    idx = comb.nonzero()[:, 0]
    if idx.numel() == 0:
        return colour, kind, key, elim, act, ovf
    c2, k2, a, o = combination_match(cfg, colour[idx], kind[idx], coord1[idx], coord2[idx])
    e = cfg.flat_size - k2.flatten(1).count_nonzero(-1).to(torch.int32)
    c2, k2 = gravity(c2, k2)
    both = trandom.split(key[idx])
    c2, k2 = apply_refill(c2, k2, draw_colour_grid(both[:, 1], cfg))
    return (
        colour.index_copy(0, idx, c2), kind.index_copy(0, idx, k2),
        key.index_copy(0, idx, both[:, 0]),
        elim.index_copy(0, idx, e), act.index_copy(0, idx, a), ovf.index_copy(0, idx, o),
    )


def engine_move(cfg: EnvConfig, colour, kind, key, coord1, coord2, eff, cur_mask):
    """``Board.move`` (`board.py:330-395`) for a batch.

    Boards where ``eff`` is False are no-ops: board, key and ``cur_mask``
    come back unchanged.  An effective move swaps; with specials, a swap of
    two specials or of a cookie runs the combination branch
    (``combination_trip``, K5 on the card); then ``key, sub = split(key)``,
    the cascade and the playability loop.

    The cascade is ``fused_cascade`` without specials and
    ``fused_specials_cascade`` then ``settled_mask_sp`` with them; its call
    runs in span ``cascade`` with ``rounds`` (1 for K1's one launch).

    Returns (colour, kind, key, eliminations, is_comb, new_specials,
    activated, shuffled, post_mask, truncated, trips).
    """
    B = colour.shape[0]
    dev = colour.device
    e1, e3 = eff[:, None], eff[:, None, None]
    sw_colour, sw_kind = swap_cells(colour, kind, coord1, coord2)
    moved = torch.where(e3, sw_colour, colour)
    zero = torch.zeros(B, dtype=torch.int32, device=dev)
    false = torch.zeros(B, dtype=torch.bool, device=dev)

    # Non-effective boards go through the cascade unchanged and line-free:
    # 0 trips, and their outputs are discarded.
    if cfg.any_special:
        moved_kind = torch.where(e3, sw_kind, kind)
        comb = eff & is_combination(moved_kind, coord1, coord2)
        # on the card K5 updates the flagged boards of these temporaries in place
        moved, moved_kind, key_c, comb_elim, comb_act, comb_ovf = combination_trip(
            cfg, moved, moved_kind, key, coord1, coord2, comb
        )
        both = trandom.split(key_c)
        key_moved, sub = both[:, 0], both[:, 1].contiguous()
        with span("cascade") as sp:
            c_colour, c_kind, elim, act, new, trips, trunc = fused_specials_cascade(
                cfg, moved, moved_kind, sub
            )
            sp.set(rounds=last_cascade["rounds"])
        kmask = settled_mask_sp(cfg, c_colour, c_kind)
        # new specials filled holes: they count as eliminations (`board.py:378`)
        elim = comb_elim + elim + new
        act = comb_act + act
        trunc = trunc | comb_ovf
    else:
        both = trandom.split(key)
        key_moved, sub = both[:, 0], both[:, 1].contiguous()
        with span("cascade", rounds=1):  # K1 runs the whole cascade in one launch
            c_colour, elim, trips, trunc, kmask = fused_cascade(cfg, moved, sub)
        c_kind = kind  # all-normal before and after the cascade
        comb, new, act = false, zero, zero

    p_colour, p_kind, p_key, p_shuffled, p_mask, p_gave_up = make_playable(
        cfg, c_colour, c_kind, key_moved, false, mask0=kmask, skip=~eff,
    )
    return (
        torch.where(e3, p_colour, colour),
        torch.where(e3, p_kind, kind),
        torch.where(e1, p_key, key),
        torch.where(eff, elim, zero),
        comb,
        torch.where(eff, new, zero),
        torch.where(eff, act, zero),
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
        settled_mask_sp(cfg, state.colour.contiguous(), state.kind.contiguous())
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
