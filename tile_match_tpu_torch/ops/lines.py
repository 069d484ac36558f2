"""Colour-line detection on batches of boards (counterpart of the
no-specials half of ``tile_match_tpu.ops.lines``).

Semantics of the original game's ``get_colour_lines`` (`board.py:149-215`):
only lines anchored in the lowest row that holds one are primary —
horizontal runs >= 3 lying in that row and vertical runs >= 3 whose bottom
cell is in it — and each primary cell adds the >= 3 same-colour extension
segments through it.  The LineSet form of that detection serves only the
specials machinery and is not ported yet; with every special disabled a
cascade trip needs only the union mask below.

Every function takes colour int32[B, R, C] and returns per-board results.
"""

from __future__ import annotations

import torch

from ..config import EnvConfig
from .runs import BIG, _cummax, _cummin_rev, _shift, colour_run_extents, true_run_extents


def _row_col_ids(colour: torch.Tensor):
    _, R, C = colour.shape
    dev = colour.device
    row_ids = torch.arange(R, dtype=torch.int32, device=dev).reshape(1, R, 1)
    col_ids = torch.arange(C, dtype=torch.int32, device=dev).reshape(1, 1, C)
    return row_ids, col_ids


def _at_row(x: torch.Tensor, rows: torch.Tensor) -> torch.Tensor:
    """x[b, rows[b], :] for x of shape [B, R, C] -> [B, C]."""
    B, _, C = x.shape
    return x.gather(1, rows.long().reshape(B, 1, 1).expand(B, 1, C))[:, 0]


def _lowest_line_row(colour: torch.Tensor):
    """Shared front of ``line_union_mask`` and ``first_line_info``."""
    valid = colour > 0
    row_ids, _ = _row_col_ids(colour)
    hs, _he, hl = colour_run_extents(colour, axis=-1)
    vs, ve, vl = colour_run_extents(colour, axis=-2)
    v_bottom3 = valid & (vl >= 3) & (ve == row_ids)
    h_in3 = valid & (hl >= 3)
    row_flag = h_in3.any(-1) | v_bottom3.any(-1)  # [B, R]
    exists = row_flag.any(-1)  # [B]
    r0 = torch.where(row_flag, row_ids[:, :, 0], -1).max(-1).values
    sr0 = r0.clamp(min=0)
    return exists, sr0, hs, vs, v_bottom3, h_in3


def line_union_mask(cfg: EnvConfig, colour: torch.Tensor) -> torch.Tensor:
    """bool[B, R, C]: the union of all cells of the detected lines —
    primary lowest-row lines plus their >= 3 extension segments.  One
    no-specials cascade trip deletes exactly this set.

    Extension cover runs as reach scans: a generator cell g (primary, with
    an extension of length >= 3) covers [g - lext, g + rext] in its row, and
    the same along its column.
    """
    valid = colour > 0
    row_ids, col_ids = _row_col_ids(colour)
    exists, sr0, _hs, vs, v_bottom3, h_in3 = _lowest_line_row(colour)

    vflag = _at_row(v_bottom3, sr0)[:, None, :]  # [B, 1, C]
    vtop = _at_row(vs, sr0)[:, None, :]
    srow = sr0.reshape(-1, 1, 1)
    member_v = vflag & (vtop <= row_ids) & (row_ids <= srow)
    member_h = (row_ids == srow) & h_in3
    primary = (member_v | member_h) & exists.reshape(-1, 1, 1)
    nonprim = ~primary

    def ext(axis, pos_ids):
        ok_fwd = nonprim & valid & (colour == _shift(colour, axis, 1, -1))
        _, te = true_run_extents(ok_fwd, axis)
        ok_next = _shift(ok_fwd, axis, -1, False)
        te_next = _shift(te, axis, -1, -1)
        fwd = torch.where(ok_next, te_next - pos_ids, 0)
        ok_bwd = nonprim & valid & (colour == _shift(colour, axis, -1, -1))
        ts, _ = true_run_extents(ok_bwd, axis)
        ok_prev = _shift(ok_bwd, axis, 1, False)
        ts_prev = _shift(ts, axis, 1, BIG)
        bwd = torch.where(ok_prev, pos_ids - ts_prev, 0)
        return bwd, fwd

    lext, rext = ext(-1, col_ids)
    uext, dext = ext(-2, row_ids)
    cand_h = primary & (1 + lext + rext >= 3)
    cand_v = primary & (1 + uext + dext >= 3)

    right_reach = _cummax(torch.where(cand_h, col_ids + rext, -1), -1)
    left_reach = _cummin_rev(torch.where(cand_h, col_ids - lext, BIG), -1)
    cover_h = (right_reach >= col_ids) | (left_reach <= col_ids)
    down_reach = _cummax(torch.where(cand_v, row_ids + dext, -1), -2)
    up_reach = _cummin_rev(torch.where(cand_v, row_ids - uext, BIG), -2)
    cover_v = (down_reach >= row_ids) | (up_reach <= row_ids)

    return primary | ((cover_h | cover_v) & valid)


def run_member_mask(cfg: EnvConfig, colour: torch.Tensor) -> torch.Tensor:
    """bool[B, R, C]: cells of ANY >= 3 same-colour run — the redraw target
    of board generation (``engine.make_playable``)."""
    valid = colour > 0
    _, _, hl = colour_run_extents(colour, axis=-1)
    _, _, vl = colour_run_extents(colour, axis=-2)
    return valid & ((hl >= 3) | (vl >= 3))


def first_line_info(cfg: EnvConfig, colour: torch.Tensor):
    """(has_lines bool[B], top row of the first detected line int32[B]).

    The first detected line is a primary one — vertical before horizontal
    at the same column — and its first coordinate is its topmost cell.
    """
    B, _, C = colour.shape
    exists, sr0, hs, vs, v_bottom3, h_in3 = _lowest_line_row(colour)
    cols = torch.arange(C, dtype=torch.int32, device=colour.device)
    vflag = _at_row(v_bottom3, sr0)
    hflag = _at_row(h_in3, sr0) & (_at_row(hs, sr0) == cols)
    pre_flag = torch.stack([vflag, hflag], dim=-1).reshape(B, 2 * C)
    pre_top = torch.stack(
        [_at_row(vs, sr0), sr0[:, None].expand(B, C)], dim=-1
    ).reshape(B, 2 * C)
    first = pre_flag.to(torch.int32).argmax(-1, keepdim=True)
    top = torch.where(exists, pre_top.gather(1, first)[:, 0], 0)
    return exists, top.to(torch.int32)


def has_any_line(cfg: EnvConfig, colour: torch.Tensor) -> torch.Tensor:
    """bool[B]: does any >= 3 colour run exist anywhere on the board?"""
    return run_member_mask(cfg, colour).flatten(1).any(-1)
