"""Colour-line detection on batches of boards (counterpart of the
no-specials half of ``tile_match_tpu.ops.lines``).

Semantics of the original game's ``get_colour_lines`` (`board.py:149-215`):
only lines anchored in the lowest row that holds one are primary —
horizontal runs >= 3 lying in that row and vertical runs >= 3 whose bottom
cell is in it — and each primary cell adds the >= 3 same-colour extension
segments through it.  ``get_colour_lines`` gives the lines as a ``LineSet``
of slots, in the order the classification queue reads them; with every
special disabled a cascade trip needs only ``line_union_mask``.

Every function takes colour int32[B, R, C] and returns per-board results.

The line test, ``run_member_mask`` and ``has_any_line``, is one launch of a
CUDA kernel on CUDA tensors (``csrc/line_test.cu``, one library for
every board shape), and its plain
version, the run-extent scans below (``plain_run_member_mask``,
``plain_has_any_line``: torch ops on any device), on CPU tensors; any
other device raises.  ``cuda_build.launches["line_test"]`` counts the
kernel's launches; each runs in program span ``line_test`` with ``boards``
(the launch's batch) and ``what`` (``member`` or ``any``).
"""

from __future__ import annotations

import dataclasses

import torch

from .. import cuda_build
from ..config import EnvConfig
from ..profiling import span as program_span
from .runs import BIG, _cummax, _cummin_rev, _shift, colour_run_extents, true_run_extents

def _line_test(colour: torch.Tensor, what: str) -> torch.Tensor:
    """The kernel's ``member`` mask bool[B, R, C] or ``any`` bool[B] of
    colour int32[B, R, C] on its card: one launch, none for an empty batch.
    A strided view is copied contiguous first."""
    if colour.dtype != torch.int32 or colour.dim() != 3:
        raise ValueError(f"colour must be an int32[B, R, C] tensor, got {colour.dtype}{list(colour.shape)}")
    B, R, C = colour.shape
    shape = (B, R, C) if what == "member" else (B,)
    if colour.numel() == 0:
        return torch.zeros(shape, dtype=torch.bool, device=colour.device)
    out = torch.empty(shape, dtype=torch.bool, device=colour.device)
    colour = colour.contiguous()
    with program_span("line_test", boards=B, what=what):
        cuda_build.launch(f"tmt_line_test_{what}", colour.device, None, colour.data_ptr(),
                          out.data_ptr(), B, R, C)
    return out


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


def extension_lengths(colour: torch.Tensor, primary: torch.Tensor):
    """(lext, rext, uext, dext) int32[B, R, C]: the length of the chain of
    same-colour, non-primary cells on each side of every cell — the
    extension segment through a primary cell is 1 + lext + rext along its
    row and 1 + uext + dext along its column."""
    valid = colour > 0
    row_ids, col_ids = _row_col_ids(colour)
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
    return lext, rext, uext, dext


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
    lext, rext, uext, dext = extension_lengths(colour, primary)
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
    of board generation (``engine.make_playable``).  One kernel launch on a
    CUDA tensor."""
    if cuda_build.on_card("line_test", colour):
        return _line_test(colour, "member")
    return plain_run_member_mask(cfg, colour)


def plain_run_member_mask(cfg: EnvConfig, colour: torch.Tensor) -> torch.Tensor:
    """``run_member_mask`` by the run-extent scans, torch ops on any device:
    the kernel's plain version."""
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
    """bool[B]: does any >= 3 colour run exist anywhere on the board?  One
    kernel launch on a CUDA tensor."""
    if cuda_build.on_card("line_test", colour):
        return _line_test(colour, "any")
    return plain_has_any_line(cfg, colour)


def plain_has_any_line(cfg: EnvConfig, colour: torch.Tensor) -> torch.Tensor:
    """``has_any_line`` by the run-extent scans, torch ops on any device:
    the kernel's plain version, which the plain cascades call."""
    return plain_run_member_mask(cfg, colour).flatten(1).any(-1)


@dataclasses.dataclass
class LineSet:
    """The detected lines of a batch of boards, in fixed-capacity slots
    (LM = ``cfg.lines_max``, L = ``cfg.line_len_max``)."""

    coords: torch.Tensor  # int32[B, LM, L, 2]; (-1, -1) padded
    length: torch.Tensor  # int32[B, LM]; 0 for unused slots
    count: torch.Tensor  # int32[B]
    ovf: torch.Tensor  # bool[B]: detected lines exceeded lines_max


def get_colour_lines(cfg: EnvConfig, colour: torch.Tensor) -> LineSet:
    """The lines of ``get_colour_lines`` (`board.py:149-215`) as slots.

    Primary lines first, by column, the vertical line before the
    horizontal one at the same column; then the extension segments of
    length >= 3 through primary cells, in order of the first primary cell
    (by its position in the primary coordinate list) that generates them,
    the horizontal extension before the vertical one.  Every line is stored
    with its coordinates ascending.  Lines beyond ``lines_max`` are dropped
    and set ``ovf``.
    """
    B, R, C = colour.shape
    LM, L = cfg.lines_max, cfg.line_len_max
    dev = colour.device
    row_ids, col_ids = _row_col_ids(colour)
    exists, sr0, hs, vs, v_bottom3, h_in3 = _lowest_line_row(colour)
    _, _, hl = colour_run_extents(colour, axis=-1)

    cols = torch.arange(C, dtype=torch.int32, device=dev).expand(B, C)
    ex = exists[:, None]
    vflag = _at_row(v_bottom3, sr0) & ex  # [B, C]
    vtop = _at_row(vs, sr0)
    vlen = sr0[:, None] - vtop + 1
    hflag = _at_row(h_in3, sr0) & (_at_row(hs, sr0) == cols) & ex
    hlen = _at_row(hl, sr0)

    def interleave(a, b):  # pre-slot 2c: vertical at column c; 2c+1: horizontal from c
        return torch.stack([a, b], dim=-1).reshape(B, 2 * C)

    pre_flag = interleave(vflag, hflag)
    pre_vert = interleave(torch.ones_like(vflag), torch.zeros_like(hflag))
    pre_fix = interleave(cols, sr0[:, None].expand(B, C))
    pre_start = interleave(vtop, cols)
    pre_len = interleave(vlen, hlen)
    slot_pos = pre_flag.to(torch.int32).cumsum(-1) - 1
    n_primary = pre_flag.sum(-1, dtype=torch.int32)

    # primary membership and each primary cell's first-occurrence key
    srow = sr0.reshape(B, 1, 1)
    ex3 = exists.reshape(B, 1, 1)
    member_v = vflag[:, None, :] & (vtop[:, None, :] <= row_ids) & (row_ids <= srow) & ex3
    member_h = (row_ids == srow) & h_in3 & ex3
    primary = member_v | member_h
    key_v = torch.where(member_v, (2 * col_ids) * L + (row_ids - vtop[:, None, :]), BIG)
    key_h = torch.where(member_h, (2 * hs + 1) * L + (col_ids - hs), BIG)
    key = torch.minimum(key_v, key_h)

    lext, rext, uext, dext = extension_lengths(colour, primary)
    is_gen = key < BIG
    h_ext_len = 1 + lext + rext
    v_ext_len = 1 + uext + dext
    ord_h = torch.where(is_gen & (h_ext_len >= 3), 2 * key, BIG).reshape(B, -1)
    ord_v = torch.where(is_gen & (v_ext_len >= 3), 2 * key + 1, BIG).reshape(B, -1)
    e_ord = torch.cat([ord_h, ord_v], dim=1)  # [B, 2RC]
    RC = R * C
    e_vert = torch.cat(
        [torch.zeros(B, RC, dtype=torch.int32, device=dev),
         torch.ones(B, RC, dtype=torch.int32, device=dev)], dim=1
    )
    e_fix = torch.cat(
        [row_ids.expand(B, R, C).reshape(B, RC), col_ids.expand(B, R, C).reshape(B, RC)], dim=1
    )
    e_start = torch.cat([(col_ids - lext).reshape(B, RC), (row_ids - uext).reshape(B, RC)], dim=1)
    e_len = torch.cat([h_ext_len.reshape(B, RC), v_ext_len.reshape(B, RC)], dim=1)

    n_ext_all = (e_ord < BIG).sum(-1, dtype=torch.int32)
    ovf = n_primary + n_ext_all > LM
    if cfg.debug_checks and bool(ovf.any()):
        n = int((n_primary + n_ext_all)[ovf][0])
        raise RuntimeError(f"lines_max overflow: {n} detected lines exceed capacity {LM}")

    # the first LM extension candidates by key (live keys are distinct)
    e_sorted, perm = torch.sort(e_ord, dim=-1, stable=True)
    e_sorted, perm = e_sorted[:, :LM], perm[:, :LM]
    n_ext = (e_sorted < BIG).sum(-1, dtype=torch.int32)
    ext_slot = n_primary[:, None] + torch.arange(LM, dtype=torch.int32, device=dev)
    ext_ok = (e_sorted < BIG) & (ext_slot < LM)

    # slot descriptors; writes beyond the LM slots land in a dump column
    # that is cut off
    p_idx = torch.where(pre_flag, slot_pos, LM).clamp(max=LM).long()
    e_idx = torch.where(ext_ok, ext_slot, LM).clamp(max=LM).long()

    def build(field_p, field_e):
        out = torch.zeros(B, LM + 1, dtype=torch.int32, device=dev)
        out.scatter_(1, p_idx, field_p.to(torch.int32))
        out.scatter_(1, e_idx, field_e.to(torch.int32).gather(1, perm))
        return out[:, :LM]

    d_vert = build(pre_vert, e_vert) > 0
    d_fix = build(pre_fix, e_fix)
    d_start = build(pre_start, e_start)
    d_len = build(pre_len, e_len)

    count = torch.clamp(n_primary + n_ext, max=LM)
    slot_live = torch.arange(LM, device=dev)[None, :] < count[:, None]
    d_len = torch.where(slot_live, d_len, 0)

    j = torch.arange(L, dtype=torch.int32, device=dev)
    rr = torch.where(d_vert[..., None], d_start[..., None] + j, d_fix[..., None])
    cc = torch.where(d_vert[..., None], d_fix[..., None], d_start[..., None] + j)
    in_len = j < d_len[..., None]
    coords = torch.stack([torch.where(in_len, rr, -1), torch.where(in_len, cc, -1)], dim=-1)
    return LineSet(
        coords=coords.to(torch.int32), length=d_len, count=count.to(torch.int32), ovf=ovf
    )
