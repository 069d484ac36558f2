"""The specials cascade's simple trips: its CUDA kernel's wrapper and its
plain PyTorch version (counterpart of ``cascade_sp_chunk`` in
``tile_match_tpu.ops.pallas_cascade``).

Most cascade trips on most boards classify and resolve in closed form:
disjoint normal lines, unshared 4-lines (lasers) and 5..8-lines (cookies),
isolated pairs and stars of sharing lines (bombs), with the lasers and
bombs among the deleted cells activating as one converged closure.  One
call runs, for every board, its leading such trips — delete, create the
specials, gravity, refill trip t of the board from ``draw_colour_grid(
fold_in(sub, t))`` — and stops a board when it is line-free, at
``cfg.max_cascades`` trips, after ``limit`` trips, or when its next trip is
not simple: then the board is **frozen** and the caller runs that trip
through the full classify/resolve machinery (``engine.
specials_cascade_trip_grid``).  ``reasons`` says why a board froze.

Input boards hold no empty cell (colour 0 and kind 0).  Configs without
the bomb take a case table of their own (``_case_table_no_bomb``), where
every line classifies by its length alone.

``cascade_sp_chunk`` launches the CUDA kernel (``csrc/cascade_sp.cu``) on
CUDA tensors and runs ``cascade_sp_reference`` on CPU tensors.
"""

from __future__ import annotations

import torch

from .. import cuda_build
from .. import random as trandom
from ..config import EnvConfig
from ..profiling import kernel_span
from .board_ops import apply_refill, draw_colour_grid, gravity
from .lines import _row_col_ids, extension_lengths, plain_has_any_line
from .runs import BIG, _cummax, _cummin_rev, colour_run_extents

# Why a board froze (bits OR-ed into ``reasons``).
REASON_LEN5 = 1  # cookie line too long (>= 9) or a shared >= 5 line
REASON_EXT4 = 2  # extension line of length >= 5
REASON_EXT_BOMB = 4  # primary + extension structure outside the case table
REASON_COOKIE_HIT = 8  # a cookie in the deleted cells or hit by the activation closure
REASON_UNCONVERGED = 16  # activation closure not converged within _NEXP expansions
REASON_CROSS = 32  # h x v primary crossing outside the case table
REASON_MULTI = 64  # a line with >= 2 shares, or overlapping extensions

_NEXP = 4  # expansions of the activation closure


def _check_config(cfg: EnvConfig) -> None:
    if not cfg.any_special:
        raise ValueError("cascade_sp runs configs with specials; use ops.cascade")


def _detect(colour: torch.Tensor) -> dict:
    """The per-cell detection of one trip: the union of the detected lines
    and the intermediates the case table reads (run offsets and lengths,
    primary membership, extension candidates and lengths)."""
    valid = colour > 0
    row_ids, col_ids = _row_col_ids(colour)
    hs, he, _ = colour_run_extents(colour, axis=-1)
    vs, ve, _ = colour_run_extents(colour, axis=-2)
    lcnt = torch.where(valid, col_ids - hs, 0)
    rcnt = torch.where(valid, he - col_ids, 0)
    ucnt = torch.where(valid, row_ids - vs, 0)
    dcnt = torch.where(valid, ve - row_ids, 0)
    hl = lcnt + rcnt + 1
    vl = ucnt + dcnt + 1
    h_in3 = valid & (hl >= 3)
    v_b3 = valid & (vl >= 3) & (dcnt == 0)
    sr0 = torch.where(h_in3 | v_b3, row_ids, -1).amax((1, 2), keepdim=True)
    exists = sr0 >= 0
    rowmask = row_ids == sr0
    vflag_cell = v_b3 & rowmask
    vflag = vflag_cell.any(1, keepdim=True)
    vtop = torch.where(vflag_cell, row_ids - ucnt, 0).sum(1, keepdim=True)
    member_v = vflag & (vtop <= row_ids) & (row_ids <= sr0)
    member_h = rowmask & h_in3
    primary = (member_v | member_h) & exists
    lext, rext, uext, dext = extension_lengths(colour, primary)
    cand_h = primary & (1 + lext + rext >= 3)
    cand_v = primary & (1 + uext + dext >= 3)
    right_reach = _cummax(torch.where(cand_h, col_ids + rext, -1), -1)
    left_reach = _cummin_rev(torch.where(cand_h, col_ids - lext, BIG), -1)
    cover_h = (right_reach >= col_ids) | (left_reach <= col_ids)
    down_reach = _cummax(torch.where(cand_v, row_ids + dext, -1), -2)
    up_reach = _cummin_rev(torch.where(cand_v, row_ids - uext, BIG), -2)
    cover_v = (down_reach >= row_ids) | (up_reach <= row_ids)
    return dict(
        union=primary | ((cover_h | cover_v) & valid), exists=exists[:, 0, 0],
        hs=hs.long(), member_h=member_h, member_v=member_v & exists, hl=hl, vl=vl,
        lcnt=lcnt, rcnt=rcnt, ucnt=ucnt, cand_h=cand_h, cand_v=cand_v,
        hext=1 + lext + rext, vext=1 + uext + dext,
        lext=lext, rext=rext, uext=uext, dext=dext,
        cover_h=cover_h, cover_v=cover_v, nonprim=~primary,
    )


def _case_table_no_bomb(cfg: EnvConfig, a: dict):
    """The closed-form classification of one trip without the bomb; returns
    what ``_case_table`` returns.

    Without the bomb no line pairs with another (`board.py:304-320` needs
    it), so every line classifies by its length alone: 3-lines and, with
    the cookie off, >= 5-lines are normals; a 4-line is a laser at its
    second cell (the h -> v fallback as in ``_case_table``); a 5..8-line
    with the cookie on is a cookie at its third cell whose first five cells
    go, a length-8 line's remainder goes as a normal and 6- and 7-lines
    keep their tail.  Creation picks never collide: a v-line's pick lies
    above the flag row, and extensions of length 3 create nothing.  A cell
    survives only if every line holding it leaves it in its tail: a tail
    cell that a crossing line or an extension also holds is deleted by
    that line (the reference kernel's no-bomb branch keeps it,
    `pallas_cascade.py:527-529`; the machinery deletes it), and the corner
    of two crossing 6- or 7-lines that is in both tails survives.  Lines
    of length >= 9 (the remainder classifies again) and extensions of
    length >= 4 freeze the board.
    """
    h_code = 3 if cfg.horizontal_laser else (2 if cfg.vertical_laser else 0)
    v_code = 2 if cfg.vertical_laser else 0
    member_h, member_v = a["member_h"], a["member_v"]
    hl, vl = a["hl"], a["vl"]
    lcnt, ucnt = a["lcnt"], a["ucnt"]
    cand_h, cand_v = a["cand_h"], a["cand_v"]
    zb = torch.zeros_like(member_h)

    def any_(m):
        return m.flatten(1).any(-1)

    if cfg.cookie:
        len_bad = (member_h & (hl >= 9)) | (member_v & (vl >= 9))
    else:
        len_bad = zb
    ext_bad = (cand_h & (a["hext"] >= 4)) | (cand_v & (a["vext"] >= 4))
    reasons = (any_(len_bad) * REASON_LEN5 + any_(ext_bad) * REASON_EXT4).to(torch.int32)
    simple = ~any_(len_bad | ext_bad)

    h4 = member_h & (hl == 4) & (lcnt == 1) if h_code else zb
    v4 = member_v & (vl == 4) & (ucnt == 1) if v_code else zb
    if cfg.cookie:
        ck = (member_h & (hl >= 5) & (hl <= 8) & (lcnt == 2)) | (
            member_v & (vl >= 5) & (vl <= 8) & (ucnt == 2)
        )
        h_tail = member_h & (hl >= 6) & (hl <= 7) & (lcnt >= 5)
        v_tail = member_v & (vl >= 6) & (vl <= 7) & (ucnt >= 5)
        keep = (
            (h_tail | v_tail) & (h_tail | ~member_h) & (v_tail | ~member_v) & ~cand_h & ~cand_v
        )
    else:
        ck = keep = zb
    create = h4 | v4 | ck
    code = torch.where(
        h4, h_code, torch.where(v4, v_code, torch.where(ck, -1, 0))
    ).to(torch.int32)
    return simple, create, code, keep, reasons


def _case_table(cfg: EnvConfig, a: dict):
    """The closed-form classification of one trip.

    Returns (simple bool[B], create bool[B, R, C], code int32[B, R, C],
    keep bool[B, R, C], reasons int32[B]): when ``simple``, resolution
    deletes the union minus ``keep`` and creates a special of kind ``code``
    at each ``create`` cell.

    Absorbed: disjoint 3-lines (normals); unshared 4-lines (a laser at the
    line's second cell, with the h -> v fallback); unshared 5..8-lines with
    cookies on (a cookie at the third cell; the first five cells go, a
    length-8 line's remainder goes as a normal, 6- and 7-lines keep their
    tail); and sharing lines in isolated crossing pairs or stars — one
    centre primary with extension leaves — whose pop order (sort by first
    row, stable, primaries first, `board.py:282`) follows from the
    geometry: the first 3-line in pop order bomb-pairs with the first
    queued line sharing with it (a bomb at the share point, `board.py:
    441-447`; a 4-line partner keeps its farthest cell, `board.py:309-312`),
    4-lines popped before it become lasers, and every other line resolves
    alone.  Everything else freezes the board.  Configs without the bomb
    take ``_case_table_no_bomb``.
    """
    if not cfg.bomb:
        return _case_table_no_bomb(cfg, a)
    h_code = 3 if cfg.horizontal_laser else (2 if cfg.vertical_laser else 0)
    v_code = 2 if cfg.vertical_laser else 0
    member_h, member_v = a["member_h"], a["member_v"]
    hl, vl = a["hl"], a["vl"]
    lcnt, rcnt, ucnt = a["lcnt"], a["rcnt"], a["ucnt"]
    cand_h, cand_v = a["cand_h"], a["cand_v"]
    hext, vext = a["hext"], a["vext"]
    lext, rext, uext, dext = a["lext"], a["rext"], a["uext"], a["dext"]
    nonprim = a["nonprim"]
    hs = a["hs"]
    r_ids, c_ids = _row_col_ids(member_h)
    C = member_h.shape[2]
    zb = torch.zeros_like(member_h)

    def rs_row(v):  # sum of v over the cell's horizontal colour run
        v = v.to(torch.int32)
        return torch.zeros_like(v).scatter_add_(-1, hs, v).gather(-1, hs)

    def rmax_row(v):  # max of v (>= -1) over the cell's horizontal colour run
        return torch.full_like(v, -1).scatter_reduce_(-1, hs, v, "amax").gather(-1, hs)

    def col_sum(v):
        return v.to(torch.int32).sum(1, keepdim=True)

    def row_sum(v):
        return v.to(torch.int32).sum(2, keepdim=True)

    def any_(m):
        return m.flatten(1).any(-1)

    cross = member_h & member_v
    # per-v-line aggregates (one vertical primary per column)
    n_gh_col = col_sum(cand_h)
    n_crv_col = col_sum(cross)
    nsh_v = n_gh_col + n_crv_col
    # per-h-line aggregates (the colour run in the flag row is the line)
    n_gv_run = rs_row(cand_v)
    n_crh_run = rs_row(cross)
    nsh_h = n_gv_run + n_crh_run

    multi = (
        (nonprim & a["cover_h"] & a["cover_v"])
        | (cand_h & (row_sum(cand_h) >= 2))
        | (cand_v & (col_sum(cand_v) >= 2))
        | (member_h & (n_gv_run >= 1) & (n_crh_run >= 1))
        | (member_h & (n_crh_run >= 2))
        | (member_v & (n_crv_col >= 2))
    )
    ext_bad = (cand_h & (hext >= 5)) | (cand_v & (vext >= 5))

    # v-centre stars: the centre pops first
    v_star = member_v & (n_gh_col >= 1) & (n_crv_col == 0)
    top_g_row = torch.where(cand_h, r_ids, BIG).amin(1, keepdim=True)
    v3_top = cand_h & (vl == 3) & (n_crv_col == 0) & (r_ids == top_g_row)
    v4_star_bad = cand_h & (vl == 4) & (hext == 4) & (ucnt == 1)
    v_ck_ok = member_v & (vl >= 5) & (vl <= 7) & (nsh_v >= 1) if cfg.cookie else zb
    v_ck_bad = cand_h & (vl >= 5) & (vl <= 7) & (hext == 4) & (ucnt == 2)
    v_ck_col = v_ck_ok.any(1, keepdim=True)
    cross_leaf = cross & v_ck_col & (nsh_h == 1) & ((hl == 3) | (hl == 4))

    # h-centre stars
    h_star = member_h & (n_gv_run >= 1) & (n_crh_run == 0)
    e3 = cand_v & (vext == 3) & (uext >= 1)
    has_e3 = rs_row(e3) > 0
    init_key = torch.where(e3, uext * C + (C - 1 - c_ids), -1)
    initA = e3 & (init_key == rmax_row(init_key)) & h_star
    u0g = cand_v & (uext == 0)
    u0_key = torch.where(u0g, C - 1 - c_ids, -1)
    partB = u0g & (u0_key == rmax_row(u0_key)) & h_star & ~has_e3 & (hl == 3)
    ext4_u1 = cand_v & (vext == 4) & (uext == 1)
    ext4_u0 = cand_v & (vext == 4) & (uext == 0)
    h4_star_bad = h_star & (hl == 4) & ~has_e3 & (rs_row(ext4_u1 | (ext4_u0 & (lcnt == 1))) > 0)
    h_ck_ok = (
        member_h & (hl >= 5) & (hl <= 7) & (nsh_h >= 1) & (n_crh_run == 0) & ~has_e3
        if cfg.cookie else zb
    )
    h_ck_bad = (
        member_h & (hl >= 5) & (hl <= 7)
        & (has_e3 | (rs_row(ext4_u1 | (ext4_u0 & (lcnt == 2))) > 0))
        & (n_gv_run >= 1)
    )

    shared_h = member_h & (nsh_h >= 1)
    shared_v = member_v & (nsh_v >= 1)
    if cfg.cookie:
        len_bad = (
            (member_h & (hl >= 9)) | (member_v & (vl >= 9))
            | (shared_h & (hl == 8)) | (shared_v & (vl == 8))
            | (shared_h & (hl >= 5) & (hl <= 7) & ~(h_ck_ok & ~h_ck_bad))
            | (shared_v & (vl >= 5) & (vl <= 7) & ~v_ck_ok)
        )
    else:
        len_bad = (shared_h & (hl >= 5)) | (shared_v & (vl >= 5))

    # crossing pairs, both sides sharing once
    cr_pair = cross & (nsh_h == 1) & (nsh_v == 1)
    cr33 = cr_pair & (hl == 3) & (vl == 3)
    cr43 = cr_pair & (hl == 4) & (vl == 3)
    crv4 = cr_pair & (vl == 4) & ((hl == 3) | (hl == 4))
    cross_bad = cross & ~(cr33 | cr43 | crv4 | cross_leaf)
    star_bad = (
        v4_star_bad | (v_ck_bad & v_ck_col) | h4_star_bad
        | (cand_h & (hext <= 4) & (vl == 3) & (n_crv_col >= 1))
    )
    reasons = (
        any_(len_bad) * REASON_LEN5 + any_(ext_bad) * REASON_EXT4
        + any_(star_bad | h_ck_bad) * REASON_EXT_BOMB + any_(cross_bad) * REASON_CROSS
        + any_(multi) * REASON_MULTI
    ).to(torch.int32)
    simple = ~any_(len_bad | ext_bad | multi | cross_bad | star_bad | h_ck_bad)

    # creations
    bomb_cells = cr33 | cr43 | v3_top | (initA & ((hl == 3) | (hl == 4))) | partB
    v4_flag = crv4.any(1, keepdim=True) | ((n_gh_col >= 1) & (n_crv_col == 0))
    v4 = member_v & (vl == 4) & (ucnt == 1) & ((nsh_v == 0) | v4_flag)
    h4_flag = (rs_row((crv4 & (hl == 4)) | cross_leaf) > 0) | (
        (n_gv_run >= 1) & (n_crh_run == 0) & ~has_e3
    )
    h4 = member_h & (hl == 4) & (lcnt == 1) & ((nsh_h == 0) | h4_flag)
    ext_vl = cand_v & (vext == 4) & h_star & ~partB
    tgt_vr = torch.where(ext_vl, r_ids - uext + 2, 0).sum(1, keepdim=True)
    ext_vl_cells = (r_ids + 1) == tgt_vr
    ext_hl = cand_h & (hext == 4) & ((v_star & ~v3_top) | (v_ck_col & (vl >= 5)))
    tgt_hc = torch.where(ext_hl, c_ids - lext + 2, 0).sum(2, keepdim=True)
    ext_hl_cells = (c_ids + 1) == tgt_hc
    if cfg.cookie:
        ck = (
            member_h & (hl >= 5) & (hl <= 8) & (lcnt == 2) & ((nsh_h == 0) | h_ck_ok)
        ) | (member_v & (vl >= 5) & (vl <= 8) & (ucnt == 2) & ((nsh_v == 0) | v_ck_ok))
    else:
        ck = zb

    # survivors: union cells that no match's coordinate list holds
    hrun_s = cr43 | (initA & (hl == 4))
    surv_col = torch.where(rcnt > lcnt, c_ids + rcnt, c_ids - lcnt)
    keep = member_h & ((c_ids + 1) == rs_row(torch.where(hrun_s, surv_col + 1, 0)))
    hx_surv = torch.where(rext > lext, c_ids + rext, c_ids - lext)
    tgt_sc = torch.where(v3_top & (hext == 4), hx_surv + 1, 0).sum(2, keepdim=True)
    keep = keep | (((c_ids + 1) == tgt_sc) & nonprim)
    tgt_sr = torch.where(partB & (vext == 4), r_ids + dext + 1, 0).sum(1, keepdim=True)
    keep = keep | (((r_ids + 1) == tgt_sr) & nonprim)
    if cfg.cookie:
        keep = keep | (
            member_h & (hl >= 6) & (hl <= 7) & (lcnt >= 5) & ((nsh_h == 0) | h_ck_ok)
            & ~cand_v & ~cross & ~member_v
        )
        keep = keep | (
            member_v & (vl >= 6) & (vl <= 7) & (ucnt >= 5) & ((nsh_v == 0) | v_ck_ok)
            & ~cand_h & ~cross & ~member_h
        )

    vl_cells = (v4 | ext_vl_cells) if v_code else zb
    hl_cells = (h4 | ext_hl_cells) if h_code else zb
    create = bomb_cells | vl_cells | hl_cells | ck
    code = torch.where(
        bomb_cells, 4,
        torch.where(vl_cells, v_code, torch.where(hl_cells, h_code, torch.where(ck, -1, 0))),
    ).to(torch.int32)
    return simple, create, code, keep, reasons


def _regions(S: torch.Tensor, kind: torch.Tensor) -> torch.Tensor:
    """Cells wiped by the activated specials S: laser columns and rows,
    3x3 boxes of bombs."""
    R, C = S.shape[1], S.shape[2]
    vcol = (S & (kind == 2)).any(1, keepdim=True)
    hrow = (S & (kind == 3)).any(2, keepdim=True)
    bomb = torch.nn.functional.pad((S & (kind == 4)).to(torch.int8), (1, 1, 1, 1))
    bd = torch.zeros_like(S)
    for dr in range(3):
        for dc in range(3):
            bd = bd | (bomb[:, dr : dr + R, dc : dc + C] > 0)
    return vcol | hrow | bd


def _trip(cfg: EnvConfig, x, k):
    """One trip's decision and outcome on boards that hold a line.

    Returns (simple bool[b], reasons int32[b], dele bool[b, R, C], create,
    code, activated int32[b])."""
    a = _detect(x)
    shape_ok, create, code, keep, reasons = _case_table(cfg, a)
    dele_b = a["union"] & ~keep

    # the lasers and bombs among the deleted cells activate; their regions
    # hold only normals and specials of the closure, so the wipes commute
    # and the outcome is the union of the regions.  A cookie anywhere in
    # the closure, or a closure still growing after _NEXP expansions,
    # leaves the trip to the machinery.
    spec_cells = dele_b & (k != 1)
    n_spec = spec_cells.flatten(1).sum(-1)
    S = spec_cells & (k > 1)
    bad_sp = (spec_cells & (k == -1)).flatten(1).any(-1)
    live_sp = (k != 1) & (k != 0)
    for _ in range(_NEXP):
        hit = _regions(S, k) & live_sp
        bad_sp = bad_sp | (hit & (k == -1)).flatten(1).any(-1)
        S = S | (hit & (k > 1))
    region = _regions(S, k)
    hit_f = region & live_sp
    bad_sp = bad_sp | (hit_f & (k == -1)).flatten(1).any(-1)
    unconverged = (hit_f & (k > 1) & ~S).flatten(1).any(-1)
    act_lane = (n_spec > 0) & ~bad_sp & ~unconverged
    simple = shape_ok & ((n_spec == 0) | act_lane)
    reasons = (
        reasons + bad_sp * REASON_COOKIE_HIT + (unconverged & ~bad_sp) * REASON_UNCONVERGED
    ).to(torch.int32)
    dele = dele_b | (region & act_lane[:, None, None])
    return simple, reasons, dele, create, code, S.flatten(1).sum(-1, dtype=torch.int32)


def cascade_sp_reference(
    cfg: EnvConfig, colour, kind, sub_keys, trips, elim, frozen, limit: int
):
    """Plain PyTorch version of the kernel.  colour, kind int32[B, R, C];
    sub_keys int64[B, 2]; trips, elim, frozen int32[B].

    Returns (colour, kind, trips, elim, new, act, frozen, active, reasons):
    ``trips`` and ``elim`` carry on from the inputs, ``frozen`` is the
    input OR a freeze of this call, ``new``/``act`` count this call's
    created and activated specials, ``active`` is "still holds a line" and
    ``reasons`` the freeze reasons of this call.

    Boards run in lockstep; a board that stops never runs again, so every
    running board's trip index is its own ``trips``.
    """
    _check_config(cfg)
    T = cfg.max_cascades
    x, k = colour.clone(), kind.clone()
    trips, elim, frozen = trips.clone(), elim.clone(), frozen.clone()
    B = x.shape[0]
    new = torch.zeros(B, dtype=torch.int32, device=x.device)
    act = torch.zeros_like(new)
    reasons = torch.zeros_like(new)
    for _ in range(limit):
        live = plain_has_any_line(cfg, x) & (frozen == 0) & (trips < T)
        if not bool(live.any()):
            break
        idx = live.nonzero()[:, 0]
        xs, ks = x[idx], k[idx]
        simple, rbits, dele, create, code, act_n = _trip(cfg, xs, ks)
        reasons[idx] |= torch.where(simple, 0, rbits)
        frozen[idx] = torch.where(simple, frozen[idx], 1)
        p3 = simple[:, None, None]
        dele = dele & p3
        cre = create & p3
        line_colour = xs
        xs = torch.where(dele, 0, xs)
        ks = torch.where(dele, 0, ks)
        xs = torch.where(cre, torch.where(code == -1, 0, line_colour), xs)
        ks = torch.where(cre, code, ks)
        n_created = cre.flatten(1).sum(-1, dtype=torch.int32)
        n_dele = dele.flatten(1).sum(-1, dtype=torch.int32)
        s = simple.to(torch.int32)
        elim[idx] += s * (n_dele - n_created)
        new[idx] += s * n_created
        act[idx] += s * act_n
        xs, ks = gravity(xs, ks)
        grid = draw_colour_grid(trandom.fold_in(sub_keys[idx], trips[idx]), cfg)
        xs, ks = apply_refill(xs, ks, grid)
        x[idx] = xs
        k[idx] = ks
        trips[idx] += s
    return x, k, trips, elim, new, act, frozen, plain_has_any_line(cfg, x), reasons


@kernel_span("cascade_sp_chunk")
def cascade_sp_chunk(
    cfg: EnvConfig, colour, kind, sub_keys, trips, elim, frozen, limit: int
):
    """The simple trips of ``cascade_sp_reference``, as one CUDA kernel
    launch on a CUDA device; on CPU tensors, ``cascade_sp_reference``."""
    if not cuda_build.on_card("cascade_sp_chunk", colour):
        return cascade_sp_reference(cfg, colour, kind, sub_keys, trips, elim, frozen, limit)
    _check_config(cfg)
    B, R, C = colour.shape
    inputs = (colour, kind, sub_keys, trips, elim, frozen)
    cuda_build.check_inputs("cascade_sp_chunk", cfg, (
        ("colour", colour, torch.int32, (B, R, C)), ("kind", kind, torch.int32, (B, R, C)),
        ("sub_keys", sub_keys, torch.int64, (B, 2)), ("trips", trips, torch.int32, (B,)),
        ("elim", elim, torch.int32, (B,)), ("frozen", frozen, torch.int32, (B,)),
    ))
    dev = colour.device
    out = (torch.empty_like(colour), torch.empty_like(kind),
           *(torch.empty(B, dtype=torch.int32, device=dev) for _ in range(5)),  # trips .. frozen
           torch.empty(B, dtype=torch.bool, device=dev),  # active
           torch.empty(B, dtype=torch.int32, device=dev))  # reasons
    cuda_build.launch(
        "tmt_cascade_sp", dev, (R, C), *(t.data_ptr() for t in inputs),
        *(t.data_ptr() for t in out), B, R, C, cfg.num_colours, cfg.max_cascades, int(limit),
        int(cfg.cookie), int(cfg.vertical_laser), int(cfg.horizontal_laser), int(cfg.bomb),
    )
    return out
