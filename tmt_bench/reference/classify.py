"""Greedy match classification on batches of boards (counterpart of
``tile_match_tpu.ops.classify``).

``process_colour_lines`` (`board.py:269-327` of the original game):

* the lines form a queue, stable-sorted by the row of each line's first
  (topmost) coordinate (`board.py:282`);
* pop the front; greedy priority: cookie (length >= 5, enabled) -> laser
  (length 4) -> bomb (enabled, shares a coordinate with a queued line) ->
  normal (length >= 3);
* a cookie takes the first 5 coordinates and re-queues the rest if it is
  longer than 2 (`board.py:287-292`);
* a horizontal 4-line falls back to a vertical laser when horizontal lasers
  are disabled and vertical ones enabled (`board.py:297-302`);
* a bomb takes the whole line plus the 3 partner coordinates closest
  (Manhattan, stable) to the first shared coordinate; the partner is dropped
  when shorter than 6, else loses those 3 coordinates (`board.py:304-320`).

The queue lives in slot tensors [B, 2*LM, ...] with integer order keys:
pop = argmin of the keys, append = a fresh slot with a larger key.  A line
that shares no coordinate with another can never pair with a bomb, so those
lines classify in one vectorised pass (cookie splits level by level); only
the sharing lines go through the pop loop, a masked batch loop over the
boards that have any.  The two streams merge by (cookie level, root key),
which is the sequential pop order.  Every write of a board that is not
popping goes to a dump slot at the end of each slot tensor.
"""

from __future__ import annotations

import dataclasses

import torch

from .config import (
    EnvConfig,
    MATCH_BOMB,
    MATCH_COOKIE,
    MATCH_H_LASER,
    MATCH_NORMAL,
    MATCH_V_LASER,
)
from .lines import LineSet
from .runs import BIG


@dataclasses.dataclass
class Matches:
    coords: torch.Tensor  # int32[B, MM, CM, 2]; (-1, -1) padded
    length: torch.Tensor  # int32[B, MM]
    mtype: torch.Tensor  # int32[B, MM] (MATCH_* codes)
    mcolour: torch.Tensor  # int32[B, MM]
    count: torch.Tensor  # int32[B]
    ovf: torch.Tensor  # bool[B]: queue append or emission capacity hit


def _laser_type(cfg: EnvConfig, is_h: torch.Tensor) -> torch.Tensor:
    """Match code of a length-4 line by orientation (the h -> v fallback)."""
    other = MATCH_V_LASER if cfg.vertical_laser else MATCH_NORMAL
    if cfg.horizontal_laser:
        return torch.where(is_h, MATCH_H_LASER, other).to(torch.int32)
    return torch.full_like(is_h, other, dtype=torch.int32)


def _cell_bits(cfg: EnvConfig, coords: torch.Tensor, live: torch.Tensor) -> torch.Tensor:
    """bool[..., R*C]: the cells of the live coordinates of each list
    coords int[..., n, 2] (live bool[..., n])."""
    R, C = cfg.num_rows, cfg.num_cols
    ords = coords[..., 0].clamp(0, R - 1) * C + coords[..., 1].clamp(0, C - 1)
    ords = torch.where(live, ords, R * C).long()
    out = torch.zeros(*coords.shape[:-2], R * C + 1, dtype=torch.bool, device=coords.device)
    out.scatter_(-1, ords, True)
    return out[..., : R * C]


def _pop_machine(cfg, colour, lo, lc, ll, bmask, KSPAN):
    """The pop loop over the sharing lines of a sub-batch.

    Slot tensors carry a dump slot at index LM2.  Returns the emissions
    (coords [b, MM, CM, 2], len, type, colour, merge key [b, MM]), their
    count and the sticky append-overflow flag."""
    b = lo.shape[0]
    R, C = cfg.num_rows, cfg.num_cols
    L, CM = cfg.line_len_max, cfg.match_coords_max
    LM2 = lo.shape[1] - 1
    MM = LM2
    DUMP = LM2
    dev = lo.device
    bi = torch.arange(b, device=dev)
    jj = torch.arange(L, device=dev)
    cm_ids = torch.arange(CM, device=dev)
    slot_ids = torch.arange(LM2 + 1, device=dev)
    flat = colour.reshape(b, R * C)
    i32 = torch.int32

    lroot = lo.clone()
    llev = torch.zeros_like(lo)
    atail = torch.full((b,), cfg.lines_max, dtype=i32, device=dev)
    next_order = torch.full((b,), KSPAN, dtype=i32, device=dev)
    mc = torch.full((b, MM + 1, CM, 2), -1, dtype=i32, device=dev)
    mlen = torch.zeros((b, MM + 1), dtype=i32, device=dev)
    mt = torch.zeros_like(mlen)
    mcol = torch.zeros_like(mlen)
    mkey = torch.full((b, MM + 1), BIG, dtype=i32, device=dev)
    mcount = torch.zeros((b,), dtype=i32, device=dev)
    movf = torch.zeros((b,), dtype=torch.bool, device=dev)

    while True:
        go = (lo < BIG).any(-1)
        if not bool(go.any()):
            break
        sel = lo.argmin(-1)
        n = ll[bi, sel]
        line = lc[bi, sel]  # [b, L, 2]
        sel_root = lroot[bi, sel]
        sel_lev = llev[bi, sel]
        in_line_n = jj[None, :] < n[:, None]
        kill = torch.where(go, sel, DUMP)
        lo[bi, kill] = BIG
        ll[bi, kill] = 0

        line_colour = flat[bi, (line[:, 0, 0].clamp(min=0) * C + line[:, 0, 1].clamp(min=0)).long()]
        cookie_case = go & (n >= 5) if cfg.cookie else torch.zeros_like(go)
        laser_case = go & ~cookie_case & (n == 4)
        if cfg.bomb:
            pb = bmask[bi, sel]
            share_line = (
                (bmask & pb[:, None, :]).any(-1) & (lo < BIG) & (ll > 0) & (slot_ids < LM2)
            )
            partner = torch.where(share_line, lo, BIG).argmin(-1)
            bomb_case = go & ~cookie_case & ~laser_case & share_line.any(-1) & (n >= 3)
        else:
            bomb_case = torch.zeros_like(go)
        normal_case = go & ~cookie_case & ~laser_case & ~bomb_case & (n >= 3)
        emit = cookie_case | laser_case | bomb_case | normal_case

        # the emitted match
        keep = torch.where(cookie_case, n.clamp(max=5), n)
        src = line[:, cm_ids.clamp(max=L - 1)]  # [b, CM, 2]
        out_c = torch.where((cm_ids[None, :] < keep[:, None])[..., None], src, -1)
        out_len = keep
        out_colour = torch.where(cookie_case, 0, line_colour)
        laser_type = _laser_type(cfg, line[:, 0, 0] == line[:, 1, 0])
        out_type = torch.where(
            cookie_case,
            MATCH_COOKIE if cfg.cookie else MATCH_NORMAL,
            torch.where(laser_case, laser_type, MATCH_NORMAL),
        ).to(i32)

        # cookie remainder re-queued after every queued line
        rem_len = n - 5
        dropped = cookie_case & (rem_len > 2) & (atail >= LM2)
        if cfg.debug_checks and bool(dropped.any()):
            raise RuntimeError("classify queue overflow: cookie remainder dropped")
        movf = movf | dropped
        do_append = cookie_case & (rem_len > 2) & (atail < LM2)
        rem_live = jj[None, :] < rem_len[:, None]
        rem = torch.where(rem_live[..., None], line[:, (jj + 5).clamp(max=L - 1)], -1)
        app = torch.where(do_append, atail.clamp(max=LM2 - 1), DUMP).long()
        lc[bi, app] = rem
        ll[bi, app] = torch.where(do_append, rem_len, 0)
        lo[bi, app] = torch.where(do_append, next_order, BIG)
        lroot[bi, app] = sel_root
        llev[bi, app] = sel_lev + 1
        if cfg.bomb:
            bmask[bi, app] = _cell_bits(cfg, rem, rem_live)
        atail = atail + do_append.to(i32)
        next_order = next_order + do_append.to(i32)

        if cfg.bomb:
            # first coordinate of the line (in line order) in the partner
            pbits = bmask[bi, partner]
            line_ord = line[..., 0].clamp(0, R - 1) * C + line[..., 1].clamp(0, C - 1)
            memb = pbits.gather(1, line_ord.long()) & in_line_n
            shared = line[bi, memb.to(i32).argmax(-1)]  # [b, 2]
            p_coords = lc[bi, partner]  # [b, L, 2]
            p_len = ll[bi, partner]
            p_live = jj[None, :] < p_len[:, None]
            dist = (p_coords - shared[:, None, :]).abs().sum(-1)
            sort_key = torch.where(p_live, dist * L + jj, BIG)
            sel3 = torch.sort(sort_key, dim=-1, stable=True).indices[:, :3]
            sel3_coords = p_coords[bi[:, None], sel3]  # [b, 3, 2]
            sel3_valid = p_live.gather(1, sel3)
            in_line = (
                ((sel3_coords[:, :, None, :] == line[:, None, :, :]).all(-1) & in_line_n[:, None, :])
                .any(-1)
            )
            extra_ok = sel3_valid & ~in_line
            extra_pos = n[:, None] + extra_ok.to(i32).cumsum(-1) - 1
            bomb_c = out_c.clone()
            for t in range(3):
                pos = extra_pos[:, t].clamp(max=CM - 1).long()
                cur = bomb_c[bi, pos]
                bomb_c[bi, pos] = torch.where(extra_ok[:, t, None], sel3_coords[:, t], cur)
            bomb_len = n + extra_ok.sum(-1, dtype=i32)
            out_c = torch.where(bomb_case[:, None, None], bomb_c, out_c)
            out_len = torch.where(bomb_case, bomb_len, out_len)
            out_type = torch.where(bomb_case, MATCH_BOMB, out_type).to(i32)

            # the partner: dropped below length 6, else shrunk by sel3
            drop = torch.where(bomb_case & (p_len < 6), partner, DUMP)
            lo[bi, drop] = BIG
            ll[bi, drop] = 0
            shrink = bomb_case & (p_len >= 6)
            removed = torch.zeros_like(p_live).scatter_(1, sel3, True)
            keep_mask = ~removed & p_live
            dest = torch.where(keep_mask, keep_mask.to(i32).cumsum(-1) - 1, L).long()
            new_p = torch.full((b, L + 1, 2), -1, dtype=i32, device=dev)
            new_p.scatter_(1, dest[..., None].expand(b, L, 2), p_coords)
            shrink_idx = torch.where(shrink, partner, DUMP)
            lc[bi, shrink_idx] = new_p[:, :L]
            ll[bi, shrink_idx] = torch.where(shrink, p_len - 3, 0)
            rm = _cell_bits(cfg, sel3_coords, torch.ones_like(sel3_valid))
            bmask[bi, shrink_idx] = pbits & ~rm

        mslot = torch.where(emit, mcount.clamp(max=MM - 1), MM).long()
        mc[bi, mslot] = out_c
        mlen[bi, mslot] = out_len
        mt[bi, mslot] = out_type
        mcol[bi, mslot] = out_colour.to(i32)
        mkey[bi, mslot] = sel_lev * KSPAN + sel_root
        mcount = mcount + emit.to(i32)

    return mc[:, :MM], mlen[:, :MM], mt[:, :MM], mcol[:, :MM], mkey[:, :MM], mcount, movf


def process_colour_lines(cfg: EnvConfig, colour: torch.Tensor, lineset: LineSet) -> Matches:
    """Classify every board's lines into matches.  colour int32[B, R, C]."""
    B = colour.shape[0]
    LM, L, CM = cfg.lines_max, cfg.line_len_max, cfg.match_coords_max
    LM2 = 2 * LM
    MM = LM2  # emissions <= pops <= slots ever alive
    R, C = cfg.num_rows, cfg.num_cols
    dev = colour.device
    i32 = torch.int32

    lc = torch.full((B, LM2, L, 2), -1, dtype=i32, device=dev)
    lc[:, :LM] = lineset.coords
    ll = torch.zeros((B, LM2), dtype=i32, device=dev)
    ll[:, :LM] = lineset.length
    slot_ids = torch.arange(LM2, dtype=i32, device=dev)
    alive0 = (slot_ids[None, :] < lineset.count[:, None]) & (ll > 0)
    lo = torch.where(alive0, lc[:, :, 0, 0] * LM + slot_ids, BIG)

    if cfg.bomb:
        # membership bitboards of the straight, ascending lines
        bmask = _cell_bits(cfg, lc, (torch.arange(L, device=dev) < ll[..., None]) & alive0[..., None])
        shared = alive0 & (bmask & (bmask.sum(1, dtype=i32) >= 2)[:, None, :]).any(-1)
    else:
        bmask = None
        shared = torch.zeros_like(alive0)
    KSPAN = (R + 2) * LM  # above every initial order key

    # ---- lines that share nothing: one vectorised pass, level by level ----
    f_live = alive0 & ~shared
    f_root = torch.where(f_live, lo, BIG)
    f_coords = torch.where(f_live[..., None, None], lc, -1)
    ord0 = f_coords[:, :, 0, 0].clamp(0, R - 1) * C + f_coords[:, :, 0, 1].clamp(0, C - 1)
    f_colour0 = torch.where(f_live, colour.reshape(B, R * C).gather(1, ord0.long()), 0)
    f_laser_t = _laser_type(cfg, f_coords[:, :, 0, 0] == f_coords[:, :, 1, 0])
    NL = 1 + max(0, (L - 3) // 5) if cfg.cookie else 1
    cm_ids = torch.arange(CM, device=dev)
    lev = {k: [] for k in ("len", "type", "colour", "coords", "key")}
    live_k = f_live
    len_k = torch.where(f_live, ll, 0)
    for k in range(NL):
        is_cookie = live_k & (len_k >= 5) if cfg.cookie else torch.zeros_like(live_k)
        keep = torch.where(is_cookie, 5, len_k)
        typ = torch.where(
            is_cookie, MATCH_COOKIE,
            torch.where(live_k & (len_k == 4), f_laser_t, MATCH_NORMAL),
        )
        shifted = f_coords[:, :, (cm_ids + 5 * k).clamp(max=L - 1)]  # [B, LM2, CM, 2]
        emit_mask = (cm_ids < keep[..., None]) & live_k[..., None]
        lev["len"].append(torch.where(live_k, keep, 0))
        lev["type"].append(torch.where(live_k, typ, 0))
        lev["colour"].append(torch.where(live_k & ~is_cookie, f_colour0, 0))
        lev["coords"].append(torch.where(emit_mask[..., None], shifted, -1))
        lev["key"].append(torch.where(live_k, k * KSPAN + f_root, BIG))
        rem = len_k - 5
        live_k = is_cookie & (rem > 2)
        len_k = torch.where(live_k, rem, 0)
    all_key = torch.cat(lev["key"], 1)

    # ---- sharing lines: the pop loop, on the boards that have any ----------
    mc = torch.full((B, MM, CM, 2), -1, dtype=i32, device=dev)
    mlen = torch.zeros((B, MM), dtype=i32, device=dev)
    mt = torch.zeros_like(mlen)
    mcol = torch.zeros_like(mlen)
    mkey = torch.full((B, MM), BIG, dtype=i32, device=dev)
    mcount = torch.zeros((B,), dtype=i32, device=dev)
    movf = torch.zeros((B,), dtype=torch.bool, device=dev)
    if cfg.bomb:
        idx = shared.any(-1).nonzero()[:, 0]
        if idx.numel():
            def pad(x, fill):
                return torch.cat([x, torch.full_like(x[:, :1], fill)], dim=1)

            out = _pop_machine(
                cfg, colour[idx],
                pad(torch.where(shared, lo, BIG)[idx], BIG),
                pad(lc[idx], -1), pad(ll[idx], 0), pad(bmask[idx], False), KSPAN,
            )
            for dst, src in zip((mc, mlen, mt, mcol, mkey, mcount, movf), out):
                dst.index_copy_(0, idx, src)

    # ---- merge the two streams by (level, root key) ------------------------
    mkey = torch.where(torch.arange(MM, device=dev) < mcount[:, None], mkey, BIG)
    cat_key = torch.cat([all_key, mkey], 1)
    cat_len = torch.cat(lev["len"] + [mlen], 1)
    cat_type = torch.cat(lev["type"] + [mt], 1)
    cat_colour = torch.cat(lev["colour"] + [mcol], 1)
    cat_coords = torch.cat(lev["coords"] + [mc], 1)
    emit_ovf = (cat_key < BIG).sum(-1) > MM
    if cfg.debug_checks and bool(emit_ovf.any()):
        raise RuntimeError("classify emission overflow: more than MM live matches")
    sk, perm = torch.sort(cat_key, dim=-1, stable=True)
    live = sk[:, :MM] < BIG
    perm = perm[:, :MM]

    def take(x, fill):
        g = x.gather(1, perm.reshape(B, MM, *([1] * (x.ndim - 2))).expand(B, MM, *x.shape[2:]))
        return torch.where(live.reshape(B, MM, *([1] * (x.ndim - 2))), g, fill)

    return Matches(
        coords=take(cat_coords, -1),
        length=take(cat_len, 0),
        mtype=take(cat_type, 0).to(i32),
        mcolour=take(cat_colour, 0).to(i32),
        count=((all_key < BIG).sum(-1, dtype=i32) + mcount),
        ovf=movf | emit_ovf | lineset.ovf,
    )
