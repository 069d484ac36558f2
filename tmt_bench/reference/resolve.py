"""Match resolution on batches of boards (counterpart of
``tile_match_tpu.ops.resolve``): special-creation positions, elimination
and activation, special creation.

``resolve_colour_matches`` (`board.py:397-427`), ``get_special_creation_pos``
(`board.py:429-458`), ``resolve_colour_match`` (`board.py:460-471`) and
``create_special`` (`board.py:572-597`) of the original game, with the
recursive activation chains run by the stack machine of ``activate.py``.
"""

from __future__ import annotations

import dataclasses

import torch

from .config import EnvConfig, KIND_COOKIE, KIND_NORMAL, MATCH_BOMB, MATCH_COOKIE, MATCH_NORMAL
from .activate import machine_init, machine_step, push_frame
from .classify import Matches
from .runs import BIG


def _match_ords(cfg: EnvConfig, matches: Matches) -> torch.Tensor:
    """int64[B, MM, CM]: flat cell of every live match coordinate, R*C
    where dead."""
    R, C = cfg.num_rows, cfg.num_cols
    MM, CM = matches.coords.shape[1], matches.coords.shape[2]
    dev = matches.coords.device
    live = (torch.arange(CM, device=dev) < matches.length[..., None]) & (
        torch.arange(MM, device=dev)[:, None] < matches.count[:, None, None]
    )
    ords = matches.coords[..., 0].clamp(0, R - 1) * C + matches.coords[..., 1].clamp(0, C - 1)
    return torch.where(live, ords, R * C).long()


def _bits(ords: torch.Tensor, RC: int) -> torch.Tensor:
    """bool[..., RC]: membership bitboards of flat-cell lists ords[..., n]
    (entries equal to RC are dead)."""
    out = torch.zeros(*ords.shape[:-1], RC + 1, dtype=torch.bool, device=ords.device)
    out.scatter_(-1, ords, True)
    return out[..., :RC]


def _creation_pos(cfg: EnvConfig, match_coords, n, is_bomb, taken):
    """One match's special-creation coordinate per board (`board.py:429-458`).

    match_coords int32[B, CM, 2]; n int[B] live count; is_bomb bool[B];
    taken bool[B, R, C].  A straight match takes the middle (the lower
    middle when even) of its coordinates not yet taken, which arrive
    ascending; a bomb takes the (mode row, mode column) corner if it is a
    free coordinate of the match, else the free coordinate closest to it by
    squared distance, ties to the earliest.  Returns int32[B, 2].
    """
    CM = cfg.match_coords_max
    R, C = cfg.num_rows, cfg.num_cols
    B = match_coords.shape[0]
    dev = match_coords.device
    bi = torch.arange(B, device=dev)
    jj = torch.arange(CM, device=dev)
    rr = match_coords[..., 0].clamp(0, R - 1)
    cc = match_coords[..., 1].clamp(0, C - 1)
    live = jj < n[:, None]
    valid = live & ~taken.reshape(B, R * C).gather(1, (rr * C + cc).long())

    nv = valid.sum(-1)
    pick = torch.where(nv % 2 == 0, nv // 2 - 1, nv // 2)
    sel_mid = valid & (valid.to(torch.int64).cumsum(-1) == (pick + 1)[:, None])
    straight_pos = match_coords[bi, sel_mid.to(torch.int32).argmax(-1)]

    xs, ys = match_coords[..., 0], match_coords[..., 1]
    both = live[:, None, :] & live[:, :, None]
    cnt_x = ((xs[:, None, :] == xs[:, :, None]) & both).sum(-1)
    cnt_y = ((ys[:, None, :] == ys[:, :, None]) & both).sum(-1)
    corner_x = xs[bi, torch.where(live, cnt_x, -1).argmax(-1)]
    corner_y = ys[bi, torch.where(live, cnt_y, -1).argmax(-1)]
    corner = torch.stack([corner_x, corner_y], -1)
    corner_valid = (valid & (xs == corner_x[:, None]) & (ys == corner_y[:, None])).any(-1)
    d2 = (xs - corner_x[:, None]) ** 2 + (ys - corner_y[:, None]) ** 2
    dkey = torch.where(valid, d2 * CM + jj, BIG)
    closest = match_coords[bi, dkey.argmin(-1)]
    bomb_pos = torch.where(corner_valid[:, None], corner, closest)
    return torch.where(is_bomb[:, None], bomb_pos, straight_pos).to(torch.int32)


def resolve_colour_matches(cfg: EnvConfig, colour, kind, matches: Matches):
    """Resolve one cascade trip's matches on every board.

    Returns (colour, kind, activated int32[B], new specials int32[B], ovf
    bool[B]); ``ovf`` is the activation machine's dropped-frame flag.

    Phase 1 picks the creation positions of the special matches in match
    order, before any deletion.  Phase 2 deletes match by match, coordinate
    by coordinate, and activates every special it meets: runs of matches
    and coordinates with no special delete at once (normals have no side
    effects), and each special met pushes its frame on the machine.  A
    board whose matches hold no special just deletes their union.  Phase 3
    writes the new specials.
    """
    B, R, C = colour.shape
    RC = R * C
    MM, CM = matches.coords.shape[1], matches.coords.shape[2]
    dev = colour.device
    bi = torch.arange(B, device=dev)
    mm_ids = torch.arange(MM, device=dev)
    jj_cm = torch.arange(CM, device=dev)
    ords_all = _match_ords(cfg, matches)  # [B, MM, CM]
    mb = _bits(ords_all, RC)  # [B, MM, RC]
    union = mb.any(1).reshape(B, R, C)
    has_special = (union & (kind != 0) & (kind != KIND_NORMAL)).flatten(1).any(-1)
    colour_fast = torch.where(union, 0, colour)
    kind_fast = torch.where(union, 0, kind)

    # ---- phase 1: creation positions ---------------------------------------
    is_special_slot = (
        (mm_ids < matches.count[:, None]) & (matches.mtype != MATCH_NORMAL) & (matches.mtype != 0)
    )
    spec_rank = is_special_slot.to(torch.int32).cumsum(-1)
    n_special = spec_rank[:, -1]
    taken = torch.zeros((B, R, C), dtype=torch.bool, device=dev)
    q_r = torch.zeros((B, MM + 1), dtype=torch.int32, device=dev)
    q_c = torch.zeros_like(q_r)
    q_ok = torch.zeros((B, MM + 1), dtype=torch.bool, device=dev)
    for k in range(int(n_special.max()) if B else 0):
        on = k < n_special
        m = (is_special_slot & (spec_rank == k + 1)).to(torch.int32).argmax(-1)
        pos = _creation_pos(
            cfg, matches.coords[bi, m], matches.length[bi, m],
            matches.mtype[bi, m] == MATCH_BOMB, taken,
        )
        pr = pos[:, 0].clamp(0, R - 1)
        pc = pos[:, 1].clamp(0, C - 1)
        flat_taken = taken.reshape(B, RC)
        cell = (pr * C + pc).long()
        flat_taken[bi, cell] = flat_taken[bi, cell] | on
        slot = torch.where(on, m, MM)
        q_r[bi, slot] = pr
        q_c[bi, slot] = pc
        q_ok[bi, slot] = on
    q_r, q_c, q_ok = q_r[:, :MM], q_c[:, :MM], q_ok[:, :MM]

    # ---- phase 2: elimination and activation, on boards with a special ----
    st = machine_init(cfg, colour, kind)
    m = torch.where(has_special, 0, matches.count)
    while True:
        go = (st.sp > 0) | (m < matches.count)
        if not bool(go.any()):
            break
        run_machine = go & (st.sp > 0)
        outer = go & (st.sp == 0)
        if bool(run_machine.any()):
            st = machine_step(cfg, st, run_machine)
        if bool(outer.any()):
            # the first remaining match holding a special, and the first
            # special among its coordinates; delete everything before it
            sp_flat = ((st.kind != 0) & (st.kind != KIND_NORMAL)).reshape(B, RC)
            alive_m = (mm_ids >= m[:, None]) & (mm_ids < matches.count[:, None])
            has_sp = alive_m & (mb & sp_flat[:, None, :]).any(-1)
            exists = has_sp.any(-1) & outer
            ms = has_sp.to(torch.int32).argmax(-1)
            row_ords = ords_all[bi, ms]  # [B, CM]
            sp_pad = torch.cat([sp_flat, torch.zeros_like(sp_flat[:, :1])], 1)
            spv = sp_pad.gather(1, row_ords)
            fs = torch.where(exists, spv.to(torch.int32).argmax(-1), 0)
            del_rows = torch.where(exists[:, None], alive_m & (mm_ids < ms[:, None]), alive_m)
            dm = (mb & del_rows[..., None]).any(1)
            prefix_ords = torch.where(
                (jj_cm < fs[:, None]) & exists[:, None], row_ords, RC
            )
            dmask = ((dm | _bits(prefix_ords, RC)) & outer[:, None]).reshape(B, R, C)
            kind2 = torch.where(dmask, 0, st.kind)
            st = dataclasses.replace(st, colour=torch.where(dmask, 0, st.colour), kind=kind2)
            fsc = fs.clamp(max=CM - 1)
            sr = matches.coords[bi, ms, fsc, 0].clamp(0, R - 1)
            sc = matches.coords[bi, ms, fsc, 1].clamp(0, C - 1)
            skind = kind2.reshape(B, RC)[bi, (sr * C + sc).long()]
            st = push_frame(st, skind, sr, sc, 1, pred=exists)
            m = torch.where(outer, torch.where(exists, ms.to(m.dtype), matches.count), m)
    colour = torch.where(has_special[:, None, None], st.colour, colour_fast)
    kind = torch.where(has_special[:, None, None], st.kind, kind_fast)
    activated = st.count
    ovf = has_special & st.ovf

    # ---- phase 3: the new specials ----------------------------------------
    new_kind = torch.where(matches.mtype == MATCH_COOKIE, KIND_COOKIE, matches.mtype)
    ordq = torch.where(q_ok, q_r * C + q_c, RC).long()
    hit = torch.zeros((B, RC + 1), dtype=torch.int32, device=dev).scatter_add_(
        1, ordq, torch.ones_like(q_r)
    )[:, :RC]
    hcol = torch.zeros((B, RC + 1), dtype=torch.int32, device=dev).scatter_add_(
        1, ordq, matches.mcolour
    )[:, :RC]
    hkind = torch.zeros((B, RC + 1), dtype=torch.int32, device=dev).scatter_add_(
        1, ordq, new_kind.to(torch.int32)
    )[:, :RC]
    anyhit = (hit > 0).reshape(B, R, C)
    colour = torch.where(anyhit, hcol.reshape(B, R, C), colour)
    kind = torch.where(anyhit, hkind.reshape(B, R, C), kind)
    num_new = q_ok.sum(-1, dtype=torch.int32)
    return colour, kind, activated, num_new, ovf
