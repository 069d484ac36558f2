"""Special-tile activation as an explicit stack machine, on batches of boards
(counterpart of ``tile_match_tpu.ops.activate``).

The original game activates specials by recursion (`board.py:473-556`): a
laser wipes its row or column cell by cell, recursing into every special it
hits; a bomb does the same over its 3x3 box; a cookie picks the most common
colour at activation time, deletes its normals and then activates its
specials in row-major order.  Boards depend on that order (the cookie reads
the board mid-recursion), so the recursion is kept: each board has a stack
of frames, and one micro-step either enters the top frame (deletes the
special's own cell) or deletes the stretch of normal cells up to the
frame's next special and pushes that special's frame, or pops.

Frame ops are the tile kinds of the real specials plus two that combination
matches use (`board.py:600-726`):

* OP_MASKSCAN — ``activate_specials_in_mask`` (`board.py:721-726`): visit
  every special of one colour in row-major order; its children are not
  counted;
* OP_BOMB2 — the bomb+bomb 5x5 sweep (`board.py:699-719`): a bomb of
  radius 2 with no entry actions and uncounted children.

Every tensor carries the batch first; the frame arrays have one extra dump
slot at the end, where the writes of boards that do not push land.
"""

from __future__ import annotations

import dataclasses

import torch

from .config import EnvConfig, KIND_BOMB, KIND_COOKIE, KIND_H_LASER, KIND_NORMAL, KIND_V_LASER
from .runs import BIG

OP_V_LASER = KIND_V_LASER  # 2
OP_H_LASER = KIND_H_LASER  # 3
OP_BOMB = KIND_BOMB  # 4
OP_COOKIE = KIND_COOKIE  # -1
OP_MASKSCAN = 5
OP_BOMB2 = 6


@dataclasses.dataclass
class Machine:
    colour: torch.Tensor  # int32[B, R, C]
    kind: torch.Tensor  # int32[B, R, C]
    count: torch.Tensor  # int32[B]: counted activations
    f_op: torch.Tensor  # int32[B, SM + 1] frame arrays (last slot: dump)
    f_r: torch.Tensor
    f_c: torch.Tensor
    f_idx: torch.Tensor  # -1: not entered yet; else next flat cell to scan
    f_col: torch.Tensor  # cookie / maskscan colour
    f_cnt: torch.Tensor  # 1: the frame's activation is counted
    ovf: torch.Tensor  # bool[B]: a push was dropped or the budget ran out
    sp: torch.Tensor  # int32[B] stack pointer


def machine_init(cfg: EnvConfig, colour, kind) -> Machine:
    B = colour.shape[0]
    dev = colour.device
    z = torch.zeros((B, cfg.stack_max + 1), dtype=torch.int32, device=dev)
    zb = torch.zeros((B,), dtype=torch.int32, device=dev)
    return Machine(
        colour=colour, kind=kind, count=zb, f_op=z, f_r=z.clone(), f_c=z.clone(),
        f_idx=z.clone(), f_col=z.clone(), f_cnt=z.clone(),
        ovf=torch.zeros((B,), dtype=torch.bool, device=dev), sp=zb.clone(),
    )


def _full(x, like):
    if torch.is_tensor(x):
        return x.to(torch.int32).expand(like.shape)
    return torch.full_like(like, x)


def push_frame(st: Machine, op, r, c, counted, pred, idx=-1, fcolour=0) -> Machine:
    """Push one frame on the boards where ``pred``.  A push onto a full
    stack is dropped (sp unchanged) and sets ``ovf``."""
    B = st.sp.shape[0]
    SM = st.f_op.shape[1] - 1
    bi = torch.arange(B, device=st.sp.device)
    pred = pred.expand(B) if torch.is_tensor(pred) else torch.full((B,), bool(pred), device=st.sp.device)
    ok = pred & (st.sp < SM)
    i = torch.where(ok, st.sp, SM).long()
    vals = {
        "f_op": op, "f_r": r, "f_c": c, "f_idx": idx, "f_col": fcolour, "f_cnt": counted,
    }
    out = {}
    for name, v in vals.items():
        arr = getattr(st, name).clone()
        arr[bi, i] = _full(v, st.sp)
        out[name] = arr
    return dataclasses.replace(
        st, **out, sp=st.sp + ok.to(torch.int32), ovf=st.ovf | (pred & ~ok)
    )


def machine_step(cfg: EnvConfig, st: Machine, go: torch.Tensor) -> Machine:
    """One micro-step on the boards where ``go`` (which need sp > 0); the
    other boards are unchanged."""
    B, R, C = st.colour.shape
    K = cfg.num_colours
    SM = st.f_op.shape[1] - 1
    dev = st.colour.device
    bi = torch.arange(B, device=dev)
    top = torch.where(go, st.sp - 1, SM).long()
    op = st.f_op[bi, top]
    r = st.f_r[bi, top][:, None, None]
    c = st.f_c[bi, top][:, None, None]
    idx = st.f_idx[bi, top]
    fcol = st.f_col[bi, top]
    counted = st.f_cnt[bi, top]
    colour, kind = st.colour, st.kind
    row_ids = torch.arange(R, dtype=torch.int32, device=dev).reshape(1, R, 1)
    col_ids = torch.arange(C, dtype=torch.int32, device=dev).reshape(1, 1, C)
    ord_ = row_ids * C + col_ids

    is_real = (op == OP_V_LASER) | (op == OP_H_LASER) | (op == OP_BOMB) | (op == OP_COOKIE)
    entry = go & is_real & (idx < 0)

    # entry (`board.py:487-499`): on an all-empty board return at once;
    # else delete the special's own cell, count it, and for a cookie pick
    # the most common colour and delete its normals (`board.py:530-544`)
    board_dead = (colour == 0).flatten(1).all(-1)
    pop_now = entry & board_dead
    do_entry = entry & ~board_dead
    at_cell = do_entry[:, None, None] & (row_ids == r) & (col_ids == c)
    colour = torch.where(at_cell, 0, colour)
    kind = torch.where(at_cell, 0, kind)
    count = st.count + (do_entry & (counted > 0)).to(torch.int32)
    is_cookie_entry = do_entry & (op == OP_COOKIE)
    colours = torch.arange(1, K + 1, dtype=torch.int32, device=dev)
    counts = (colour.reshape(B, 1, R * C) == colours[None, :, None]).sum(-1)
    chosen = 1 + counts.argmax(-1).to(torch.int32)
    fcol = torch.where(is_cookie_entry, chosen, fcol)
    del_norm = is_cookie_entry[:, None, None] & (colour == fcol[:, None, None]) & (kind == KIND_NORMAL)
    colour = torch.where(del_norm, 0, colour)
    kind = torch.where(del_norm, 0, kind)
    idx = torch.where(do_entry, 0, idx)
    f_col = st.f_col.clone()
    f_col[bi, top] = fcol
    f_idx = st.f_idx.clone()
    f_idx[bi, top] = idx

    # scan: delete the normals of the region up to its next special, then
    # push that special's frame; pop when none is left
    scan = go & (~entry | do_entry) & ~pop_now
    o3 = op[:, None, None]
    region = torch.where(
        o3 == OP_V_LASER, col_ids == c,
        torch.where(
            o3 == OP_H_LASER, row_ids == r,
            torch.where(
                o3 == OP_BOMB, ((row_ids - r).abs() <= 1) & ((col_ids - c).abs() <= 1),
                torch.where(
                    o3 == OP_BOMB2, ((row_ids - r).abs() <= 2) & ((col_ids - c).abs() <= 2),
                    (colour == fcol[:, None, None]) & (kind > 1),  # cookie / maskscan
                ),
            ),
        ),
    )
    is_scan_only = (op == OP_COOKIE) | (op == OP_MASKSCAN)
    pending = region & (ord_ >= idx[:, None, None])
    special = pending & (kind != 0) & (kind != KIND_NORMAL)
    first_ord = torch.where(special, ord_, BIG).flatten(1).min(-1).values
    found = first_ord < BIG
    delete = (
        (scan & ~is_scan_only)[:, None, None] & pending & ~special
        & (ord_ < first_ord[:, None, None])
    )
    colour = torch.where(delete, 0, colour)
    kind = torch.where(delete, 0, kind)

    pop = pop_now | (scan & ~found)
    sp2 = torch.where(pop, st.sp - 1, st.sp)
    sr = first_ord // C
    sc = first_ord % C
    skind = kind.reshape(B, R * C)[bi, (sr.clamp(0, R - 1) * C + sc.clamp(0, C - 1)).long()]
    child_counted = is_real.to(torch.int32)  # maskscan / bomb2 children are uncounted
    do_push = scan & found
    if cfg.debug_checks:
        full = do_push & (sp2 >= cfg.stack_max)
        if bool(full.any()):
            d = int(sp2[full][0])
            raise RuntimeError(f"stack_max overflow: activation frame dropped at depth {d}")
    f_idx[bi, top] = torch.where(do_push, first_ord + 1, f_idx[bi, top])
    st2 = dataclasses.replace(
        st, colour=colour, kind=kind, count=count, f_idx=f_idx, f_col=f_col, sp=sp2
    )
    return push_frame(st2, skind, sr, sc, child_counted, pred=do_push, idx=-1, fcolour=0)


def run_machine(cfg: EnvConfig, st: Machine) -> Machine:
    """Micro-steps until every stack drains or ``activation_steps_max``
    steps have run; a stack left non-empty sets ``ovf``."""
    for _ in range(cfg.activation_steps_max):
        go = st.sp > 0
        if not bool(go.any()):
            break
        st = machine_step(cfg, st, go)
    live = st.sp > 0
    if cfg.debug_checks and bool(live.any()):
        n = int(st.sp[live][0])
        raise RuntimeError(f"activation_steps_max exceeded: chain truncated with {n} frames live")
    return dataclasses.replace(st, ovf=st.ovf | live)
