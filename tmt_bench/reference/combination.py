"""Combination matches on batches of boards (counterpart of
``tile_match_tpu.ops.combination``): the 9-way special+special and cookie
interaction table of ``combination_match`` (`board.py:600-719`).

Each case applies its direct board edits, then seeds the activation stack
machine with the case's activations — pushed in reverse execution order,
the stack being LIFO — and runs it to completion.  The seeded activations
are not counted (is_combination_match, `board.py:498`); their recursive
children are.

Only the match itself lives here; the branch around it (gravity and the
refill from ``key, k = split(key)``) is ``engine.combination_branch``.
"""

from __future__ import annotations

import torch

from .config import EnvConfig, KIND_BOMB, KIND_COOKIE, KIND_NORMAL
from .activate import OP_BOMB2, OP_H_LASER, OP_MASKSCAN, OP_V_LASER, machine_init, push_frame, run_machine


def _at(x, coord):
    """x[b, coord[b, 0], coord[b, 1]] for x int[B, R, C], coord int[B, 2]."""
    B, _, C = x.shape
    flat = (coord[:, 0].long() * C + coord[:, 1].long())[:, None]
    return x.reshape(B, -1).gather(1, flat)[:, 0]


def is_combination(kind, coord1, coord2) -> torch.Tensor:
    """`board.py:357-359`: both cells special, or at least one a cookie."""
    k1 = _at(kind, coord1)
    k2 = _at(kind, coord2)
    two_special = (k1 != 0) & (k1 != 1) & (k2 != 0) & (k2 != 1)
    return two_special | (k1 < 0) | (k2 < 0)


def combination_match(cfg: EnvConfig, colour, kind, coord1, coord2):
    """Run the combination match of every board; coords int[B, 2].

    Returns (colour, kind, activated int32[B], ovf bool[B]); ``ovf`` is the
    activation machine's truncation flag.
    """
    B, R, C = colour.shape
    dev = colour.device
    r1, c1 = coord1[:, 0].to(torch.int32), coord1[:, 1].to(torch.int32)
    r2, c2 = coord2[:, 0].to(torch.int32), coord2[:, 1].to(torch.int32)
    k1, k2 = _at(kind, coord1), _at(kind, coord2)
    col1, col2 = _at(colour, coord1), _at(colour, coord2)

    laser1 = (k1 == 2) | (k1 == 3)
    laser2 = (k2 == 2) | (k2 == 3)
    case_cc = (k1 == KIND_COOKIE) & (k2 == KIND_COOKIE)
    case_cn = ((k1 == KIND_COOKIE) & (k2 == KIND_NORMAL)) | ((k1 == KIND_NORMAL) & (k2 == KIND_COOKIE))
    case_cs = ((k1 == KIND_COOKIE) & (k2 >= 2)) | ((k1 >= 2) & (k2 == KIND_COOKIE))
    case_ll = laser1 & laser2
    case_lb = ((k1 == KIND_BOMB) & laser2) | ((k2 == KIND_BOMB) & laser1)
    case_bb = (k1 == KIND_BOMB) & (k2 == KIND_BOMB)

    # cookie first for cookie+normal and cookie+special (`board.py:620-623, 645-648`)
    cookie_is_1 = k1 == KIND_COOKIE
    cook_r = torch.where(cookie_is_1, r1, r2)
    cook_c = torch.where(cookie_is_1, c1, c2)
    other_k = torch.where(cookie_is_1, k2, k1)
    other_col = torch.where(cookie_is_1, col2, col1)

    row_ids = torch.arange(R, dtype=torch.int32, device=dev).reshape(1, R, 1)
    col_ids = torch.arange(C, dtype=torch.int32, device=dev).reshape(1, 1, C)

    def cell(r, c):
        return (row_ids == r[:, None, None]) & (col_ids == c[:, None, None])

    def b3(x):
        return x[:, None, None]

    # direct edits: cookie+cookie wipes the board (`board.py:615-616`); the
    # cookie cell goes (cookie+normal deletes coord1 twice and never coord2
    # directly, `board.py:626-628` — the partner normal dies through the
    # colour mask; cookie+special `board.py:650-651`); laser/bomb pairs
    # delete both swap cells (`board.py:664-666, 678-680, 700-702`);
    # cookie+normal deletes the partner colour's normals
    # (`board.py:630-635`); cookie+special turns them into the partner's
    # special (`board.py:653-657`)
    same_col_normal = (colour == b3(other_col)) & (kind == KIND_NORMAL)
    delete = (
        b3(case_cc)
        | (b3(case_cn | case_cs) & cell(cook_r, cook_c))
        | (b3(case_ll | case_lb | case_bb) & (cell(r1, c1) | cell(r2, c2)))
        | (b3(case_cn) & same_col_normal)
    )
    convert = b3(case_cs) & same_col_normal
    new_colour = torch.where(delete, 0, colour)
    new_kind = torch.where(delete, 0, torch.where(convert, b3(other_k), kind))

    # activation seeds, pushed in reverse execution order
    st = machine_init(cfg, new_colour, new_kind)
    rmin = torch.minimum(r1, r2)
    cmin = torch.minimum(c1, c2)
    # bomb+bomb: one 5x5 sweep (`board.py:704-719`)
    st = push_frame(st, OP_BOMB2, rmin, cmin, 0, pred=case_bb, idx=0)
    # laser+laser: vertical, then horizontal laser at (rmin, cmin) (`board.py:668-674`)
    st = push_frame(st, OP_H_LASER, rmin, cmin, 0, pred=case_ll)
    st = push_frame(st, OP_V_LASER, rmin, cmin, 0, pred=case_ll)
    # laser+bomb: horizontal lasers on rows rmin-1..rmin+1, then vertical
    # lasers on columns cmin-1..cmin+1, clipped to the board (`board.py:682-696`)
    st = push_frame(st, OP_V_LASER, rmin, cmin + 1, 0, pred=case_lb & (cmin + 1 <= C - 1))
    st = push_frame(st, OP_V_LASER, rmin, cmin, 0, pred=case_lb)
    st = push_frame(st, OP_V_LASER, rmin, cmin - 1, 0, pred=case_lb & (cmin - 1 >= 0))
    st = push_frame(st, OP_H_LASER, rmin + 1, cmin, 0, pred=case_lb & (rmin + 1 <= R - 1))
    st = push_frame(st, OP_H_LASER, rmin, cmin, 0, pred=case_lb)
    st = push_frame(st, OP_H_LASER, rmin - 1, cmin, 0, pred=case_lb & (rmin - 1 >= 0))
    # cookie+normal / cookie+special: row-major scan of the partner colour's
    # specials (`board.py:637-641, 659-660`)
    st = push_frame(
        st, OP_MASKSCAN, torch.zeros_like(rmin), torch.zeros_like(rmin), 0,
        pred=case_cn | case_cs, idx=0, fcolour=other_col,
    )
    st = run_machine(cfg, st)

    # +2 in every case (`board.py:609`); cookie+normal takes one back (`board.py:641`)
    activated = 2 + st.count - case_cn.to(torch.int32)
    return st.colour, st.kind, activated, st.ovf
