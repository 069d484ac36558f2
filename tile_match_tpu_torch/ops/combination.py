"""Combination matches on batches of boards (counterpart of
``tile_match_tpu.ops.combination``): the 9-way special+special and cookie
interaction table of ``combination_match`` (`board.py:600-719`).

Each case applies its direct board edits, then seeds the activation stack
machine with the case's activations — pushed in reverse execution order,
the stack being LIFO — and runs it to completion.  The seeded activations
are not counted (is_combination_match, `board.py:498`); their recursive
children are.

``combination_trip`` is the combination branch of a move — the match,
gravity and a refill from ``key, kd = split(key)`` on the boards a mask
picks — as the CUDA kernel K5 (``csrc/combination.cu``; in the JAX package
the XLA combination round of ``batched_step_fused_sp``,
tile_match_tpu/envs/fused.py:422-524) on CUDA tensors, and as its plain
version ``engine.combination_branch`` on CPU tensors.  The kernel takes
the whole batch and its flags, with no compaction of the flagged boards
and no host sync, and updates the flagged boards in place: on the card the
caller's board tensors are the board outputs, and an unflagged board is
neither read nor written.
"""

from __future__ import annotations

import contextlib
import ctypes
import functools

import torch

from .. import cuda_build
from ..config import EnvConfig, KIND_BOMB, KIND_COOKIE, KIND_NORMAL
from ..profiling import kernel_span
from .activate import OP_BOMB2, OP_H_LASER, OP_MASKSCAN, OP_V_LASER, machine_init, push_frame, run_machine

# the cap bits the kernel returns per board (csrc/machine.cuh kCap*): a
# micro-step's push was dropped; the step budget ran out with frames live
CAP_STACK, CAP_STEPS = 8, 16


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


@functools.lru_cache(maxsize=None)
def _plan(lib, device, B: int, R: int, C: int, K: int, SM: int):
    """K5's persistent grid for B boards with ``lib`` on ``device``: (warps
    a block, blocks, bytes of device-memory scratch a warp, 0 when it lies
    in shared memory).  Once per library, card and sizes."""
    out = (ctypes.c_longlong * 3)()
    plan = cuda_build.c_function(lib, "tmt_combination_trip_plan",
                                 [ctypes.c_int] * 5 + [ctypes.c_void_p])
    with torch.cuda.device(device) if device.type == "cuda" else contextlib.nullcontext():
        err = plan(B, R, C, K, SM, out)
    if err != 0:
        raise RuntimeError(f"combination_trip: no launch plan for {B} {R}x{C} boards: "
                           f"cudaError_t {err}")
    return tuple(out)


def raise_caps(cfg: EnvConfig, caps: torch.Tensor, live: torch.Tensor) -> None:
    """Raise the plain branch's ``debug_checks`` message for the first cap
    that fired, in the order the plain machine meets them (a dropped push
    at any micro-step, then the step budget after the run); caps, live:
    int32[B] on the host."""
    if bool((caps & CAP_STACK).any()):
        raise RuntimeError(
            f"stack_max overflow: activation frame dropped at depth {cfg.stack_max}"
        )
    if bool((caps & CAP_STEPS).any()):
        n = int(live[(caps & CAP_STEPS) > 0][0])
        raise RuntimeError(f"activation_steps_max exceeded: chain truncated with {n} frames live")


@kernel_span("combination_trip")
def combination_trip(cfg: EnvConfig, colour, kind, key, coord1, coord2, comb):
    """The combination branch of the boards where ``comb`` (`board.py:
    357-366`): colour, kind int32[B, R, C], key int64[B, 2] threefry words,
    coord1, coord2 int[B, 2], comb bool[B].  Returns (colour, kind, key,
    elim, activated, ovf), equal to ``engine.combination_branch``'s; the
    other boards come back unchanged with zero counts.  The CUDA kernel on
    a CUDA device, the plain branch on CPU tensors.

    On the card the flagged boards are updated in place: the returned
    colour and kind are the tensors passed in (contiguous), which the
    kernel writes on the flagged boards only; key and the counts are fresh
    tensors.  On the CPU nothing is written in place."""
    if not cuda_build.on_card("combination_trip", colour):
        from .. import engine

        return engine.combination_branch(cfg, colour, kind, key, coord1, coord2, comb)
    B, R, C = colour.shape
    coord1 = coord1.to(torch.int32).contiguous()
    coord2 = coord2.to(torch.int32).contiguous()
    comb = comb.to(torch.bool).contiguous()
    key = key.contiguous()
    cuda_build.check_inputs("combination_trip", cfg, (
        ("colour", colour, torch.int32, (B, R, C)), ("kind", kind, torch.int32, (B, R, C)),
        ("key", key, torch.int64, (B, 2)), ("coord1", coord1, torch.int32, (B, 2)),
        ("coord2", coord2, torch.int32, (B, 2)), ("comb", comb, torch.bool, (B,)),
    ))
    dev = colour.device
    key_out = torch.empty_like(key)
    elim, act, caps, live = (torch.empty(B, dtype=torch.int32, device=dev) for _ in range(4))
    ovf = torch.empty(B, dtype=torch.bool, device=dev)
    if B == 0:
        return colour, kind, key_out, elim, act, ovf
    K, SM = cfg.num_colours, cfg.stack_max
    warps, blocks, scratch_bytes = _plan(cuda_build.library("combination_trip", dev, (R, C)), dev,
                                         B, R, C, K, SM)
    scratch = (None if scratch_bytes == 0 else
               torch.empty(warps * blocks * scratch_bytes, dtype=torch.uint8, device=dev))
    cuda_build.launch(
        "tmt_combination_trip", dev, (R, C), colour.data_ptr(), kind.data_ptr(), key.data_ptr(),
        coord1.data_ptr(), coord2.data_ptr(), comb.data_ptr(), key_out.data_ptr(), elim.data_ptr(),
        act.data_ptr(), ovf.data_ptr(), caps.data_ptr(), live.data_ptr(),
        None if scratch is None else scratch.data_ptr(), B, R, C, K, SM,
        cfg.activation_steps_max, warps, blocks,
    )
    if cfg.debug_checks:
        raise_caps(cfg, caps.cpu(), live.cpu())
    return colour, kind, key_out, elim, act, ovf
