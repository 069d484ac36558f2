"""The combination branch of a move (K5): the port's plain branch against the
JAX package's combination round, and K5's board program built for the host
against the plain branch; the activation machine K4 and K5 share, built for
the host, against the plain machine.

``engine.combination_branch`` (the combination match, the eliminations,
gravity, ``key, kd = split(key)`` and the refill from ``kd``) equals the
per-board body ``one`` of the JAX package's combination round
(tile_match_tpu/envs/fused.py:469-480, jitted and vmapped) in every output,
the key included, with every special set ``EnvConfig.create`` accepts, on
boards with sprinkled specials whose swap cells are painted with all 25
ordered pairs of kinds; boards whose flag is clear come back unchanged with
zero counts.  ``csrc/combination.cu`` compiled as plain C++
(``-DTMT_HOST_BUILD``, as ``test_torch_kernels_host.py`` builds K1-K3) and
run by the wrapper itself through the host seam (the boards updated in
place, as on the card) equals the plain branch on the same boards, in fixed-shape libraries and at
36x36 (the library of any shape), with caps tight enough that each fires
and raises the plain branch's ``debug_checks`` message, and on the
recorded combination fixtures and painted boards whose chains are longer
than the main path's longest; its ``tmt_run_machine_host`` (the machine of
``csrc/machine.cuh``, K4's, alone) and ``tmt_run_machine_bits_host`` (K5's
bit-plane machine of ``csrc/machine_bits.cuh`` alone) equal
``ops.activate.run_machine`` for every frame op, on sprinkled boards under
tight caps and on the recorded activation fixtures.  On the CPU the
wrapper writes nothing in place, and ``engine_move`` hands it temporaries
of its own (the kernel updates them in place on the card).
``test_torch_kernels_cuda.py`` holds the kernel itself on the card.

    JAX_PLATFORMS=cpu python -m pytest tests/test_torch_combination_trip.py -q
"""

import ctypes
import dataclasses
import functools
import json
import os

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from chip_smoke import combination_inputs
from tests.test_torch_specials import sprinkled
from tests.test_torch_trip_sp import SET_IDS, SETS, SIZES, _cfgs, _kinds
from tests.torch_port_helpers import host_build, host_kernels  # noqa: F401  (a fixture)
from tile_match_tpu.ops.board_ops import apply_refill as j_refill
from tile_match_tpu.ops.board_ops import draw_colour_grid as j_draw
from tile_match_tpu.ops.board_ops import gravity as j_gravity
from tile_match_tpu.ops.combination import combination_match as j_comb
from tile_match_tpu_torch import cuda_build
from tile_match_tpu_torch import engine
from tile_match_tpu_torch.config import EnvConfig
from tile_match_tpu_torch.ops import activate as tact
from tile_match_tpu_torch.ops import combination

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NAMES = ["colour", "kind", "key", "elim", "act", "ovf"]
B = 130
ALL = SETS[-1]
FIX = json.load(open(os.path.join(ROOT, "tests", "mechanic_fixtures.json")))


@functools.lru_cache(maxsize=None)
def comb_inputs(tc, seed, n=B):
    """``chip_smoke.combination_inputs`` with the config's special kinds
    sprinkled: the swap cells hold the 25 ordered pairs of kinds in turn.
    Returns numpy (colour, kind, keys uint32[n, 2], coord1, coord2 int32[n,
    2], comb bool[n]); cached, read-only."""
    t = combination_inputs(tc.num_rows, tc.num_cols, tc.num_colours, n, seed, "cpu",
                           kinds=tuple(_kinds(tc)))
    out = [a.numpy() for a in t]
    out[2] = out[2].astype(np.uint32)
    return tuple(out)


@functools.lru_cache(maxsize=None)
def _jax_one(jc):
    """The JAX package's per-board combination round (fused.py:469-480),
    jitted and vmapped."""
    def one(colour, kind, c1, c2, key):
        colour2, kind2, act, ovf = j_comb(jc, colour, kind, c1, c2)
        elim = jc.flat_size - jnp.count_nonzero(kind2).astype(jnp.int32)
        colour2, kind2 = j_gravity(colour2, kind2)
        key2, kd = jax.random.split(key)
        colour2, kind2 = j_refill(colour2, kind2, j_draw(kd, jc))
        return colour2, kind2, key2, elim, act, ovf

    return jax.jit(jax.vmap(one))


def jax_branch(jc, colour, kind, keys, c1, c2, comb):
    """JAX's round on the flagged boards; the others unchanged, zero counts."""
    out = [np.asarray(o) for o in _jax_one(jc)(*(jnp.asarray(a) for a in (colour, kind, c1, c2, keys)))]
    b3, b2 = comb[:, None, None], comb[:, None]
    return [np.where(b3, out[0], colour), np.where(b3, out[1], kind),
            np.where(b2, out[2], keys).astype(np.int64), np.where(comb, out[3], 0),
            np.where(comb, out[4], 0), np.where(comb, out[5], False)]


def _torch(colour, kind, keys, c1, c2, comb):
    return (torch.from_numpy(colour), torch.from_numpy(kind), torch.from_numpy(keys.astype(np.int64)),
            torch.from_numpy(c1), torch.from_numpy(c2), torch.from_numpy(comb))


def plain(tc, *inputs):
    return engine.combination_branch(tc, *_torch(*inputs))


def _assert_equal(got, want, tag, names=NAMES):
    for name, g, w in zip(names, got, want):
        assert g.dtype == w.dtype and torch.equal(g, w), f"{tag}: {name}"


def _set_cfgs(i, **kw):
    R, C, K = SIZES[i % len(SIZES)]
    return _cfgs(R, C, K, SETS[i], **kw)


@pytest.mark.parametrize("i", range(len(SETS)), ids=SET_IDS)
def test_plain_branch_matches_jax(i):
    jc, tc = _set_cfgs(i)
    inputs = comb_inputs(tc, seed=200 + i)
    want = jax_branch(jc, *inputs)
    got = plain(tc, *inputs)
    for name, g, w in zip(NAMES, got, want):
        g = g.numpy()
        assert g.dtype == w.dtype and np.array_equal(g, w), f"{SET_IDS[i]}: {name}"
    comb = inputs[5]
    assert 0 < int(comb.sum()) < B
    assert int(got[4].sum()) > 0 and int(got[3].sum()) > 0


# ---- K5's board program, built for the host -----------------------------------


@pytest.fixture(scope="module")
def host_lib(tmp_path_factory):
    return host_build(tmp_path_factory, "combination")


@pytest.fixture
def host_k5(host_kernels):
    """K5's wrapper on the host build of any board shape."""
    host_kernels("combination_trip", shape=None)


def run_k5(cfg, colour, kind, keys, c1, c2, comb):
    """K5's wrapper on numpy inputs (copies of the boards, which it updates
    in place), on the host build the seam points it at: (the six outputs,
    cap bits, frames live), torch tensors; the caps and frames are those the
    wrapper reads back with ``debug_checks`` on, recorded in place of its
    raising."""
    colour, kind, keys, c1, c2, comb = _torch(colour, kind, keys, c1, c2, comb)
    read = []
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(combination, "raise_caps", lambda cfg, caps, live: read.append((caps, live)))
        got = combination.combination_trip(dataclasses.replace(cfg, debug_checks=True),
                                           colour.clone(), kind.clone(), keys, c1, c2, comb)
    ((caps, live),) = read
    return got, caps, live


@pytest.mark.parametrize("i", range(len(SETS)), ids=SET_IDS)
def test_board_program_matches_plain(host_k5, i):
    _, tc = _set_cfgs(i)
    inputs = comb_inputs(tc, seed=200 + i)
    got, caps, _ = run_k5(tc, *inputs)
    _assert_equal(got, plain(tc, *inputs), SET_IDS[i])
    assert int(caps.sum()) == 0


def test_unflagged_boards_come_back_unchanged(host_k5):
    _, tc = _set_cfgs(len(SETS) - 1)
    colour, kind, keys, c1, c2, comb = comb_inputs(tc, seed=5)
    got, caps, live = run_k5(tc, colour, kind, keys, c1, c2, np.zeros_like(comb))
    _assert_equal(got, _torch(colour, kind, keys, c1, c2, comb)[:3], "unflagged", NAMES[:3])
    for t in (*got[3:], caps, live):
        assert not t.any()


@pytest.mark.parametrize("R,C,K,specials", [(10, 10, 4, ALL),
                                            (9, 7, 2, (("cookie",), ("vertical_laser",)))])
def test_fixed_shape_library_matches_plain(host_kernels, R, C, K, specials):
    """The libraries of one board shape (geometry fixed at compile time), as
    the card builds them for boards up to 32 by 32."""
    host_kernels("combination_trip", shape=(R, C))
    _, tc = _cfgs(R, C, K, specials)
    inputs = comb_inputs(tc, seed=R * C)
    got, _, _ = run_k5(tc, *inputs)
    _assert_equal(got, plain(tc, *inputs), f"{R}x{C}")
    narrow = tuple(np.ascontiguousarray(a[:, :, :-1]) if a.ndim == 3 else a for a in inputs)
    # another shape is refused (by the plan, the first call into the library)
    with pytest.raises(RuntimeError, match=f"no launch plan for {B} {R}x{C - 1} boards: .* -1"):
        run_k5(_cfgs(R, C - 1, K, specials)[1], *narrow)


def test_board_program_36x36(host_k5):
    """Above 32x32: the library whose geometry is read at run time (a
    laser's 36 cells take two votes on the card)."""
    _, tc = _cfgs(36, 36, 6, ALL)
    inputs = comb_inputs(tc, seed=36, n=50)
    got, _, _ = run_k5(tc, *inputs)
    _assert_equal(got, plain(tc, *inputs), "36x36")
    assert int(got[4].sum()) > 0


def _plain_error(tc, inputs):
    try:
        plain(dataclasses.replace(tc, debug_checks=True), *inputs)
    except RuntimeError as e:
        return str(e)
    return ""


def _k5_error(tc, caps, live):
    try:
        combination.raise_caps(dataclasses.replace(tc, debug_checks=True), caps, live)
    except RuntimeError as e:
        return str(e)
    return ""


@pytest.mark.parametrize("kw,bit", [(dict(max_stack=2), combination.CAP_STACK),
                                    (dict(max_activation_steps=3), combination.CAP_STEPS),
                                    (dict(max_stack=2, max_activation_steps=3), None)],
                         ids=["stack2", "steps3", "stack2-steps3"])
def test_caps_fire_as_in_plain(host_k5, kw, bit):
    """Tight caps: the outputs and ``ovf`` equal the plain branch's where
    caps fire, and the first cap's message is the plain branch's."""
    _, tc = _cfgs(8, 8, 3, ALL, **kw)
    inputs = comb_inputs(tc, seed=8)
    got, caps, live = run_k5(tc, *inputs)
    _assert_equal(got, plain(tc, *inputs), str(kw))
    message = _plain_error(tc, inputs)
    assert message and _k5_error(tc, caps, live) == message
    if bit is not None:
        assert bool((caps & bit).any()) and bool(got[5][caps > 0].all())
    fired = caps > 0
    assert bool((live[fired & ((caps & combination.CAP_STEPS) > 0)] > 0).all())


@pytest.mark.parametrize("fx", FIX["combination"], ids=[f["name"] for f in FIX["combination"]])
def test_combination_fixture(host_k5, fx):
    """The recorded combination matches of the original game: K5 equals the
    plain branch, and counts the recorded activations."""
    cfg = EnvConfig.create(fx["rows"], fx["cols"], fx["colours"], 10)
    colour, kind = (np.asarray(ch, np.int32)[None] for ch in fx["before"])
    inputs = (colour, kind, np.array([[7, 9]], np.uint32), np.array([fx["coord1"]], np.int32),
              np.array([fx["coord2"]], np.int32), np.ones(1, bool))
    got, _, _ = run_k5(cfg, *inputs)
    _assert_equal(got, plain(cfg, *inputs), fx["name"])
    assert int(got[4][0]) == fx["num_specials_activated"], fx["name"]


def test_wrapper_runs_the_plain_branch_on_the_cpu():
    _, tc = _set_cfgs(len(SETS) - 1)
    t = _torch(*comb_inputs(tc, seed=3, n=40))
    before = cuda_build.launches["combination_trip"]
    _assert_equal(combination.combination_trip(tc, *t), engine.combination_branch(tc, *t), "cpu")
    assert cuda_build.launches["combination_trip"] == before
    with pytest.raises(ValueError, match="unsupported device"):
        combination.combination_trip(tc, *(x.to("meta") for x in t))


# ---- the shared activation machine alone, built for the host ------------------

OPS = {"v_laser": tact.OP_V_LASER, "h_laser": tact.OP_H_LASER, "bomb": tact.OP_BOMB,
       "cookie": tact.OP_COOKIE, "maskscan": tact.OP_MASKSCAN, "bomb2": tact.OP_BOMB2}


def _machine_fn(lib):
    fn = lib.tmt_run_machine_host
    fn.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 6
    fn.restype = ctypes.c_int
    return fn


def run_machine_host(fn, cfg, colour, kind, seeds):
    """``tmt_run_machine_host`` on numpy boards with one seed frame each
    (op, row, column, scan index, colour, counted): (colour, kind, count,
    ovf, frames live), cap bits."""
    colour, kind = torch.from_numpy(colour), torch.from_numpy(kind)
    seeds = torch.from_numpy(np.ascontiguousarray(seeds, np.int32))
    n, R, C = colour.shape
    out = [torch.empty_like(colour), torch.empty_like(kind), torch.empty(n, dtype=torch.int32),
           torch.empty(n, dtype=torch.bool)]
    caps = torch.empty(n, dtype=torch.int32)
    live = torch.empty(n, dtype=torch.int32)
    err = fn(colour.data_ptr(), kind.data_ptr(), seeds.data_ptr(), *(t.data_ptr() for t in out),
             caps.data_ptr(), live.data_ptr(), n, R, C, cfg.num_colours, cfg.stack_max,
             cfg.activation_steps_max)
    assert err == 0
    return (*out, live), caps


def plain_machine(cfg, colour, kind, seeds):
    """``ops.activate``'s machine from the same seed frames."""
    s = torch.from_numpy(np.ascontiguousarray(seeds, np.int32))
    st = tact.machine_init(cfg, torch.from_numpy(colour), torch.from_numpy(kind))
    st = tact.push_frame(st, s[:, 0], s[:, 1], s[:, 2], s[:, 5], pred=True, idx=s[:, 3],
                         fcolour=s[:, 4])
    st = tact.run_machine(cfg, st)
    return st.colour, st.kind, st.count, st.ovf, st.sp


def _seeds(cfg, kind, op, rng):
    """One seed frame a board: op at a random cell; a real special not
    entered yet and counted, a 5x5 sweep or a mask scan from a random scan
    index, uncounted, the mask scan of a random colour."""
    n, R, C = kind.shape
    real = op in (tact.OP_V_LASER, tact.OP_H_LASER, tact.OP_BOMB, tact.OP_COOKIE)
    rows, cols = rng.integers(0, R, n), rng.integers(0, C, n)
    idx = np.full(n, -1) if real else rng.integers(0, R * C // 2, n)
    col = rng.integers(1, cfg.num_colours + 1, n) if op == tact.OP_MASKSCAN else np.zeros(n, int)
    return np.stack([np.full(n, op), rows, cols, idx, col, np.full(n, int(real))], 1)


@pytest.mark.parametrize("kw", [{}, dict(max_stack=2, max_activation_steps=3)],
                         ids=["default", "tight"])
@pytest.mark.parametrize("op", OPS)
def test_machine_matches_plain(host_lib, op, kw):
    """Each frame op seeded on boards with many specials, 10x10 and 36x36
    (where a laser's line takes two votes on the card): the same boards,
    counts, ``ovf`` and frames live; under tight caps the same first
    ``debug_checks`` message."""
    fn = _machine_fn(host_lib)
    for R, C, K, n in ((10, 10, 4, 120), (36, 36, 6, 16)):
        _, tc = _cfgs(R, C, K, ALL, **kw)
        colour, kind = sprinkled(R, C, K, n, seed=R + len(op), n_max=R * C // 4)
        seeds = _seeds(tc, kind, OPS[op], np.random.default_rng(R * 7 + len(op)))
        got, caps = run_machine_host(fn, tc, colour, kind, seeds)
        want = plain_machine(tc, colour, kind, seeds)
        _assert_equal(got, want, f"{op} {R}x{C} {kw}", ["colour", "kind", "count", "ovf", "live"])
        assert int((got[0] == 0).sum()) > int((colour == 0).sum())  # the machine deleted cells
        if kw:
            assert int(caps.sum()) > 0
            assert _k5_error(tc, caps, got[4]) == _plain_machine_error(tc, colour, kind, seeds)


def _plain_machine_error(cfg, colour, kind, seeds):
    try:
        plain_machine(dataclasses.replace(cfg, debug_checks=True), colour, kind, seeds)
    except RuntimeError as e:
        return str(e)
    return ""


@pytest.mark.parametrize("fx", FIX["activation"], ids=[f["name"] for f in FIX["activation"]])
def test_machine_activation_fixture(host_lib, fx):
    """The recorded activations of the original game, from the special at
    the fixture's cell, counted."""
    cfg = EnvConfig.create(fx["rows"], fx["cols"], fx["colours"], 10)
    colour, kind = (np.asarray(ch, np.int32)[None] for ch in fx["before"])
    r, c = fx["coord"]
    seeds = np.array([[kind[0, r, c], r, c, -1, 0, 1]], np.int32)
    got, _ = run_machine_host(_machine_fn(host_lib), cfg, colour, kind, seeds)
    _assert_equal(got, plain_machine(cfg, colour, kind, seeds), fx["name"],
                  ["colour", "kind", "count", "ovf", "live"])
    want_col, want_kin = (np.asarray(ch, np.int32) for ch in fx["after"])
    assert np.array_equal(got[0][0].numpy(), want_col) and np.array_equal(got[1][0].numpy(), want_kin)
    assert int(got[2][0]) == fx["num_specials_activated"], fx["name"]


# ---- K5's bit-plane machine alone, built for the host ------------------------


def _bits_fn(lib):
    fn = lib.tmt_run_machine_bits_host
    fn.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 6
    fn.restype = ctypes.c_int
    return fn


@pytest.mark.parametrize("kw", [{}, dict(max_stack=2), dict(max_activation_steps=3)],
                         ids=["default", "stack2", "steps3"])
@pytest.mark.parametrize("op", OPS)
def test_bits_machine_matches_plain(host_lib, op, kw):
    """``tmt_run_machine_bits_host`` (csrc/machine_bits.cuh, K5's machine)
    against ``ops.activate.run_machine``, each frame op seeded on boards
    with many specials at 6x6, 8x8 and 10x10 (130 boards, 4 words of a
    board's planes at 10x10): the same boards, counts, ``ovf`` and frames
    live; where a cap fires, the plain machine's first ``debug_checks``
    message."""
    fn = _bits_fn(host_lib)
    for R, C, K in ((10, 10, 4), (8, 8, 3), (6, 6, 3)):
        _, tc = _cfgs(R, C, K, ALL, **kw)
        colour, kind = sprinkled(R, C, K, B, seed=R * 3 + len(op), n_max=R * C // 3)
        seeds = _seeds(tc, kind, OPS[op], np.random.default_rng(R * 5 + len(op)))
        got, caps = run_machine_host(fn, tc, colour, kind, seeds)
        want = plain_machine(tc, colour, kind, seeds)
        _assert_equal(got, want, f"{op} {R}x{C} {kw}", ["colour", "kind", "count", "ovf", "live"])
        assert int((got[0] == 0).sum()) > int((colour == 0).sum())  # the machine deleted cells
        if kw:
            assert int(caps.sum()) > 0
            assert _k5_error(tc, caps, got[4]) == _plain_machine_error(tc, colour, kind, seeds)


def test_bits_machine_fixed_shape_and_wide_boards(tmp_path_factory, host_lib):
    """The bit-plane machine in a library of one board shape (10x10, its
    geometry fixed at compile time) and at 36x36 and 40x60 in the library
    of any shape (planes of 41 and 75 words: two and four words a lane on
    the card), every frame op in turn."""
    fixed = _bits_fn(host_build(tmp_path_factory, "combination", (10, 10)))
    for fn, (R, C, K, n) in ((fixed, (10, 10, 4, B)), (_bits_fn(host_lib), (36, 36, 6, 4)),
                             (_bits_fn(host_lib), (40, 60, 5, 2))):
        _, tc = _cfgs(R, C, K, ALL)
        colour, kind = sprinkled(R, C, K, n, seed=R + C, n_max=R * C // 8)
        for op in OPS:
            seeds = _seeds(tc, kind, OPS[op], np.random.default_rng(R * C + len(op)))
            got, _ = run_machine_host(fn, tc, colour, kind, seeds)
            _assert_equal(got, plain_machine(tc, colour, kind, seeds), f"{op} {R}x{C}",
                          ["colour", "kind", "count", "ovf", "live"])


@pytest.mark.parametrize("fx", FIX["activation"], ids=[f["name"] for f in FIX["activation"]])
def test_bits_machine_activation_fixture(host_lib, fx):
    """The recorded activations of the original game through the bit-plane
    machine, from the special at the fixture's cell, counted."""
    cfg = EnvConfig.create(fx["rows"], fx["cols"], fx["colours"], 10)
    colour, kind = (np.asarray(ch, np.int32)[None] for ch in fx["before"])
    r, c = fx["coord"]
    seeds = np.array([[kind[0, r, c], r, c, -1, 0, 1]], np.int32)
    got, _ = run_machine_host(_bits_fn(host_lib), cfg, colour, kind, seeds)
    want_col, want_kin = (np.asarray(ch, np.int32) for ch in fx["after"])
    assert np.array_equal(got[0][0].numpy(), want_col) and np.array_equal(got[1][0].numpy(), want_kin)
    assert int(got[2][0]) == fx["num_specials_activated"], fx["name"]


def test_engine_move_hands_k5_its_temporaries(monkeypatch):
    """The first 12 steps of the recorded config-3 rollout (tests/data/
    torch_port_fixture_cfg3.npz) replay bit for bit on the CPU with the
    combination branch watched: ``engine_move`` hands ``combination_trip``
    boards of its own (the swap's temporaries, never the caller's state
    tensors, which the kernel on the card updates in place), and on the CPU
    the wrapper writes nothing into them."""
    from tile_match_tpu_torch import random as trandom
    from tile_match_tpu_torch.envs.batched import BatchedTileMatchEnv
    from tile_match_tpu_torch.interop import state_to_numpy

    calls, moves = [], []
    trip, move = engine.combination_trip, engine.engine_move

    def watched_move(cfg, colour, kind, *rest):
        moves.append((colour.data_ptr(), kind.data_ptr()))
        return move(cfg, colour, kind, *rest)

    def watched_trip(cfg, colour, kind, key, coord1, coord2, comb):
        before = colour.clone(), kind.clone()
        out = trip(cfg, colour, kind, key, coord1, coord2, comb)
        calls.append(((colour.data_ptr(), kind.data_ptr()), int(comb.sum()),
                      torch.equal(colour, before[0]) and torch.equal(kind, before[1])))
        return out

    monkeypatch.setattr(engine, "engine_move", watched_move)
    monkeypatch.setattr(engine, "combination_trip", watched_trip)
    d = np.load(os.path.join(ROOT, "tests", "data", "torch_port_fixture_cfg3.npz"))
    R, C, K, moves_max = (int(v) for v in d["config"])
    cfg = EnvConfig(R, C, K, moves_max, **dict(zip(
        ("cookie", "vertical_laser", "horizontal_laser", "bomb"), (bool(f) for f in d["specials"]))))
    env = BatchedTileMatchEnv(cfg, d["colour"].shape[1], device="cpu")
    states, _ = env.reset(trandom.PRNGKey(int(d["seed"]), "cpu"))
    for t in range(12):
        states, _ = env.step(states, torch.as_tensor(d["actions"][t].astype(np.int64)))
        got = state_to_numpy(states)
        for name in ("colour", "kind", "key"):
            assert np.array_equal(got[name], d[name][t + 1]), f"step {t}: {name}"
    assert len(calls) == len(moves) == 12
    assert sum(flagged for _, flagged, _ in calls) > 0
    for (ptrs, _, untouched), caller in zip(calls, moves):
        assert untouched and ptrs[0] not in caller and ptrs[1] not in caller


# the most micro-steps of a flagged board's chain on config 3's step-20 K5
# inputs at B=16384 (chip_smoke.k5_readings, PERF.md §6)
LONGEST_MAIN_PATH_CHAIN = 77


def _painted_long_chain(partner):
    """A 10x10x4 board whose swap of a cookie at (0, 0) with a special at
    (0, 1) turns every other cell's normal (colour 1, half the board) into
    that special: each converted special's frame scans its region in turn."""
    r, c = np.indices((10, 10))
    colour = ((r + 2 * c) % 4 + 1).astype(np.int32)
    colour[(r + c) % 2 == 0] = 1
    kind = np.ones_like(colour)
    kind[0, 0], colour[0, 0] = -1, 0
    kind[0, 1], colour[0, 1] = partner, 1
    return colour, kind


def test_longest_chain_painted_board(host_k5):
    """Painted boards whose chains are longer than the longest of the main
    path's step-20 launch (one for each partner special): K5's host build
    equals the plain branch and JAX's combination round on them."""
    from chip_smoke import chain_lengths

    jc, tc = _cfgs(10, 10, 4, ALL)
    boards = [_painted_long_chain(k) for k in (2, 3, 4)]
    inputs = (np.stack([b[0] for b in boards]), np.stack([b[1] for b in boards]),
              np.array([[1, 2], [3, 4], [5, 6]], np.uint32), np.zeros((3, 2), np.int32),
              np.tile(np.array([[0, 1]], np.int32), (3, 1)), np.ones(3, bool))
    _, steps = chain_lengths(tc, _torch(*inputs))
    assert int(steps.min()) > LONGEST_MAIN_PATH_CHAIN
    want = plain(tc, *inputs)
    got, caps, _ = run_k5(tc, *inputs)
    _assert_equal(got, want, "painted long chains")
    assert int(caps.sum()) == 0
    for name, g, w in zip(NAMES, want, jax_branch(jc, *inputs)):
        assert np.array_equal(g.numpy(), w), name


def test_bits_machine_mask_scan_of_a_colour_without_a_plane(host_lib):
    """A mask scan of colour 0 or K + 1, which have no colour plane in K5's
    machine: the specials of that colour come from the board's cells, as
    in the plain machine."""
    _, tc = _cfgs(8, 8, 3, ALL)
    colour, kind = sprinkled(8, 8, 3, B, seed=17, n_max=20)
    rng = np.random.default_rng(17)
    odd = (kind > 1) & (rng.random(kind.shape) < 0.5)
    colour = np.where(odd, rng.choice(np.array([0, 4], np.int32), kind.shape), colour).astype(np.int32)
    seeds = _seeds(tc, kind, tact.OP_MASKSCAN, rng)
    seeds[:, 4] = np.where(np.arange(B) % 2 == 0, 0, 4)
    got, _ = run_machine_host(_bits_fn(host_lib), tc, colour, kind, seeds)
    want = plain_machine(tc, colour, kind, seeds)
    _assert_equal(got, want, "mask scan", ["colour", "kind", "count", "ovf", "live"])
    assert int(got[2].sum()) > 0  # the scans found specials and activated their children
