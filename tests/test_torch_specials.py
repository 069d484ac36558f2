"""The port's specials machinery equals the JAX package's, exactly: line
slots, classification, resolution, activation and combination matches,
against ``jax.vmap`` of the JAX functions on boards with sprinkled
specials, and the recorded mechanic fixtures."""

import json
import os

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from tile_match_tpu.config import EnvConfig as JaxConfig
from tile_match_tpu.ops import activate as jact
from tile_match_tpu.ops.classify import process_colour_lines as j_classify
from tile_match_tpu.ops.combination import combination_match as j_comb
from tile_match_tpu.ops.combination import is_combination as j_is_comb
from tile_match_tpu.ops.lines import get_colour_lines as j_lines
from tile_match_tpu.ops.resolve import resolve_colour_matches as j_resolve
from tile_match_tpu_torch.config import EnvConfig
from tile_match_tpu_torch.ops import activate as tact
from tile_match_tpu_torch.ops.classify import process_colour_lines
from tile_match_tpu_torch.ops.combination import combination_match, is_combination
from tile_match_tpu_torch.ops.lines import get_colour_lines
from tile_match_tpu_torch.ops.resolve import _creation_pos, resolve_colour_matches

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ALL = (("cookie",), ("vertical_laser", "horizontal_laser", "bomb"))
LASERS_BOMB = ((), ("vertical_laser", "horizontal_laser", "bomb"))
# (rows, cols, colours, specials): two colours make long lines and shares
CASES = [(6, 6, 3, ALL), (8, 8, 4, ALL), (8, 8, 2, ALL), (8, 8, 3, LASERS_BOMB)]
IDS = ["6x6x3-all", "8x8x4-all", "8x8x2-all", "8x8x3-lasers-bomb"]


def _cfgs(R, C, K, specials):
    kw = dict(colourless_specials=specials[0], colour_specials=specials[1])
    return JaxConfig.create(R, C, K, 10, **kw), EnvConfig.create(R, C, K, 10, **kw)


def sprinkled(R, C, K, B, seed, n_max=6, kinds=(2, 3, 4, -1)):
    """Random boards with 0..n_max-1 specials each, of the given kinds
    (cookies colourless)."""
    rng = np.random.default_rng(seed)
    colour = rng.integers(1, K + 1, size=(B, R, C)).astype(np.int32)
    kind = np.ones_like(colour)
    for b in range(B):
        n = rng.integers(0, n_max)
        cells = rng.choice(R * C, size=n, replace=False)
        ks = rng.choice(np.array(kinds, np.int32), size=n)
        kind[b].reshape(-1)[cells] = ks
        colour[b].reshape(-1)[cells[ks == -1]] = 0
    return colour, kind


def _equal(got, want, tag):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, tag
    assert np.array_equal(got, want), f"{tag}: boards {np.nonzero((got != want).reshape(len(got), -1).any(1))[0][:5]}"


@pytest.mark.parametrize("R,C,K,specials", CASES, ids=IDS)
def test_lines_classify_resolve_match_jax(R, C, K, specials):
    jc, tc = _cfgs(R, C, K, specials)
    colour, kind = sprinkled(R, C, K, 160, seed=R * 10 + K)

    def one(c, k):
        ls = j_lines(jc, c, k)
        m = j_classify(jc, c, ls)
        return ls, m, j_resolve(jc, c, k, m)

    jls, jm, jres = jax.jit(jax.vmap(one))(jnp.asarray(colour), jnp.asarray(kind))
    tcol, tkind = torch.from_numpy(colour), torch.from_numpy(kind)
    tls = get_colour_lines(tc, tcol)
    for f in ("coords", "length", "count", "ovf"):
        _equal(getattr(tls, f), getattr(jls, f), f"lines.{f}")
    tm = process_colour_lines(tc, tcol, tls)
    for f in ("coords", "length", "mtype", "mcolour", "count", "ovf"):
        _equal(getattr(tm, f), getattr(jm, f), f"matches.{f}")
    tres = resolve_colour_matches(tc, tcol, tkind, tm)
    for name, g, w in zip(("colour", "kind", "activated", "new", "ovf"), tres, jres):
        _equal(g, w, f"resolve.{name}")
    # the boards exercise every match type and the machinery
    assert int(np.asarray(jm.count).sum()) > 0 and int(np.asarray(jres[3]).sum()) > 0


@pytest.mark.parametrize("R,C,K,specials", CASES[:2] + CASES[3:], ids=IDS[:2] + IDS[3:])
def test_run_machine_matches_jax(R, C, K, specials):
    """One counted activation pushed at a random special of each board."""
    jc, tc = _cfgs(R, C, K, specials)
    colour, kind = sprinkled(R, C, K, 96, seed=R + K + 1, n_max=12)
    rng = np.random.default_rng(R)
    rc = np.stack([rng.integers(0, R, 96), rng.integers(0, C, 96)], 1).astype(np.int32)
    op = kind[np.arange(96), rc[:, 0], rc[:, 1]]

    def one(c, k, o, r, cc):
        st = jact.machine_init(jc, c, k, 0)
        st = jact.push_frame(st, o, r, cc, 1, pred=True, idx=-1)
        st = jact.run_machine(jc, st)
        return st[0], st[1], st[2], st[-2], st[-1]

    want = jax.jit(jax.vmap(one))(
        jnp.asarray(colour), jnp.asarray(kind), jnp.asarray(op), jnp.asarray(rc[:, 0]),
        jnp.asarray(rc[:, 1]),
    )
    st = tact.machine_init(tc, torch.from_numpy(colour), torch.from_numpy(kind))
    r_t, c_t = torch.from_numpy(rc[:, 0]), torch.from_numpy(rc[:, 1])
    st = tact.push_frame(st, torch.from_numpy(op), r_t, c_t, 1, pred=True)
    st = tact.run_machine(tc, st)
    for name, g, w in zip(("colour", "kind", "count", "ovf", "sp"),
                          (st.colour, st.kind, st.count, st.ovf, st.sp), want):
        _equal(g, w, name)


def test_run_machine_budget_and_stack_caps_match_jax():
    """Tiny caps: a dropped push and an exhausted step budget set ovf."""
    kw = dict(max_stack=2, max_activation_steps=3)
    jc = JaxConfig.create(6, 6, 3, 10, **kw)
    tc = EnvConfig.create(6, 6, 3, 10, **kw)
    colour, kind = sprinkled(6, 6, 3, 64, seed=4, n_max=14)
    kind[:, 2, :] = 3  # a row of horizontal lasers: deep chains

    def one(c, k):
        st = jact.machine_init(jc, c, k, 0)
        st = jact.push_frame(st, jnp.int32(2), 0, 2, 1, pred=True, idx=-1)
        st = jact.run_machine(jc, st)
        return st[0], st[1], st[2], st[-2]

    want = jax.jit(jax.vmap(one))(jnp.asarray(colour), jnp.asarray(kind))
    st = tact.machine_init(tc, torch.from_numpy(colour), torch.from_numpy(kind))
    z = torch.zeros(64, dtype=torch.int32)
    st = tact.push_frame(st, 2, z, z + 2, 1, pred=True)
    st = tact.run_machine(tc, st)
    for name, g, w in zip(("colour", "kind", "count", "ovf"), (st.colour, st.kind, st.count, st.ovf), want):
        _equal(g, w, name)
    assert bool(st.ovf.any())


@pytest.mark.parametrize("R,C,K,specials", CASES[:2] + CASES[3:], ids=IDS[:2] + IDS[3:])
def test_combination_matches_jax(R, C, K, specials):
    """Swaps of two specials, or of a cookie and anything, in every pairing."""
    jc, tc = _cfgs(R, C, K, specials)
    B = 120
    colour, kind = sprinkled(R, C, K, B, seed=R * K, n_max=8)
    rng = np.random.default_rng(K)
    c1 = np.stack([rng.integers(0, R - 1, B), rng.integers(0, C - 1, B)], 1).astype(np.int32)
    right = rng.random(B) < 0.5
    c2 = c1 + np.where(right[:, None], [0, 1], [1, 0]).astype(np.int32)
    pairs = [(a, b) for a in (-1, 1, 2, 3, 4) for b in (-1, 1, 2, 3, 4)]
    for b in range(B):
        for (r, c), k in zip((c1[b], c2[b]), pairs[b % len(pairs)]):
            kind[b, r, c] = k
            colour[b, r, c] = 0 if k == -1 else rng.integers(1, K + 1)
    jargs = [jnp.asarray(a) for a in (colour, kind, c1, c2)]
    targs = [torch.from_numpy(a) for a in (colour, kind, c1, c2)]
    _equal(is_combination(targs[1], targs[2], targs[3]), jax.vmap(j_is_comb)(*jargs[1:]), "is_comb")
    want = jax.jit(jax.vmap(lambda c, k, a, b: j_comb(jc, c, k, a, b)))(*jargs)
    got = combination_match(tc, *targs)
    for name, g, w in zip(("colour", "kind", "activated", "ovf"), got, want):
        _equal(g, w, name)


_FIX = json.load(open(os.path.join(ROOT, "tests", "mechanic_fixtures.json")))


def _fx_cfg(fx):
    return EnvConfig.create(fx["rows"], fx["cols"], fx["colours"], 10)


def _fx_board(fx):
    col, kin = (torch.tensor(ch, dtype=torch.int32)[None] for ch in fx["before"])
    return col, kin


@pytest.mark.parametrize("fx", _FIX["activation"], ids=[f["name"] for f in _FIX["activation"]])
def test_activation_fixture(fx):
    cfg = _fx_cfg(fx)
    col, kin = _fx_board(fx)
    r, c = fx["coord"]
    st = tact.machine_init(cfg, col, kin)
    st = tact.push_frame(st, kin[:, r, c], r, c, 1, pred=True)
    st = tact.run_machine(cfg, st)
    want_col, want_kin = (np.asarray(ch, np.int32) for ch in fx["after"])
    assert np.array_equal(st.colour[0].numpy(), want_col), fx["name"]
    assert np.array_equal(st.kind[0].numpy(), want_kin), fx["name"]
    assert int(st.count[0]) == fx["num_specials_activated"], fx["name"]


@pytest.mark.parametrize("fx", _FIX["combination"], ids=[f["name"] for f in _FIX["combination"]])
def test_combination_fixture(fx):
    cfg = _fx_cfg(fx)
    col, kin = _fx_board(fx)
    c1 = torch.tensor([fx["coord1"]], dtype=torch.int32)
    c2 = torch.tensor([fx["coord2"]], dtype=torch.int32)
    out_col, out_kin, act, _ovf = combination_match(cfg, col, kin, c1, c2)
    want_col, want_kin = (np.asarray(ch, np.int32) for ch in fx["after"])
    assert np.array_equal(out_col[0].numpy(), want_col), fx["name"]
    assert np.array_equal(out_kin[0].numpy(), want_kin), fx["name"]
    assert int(act[0]) == fx["num_specials_activated"], fx["name"]


@pytest.mark.parametrize("fx", _FIX["creation_pos"], ids=[f["name"] for f in _FIX["creation_pos"]])
def test_creation_pos_fixture(fx):
    cfg = _fx_cfg(fx)
    CM = cfg.match_coords_max
    coords = torch.full((1, CM, 2), -1, dtype=torch.int32)
    n = len(fx["coords"])
    coords[0, :n] = torch.tensor(fx["coords"], dtype=torch.int32)
    taken = torch.zeros((1, fx["rows"], fx["cols"]), dtype=torch.bool)
    for r, c in fx["taken"]:
        taken[0, r, c] = True
    pos = _creation_pos(
        cfg, coords, torch.tensor([n]), torch.tensor([not fx["straight"]]), taken
    )
    assert pos[0].tolist() == fx["pos"], fx["name"]
