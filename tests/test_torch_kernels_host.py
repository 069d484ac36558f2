"""The CUDA kernels' board programs, built for the host, equal the plain
PyTorch versions exactly.

``csrc/cascade.cu``, ``csrc/cascade_sp.cu`` and ``csrc/mask_sp.cu`` write
each kernel as a sequence of per-cell phases on the executors of
``csrc/block.cuh``; compiled as plain C++ with ``-DTMT_HOST_BUILD`` the
same phases run as loops over the cells of one board after another, with
the bit helpers on the compiler's builtins.  This holds the kernels'
arithmetic against ``cascade_reference``, ``cascade_sp_reference`` and
``effective_mask_settled`` without a card, at boards above 1024 cells and
on painted boards whose runs touch the edges of rows and columns that
straddle the 32-bit words of the cell masks;
``test_torch_kernels_cuda.py`` holds the kernels themselves on the card.
Needs ``g++``; skips without it.

    JAX_PLATFORMS=cpu python -m pytest tests/test_torch_kernels_host.py -q
"""

import ctypes
import shutil
import subprocess
import types

import numpy as np
import pytest
import torch

from chip_smoke import corner_boards
from tests.test_torch_kernels_cuda import (LINE_CASES, LINE_KINDS, line_boards, line_case_ids,
                                           plain_line_test)
from tests.test_torch_specials import sprinkled
from tile_match_tpu_torch import cuda_build
from tile_match_tpu_torch import random as trandom
from tile_match_tpu_torch.config import EnvConfig
from tile_match_tpu_torch.cuda_build import CSRC
from tile_match_tpu_torch.ops.cascade import cascade_reference
from tile_match_tpu_torch.ops.cascade_sp import cascade_sp_reference
from tile_match_tpu_torch.ops.effective import effective_mask_settled

torch.set_num_threads(1)

ALL = (("cookie",), ("vertical_laser", "horizontal_laser", "bomb"))
LASERS_BOMB = ((), ("vertical_laser", "horizontal_laser", "bomb"))
V_LASER_BOMB = ((), ("vertical_laser", "bomb"))
# without the bomb: K2's no-bomb case table
NO_BOMB = (("cookie",), ("vertical_laser", "horizontal_laser"))
LASERS = ((), ("vertical_laser", "horizontal_laser"))
COOKIE = (("cookie",), ())
COOKIE_V = (("cookie",), ("vertical_laser",))
NAMES = ["colour", "kind", "trips", "elim", "new", "act", "frozen", "active", "reasons"]
K1_NAMES = ["colour", "elim", "trips", "truncated", "mask"]


def _host_build(tmp_path_factory, name, shape=None):
    """The board programs of ``csrc/<name>.cu`` built for the host: with
    ``shape`` = (R, C) the library of that board shape (its geometry fixed
    at compile time, as the card's libraries of boards up to 32 by 32),
    else the one whose geometry is read at run time (any board)."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++ to build the kernels' board programs for the host")
    defines = [] if shape is None else [f"-DTMT_ROWS={shape[0]}", f"-DTMT_COLS={shape[1]}"]
    so = tmp_path_factory.mktemp("host_build") / f"lib{name}_host.so"
    subprocess.run(
        [gxx, "-O2", "-std=c++17", "-x", "c++", "-DTMT_HOST_BUILD", *defines, "-shared", "-fPIC",
         "-I", str(CSRC), "-o", str(so), str(CSRC / f"{name}.cu")],
        check=True, capture_output=True, text=True,
    )
    return ctypes.CDLL(str(so))


def _k1_fn(lib):
    k1 = lib.tmt_fused_cascade_host
    k1.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 5
    k1.restype = ctypes.c_int
    return k1


def _k2_fn(lib):
    k2 = lib.tmt_cascade_sp_host
    k2.argtypes = [ctypes.c_void_p] * 15 + [ctypes.c_int] * 10
    k2.restype = ctypes.c_int
    return k2


@pytest.fixture(scope="module")
def host_k1(tmp_path_factory):
    return _k1_fn(_host_build(tmp_path_factory, "cascade"))


def _k3_fn(lib):
    k3 = lib.tmt_settled_mask_sp_host
    k3.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 4
    k3.restype = ctypes.c_int
    return k3


@pytest.fixture(scope="module")
def host_libs(tmp_path_factory):
    libs = {name: _host_build(tmp_path_factory, name) for name in ("cascade_sp", "mask_sp")}
    return _k2_fn(libs["cascade_sp"]), _k3_fn(libs["mask_sp"])


def _inputs(cfg, B, seed):
    R, C, K = cfg.num_rows, cfg.num_cols, cfg.num_colours
    gen = torch.Generator().manual_seed(seed)
    kinds = [k for k, on in ((2, cfg.vertical_laser), (3, cfg.horizontal_laser), (4, cfg.bomb),
                             (-1, cfg.cookie)) if on]
    colour, kind = (torch.from_numpy(a) for a in sprinkled(R, C, K, B, seed, n_max=10, kinds=kinds))
    keys = torch.randint(0, 1 << 32, (B, 2), generator=gen, dtype=torch.int64)
    trips = torch.randint(0, 3, (B,), generator=gen, dtype=torch.int32)
    elim = torch.randint(0, 9, (B,), generator=gen, dtype=torch.int32)
    frozen = (torch.rand(B, generator=gen) < 0.05).to(torch.int32)
    return colour, kind, keys, trips, elim, frozen


@pytest.mark.parametrize(
    "R,C,K,specials,B,limit",
    [(6, 6, 3, ALL, 200, 8), (8, 8, 3, LASERS_BOMB, 200, 64), (10, 10, 4, ALL, 200, 64),
     (6, 6, 2, ALL, 200, 64), (7, 9, 3, V_LASER_BOMB, 150, 2), (20, 20, 6, ALL, 40, 64),
     (5, 5, 3, ALL, 200, 64), (10, 10, 4, NO_BOMB, 200, 64), (6, 6, 3, LASERS, 200, 64),
     (8, 8, 4, COOKIE, 200, 64), (20, 20, 6, NO_BOMB, 40, 64), (7, 9, 3, COOKIE_V, 150, 2)],
)
def test_cascade_sp_board_program_matches_plain(host_libs, R, C, K, specials, B, limit):
    k2, k3 = host_libs
    cfg = EnvConfig.create(R, C, K, 30, colourless_specials=specials[0], colour_specials=specials[1])
    inputs = _inputs(cfg, B, seed=R * C + limit)
    colour, kind, keys, trips, elim, frozen = inputs
    got = [torch.empty_like(colour), torch.empty_like(kind)]
    got += [torch.empty(B, dtype=torch.int32) for _ in range(5)]
    got += [torch.empty(B, dtype=torch.bool), torch.empty(B, dtype=torch.int32)]
    err = k2(*(t.data_ptr() for t in inputs), *(t.data_ptr() for t in got),
             B, R, C, K, cfg.max_cascades, limit,
             int(cfg.cookie), int(cfg.vertical_laser), int(cfg.horizontal_laser), int(cfg.bomb))
    assert err == 0
    want = cascade_sp_reference(cfg, *inputs, limit=limit)
    for name, g, w in zip(NAMES, got, want):
        assert torch.equal(g, w), name
    assert int(want[6].sum()) > int(frozen.sum())  # some boards froze here

    mask = torch.empty(B, cfg.num_actions, dtype=torch.bool)
    assert k3(got[0].data_ptr(), got[1].data_ptr(), mask.data_ptr(), B, R, C, 1) == 0
    assert torch.equal(mask, effective_mask_settled(cfg, got[0], got[1]))


def test_cascade_sp_no_bomb_corners_match_plain(host_libs):
    """Two cookie lines crossing in both tails: the corner survives."""
    k2, _ = host_libs
    cfg = EnvConfig.create(8, 8, 4, 30, colourless_specials=NO_BOMB[0], colour_specials=NO_BOMB[1])
    colour, kind = (torch.from_numpy(a) for a in corner_boards(64, seed=1))
    keys = torch.arange(128, dtype=torch.int64).reshape(64, 2)
    z = torch.zeros(64, dtype=torch.int32)
    inputs = (colour, kind, keys, z, z, z)
    got = [torch.empty_like(colour), torch.empty_like(kind)]
    got += [torch.empty(64, dtype=torch.int32) for _ in range(5)]
    got += [torch.empty(64, dtype=torch.bool), torch.empty(64, dtype=torch.int32)]
    assert k2(*(t.data_ptr() for t in inputs), *(t.data_ptr() for t in got),
              64, 8, 8, 4, cfg.max_cascades, 1, 1, 1, 1, 0) == 0
    want = cascade_sp_reference(cfg, *inputs, limit=1)
    for name, g, w in zip(NAMES, got, want):
        assert torch.equal(g, w), name
    assert (want[4] == 2).all()


def test_build_hash_covers_included_headers(tmp_path, monkeypatch):
    """An edited shared header changes the library name of every source
    that includes it, directly or through another header, and only those."""
    for path in CSRC.iterdir():
        (tmp_path / path.name).write_bytes(path.read_bytes())
    monkeypatch.setattr(cuda_build, "CSRC", tmp_path)
    names = ("cascade", "cascade_sp", "mask_sp")
    assert {p.name for p in cuda_build.sources("cascade_sp")} == {
        "cascade_sp.cu", "trip.cuh", "block.cuh", "threefry.cuh"
    }
    before = {n: cuda_build.digest(n) for n in names}
    with open(tmp_path / "mask.cuh", "a") as f:
        f.write("// edited\n")
    after = {n: cuda_build.digest(n) for n in names}
    assert after["cascade"] != before["cascade"]  # K1's mask epilogue
    assert after["cascade_sp"] == before["cascade_sp"] and after["mask_sp"] == before["mask_sp"]
    assert {p.name for p in cuda_build.sources("mask_sp")} == {
        "mask_sp.cu", "trip.cuh", "block.cuh", "threefry.cuh"
    }
    with open(tmp_path / "block.cuh", "a") as f:  # included through mask.cuh / threefry.cuh
        f.write("// edited\n")
    assert all(cuda_build.digest(n) != after[n] for n in names)
    # a board shape is a library of its own, but for a source that reads none
    for n in ("cascade", "mask_sp"):
        assert len({cuda_build.digest(n, shape) for shape in (None, (10, 10), (10, 9))}) == 3
    assert not cuda_build.takes_shape("threefry_words")
    assert len({cuda_build.digest("threefry_words", shape) for shape in (None, (10, 10))}) == 1


def _k1_run(k1, cfg, colour, keys):
    B, R, C = colour.shape
    got = [torch.empty_like(colour), torch.empty(B, dtype=torch.int32),
           torch.empty(B, dtype=torch.int32), torch.empty(B, dtype=torch.bool),
           torch.empty(B, cfg.num_actions, dtype=torch.bool)]
    err = k1(colour.data_ptr(), keys.data_ptr(), *(t.data_ptr() for t in got),
             B, R, C, cfg.num_colours, cfg.max_cascades)
    assert err == 0
    return got


def _k2_run(k2, cfg, inputs, limit):
    colour = inputs[0]
    B, R, C = colour.shape
    got = [torch.empty_like(colour), torch.empty_like(inputs[1])]
    got += [torch.empty(B, dtype=torch.int32) for _ in range(5)]
    got += [torch.empty(B, dtype=torch.bool), torch.empty(B, dtype=torch.int32)]
    err = k2(*(t.data_ptr() for t in inputs), *(t.data_ptr() for t in got),
             B, R, C, cfg.num_colours, cfg.max_cascades, limit,
             int(cfg.cookie), int(cfg.vertical_laser), int(cfg.horizontal_laser), int(cfg.bomb))
    assert err == 0
    return got


def _k1_inputs(R, C, K, B, seed):
    rng = np.random.default_rng(seed)
    colour = torch.from_numpy(rng.integers(1, K + 1, size=(B, R, C)).astype(np.int32))
    keys = torch.from_numpy(rng.integers(0, 1 << 32, size=(B, 2), dtype=np.uint64).astype(np.int64))
    return colour, keys


@pytest.mark.parametrize("R,C,K,B,max_cascades",
                         [(5, 5, 3, 64, 64), (10, 10, 4, 64, 64), (20, 20, 6, 32, 64),
                          (7, 9, 4, 64, 2), (1, 8, 3, 16, 64), (8, 1, 3, 16, 64),
                          (36, 36, 6, 8, 64), (6, 32, 1, 4, 3), (32, 6, 1, 4, 3)])
def test_cascade_board_program_matches_plain(host_k1, R, C, K, B, max_cascades):
    """K1's board program, 36x36 (1,296 cells) above the old one-thread-per-cell cap;
    with one colour, every row and column one run of 32 cells at 6x32 and 32x6."""
    cfg = EnvConfig.create(R, C, K, 30, colourless_specials=(), colour_specials=(),
                           max_cascades=max_cascades)
    colour, keys = _k1_inputs(R, C, K, B, seed=R * C + B)
    got = _k1_run(host_k1, cfg, colour, keys)
    want = cascade_reference(cfg, colour, keys)
    for name, g, w in zip(K1_NAMES, got, want):
        assert torch.equal(g, w), name


def test_cascade_sp_board_program_above_old_cap(host_libs):
    """K2 with and without the bomb and K3 at 36x36x6 (1,296 cells)."""
    k2, k3 = host_libs
    for specials, limit in ((ALL, 64), (NO_BOMB, 64)):
        cfg = EnvConfig.create(36, 36, 6, 30, colourless_specials=specials[0],
                               colour_specials=specials[1])
        inputs = _inputs(cfg, 8, seed=36 + len(specials[1]))
        got = _k2_run(k2, cfg, inputs, limit)
        want = cascade_sp_reference(cfg, *inputs, limit=limit)
        for name, g, w in zip(NAMES, got, want):
            assert torch.equal(g, w), (specials, name)
        mask = torch.empty(8, cfg.num_actions, dtype=torch.bool)
        assert k3(got[0].data_ptr(), got[1].data_ptr(), mask.data_ptr(), 8, 36, 36, 1) == 0
        assert torch.equal(mask, effective_mask_settled(cfg, got[0], got[1]))


def painted_edges(R, C, B, seed, specials=False, longest=8):
    """Line-free two-colour boards (colours 1 and 2) with one to three
    painted runs of colour 3 or 4, 3 to ``longest`` cells each, each on an
    edge: starting in column 0, ending in column C-1, in row R-1, starting
    in row 0 or ending in row R-1.  With ``specials`` a third of the
    painted cells become a vertical or horizontal laser or a bomb."""
    rng = np.random.default_rng(seed)
    rows, cols = np.indices((R, C))
    colour = np.where((rows + cols) % 2 == 0, 1, 2)[None].repeat(B, 0).astype(np.int32)
    kind = np.ones_like(colour)
    for b in range(B):
        painted = np.zeros((R, C), bool)
        for _ in range(int(rng.integers(1, 4))):
            pc = int(rng.integers(3, 5))
            if rng.random() < 0.5:
                n = int(rng.integers(3, min(C, longest) + 1))
                r = R - 1 if rng.random() < 0.5 else int(rng.integers(0, R))
                c0 = 0 if rng.random() < 0.5 else C - n
                colour[b, r, c0:c0 + n] = pc
                painted[r, c0:c0 + n] = True
            else:
                n = int(rng.integers(3, min(R, longest) + 1))
                c = int(rng.choice([0, C - 1, int(rng.integers(0, C))]))
                r0 = R - n if rng.random() < 0.5 else 0
                colour[b, r0:r0 + n, c] = pc
                painted[r0:r0 + n, c] = True
        if specials:
            cells = np.flatnonzero(painted & (rng.random((R, C)) < 1 / 3))
            kind[b].reshape(-1)[cells] = rng.choice(np.array([2, 3, 4], np.int32), size=cells.size)
    return torch.from_numpy(colour), torch.from_numpy(kind)


# rows or columns that straddle the 32-bit words of the row-major and
# column-major cell masks: a row or column of 32 cells, the most the
# kernels' one-window bit helpers take (6x32, 32x6), and of 33 or more, on
# the helpers that loop over the words; the repo's configs' shapes (10x10,
# 20x20)
EDGE_SHAPES = [(5, 33, 4), (34, 6, 4), (3, 40, 4), (40, 3, 4), (6, 32, 4), (32, 6, 4),
               (9, 7, 4), (10, 10, 4), (20, 20, 6)]


@pytest.mark.parametrize("R,C,K", EDGE_SHAPES)
def test_painted_edges_match_plain(host_k1, host_libs, R, C, K):
    """Runs touching column 0, column C-1, row 0 and row R-1: K1, K2 with
    and without the bomb (lasers and bombs in the painted runs) and K3."""
    B = 48
    k2, k3 = host_libs
    colour, _ = painted_edges(R, C, B, seed=R * C)
    keys = torch.arange(2 * B, dtype=torch.int64).reshape(B, 2)
    cfg1 = EnvConfig.create(R, C, K, 30, colourless_specials=(), colour_specials=())
    for name, g, w in zip(K1_NAMES, _k1_run(host_k1, cfg1, colour, keys),
                          cascade_reference(cfg1, colour, keys)):
        assert torch.equal(g, w), ("K1", name)
    colour, kind = painted_edges(R, C, B, seed=R * C + 1, specials=True)
    z = torch.zeros(B, dtype=torch.int32)
    for specials in (ALL, LASERS):
        cfg = EnvConfig.create(R, C, K, 30, colourless_specials=specials[0],
                               colour_specials=specials[1])
        inputs = (colour, kind, keys, z, z, z)
        got = _k2_run(k2, cfg, inputs, 64)
        want = cascade_sp_reference(cfg, *inputs, limit=64)
        for name, g, w in zip(NAMES, got, want):
            assert torch.equal(g, w), (specials, name)
        assert int(want[5].sum()) > 0  # specials activated
        mask = torch.empty(B, cfg.num_actions, dtype=torch.bool)
        assert k3(got[0].data_ptr(), got[1].data_ptr(), mask.data_ptr(), B, R, C, 1) == 0
        assert torch.equal(mask, effective_mask_settled(cfg, got[0], got[1]))


# the card builds the cascades once for each board shape of at most 32 by
# 32, with the geometry fixed at compile time; these hold those libraries
# at a config's shape, at rows and columns of 32 cells (the most one 32-bit
# window of a mask takes) and at an odd shape
@pytest.mark.parametrize("R,C", [(10, 10), (6, 32), (32, 6), (9, 7)])
def test_fixed_geometry_matches_plain(tmp_path_factory, R, C):
    """K1 (random boards, one-colour boards whose rows and columns are each
    one run, painted runs of up to 32 cells on the edges) and K2 with and
    without the bomb (sprinkled and painted boards) built for one board
    shape; another shape is refused."""
    k1 = _k1_fn(_host_build(tmp_path_factory, "cascade", (R, C)))
    k2 = _k2_fn(_host_build(tmp_path_factory, "cascade_sp", (R, C)))
    B = 32
    for K, colour, keys, max_cascades in (
        (4, *_k1_inputs(R, C, 4, B, seed=R * C), 64),
        (1, *_k1_inputs(R, C, 1, 4, seed=1), 3),
        (4, painted_edges(R, C, B, seed=R + C, longest=32)[0],
         torch.arange(2 * B, dtype=torch.int64).reshape(B, 2), 64),
    ):
        cfg = EnvConfig.create(R, C, K, 30, colourless_specials=(), colour_specials=(),
                               max_cascades=max_cascades)
        for name, g, w in zip(K1_NAMES, _k1_run(k1, cfg, colour, keys),
                              cascade_reference(cfg, colour, keys)):
            assert torch.equal(g, w), ("K1", K, name)
    painted, kind = painted_edges(R, C, B, seed=R * C + 2, specials=True, longest=32)
    z = torch.zeros(B, dtype=torch.int32)
    for specials in (ALL, NO_BOMB):
        cfg = EnvConfig.create(R, C, 4, 30, colourless_specials=specials[0],
                               colour_specials=specials[1])
        for inputs in (_inputs(cfg, B, seed=R * C + len(specials[1])),
                       (painted, kind, torch.arange(2 * B, dtype=torch.int64).reshape(B, 2),
                        z, z, z)):
            got = _k2_run(k2, cfg, inputs, 64)
            for name, g, w in zip(NAMES, got, cascade_sp_reference(cfg, *inputs, limit=64)):
                assert torch.equal(g, w), (specials, name)
    other = torch.ones(1, R + 1, C, dtype=torch.int32)
    out = [torch.empty_like(other), *(torch.empty(1, dtype=t) for t in (torch.int32, torch.int32,
                                                                       torch.bool)),
           torch.empty(1, 2 * (R + 1) * C, dtype=torch.bool)]
    keys = torch.zeros(1, 2, dtype=torch.int64)
    assert k1(other.data_ptr(), keys.data_ptr(), *(t.data_ptr() for t in out),
              1, R + 1, C, 4, 64) == -1


# ---- K3, the settled mask, on cell bit masks --------------------------------


def _k3_run(k3, cfg, colour, kind):
    B, R, C = colour.shape
    mask = torch.empty(B, cfg.num_actions, dtype=torch.bool)
    assert k3(colour.data_ptr(), kind.data_ptr(), mask.data_ptr(), B, R, C,
              int(cfg.any_special)) == 0
    return mask


def _k3_cfg(R, C, K, any_special):
    if any_special:
        return EnvConfig.create(R, C, K, 30)
    return EnvConfig.create(R, C, K, 30, colourless_specials=(), colour_specials=())


@pytest.fixture(scope="module")
def host_k3(tmp_path_factory):
    """K3's host build, per board shape as the card builds it: the library
    of that shape at most 32 by 32, else the one of any shape."""
    libs = {}

    def get(shape):
        if shape not in libs:
            libs[shape] = _k3_fn(_host_build(tmp_path_factory, "mask_sp", shape))
        return libs[shape]

    return get


def random_mask_boards(R, C, K, B, seed):
    """Boards of colours 0..K with every kind: mostly normal (1), some
    empty (0), lasers and bombs (2-4) and cookies (-1), wherever they
    fall; runs included."""
    rng = np.random.default_rng(seed)
    colour = rng.integers(0, K + 1, size=(B, R, C)).astype(np.int32)
    kind = rng.choice(np.array([1] * 12 + [0, 2, 3, 4, -1, -1], np.int32), size=(B, R, C))
    return torch.from_numpy(colour), torch.from_numpy(kind)


@pytest.mark.parametrize("any_special", [True, False], ids=["specials", "no-specials"])
@pytest.mark.parametrize("library", ["fixed", "any"])
@pytest.mark.parametrize("R,C,K", [(5, 5, 3), (8, 8, 4), (10, 10, 4), (20, 20, 6), (32, 32, 5),
                                   (36, 36, 6)])
def test_settled_mask_board_program_matches_plain(host_k3, R, C, K, library, any_special):
    """K3 on random boards with every kind, built for the board's shape (the
    card's library for boards up to 32 by 32; 36x36 has none, and takes the
    one of any shape either way) and for any shape."""
    shape = cuda_build.shape_of(R, C) if library == "fixed" else None
    cfg = _k3_cfg(R, C, K, any_special)
    colour, kind = random_mask_boards(R, C, K, 45, seed=R * C + K)  # not a multiple of 4
    want = effective_mask_settled(cfg, colour, kind)
    assert torch.equal(_k3_run(host_k3(shape), cfg, colour, kind), want)
    assert 0 < int(want.sum()) < want.numel()


def _stencils(R, C, a):
    """The 8 stencils of action a: (run cells, the swapped cell whose
    colour moves in, the cell whose kind guards the stencil), 2-D, in the
    plain version's order, those with a cell off the board left out."""
    n_down = C * (R - 1)
    if a < n_down:
        r, c = divmod(a, C)
        P, Q = (r, c), (r + 1, c)
        out = [([(r, c - 2), (r, c - 1)], Q, Q), ([(r, c - 1), (r, c + 1)], Q, (r, c + 1)),
               ([(r, c + 1), (r, c + 2)], Q, (r, c + 2)), ([(r - 2, c), (r - 1, c)], Q, Q),
               ([(r + 1, c - 2), (r + 1, c - 1)], P, P),
               ([(r + 1, c - 1), (r + 1, c + 1)], P, (r + 1, c + 1)),
               ([(r + 1, c + 1), (r + 1, c + 2)], P, (r + 1, c + 2)),
               ([(r + 2, c), (r + 3, c)], P, (r + 3, c))]
    else:
        r, c = divmod(a - n_down, C - 1)
        P, Q = (r, c), (r, c + 1)
        out = [([(r - 2, c), (r - 1, c)], Q, Q), ([(r - 1, c), (r + 1, c)], Q, (r + 1, c)),
               ([(r + 1, c), (r + 2, c)], Q, (r + 2, c)), ([(r, c - 2), (r, c - 1)], Q, Q),
               ([(r - 2, c + 1), (r - 1, c + 1)], P, P),
               ([(r - 1, c + 1), (r + 1, c + 1)], P, (r + 1, c + 1)),
               ([(r + 1, c + 1), (r + 2, c + 1)], P, (r + 2, c + 1)),
               ([(r, c + 2), (r, c + 3)], P, (r, c + 3))]
    return [(cells, src, guard) for cells, src, guard in out
            if all(0 <= y < R and 0 <= x < C for y, x in cells)], P, Q


def painted_stencils(R, C, B, seed, variant):
    """Line-free two-colour boards (colours 1 and 2) with one to three
    stencils painted true: an action's run cells take the colour (3, or 0
    with ``variant`` "colour0") of the swapped cell that moves in.  Then by
    ``variant``: "cookie" makes each stencil's guard cell a cookie (kind -1,
    its colour kept), so that the stencil fails; "special-pair" makes both
    swapped cells specials (2-4) and a random third of the guard cells
    cookies; "colour0" paints with colour 0 (colour-0 cells match each
    other) and leaves the kinds normal.  Actions near the edges come up as
    often as any other."""
    rng = np.random.default_rng(seed)
    rows, cols = np.indices((R, C))
    colour = np.where((rows + cols) % 2 == 0, 1, 2)[None].repeat(B, 0).astype(np.int32)
    kind = np.ones_like(colour)
    n_actions = 2 * R * C - R - C
    for b in range(B):
        for _ in range(int(rng.integers(1, 4))):
            stencils, P, Q = _stencils(R, C, int(rng.integers(0, n_actions)))
            if not stencils:
                continue
            cells, src, guard = stencils[int(rng.integers(0, len(stencils)))]
            pc = 0 if variant == "colour0" else 3
            for y, x in (*cells, src):
                colour[b, y, x] = pc
            if variant == "cookie" or (variant == "special-pair" and rng.random() < 1 / 3):
                kind[b, guard[0], guard[1]] = -1
            if variant == "special-pair":
                for y, x in (P, Q):
                    kind[b, y, x] = int(rng.integers(2, 5))
    return torch.from_numpy(colour), torch.from_numpy(kind)


@pytest.mark.parametrize("variant", ["cookie", "special-pair", "colour0"])
@pytest.mark.parametrize("R,C", [(5, 5), (10, 10), (6, 32), (32, 6), (5, 33), (34, 6), (9, 7),
                                 (36, 36)])
def test_settled_mask_painted_stencils_match_plain(host_k3, R, C, variant):
    """Every stencil's last cell as a cookie, special pairs and colour-0
    runs, on rows and columns up to and across the 32-bit words, with and
    without specials, on the library of the shape and of any shape."""
    colour, kind = painted_stencils(R, C, 64, seed=R * C + len(variant), variant=variant)
    normal = torch.ones_like(kind)
    for any_special in (True, False):
        cfg = _k3_cfg(R, C, 4, any_special)
        want = effective_mask_settled(cfg, colour, kind)
        for shape in {cuda_build.shape_of(R, C), None}:
            assert torch.equal(_k3_run(host_k3(shape), cfg, colour, kind), want), (shape, any_special)
        if variant == "cookie" and not any_special:  # the guards turned painted stencils off
            assert int(want.sum()) < int(effective_mask_settled(cfg, colour, normal).sum())
        elif variant == "colour0":
            assert int(want.sum()) > 0


@pytest.mark.parametrize("R,C,K", EDGE_SHAPES)
def test_settled_mask_painted_edges_match_plain(host_k3, R, C, K):
    """K3 on painted runs of up to 32 cells touching the rows' and columns'
    ends, with lasers and bombs in them, with and without specials, on the
    library of the shape."""
    colour, kind = painted_edges(R, C, 48, seed=R * C + 3, specials=True, longest=32)
    for any_special in (True, False):
        cfg = _k3_cfg(R, C, K, any_special)
        got = _k3_run(host_k3(cuda_build.shape_of(R, C)), cfg, colour, kind)
        assert torch.equal(got, effective_mask_settled(cfg, colour, kind)), any_special


def test_settled_mask_one_board_and_refused_shape(host_k3):
    """One board (the Gym adapter's batch) and thin boards of one row or
    one column; a library of one shape refuses another."""
    for R, C in ((10, 10), (1, 8), (8, 1), (2, 2)):
        cfg = _k3_cfg(R, C, 3, True)
        colour, kind = random_mask_boards(R, C, 3, 1 if (R, C) == (10, 10) else 16, seed=R + C)
        for shape in {cuda_build.shape_of(R, C), None}:
            assert torch.equal(_k3_run(host_k3(shape), cfg, colour, kind),
                               effective_mask_settled(cfg, colour, kind))
    other = torch.ones(1, 11, 10, dtype=torch.int32)
    mask = torch.empty(1, 2 * 110 - 21, dtype=torch.bool)
    assert host_k3((10, 10))(other.data_ptr(), other.data_ptr(), mask.data_ptr(), 1, 11, 10, 1) == -1


H100_SMEM_OPTIN = 232448  # shared memory one block may opt in to on an H100, in bytes


def test_settled_mask_size_check_takes_one_board(tmp_path_factory):
    """The wrapper's size check holds one board's shared memory against the
    block's limit (a block takes fewer boards where several overflow it):
    on an H100 every board up to 150x150 runs, beyond K1's and K2's limits."""
    lib = _host_build(tmp_path_factory, "mask_sp")
    lib.tmt_settled_mask_sp_smem.restype = ctypes.c_longlong

    def optin():
        return H100_SMEM_OPTIN

    card = types.SimpleNamespace(tmt_settled_mask_sp_smem=lib.tmt_settled_mask_sp_smem,
                                 tmt_smem_optin=optin)
    for R, C in ((10, 10), (36, 36), (75, 75), (80, 80), (100, 100), (150, 150)):
        cuda_build.check_fits(card, "settled_mask_sp", R, C, "settled_mask_sp")
    assert lib.tmt_settled_mask_sp_smem(10, 10) < 2048
    with pytest.raises(ValueError, match="shared memory"):
        cuda_build.check_fits(card, "settled_mask_sp", 160, 160, "settled_mask_sp")


# ---- csrc/threefry_words.cu: random.py's words, one launch a call ----------

_TF_HOST = {
    "tmt_threefry_words": [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_longlong, ctypes.c_longlong,
                           ctypes.c_uint, ctypes.c_int, ctypes.c_void_p],
    "tmt_threefry_uniform": [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_longlong, ctypes.c_longlong,
                             ctypes.c_uint, ctypes.c_float, ctypes.c_double, ctypes.c_double,
                             ctypes.c_void_p],
    "tmt_threefry_fold_in": [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p, ctypes.c_longlong,
                             ctypes.c_int, ctypes.c_uint, ctypes.c_longlong, ctypes.c_void_p],
    "tmt_threefry_randint": [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_longlong, ctypes.c_longlong,
                             ctypes.c_uint, ctypes.c_longlong, ctypes.c_void_p],
}


@pytest.fixture(scope="module", params=[None, (10, 10)], ids=["any-shape", "10x10"])
def host_threefry(request, tmp_path_factory):
    """``csrc/threefry_words.cu`` built for the host, with no board shape
    and with the one ``tmt_bench`` builds every source under."""
    lib = _host_build(tmp_path_factory, "threefry_words", request.param)
    fns = {}
    for name, args in _TF_HOST.items():
        fn = getattr(lib, f"{name}_host")
        fn.argtypes = args
        fn.restype = ctypes.c_int
        fns[name] = fn
    return fns


def _tf_keys(M, seed):
    """M keys int64[M, 2], the extreme words among them."""
    keys = np.random.default_rng(seed).integers(0, 1 << 32, size=(M, 2), dtype=np.uint64)
    keys[:3] = [[0, 0], [0xFFFFFFFF, 0xFFFFFFFF], [0, 0xFFFFFFFF]][:M]
    return torch.from_numpy(keys.astype(np.int64))


# (function, keys, arguments): keys "M" are M random keys, "strided" the
# second halves of a split (a stride of 4 words), "one" a single key int64[2],
# "broadcast" one key expanded over 300 rows (a stride of 0)
_TF_CASES = (
    [("split", "M=5", (num, off)) for num in (2, 3, 256) for off in (0, 7, (1 << 32) - num)]
    + [("split", "strided", (2, 0)), ("split", "broadcast", (3, 11)), ("split", "one", (2, 0))]
    + [("fold_in", "M=7", (0,)), ("fold_in", "M=7", ((1 << 32) - 1,)), ("fold_in", "M=7", (-1,)),
       ("fold_in", "M=300", ("int32",)), ("fold_in", "M=300", ("int64",)),
       ("fold_in", "broadcast", ("int64",)), ("fold_in", "M=7", ("scalar-tensor",))]
    + [("random_bits", "one", ((1,), 0)), ("random_bits", "one", ((100,), 7)),
       ("random_bits", "one", ((64, 180), 64 * 180 * 3)), ("random_bits", "M=300", ((100,), 0)),
       ("random_bits", "strided", ((10, 10), (1 << 32) - 100))]
    + [("randint", "M=300", ((10, 10), lo, lo + k)) for k in (1, 4, 5, 7, 1 << 31) for lo in (0, 1)]
    + [("randint", "strided", ((7,), 3, 2)), ("randint", "one", ((1000,), -5, 10**6))]
    + [("uniform", "one", ((64, 180), 0.0, 1.0, 0)),
       ("uniform", "one", ((64, 180), float(np.finfo(np.float32).tiny), 1.0, 180)),
       ("uniform", "M=300", ((13,), -2.5, 3.0, 0))]
)


def _tf_key_arg(kind, seed):
    if kind == "one":
        return _tf_keys(3, seed)[1]
    if kind == "strided":
        return trandom.split(_tf_keys(300, seed))[:, 1]
    if kind == "broadcast":
        return _tf_keys(3, seed)[2].expand(300, 2)
    return _tf_keys(int(kind[2:]), seed)


def _tf_call(fn, keys, args, seed):
    """``random.<fn>(keys, *args)``, a fold_in's data made from its tag."""
    if fn != "fold_in":
        return getattr(trandom, fn)(keys, *args)
    (data,) = args
    lead = keys.shape[:-1]
    rng = np.random.default_rng(seed + 1)
    if data in ("int32", "int64"):
        lo = -(1 << 31) if data == "int32" else -(1 << 40)
        vals = rng.integers(lo, -lo, size=lead)
        vals.flat[:2] = [0, -1 if data == "int32" else (1 << 32) - 1]
        data = torch.from_numpy(vals.astype(np.int32 if data == "int32" else np.int64))
    elif data == "scalar-tensor":
        data = torch.tensor(123456789, dtype=torch.int64)
    return trandom.fold_in(keys, data)


@pytest.mark.parametrize("fn,keys,args", _TF_CASES, ids=[f"{f}-{k}-{i}" for i, (f, k, _) in enumerate(_TF_CASES)])
def test_threefry_words_match_plain(host_threefry, monkeypatch, fn, keys, args):
    """Each entry point, through ``random.py``'s own wrapper (its key
    strides, broadcasts and dtypes), equals the plain int64 version word for
    word: the wrapper's launch runs the host build instead of the card."""
    seed = len(str(args)) + 17
    k = _tf_key_arg(keys, seed)
    want = _tf_call(fn, k, args, seed)
    calls = []

    def host_launch(name, device, words, *cargs):
        calls.append((name, words))
        assert host_threefry[name](*cargs) == 0

    monkeypatch.setattr(trandom, "_on_card", lambda keys: True)
    monkeypatch.setattr(trandom, "_launch", host_launch)
    got = _tf_call(fn, k, args, seed)
    assert got.dtype == want.dtype and got.shape == want.shape
    assert torch.equal(got, want)
    assert len(calls) == 1  # one launch a call


# ---- the line test, run-member mask and has-any-line ------------------------


@pytest.fixture(scope="module")
def host_line_test(tmp_path_factory):
    """The line test's host build, (member, any): one library for every
    board shape, as the card builds it."""
    lib = _host_build(tmp_path_factory, "line_test")
    fns = []
    for what in ("member", "any"):
        fn = getattr(lib, f"tmt_line_test_{what}_host")
        fn.argtypes = [ctypes.c_void_p] * 2 + [ctypes.c_int] * 3
        fn.restype = ctypes.c_int
        fns.append(fn)
    return fns


@pytest.mark.parametrize("R,C,K,kind", LINE_CASES, ids=line_case_ids(LINE_CASES))
def test_line_test_board_program_matches_plain(host_line_test, R, C, K, kind):
    """The line test's board program (one thread a cell) equals
    ``run_member_mask`` and ``has_any_line`` on random boards, boards of
    which some are line-free, boards whose runs touch the edges, and boards
    with zero-colour cells; a shape with no cells is refused."""
    B = 61
    colour = line_boards(kind, R, C, K, B, seed=R * C + K + LINE_KINDS.index(kind))
    want_member, want_any = plain_line_test(colour)
    assert int(want_any.sum()) > 0 and (kind != "sparse" or R * C > 100 or int(want_any.sum()) < B)
    member_fn, any_fn = host_line_test
    member = torch.empty(B, R, C, dtype=torch.bool)
    any_ = torch.empty(B, dtype=torch.bool)
    assert member_fn(colour.data_ptr(), member.data_ptr(), B, R, C) == 0
    assert any_fn(colour.data_ptr(), any_.data_ptr(), B, R, C) == 0
    assert torch.equal(member, want_member)
    assert torch.equal(any_, want_any)
    assert any_fn(colour.data_ptr(), any_.data_ptr(), 1, R, 0) == -1
