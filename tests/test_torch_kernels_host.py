"""The CUDA kernels' board programs, built for the host, equal the plain
PyTorch versions exactly.

``csrc/cascade.cu``, ``csrc/cascade_sp.cu`` and ``csrc/mask_sp.cu`` write
each kernel as a sequence of per-cell phases on the executors of
``csrc/block.cuh``; compiled as plain C++ with ``-DTMT_HOST_BUILD`` the
same phases run as loops over the cells of one board after another, with
the bit helpers on the compiler's builtins.  The wrappers themselves run
them, through the host seam (``tests/torch_port_helpers.py``): their
checks, allocations and argument marshalling, then each entry point's
``_host`` twin in place of the launch.  This holds the kernels' arithmetic
against ``cascade_reference``, ``cascade_sp_reference`` and
``effective_mask_settled`` without a card, at boards above 1024 cells and
on painted boards whose runs touch the edges of rows and columns that
straddle the 32-bit words of the cell masks, and the table of entry
points (``cuda_build.KERNELS``) against the sources;
``test_torch_kernels_cuda.py`` holds the kernels themselves on the card.
Needs ``g++``; skips without it.

    JAX_PLATFORMS=cpu python -m pytest tests/test_torch_kernels_host.py -q
"""

import ctypes
import re

import numpy as np
import pytest
import torch

from chip_smoke import corner_boards
from tests.test_torch_kernels_cuda import (LINE_CASES, LINE_KINDS, line_boards, line_case_ids,
                                           plain_line_test)
from tests.test_torch_specials import sprinkled
from tests.torch_port_helpers import host_build, host_kernels  # noqa: F401  (a fixture)
from tile_match_tpu_torch import bench, cuda_build
from tile_match_tpu_torch import random as trandom
from tile_match_tpu_torch.config import EnvConfig
from tile_match_tpu_torch.cuda_build import CSRC
from tile_match_tpu_torch.ops.cascade import cascade_reference, fused_cascade
from tile_match_tpu_torch.ops.cascade_sp import cascade_sp_chunk, cascade_sp_reference
from tile_match_tpu_torch.ops.effective import effective_mask_settled
from tile_match_tpu_torch.ops.lines import has_any_line, run_member_mask
from tile_match_tpu_torch.ops.mask_sp import settled_mask_sp

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
def test_cascade_sp_board_program_matches_plain(host_kernels, R, C, K, specials, B, limit):
    host_kernels("cascade_sp_chunk", "settled_mask_sp", shape=None)
    cfg = EnvConfig.create(R, C, K, 30, colourless_specials=specials[0], colour_specials=specials[1])
    inputs = _inputs(cfg, B, seed=R * C + limit)
    frozen = inputs[5]
    before = dict(cuda_build.launches)
    got = cascade_sp_chunk(cfg, *inputs, limit)
    want = cascade_sp_reference(cfg, *inputs, limit=limit)
    for name, g, w in zip(NAMES, got, want):
        assert torch.equal(g, w), name
    assert int(want[6].sum()) > int(frozen.sum())  # some boards froze here

    mask = settled_mask_sp(cfg, got[0], got[1])
    assert torch.equal(mask, effective_mask_settled(cfg, got[0], got[1]))
    assert {n: c - before[n] for n, c in cuda_build.launches.items() if c != before[n]} == {
        "cascade_sp_chunk": 1, "settled_mask_sp": 1}


def test_cascade_sp_no_bomb_corners_match_plain(host_kernels):
    """Two cookie lines crossing in both tails: the corner survives."""
    host_kernels("cascade_sp_chunk", shape=None)
    cfg = EnvConfig.create(8, 8, 4, 30, colourless_specials=NO_BOMB[0], colour_specials=NO_BOMB[1])
    colour, kind = (torch.from_numpy(a) for a in corner_boards(64, seed=1))
    keys = torch.arange(128, dtype=torch.int64).reshape(64, 2)
    z = torch.zeros(64, dtype=torch.int32)
    inputs = (colour, kind, keys, z, z, z)
    got = cascade_sp_chunk(cfg, *inputs, 1)
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


def _k1_inputs(R, C, K, B, seed):
    rng = np.random.default_rng(seed)
    colour = torch.from_numpy(rng.integers(1, K + 1, size=(B, R, C)).astype(np.int32))
    keys = torch.from_numpy(rng.integers(0, 1 << 32, size=(B, 2), dtype=np.uint64).astype(np.int64))
    return colour, keys


@pytest.mark.parametrize("R,C,K,B,max_cascades",
                         [(5, 5, 3, 64, 64), (10, 10, 4, 64, 64), (20, 20, 6, 32, 64),
                          (7, 9, 4, 64, 2), (1, 8, 3, 16, 64), (8, 1, 3, 16, 64),
                          (36, 36, 6, 8, 64), (6, 32, 1, 4, 3), (32, 6, 1, 4, 3)])
def test_cascade_board_program_matches_plain(host_kernels, R, C, K, B, max_cascades):
    """K1's board program, 36x36 (1,296 cells) above the old one-thread-per-cell cap;
    with one colour, every row and column one run of 32 cells at 6x32 and 32x6."""
    host_kernels("fused_cascade", shape=None)
    cfg = EnvConfig.create(R, C, K, 30, colourless_specials=(), colour_specials=(),
                           max_cascades=max_cascades)
    colour, keys = _k1_inputs(R, C, K, B, seed=R * C + B)
    before = cuda_build.launches["fused_cascade"]
    got = fused_cascade(cfg, colour, keys)
    assert cuda_build.launches["fused_cascade"] == before + 1
    want = cascade_reference(cfg, colour, keys)
    for name, g, w in zip(K1_NAMES, got, want):
        assert torch.equal(g, w), name


def test_cascade_sp_board_program_above_old_cap(host_kernels):
    """K2 with and without the bomb and K3 at 36x36x6 (1,296 cells)."""
    host_kernels("cascade_sp_chunk", "settled_mask_sp", shape=None)
    for specials, limit in ((ALL, 64), (NO_BOMB, 64)):
        cfg = EnvConfig.create(36, 36, 6, 30, colourless_specials=specials[0],
                               colour_specials=specials[1])
        inputs = _inputs(cfg, 8, seed=36 + len(specials[1]))
        got = cascade_sp_chunk(cfg, *inputs, limit)
        want = cascade_sp_reference(cfg, *inputs, limit=limit)
        for name, g, w in zip(NAMES, got, want):
            assert torch.equal(g, w), (specials, name)
        mask = settled_mask_sp(cfg, got[0], got[1])
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
def test_painted_edges_match_plain(host_kernels, R, C, K):
    """Runs touching column 0, column C-1, row 0 and row R-1: K1, K2 with
    and without the bomb (lasers and bombs in the painted runs) and K3."""
    B = 48
    host_kernels("fused_cascade", "cascade_sp_chunk", "settled_mask_sp", shape=None)
    colour, _ = painted_edges(R, C, B, seed=R * C)
    keys = torch.arange(2 * B, dtype=torch.int64).reshape(B, 2)
    cfg1 = EnvConfig.create(R, C, K, 30, colourless_specials=(), colour_specials=())
    for name, g, w in zip(K1_NAMES, fused_cascade(cfg1, colour, keys),
                          cascade_reference(cfg1, colour, keys)):
        assert torch.equal(g, w), ("K1", name)
    colour, kind = painted_edges(R, C, B, seed=R * C + 1, specials=True)
    z = torch.zeros(B, dtype=torch.int32)
    for specials in (ALL, LASERS):
        cfg = EnvConfig.create(R, C, K, 30, colourless_specials=specials[0],
                               colour_specials=specials[1])
        inputs = (colour, kind, keys, z, z, z)
        got = cascade_sp_chunk(cfg, *inputs, 64)
        want = cascade_sp_reference(cfg, *inputs, limit=64)
        for name, g, w in zip(NAMES, got, want):
            assert torch.equal(g, w), (specials, name)
        assert int(want[5].sum()) > 0  # specials activated
        mask = settled_mask_sp(cfg, got[0], got[1])
        assert torch.equal(mask, effective_mask_settled(cfg, got[0], got[1]))


# the card builds the cascades once for each board shape of at most 32 by
# 32, with the geometry fixed at compile time; these hold those libraries
# at a config's shape, at rows and columns of 32 cells (the most one 32-bit
# window of a mask takes) and at an odd shape
@pytest.mark.parametrize("R,C", [(10, 10), (6, 32), (32, 6), (9, 7)])
def test_fixed_geometry_matches_plain(host_kernels, R, C):
    """K1 (random boards, one-colour boards whose rows and columns are each
    one run, painted runs of up to 32 cells on the edges) and K2 with and
    without the bomb (sprinkled and painted boards) built for one board
    shape; another shape is refused."""
    host_kernels("fused_cascade", "cascade_sp_chunk", shape=(R, C))
    B = 32
    for K, colour, keys, max_cascades in (
        (4, *_k1_inputs(R, C, 4, B, seed=R * C), 64),
        (1, *_k1_inputs(R, C, 1, 4, seed=1), 3),
        (4, painted_edges(R, C, B, seed=R + C, longest=32)[0],
         torch.arange(2 * B, dtype=torch.int64).reshape(B, 2), 64),
    ):
        cfg = EnvConfig.create(R, C, K, 30, colourless_specials=(), colour_specials=(),
                               max_cascades=max_cascades)
        for name, g, w in zip(K1_NAMES, fused_cascade(cfg, colour, keys),
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
            got = cascade_sp_chunk(cfg, *inputs, 64)
            for name, g, w in zip(NAMES, got, cascade_sp_reference(cfg, *inputs, limit=64)):
                assert torch.equal(g, w), (specials, name)
    other = EnvConfig.create(R + 1, C, 4, 30, colourless_specials=(), colour_specials=())
    with pytest.raises(RuntimeError, match="tmt_fused_cascade: launch failed with error -1"):
        fused_cascade(other, torch.ones(1, R + 1, C, dtype=torch.int32),
                      torch.zeros(1, 2, dtype=torch.int64))


# ---- K3, the settled mask, on cell bit masks --------------------------------


def _k3_cfg(R, C, K, any_special):
    if any_special:
        return EnvConfig.create(R, C, K, 30)
    return EnvConfig.create(R, C, K, 30, colourless_specials=(), colour_specials=())


@pytest.fixture
def host_k3(host_kernels):
    """K3's wrapper on the host build of board shape ``shape`` (None: of any
    shape): ``host_k3(shape)(cfg, colour, kind)``."""

    def on(shape):
        host_kernels("settled_mask_sp", shape=shape)
        return settled_mask_sp

    return on


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
    assert torch.equal(host_k3(shape)(cfg, colour, kind), want)
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
            assert torch.equal(host_k3(shape)(cfg, colour, kind), want), (shape, any_special)
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
        got = host_k3(cuda_build.shape_of(R, C))(cfg, colour, kind)
        assert torch.equal(got, effective_mask_settled(cfg, colour, kind)), any_special


def test_settled_mask_one_board_and_refused_shape(host_k3):
    """One board (the Gym adapter's batch) and thin boards of one row or
    one column; a library of one shape refuses another."""
    for R, C in ((10, 10), (1, 8), (8, 1), (2, 2)):
        cfg = _k3_cfg(R, C, 3, True)
        colour, kind = random_mask_boards(R, C, 3, 1 if (R, C) == (10, 10) else 16, seed=R + C)
        for shape in {cuda_build.shape_of(R, C), None}:
            assert torch.equal(host_k3(shape)(cfg, colour, kind),
                               effective_mask_settled(cfg, colour, kind))
    other = torch.ones(1, 11, 10, dtype=torch.int32)
    with pytest.raises(RuntimeError, match="tmt_settled_mask_sp: launch failed with error -1"):
        host_k3((10, 10))(_k3_cfg(11, 10, 3, True), other, other)


H100_SMEM_OPTIN = 232448  # shared memory one block may opt in to on an H100, in bytes


def test_settled_mask_size_check_takes_one_board(tmp_path_factory):
    """The wrapper's size check holds one board's shared memory (the fit
    function the table names) against the block's limit (a block takes
    fewer boards where several overflow it): on an H100 every board up to
    150x150 runs, beyond K1's and K2's limits."""
    lib = host_build(tmp_path_factory, "mask_sp")
    smem = cuda_build.c_function(lib, cuda_build.KERNELS["settled_mask_sp"].smem,
                                 [ctypes.c_int] * 2, ctypes.c_longlong)
    for R, C in ((10, 10), (36, 36), (75, 75), (80, 80), (100, 100), (150, 150)):
        cuda_build.check_fits("settled_mask_sp", R, C, smem(R, C), H100_SMEM_OPTIN)
    assert smem(10, 10) < 2048
    with pytest.raises(ValueError, match="shared memory"):
        cuda_build.check_fits("settled_mask_sp", 160, 160, smem(160, 160), H100_SMEM_OPTIN)


# ---- csrc/threefry_words.cu: random.py's words, one launch a call ----------

@pytest.fixture(scope="module", params=[None, (10, 10)], ids=["any-shape", "10x10"])
def host_threefry(request):
    """The board shape ``csrc/threefry_words.cu`` is built for on the host:
    none, and the one ``tmt_bench`` builds every source under."""
    return request.param


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
def test_threefry_words_match_plain(host_threefry, host_kernels, fn, keys, args):
    """Each entry point, through ``random.py``'s own wrapper (its key
    strides, broadcasts and dtypes), equals the plain int64 version word for
    word: the wrapper's launch runs the host build instead of the card."""
    seed = len(str(args)) + 17
    k = _tf_key_arg(keys, seed)
    want = _tf_call(fn, k, args, seed)
    host_kernels("threefry_words", shape=host_threefry)
    before = cuda_build.launches["threefry_words"]
    got = _tf_call(fn, k, args, seed)
    assert got.dtype == want.dtype and got.shape == want.shape
    assert torch.equal(got, want)
    assert cuda_build.launches["threefry_words"] == before + 1  # one launch a call


# ---- the line test, run-member mask and has-any-line ------------------------


@pytest.mark.parametrize("R,C,K,kind", LINE_CASES, ids=line_case_ids(LINE_CASES))
def test_line_test_board_program_matches_plain(host_kernels, R, C, K, kind):
    """The line test's board program (one thread a cell), through
    ``run_member_mask`` and ``has_any_line`` themselves, equals the plain
    version on random boards, boards of which some are line-free, boards
    whose runs touch the edges, and boards with zero-colour cells; a shape
    with no cells is refused."""
    B = 61
    colour = line_boards(kind, R, C, K, B, seed=R * C + K + LINE_KINDS.index(kind))
    want_member, want_any = plain_line_test(colour)
    assert int(want_any.sum()) > 0 and (kind != "sparse" or R * C > 100 or int(want_any.sum()) < B)
    host_kernels("line_test")
    before = cuda_build.launches["line_test"]
    member, any_ = run_member_mask(None, colour), has_any_line(None, colour)
    assert cuda_build.launches["line_test"] == before + 2
    assert torch.equal(member, want_member)
    assert torch.equal(any_, want_any)
    with pytest.raises(RuntimeError, match="tmt_line_test_any: launch failed with error -1"):
        cuda_build.launch("tmt_line_test_any", colour.device, None, colour.data_ptr(),
                          any_.data_ptr(), 1, R, 0)


# ---- the table of entry points against the sources ---------------------------

_C_FUNCTION = re.compile(r'extern\s+"C"\s+[\w ]+?\s+(tmt_\w+)\s*\(([^)]*)\)\s*\{')
_ENTRY_MACRO = re.compile(r"TMT_ENTRY\((tmt_\w+),([^)]*)\)\s*\{")  # csrc/threefry_words.cu
_CTYPES = {"int": ctypes.c_int, "long long": ctypes.c_longlong, "unsigned": ctypes.c_uint,
           "float": ctypes.c_float, "double": ctypes.c_double}


def _params(text: str) -> list:
    """[(type, name)] of a C parameter list, pointers written ``T*``."""
    out = []
    for p in text.split(","):
        p = " ".join(p.replace("*", " * ").split())
        kind, name = p.rsplit(" ", 1)
        out.append((kind.replace(" *", "*"), name))
    return out


def _definitions() -> list:
    """(source, name, parameters) of every C function ``csrc/*.cu`` defines,
    in either build: its ``extern "C"`` functions, and for each
    ``TMT_ENTRY`` the card's entry point (the stream last) and its host
    twin."""
    out = []
    for path in sorted(CSRC.glob("*.cu")):
        text = path.read_text()
        out += [(path.stem, name, _params(p)) for name, p in _C_FUNCTION.findall(text)]
        for name, p in _ENTRY_MACRO.findall(text):
            out += [(path.stem, name, _params(p) + [("void*", "stream")]),
                    (path.stem, f"{name}_host", _params(p))]
    return out


def test_entry_table_matches_the_sources():
    """Every card entry point (a C function whose last parameter is the
    stream) has exactly one entry in ``cuda_build.KERNELS``, under its
    kernel's source, with the ctypes of its parameters but the stream; the
    host twin the seam drives takes the same parameters but the stream;
    each fit function the table names is defined by its source; and the
    table's kernels are the keys of the launch counts and hold every
    kernel a bench config requires."""
    defs = _definitions()
    card = {}
    for source, name, params in defs:
        if params[-1] == ("void*", "stream"):
            assert name not in card, f"{name} is defined twice"
            card[name] = (source, params[:-1])
    assert sorted(card) == sorted(cuda_build.ENTRIES)
    twins = {name: params for _, name, params in defs if name.endswith("_host")}
    for symbol, (kernel, args) in cuda_build.ENTRIES.items():
        source, params = card[symbol]
        assert source == cuda_build.KERNELS[kernel].source, symbol
        assert [ctypes.c_void_p if t.endswith("*") else _CTYPES[t] for t, _ in params] == list(args), symbol
        assert [t for t, _ in twins[f"{symbol}_host"]] == [t for t, _ in params], symbol
    for kernel in cuda_build.KERNELS.values():
        if kernel.smem is not None:
            assert (kernel.source, kernel.smem, [("int", "R"), ("int", "C")]) in defs
    assert list(cuda_build.launches) == list(cuda_build.KERNELS)
    assert {n for names in bench.PATH_KERNELS.values() for n in names} <= set(cuda_build.KERNELS)
