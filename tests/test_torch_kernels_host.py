"""The CUDA kernels' board programs, built for the host, equal the plain
PyTorch versions exactly.

``csrc/cascade_sp.cu`` and ``csrc/mask_sp.cu`` write each kernel as a
sequence of per-cell phases (``csrc/block.cuh``); compiled as plain C++
with ``-DTMT_HOST_BUILD`` the same phases run as loops over the cells of
one board after another.  This holds the kernels' arithmetic against
``cascade_sp_reference`` and ``effective_mask_settled`` without a card;
``test_torch_kernels_cuda.py`` holds the kernels themselves on the card.
Needs ``g++``; skips without it.
"""

import ctypes
import shutil
import subprocess

import pytest
import torch

from chip_smoke import corner_boards
from tests.test_torch_specials import sprinkled
from tile_match_tpu_torch import cuda_build
from tile_match_tpu_torch.config import EnvConfig
from tile_match_tpu_torch.cuda_build import CSRC
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


@pytest.fixture(scope="module")
def host_libs(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++ to build the kernels' board programs for the host")
    out = tmp_path_factory.mktemp("host_build")
    libs = {}
    for name in ("cascade_sp", "mask_sp"):
        so = out / f"lib{name}_host.so"
        subprocess.run(
            [gxx, "-O2", "-std=c++17", "-x", "c++", "-DTMT_HOST_BUILD", "-shared", "-fPIC",
             "-I", str(CSRC), "-o", str(so), str(CSRC / f"{name}.cu")],
            check=True, capture_output=True, text=True,
        )
        libs[name] = ctypes.CDLL(str(so))
    k2 = libs["cascade_sp"].tmt_cascade_sp_host
    k2.argtypes = [ctypes.c_void_p] * 15 + [ctypes.c_int] * 10
    k2.restype = ctypes.c_int
    k3 = libs["mask_sp"].tmt_settled_mask_sp_host
    k3.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 4
    k3.restype = ctypes.c_int
    return k2, k3


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
        "cascade_sp.cu", "block.cuh", "threefry.cuh"
    }
    before = {n: cuda_build.digest(n) for n in names}
    with open(tmp_path / "mask.cuh", "a") as f:
        f.write("// edited\n")
    after = {n: cuda_build.digest(n) for n in names}
    assert after["cascade"] != before["cascade"] and after["mask_sp"] != before["mask_sp"]
    assert after["cascade_sp"] == before["cascade_sp"]
    with open(tmp_path / "block.cuh", "a") as f:  # included through mask.cuh / threefry.cuh
        f.write("// edited\n")
    assert all(cuda_build.digest(n) != after[n] for n in names)
