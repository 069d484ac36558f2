"""The port's CUDA kernels on a card: each equals its plain PyTorch version,
and the env on the card equals the env on the CPU.

This file imports no JAX, so it also runs on a machine with a card and no
JAX (``tests/conftest.py`` imports JAX, hence ``--noconftest``):

    python -m pytest tests/test_torch_kernels_cuda.py --noconftest -q

Without a card every test skips.
"""

import dataclasses
import os
import sys

import numpy as np
import pytest
import torch

from tile_match_tpu_torch import cuda_build, engine
from tile_match_tpu_torch import random as trandom
from tile_match_tpu_torch.config import EnvConfig
from tile_match_tpu_torch.envs.batched import BatchedTileMatchEnv, random_effective
from tile_match_tpu_torch.ops import cascade as tcas
from tile_match_tpu_torch.ops import cascade_sp as tsp
from tile_match_tpu_torch.ops import combination as tcomb
from tile_match_tpu_torch.ops import mask_sp as tmask
from tile_match_tpu_torch.ops import trip_sp as ttrip
from tile_match_tpu_torch.ops.effective import effective_mask_settled

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NAMES = ["colour", "elim", "trips", "trunc", "mask"]
SP_NAMES = ["colour", "kind", "trips", "elim", "new", "act", "frozen", "active", "reasons"]


@pytest.fixture(scope="module", autouse=True)
def _libraries():
    """Build every kernel library the tests run at once, one nvcc each (the
    cascades take their board shape at compile time)."""
    if torch.cuda.is_available():
        shapes = {(R, C) for R, C, *_ in K1_SHAPES + SP_SHAPES + NB_CASES + K3_SHAPES + K4_CASES
                  + K5_CASES + LINE_SHAPES}
        cuda_build.build_all([(kernel.source, cuda_build.shape_of(R, C))
                              for kernel in cuda_build.KERNELS.values() for R, C in shapes])


def _no_specials(R, C, K, moves=30, **kw):
    return EnvConfig.create(R, C, K, moves, colourless_specials=(), colour_specials=(), **kw)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    return torch.device("cuda", 0)


K1_SHAPES = [(10, 10, 4, 2048, 64), (5, 5, 3, 1000, 64), (20, 20, 6, 256, 64), (6, 6, 3, 130, 64),
             (7, 9, 4, 300, 2), (32, 32, 5, 64, 64), (1, 8, 3, 50, 64), (8, 1, 3, 50, 64),
             (36, 36, 6, 256, 64), (10, 10, 4, 8192, 64), (36, 36, 6, 8192, 4)]


@pytest.mark.cuda
@pytest.mark.parametrize("R,C,K,B,max_cascades", K1_SHAPES)
def test_kernel_matches_plain_version(cuda_device, R, C, K, B, max_cascades):
    """Four warps a board below 8192 boards, one from there on."""
    cfg = _no_specials(R, C, K, max_cascades=max_cascades)
    rng = np.random.default_rng(R * B + C)
    colour = torch.as_tensor(rng.integers(1, K + 1, size=(B, R, C)).astype(np.int32), device=cuda_device)
    keys = torch.as_tensor(
        rng.integers(0, 1 << 32, size=(B, 2), dtype=np.uint64).astype(np.int64), device=cuda_device
    )
    before = cuda_build.launches["fused_cascade"]
    got = tcas.fused_cascade(cfg, colour, keys)
    torch.cuda.synchronize()
    assert cuda_build.launches["fused_cascade"] == before + 1
    want = tcas.cascade_reference(cfg, colour, keys)
    for g, w, name in zip(got, want, NAMES):
        assert g.dtype == w.dtype and torch.equal(g, w), name


@pytest.mark.cuda
def test_kernel_refuses_bad_input(cuda_device):
    cfg = _no_specials(6, 6, 3)
    keys = torch.zeros((4, 2), dtype=torch.int64, device=cuda_device)
    with pytest.raises(ValueError):
        tcas.fused_cascade(cfg, torch.ones((4, 6, 6), dtype=torch.int64, device=cuda_device), keys)
    with pytest.raises(ValueError):
        tcas.fused_cascade(cfg, torch.ones((4, 6, 6), dtype=torch.int32, device=cuda_device), keys[:3])
    # beyond the shared memory of a block (boards of more than 1024 cells run)
    with pytest.raises(ValueError, match="shared memory"):
        tcas.fused_cascade(_no_specials(200, 200, 4), torch.ones((4, 200, 200), dtype=torch.int32,
                                                                device=cuda_device), keys)


@pytest.mark.cuda
def test_env_on_card_equals_env_on_cpu(cuda_device):
    cfg = _no_specials(10, 10, 4, moves=5)
    out = {}
    for dev in ("cpu", cuda_device):
        env = BatchedTileMatchEnv(cfg, 96, device=dev)
        key = trandom.PRNGKey(3, dev)
        states, ts = env.reset(key)
        rows = []
        for t in range(7):  # crosses the reset after move 5
            key, ka = trandom.split(key).unbind(0)
            states, ts = env.step(states, random_effective(ka, ts))
            rows.append([states.colour, states.key, ts.reward, ts.info.effective_actions,
                         ts.info.cascade_trips, ts.done])
        out[str(dev)] = [[x.cpu() for x in row] for row in rows]
    for a, b in zip(*out.values()):
        for x, y in zip(a, b):
            assert torch.equal(x, y)


@pytest.mark.cuda
def test_fixture_replays_on_card(cuda_device):
    from tile_match_tpu_torch.tools.parity_check import replay_fixture

    assert replay_fixture(cuda_device) == 40


def _specials(R, C, K, moves=30, **kw):
    return EnvConfig.create(R, C, K, moves, **kw)


def _chip_smoke():
    sys.path.insert(0, ROOT)
    import chip_smoke

    return chip_smoke


SP_SHAPES = [(10, 10, 4, 2048, 64), (6, 6, 3, 130, 64), (8, 8, 4, 300, 2), (20, 20, 6, 256, 64),
             (32, 32, 5, 64, 64), (36, 36, 6, 256, 64)]


@pytest.mark.cuda
@pytest.mark.parametrize("R,C,K,B,limit", SP_SHAPES)
def test_cascade_sp_kernel_matches_plain_version(cuda_device, R, C, K, B, limit):
    cfg = _specials(R, C, K)
    inputs = _chip_smoke().sprinkled_inputs(R, C, K, B, seed=R * B + limit, device=cuda_device)
    before = cuda_build.launches["cascade_sp_chunk"]
    got = tsp.cascade_sp_chunk(cfg, *inputs, limit=limit)
    torch.cuda.synchronize()
    assert cuda_build.launches["cascade_sp_chunk"] == before + 1
    want = tsp.cascade_sp_reference(cfg, *inputs, limit=limit)
    for g, w, name in zip(got, want, SP_NAMES):
        assert g.dtype == w.dtype and torch.equal(g, w), name


NO_BOMB_SETS = {
    "cookie-lasers": (("cookie",), ("vertical_laser", "horizontal_laser")),
    "lasers": ((), ("vertical_laser", "horizontal_laser")),
    "cookie": (("cookie",), ()),
    "cookie-hlaser": (("cookie",), ("horizontal_laser",)),
}
NB_CASES = [(10, 10, 4, 2048, "cookie-lasers"), (6, 6, 3, 1000, "lasers"), (8, 8, 4, 1000, "cookie"),
            (20, 20, 6, 256, "cookie-lasers"), (7, 9, 3, 300, "cookie-hlaser"),
            (36, 36, 6, 256, "cookie-lasers")]


@pytest.mark.cuda
@pytest.mark.parametrize("R,C,K,B,name", NB_CASES)
def test_cascade_sp_no_bomb_kernel_matches_plain_version(cuda_device, R, C, K, B, name):
    """K2's no-bomb case table, and K3 on its output boards."""
    specials = NO_BOMB_SETS[name]
    cfg = _specials(R, C, K, colourless_specials=specials[0], colour_specials=specials[1])
    kinds = [k for k, on in ((2, cfg.vertical_laser), (3, cfg.horizontal_laser), (-1, cfg.cookie)) if on]
    inputs = _chip_smoke().sprinkled_inputs(R, C, K, B, seed=R * B, device=cuda_device, kinds=kinds)
    got = tsp.cascade_sp_chunk(cfg, *inputs, limit=cfg.max_cascades)
    want = tsp.cascade_sp_reference(cfg, *inputs, limit=cfg.max_cascades)
    for g, w, name_ in zip(got, want, SP_NAMES):
        assert g.dtype == w.dtype and torch.equal(g, w), name_
    assert int(got[6].sum()) > int(inputs[5].sum())  # some boards froze
    assert torch.equal(tmask.settled_mask_sp(cfg, got[0], got[1]),
                       effective_mask_settled(cfg, got[0], got[1]))


@pytest.mark.cuda
def test_gym_engines_replay_on_card(cuda_device):
    """The Gym adapter's two engines on the card (the card's machine may
    have no gymnasium, so the engines are driven as the adapter drives
    them): the golden episodes and the recorded JAX Gym episodes."""
    smoke = _chip_smoke()
    assert len(smoke.replay_golden(cuda_device)) == 21
    assert len(smoke.replay_gym(cuda_device)) == 8


@pytest.mark.cuda
@pytest.mark.parametrize("R,C,K,B,limit", SP_SHAPES)
def test_settled_mask_sp_kernel_matches_plain_version(cuda_device, R, C, K, B, limit):
    cfg = _specials(R, C, K)
    colour, kind = _chip_smoke().sprinkled_inputs(R, C, K, B, seed=B, device=cuda_device)[:2]
    before = cuda_build.launches["settled_mask_sp"]
    got = tmask.settled_mask_sp(cfg, colour, kind)
    torch.cuda.synchronize()
    assert cuda_build.launches["settled_mask_sp"] == before + 1
    assert torch.equal(got, effective_mask_settled(cfg, colour, kind))


K3_SHAPES = [(10, 10, 4, 1), (10, 10, 4, 130), (5, 5, 3, 77), (20, 20, 6, 8192), (32, 32, 5, 33),
             (6, 32, 4, 64), (1, 8, 3, 9), (36, 36, 6, 256), (80, 80, 6, 7), (150, 150, 6, 3)]


@pytest.mark.cuda
@pytest.mark.parametrize("any_special", [True, False], ids=["specials", "no-specials"])
@pytest.mark.parametrize("R,C,K,B", K3_SHAPES)
def test_settled_mask_kernel_with_and_without_specials(cuda_device, R, C, K, B, any_special):
    """K3 serves every settled mask: one board, batches that fill no whole
    block of boards, boards with specials under a config without them, and
    boards too large for four a block (80x80 takes two, 150x150 one)."""
    kw = {} if any_special else {"colourless_specials": (), "colour_specials": ()}
    cfg = _specials(R, C, K, **kw)
    colour, kind = _chip_smoke().sprinkled_inputs(R, C, K, B, seed=R * C + B, device=cuda_device)[:2]
    before = cuda_build.launches["settled_mask_sp"]
    got = tmask.settled_mask_sp(cfg, colour, kind)
    torch.cuda.synchronize()
    assert cuda_build.launches["settled_mask_sp"] == before + 1
    assert torch.equal(got, effective_mask_settled(cfg, colour, kind))


@pytest.mark.cuda
def test_no_specials_env_launches_the_settled_mask_kernel(cuda_device):
    """Config 1's step on the card computes its incoming mask with K3, and
    the plain mask is never called on a CUDA tensor."""
    smoke = _chip_smoke()
    cfg = _no_specials(10, 10, 4, moves=5)
    env = BatchedTileMatchEnv(cfg, 64, device=cuda_device)
    key = trandom.PRNGKey(4, cuda_device)
    with smoke.plain_mask_refused():
        states, ts = env.reset(key)
        for _ in range(6):  # crosses the reset after move 5
            key, ka = trandom.split(key).unbind(0)
            before = cuda_build.launches["settled_mask_sp"]
            states, ts = env.step(states, random_effective(ka, ts))
            torch.cuda.synchronize()
            assert cuda_build.launches["settled_mask_sp"] > before


@pytest.mark.cuda
def test_specials_kernels_refuse_bad_input(cuda_device):
    cfg = _specials(6, 6, 3)
    colour, kind, keys, trips, elim, frozen = _chip_smoke().sprinkled_inputs(
        6, 6, 3, 4, seed=0, device=cuda_device
    )
    with pytest.raises(ValueError):
        tsp.cascade_sp_chunk(cfg, colour.long(), kind, keys, trips, elim, frozen, limit=8)
    with pytest.raises(ValueError):
        tsp.cascade_sp_chunk(cfg, colour, kind, keys[:3], trips, elim, frozen, limit=8)
    with pytest.raises(ValueError):
        tmask.settled_mask_sp(cfg, colour, kind.long())
    with pytest.raises(ValueError):  # not contiguous
        tmask.settled_mask_sp(cfg, colour.transpose(1, 2), kind.transpose(1, 2))
    # a single-laser config without the bomb runs, as its plain version
    v_only = _specials(6, 6, 3, colour_specials=("vertical_laser",))
    got = tsp.cascade_sp_chunk(v_only, colour, kind, keys, trips, elim, frozen, limit=8)
    want = tsp.cascade_sp_reference(v_only, colour, kind, keys, trips, elim, frozen, limit=8)
    for g, w, name in zip(got, want, SP_NAMES):
        assert torch.equal(g, w), name


@pytest.mark.cuda
@pytest.mark.parametrize("R,C,K,B,moves,steps", [(10, 10, 4, 64, 5, 7), (20, 20, 6, 16, 2, 3)],
                         ids=["config3", "config4-20x20"])
def test_specials_env_on_card_equals_env_on_cpu(cuda_device, R, C, K, B, moves, steps):
    cfg = _specials(R, C, K, moves=moves)
    out = {}
    for dev in ("cpu", cuda_device):
        env = BatchedTileMatchEnv(cfg, B, device=dev)
        key = trandom.PRNGKey(5, dev)
        states, ts = env.reset(key)
        rows = []
        for t in range(steps):  # crosses the reset after the last move
            key, ka = trandom.split(key).unbind(0)
            states, ts = env.step(states, random_effective(ka, ts))
            rows.append([states.colour, states.kind, states.key, ts.reward,
                         ts.info.effective_actions, ts.info.cascade_trips,
                         ts.info.num_new_specials, ts.info.num_specials_activated,
                         ts.info.truncated, ts.done])
        out[str(dev)] = [[x.cpu() for x in row] for row in rows]
    for a, b in zip(*out.values()):
        for x, y in zip(a, b):
            assert torch.equal(x, y)


def _large_board_env_matches(cuda_device, size, specials, B, steps):
    kw = {"colourless_specials": (), "colour_specials": ()} if specials == "none" else {}
    cfg = _specials(size, size, 6, moves=2, **kw)
    out = {}
    for dev in ("cpu", cuda_device):
        env = BatchedTileMatchEnv(cfg, B, device=dev)
        key = trandom.PRNGKey(9, dev)
        states, ts = env.reset(key)
        rows = []
        for t in range(steps):
            key, ka = trandom.split(key).unbind(0)
            states, ts = env.step(states, random_effective(ka, ts))
            rows.append([states.colour, states.kind, ts.reward, ts.info.effective_actions,
                         ts.info.cascade_trips, ts.done])
        out[str(dev)] = [[x.cpu() for x in row] for row in rows]
    for a, b in zip(*out.values()):
        for x, y in zip(a, b):
            assert torch.equal(x, y)


@pytest.mark.cuda
@pytest.mark.parametrize("specials", ["none", "all"])
def test_large_board_env_on_card_equals_env_on_cpu(cuda_device, specials):
    """36x36 boards (1,296 cells) step through the kernels on the card."""
    _large_board_env_matches(cuda_device, 36, specials, B=8, steps=3)


@pytest.mark.cuda
@pytest.mark.parametrize("size,specials", [(80, "all"), (100, "none")])
def test_boards_too_large_for_four_masks_a_block_step_on_card(cuda_device, size, specials):
    """Boards whose settled mask takes fewer than four boards a block (K3
    picks the boards a block from the shape): 80x80 with specials, within
    K2's limit, and 100x100 without, within K1's."""
    _large_board_env_matches(cuda_device, size, specials, B=4, steps=2)


@pytest.mark.cuda
def test_cfg3_fixture_replays_on_card(cuda_device):
    from tile_match_tpu_torch.tools.parity_check import replay_fixture

    smoke = _chip_smoke()
    assert replay_fixture(cuda_device, smoke.FIXTURE_CFG3) == 35


@pytest.mark.cuda
def test_nobomb_fixture_replays_on_card(cuda_device):
    from tile_match_tpu_torch.tools.parity_check import replay_fixture

    smoke = _chip_smoke()
    assert replay_fixture(cuda_device, smoke.FIXTURE_NOBOMB) == 35


TRIP_NAMES = ["colour", "kind", "elim", "act", "new", "ovf"]
# K4: (R, C, K, B, config overrides); 80x80's scratch lies in device memory
K4_CASES = [(10, 10, 4, 2048, {}), (6, 6, 3, 500, {}), (20, 20, 6, 256, {}), (36, 36, 6, 64, {}),
            (80, 80, 6, 8, {}), (10, 10, 3, 2048, {"max_lines": 2}),
            (10, 10, 3, 2048, {"max_stack": 2})]


@pytest.mark.cuda
@pytest.mark.parametrize("R,C,K,B,caps", K4_CASES)
def test_specials_trip_kernel_matches_plain_version(cuda_device, R, C, K, B, caps):
    """On raw boards with sprinkled specials and on the boards K2's kernel
    froze, under tight caps too."""
    smoke = _chip_smoke()
    cfg = dataclasses.replace(_specials(R, C, K), **caps)
    sets = [smoke.sprinkled_inputs(R, C, K, B, seed=R + B, device=cuda_device)[:4]]
    if R * C <= 1296:
        sets.append(smoke.frozen_trip_inputs(cfg, B, R * B, cuda_device))
    for inputs in sets:
        before = cuda_build.launches["specials_trip"]
        got = ttrip.specials_trip(cfg, *inputs)
        torch.cuda.synchronize()
        assert cuda_build.launches["specials_trip"] == before + 1
        want = engine.specials_cascade_trip(cfg, *inputs)
        for g, w, name in zip(got, want, TRIP_NAMES):
            assert g.dtype == w.dtype and torch.equal(g, w), name
    if caps:
        assert bool(got[5].any())  # the cap fired


@pytest.mark.cuda
def test_specials_trip_caps_raise_on_card(cuda_device):
    """With debug_checks, each cap raises through K4 the plain trip's
    message on the same board."""
    smoke = _chip_smoke()
    for cap in smoke.CAPS:
        R, C, K, kw, colour, kind = smoke.cap_board(cap)
        cfg = _specials(R, C, K, debug_checks=True, **kw)
        inputs = (torch.from_numpy(colour)[None], torch.from_numpy(kind)[None],
                  torch.tensor([[3, 4]]), torch.zeros(1, dtype=torch.int32))
        with pytest.raises(RuntimeError) as want:
            ttrip.specials_trip(cfg, *inputs)
        with pytest.raises(RuntimeError) as got:
            ttrip.specials_trip(cfg, *(t.to(cuda_device) for t in inputs))
        assert str(got.value) == str(want.value), cap


@pytest.mark.cuda
def test_specials_trip_refuses_bad_input(cuda_device):
    cfg = _specials(6, 6, 3)
    colour, kind, keys, trips = _chip_smoke().sprinkled_inputs(6, 6, 3, 4, seed=0,
                                                               device=cuda_device)[:4]
    with pytest.raises(ValueError):
        ttrip.specials_trip(cfg, colour.long(), kind, keys, trips)
    with pytest.raises(ValueError):
        ttrip.specials_trip(cfg, colour, kind, keys[:3], trips)
    with pytest.raises(ValueError):  # not contiguous
        ttrip.specials_trip(cfg, colour.transpose(1, 2), kind.transpose(1, 2), keys, trips)
    big = _specials(256, 256, 3)
    board = torch.ones((1, 256, 256), dtype=torch.int32, device=cuda_device)
    with pytest.raises(ValueError, match="65535 cells"):
        ttrip.specials_trip(big, board, board, keys[:1], trips[:1])


@pytest.mark.cuda
def test_specials_cascade_runs_every_full_trip_on_k4(cuda_device):
    """``fused_specials_cascade`` on the card, with the plain trip refused
    there, equals the cascade on the CPU."""
    smoke = _chip_smoke()
    cfg = _specials(10, 10, 4)
    colour, kind, keys = smoke.sprinkled_inputs(10, 10, 4, 512, seed=9, device=cuda_device)[:3]
    before = cuda_build.launches["specials_trip"]
    with smoke.plain_trip_refused():
        got = engine.fused_specials_cascade(cfg, colour, kind, keys)
    torch.cuda.synchronize()
    assert cuda_build.launches["specials_trip"] > before
    want = engine.fused_specials_cascade(cfg, colour.cpu(), kind.cpu(), keys.cpu())
    for g, w in zip(got, want):
        assert torch.equal(g.cpu(), w)


COMB_NAMES = ["colour", "kind", "key", "elim", "act", "ovf"]
# K5: (R, C, K, B, config overrides); 100x100's scratch lies in device memory
K5_CASES = [(10, 10, 4, 4096, {}), (36, 36, 6, 64, {}), (100, 100, 6, 4, {}),
            (10, 10, 3, 1024, {"max_stack": 2}), (10, 10, 3, 1024, {"max_activation_steps": 8})]


@pytest.mark.cuda
@pytest.mark.parametrize("R,C,K,B,caps", K5_CASES)
def test_combination_trip_kernel_matches_plain_version(cuda_device, R, C, K, B, caps):
    """On boards whose swap cells hold every ordered pair of kinds, flagged
    and not, under tight caps too."""
    smoke = _chip_smoke()
    cfg = dataclasses.replace(_specials(R, C, K), **caps)
    inputs = smoke.combination_inputs(R, C, K, B, seed=R + B, device=cuda_device)
    before = cuda_build.launches["combination_trip"]
    got = tcomb.combination_trip(cfg, *(t.clone() for t in inputs))  # updated in place
    torch.cuda.synchronize()
    assert cuda_build.launches["combination_trip"] == before + 1
    want = engine.combination_branch(cfg, *inputs)
    for g, w, name in zip(got, want, COMB_NAMES):
        assert g.dtype == w.dtype and torch.equal(g, w), name
    if caps:
        assert bool(got[5].any())  # the cap fired


@pytest.mark.cuda
@pytest.mark.parametrize("B", [1, 130, 4096])
def test_combination_trip_leaves_unflagged_boards_untouched(cuda_device, B):
    """Every flag clear: the caller's boards byte for byte as they were, the
    keys through, zero counts; one flag set: the plain branch's outputs,
    the other boards as they were."""
    smoke = _chip_smoke()
    cfg = _specials(10, 10, 4)
    colour, kind, keys, c1, c2, comb = smoke.combination_inputs(10, 10, 4, B, seed=B,
                                                                device=cuda_device)
    mine = colour.clone(), kind.clone()
    got = tcomb.combination_trip(cfg, *mine, keys, c1, c2, torch.zeros_like(comb))
    torch.cuda.synchronize()
    assert got[0] is mine[0] and got[1] is mine[1]
    assert torch.equal(mine[0], colour) and torch.equal(mine[1], kind) and torch.equal(got[2], keys)
    assert not any(bool(t.any()) for t in got[3:])
    one = torch.zeros_like(comb)
    one[int(comb.nonzero()[0, 0]) if comb.any() else 0] = True
    inputs = (colour, kind, keys, c1, c2, one)
    got = tcomb.combination_trip(cfg, *(t.clone() for t in inputs))
    want = engine.combination_branch(cfg, *inputs)
    for g, w, name in zip(got, want, COMB_NAMES):
        assert g.dtype == w.dtype and torch.equal(g, w), name
    assert torch.equal(got[0][~one], colour[~one]) and torch.equal(got[1][~one], kind[~one])


@pytest.mark.cuda
def test_combination_trip_caps_raise_on_card(cuda_device):
    """With debug_checks, each cap raises through K5 the plain branch's
    message on the same boards."""
    inputs = _chip_smoke().combination_inputs(8, 8, 3, 256, seed=19, device="cpu")
    for kw in (dict(max_stack=2), dict(max_activation_steps=3)):
        cfg = _specials(8, 8, 3, debug_checks=True, **kw)
        with pytest.raises(RuntimeError) as want:
            tcomb.combination_trip(cfg, *inputs)
        with pytest.raises(RuntimeError) as got:
            tcomb.combination_trip(cfg, *(t.to(cuda_device) for t in inputs))
        assert str(got.value) == str(want.value), kw


@pytest.mark.cuda
def test_combination_trip_refuses_bad_input(cuda_device):
    cfg = _specials(6, 6, 3)
    colour, kind, keys, c1, c2, comb = _chip_smoke().combination_inputs(6, 6, 3, 4, seed=0,
                                                                        device=cuda_device)
    with pytest.raises(ValueError):
        tcomb.combination_trip(cfg, colour.long(), kind, keys, c1, c2, comb)
    with pytest.raises(ValueError):
        tcomb.combination_trip(cfg, colour, kind, keys[:3], c1, c2, comb)
    with pytest.raises(ValueError):  # not contiguous
        tcomb.combination_trip(cfg, colour.transpose(1, 2), kind.transpose(1, 2), keys, c1, c2,
                               comb)


@pytest.mark.cuda
def test_specials_env_runs_every_combination_on_k5(cuda_device):
    """Config 3's step on the card, with the plain branch refused there,
    equals the step on the CPU over ten steps."""
    smoke = _chip_smoke()
    cfg = _specials(10, 10, 4)
    outs = []
    for dev in (cuda_device, torch.device("cpu")):
        env = BatchedTileMatchEnv(cfg, 512, device=dev)
        states, ts = env.reset(trandom.PRNGKey(3, dev))
        gen = torch.Generator().manual_seed(4)  # the actions drawn on the CPU for both
        before = cuda_build.launches["combination_trip"]
        with smoke.plain_combination_refused():
            for _ in range(10):
                mask = ts.info.effective_actions.cpu()
                actions = torch.where(mask, torch.rand(mask.shape, generator=gen), -1.0).argmax(-1)
                states, ts = env.step(states, actions.to(dev))
        outs.append((states.colour.cpu(), states.kind.cpu(), states.key.cpu(), ts.reward.cpu()))
        if dev.type == "cuda":
            assert cuda_build.launches["combination_trip"] == before + 10
    for g, w in zip(*outs):
        assert torch.equal(g, w)


def _tf_keys(M, seed, device):
    keys = np.random.default_rng(seed).integers(0, 1 << 32, size=(M, 2), dtype=np.uint64)
    keys[:2] = [[0, 0], [0xFFFFFFFF, 0xFFFFFFFF]][:M]
    return torch.as_tensor(keys.astype(np.int64), device=device)


# (name, the call on keys of the given device, launches a call on the card)
TF_CASES = [
    ("split-one-key", lambda d: trandom.split(_tf_keys(2, 1, d)[1]), 1),
    ("split-batch-offset", lambda d: trandom.split(_tf_keys(2, 2, d)[0], 16384, 5 * 16384), 1),
    ("split-strided", lambda d: trandom.split(trandom.split(_tf_keys(4096, 3, d))[:, 1]), 2),
    ("fold_in-int32", lambda d: trandom.fold_in(
        _tf_keys(4096, 4, d), torch.arange(-5, 4091, dtype=torch.int32, device=d)), 1),
    ("fold_in-int", lambda d: trandom.fold_in(_tf_keys(4096, 5, d), (1 << 32) - 1), 1),
    ("random_bits", lambda d: trandom.random_bits(_tf_keys(2, 6, d)[0], (16384, 180), 7), 1),
    ("uniform", lambda d: trandom.uniform(_tf_keys(2, 7, d)[0], (16384, 180),
                                          np.finfo(np.float32).tiny, 1.0, 180), 1),
    ("draw_colour_grid", lambda d: trandom.randint(_tf_keys(16384, 8, d), (10, 10), 1, 5), 1),
    ("randint-wide", lambda d: trandom.randint(_tf_keys(300, 9, d), (33,), -7, (1 << 31) - 7), 1),
    ("randint-tensor-maxval", lambda d: trandom.randint(
        _tf_keys(300, 10, d), (10,), 1, torch.arange(300, device=d)[:, None] % 9 + 2), 3),
    ("permutation", lambda d: trandom.permutation(_tf_keys(4096, 11, d), 100), 2),
    ("bits-offset-above-2**31", lambda d: trandom.random_bits(_tf_keys(2, 12, d)[0], (3,), (1 << 31) + 5), 1),
]


@pytest.mark.cuda
@pytest.mark.parametrize("name,call,n_launches", TF_CASES, ids=[c[0] for c in TF_CASES])
def test_threefry_kernel_matches_plain_version(cuda_device, name, call, n_launches):
    """random.py on the card (the threefry kernel) equals its plain int64
    version on the CPU word for word, one launch a split, fold_in,
    random_bits, uniform or randint."""
    before = cuda_build.launches["threefry_words"]
    got = call(cuda_device)
    torch.cuda.synchronize()
    assert cuda_build.launches["threefry_words"] == before + n_launches
    want = call(torch.device("cpu"))
    assert got.dtype == want.dtype and got.shape == want.shape
    assert torch.equal(got.cpu(), want)


@pytest.mark.cuda
def test_threefry_categorical_on_card_uses_the_kernel_words(cuda_device):
    """categorical on the card: the kernel's uniforms, then torch's two logs
    and argmax on the card, as the plain uniforms would give there."""
    key = _tf_keys(2, 13, cuda_device)[1]
    logits = torch.where(torch.rand(16384, 180, generator=torch.Generator().manual_seed(0)) < 0.3,
                         0.0, -torch.inf).to(cuda_device)
    before = cuda_build.launches["threefry_words"]
    got = trandom.categorical(key, logits, offset=180)
    torch.cuda.synchronize()
    assert cuda_build.launches["threefry_words"] == before + 1
    u = trandom.uniform(key.cpu(), logits.shape, np.finfo(np.float32).tiny, 1.0, 180).to(cuda_device)
    assert torch.equal(got, torch.argmax(-torch.log(-torch.log(u)) + logits, dim=-1))


@pytest.mark.cuda
def test_threefry_launches_in_span_only_under_profiler(cuda_device):
    """Each launch is one program span ``threefry`` with the words it
    writes, recorded only while a profiler runs."""
    from torch.profiler import ProfilerActivity, profile

    from tile_match_tpu_torch import profiling

    keys = _tf_keys(300, 14, cuda_device)
    profiling.clear_spans()
    trandom.split(keys, 3)
    assert profiling.spans() == []
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        trandom.split(keys, 3)
        trandom.randint(keys, (10, 10), 1, 5)
        trandom.fold_in(keys, 7)
        torch.cuda.synchronize()
    got = [(s.name, s.attrs) for s in profiling.spans()]
    profiling.clear_spans()
    assert got == [("threefry", {"words": 300 * 3 * 2}), ("threefry", {"words": 300 * 100}),
                   ("threefry", {"words": 300 * 2})]


def test_threefry_plain_version_on_cpu_and_other_devices_refused(monkeypatch):
    """On CPU tensors random.py runs its plain version and never loads the
    kernel's library; a device that is neither CPU nor CUDA raises."""

    def refused(*args):
        raise AssertionError("the threefry library was loaded for CPU tensors")

    monkeypatch.setattr(cuda_build, "load", refused)
    monkeypatch.setattr(cuda_build, "library", refused)
    keys = torch.tensor([[0, 42], [7, 0xFFFFFFFF]], dtype=torch.int64)
    before = cuda_build.launches["threefry_words"]
    trandom.split(keys, 3)
    trandom.fold_in(keys, torch.tensor([1, 2]))
    trandom.random_bits(keys, (5,))
    trandom.randint(keys, (4,), 0, 10)
    trandom.randint(keys, (4,), 0, torch.tensor(10))
    trandom.uniform(keys, (3,))
    trandom.categorical(keys[0], torch.zeros(2, 6))
    trandom.permutation(keys, 9)
    assert cuda_build.launches["threefry_words"] == before
    meta = torch.zeros(2, dtype=torch.int64, device="meta")
    for call in (lambda: trandom.split(meta), lambda: trandom.fold_in(meta, 1),
                 lambda: trandom.random_bits(meta, (3,)), lambda: trandom.randint(meta, (3,), 0, 4),
                 lambda: trandom.uniform(meta, (3,))):
        with pytest.raises(ValueError, match="unsupported device"):
            call()


# ---- the line test (csrc/line_test.cu) --------------------------------------


def line_boards(kind, R, C, K, B, seed):
    """colour int32[B, R, C] for the line test.  ``random``: colours 1..K,
    uniform.  ``sparse``: a line-free two-colour checkerboard (1, 2) with
    colour 3 scattered on it, so that some boards hold a line and some do
    not.  ``painted``: the checkerboard with one to three runs of colour 3
    or 4, 3 cells up to a whole row or column long, each touching an edge
    (column 0, column C - 1, row 0 or row R - 1).  ``zeros``: colours 0..K
    with 0 a third of the cells, and a run of three or more zeros painted in
    each board: zero-colour cells never join a run."""
    rng = np.random.default_rng(seed)
    rows, cols = np.indices((R, C))
    checker = np.where((rows + cols) % 2 == 0, 1, 2).astype(np.int32)
    if kind == "random":
        colour = rng.integers(1, K + 1, size=(B, R, C))
    elif kind == "sparse":
        colour = np.where(rng.random((B, R, C)) < 0.2, 3, checker[None])
    elif kind == "painted":
        colour = checker[None].repeat(B, 0)
        for b in range(B):
            for _ in range(int(rng.integers(1, 4))):
                pc = int(rng.integers(3, 5))
                if rng.random() < 0.5 and C >= 3:
                    n = int(rng.integers(3, C + 1))
                    r = int(rng.choice([0, R - 1, int(rng.integers(0, R))]))
                    c0 = 0 if rng.random() < 0.5 else C - n
                    colour[b, r, c0:c0 + n] = pc
                elif R >= 3:
                    n = int(rng.integers(3, R + 1))
                    c = int(rng.choice([0, C - 1, int(rng.integers(0, C))]))
                    r0 = 0 if rng.random() < 0.5 else R - n
                    colour[b, r0:r0 + n, c] = pc
    elif kind == "zeros":
        colour = np.where(rng.random((B, R, C)) < 1 / 3, 0, rng.integers(1, K + 1, size=(B, R, C)))
        for b in range(B):
            if rng.random() < 0.5 and C >= 3:
                n, r = int(rng.integers(3, C + 1)), int(rng.integers(0, R))
                colour[b, r, :n] = 0
            elif R >= 3:
                n, c = int(rng.integers(3, R + 1)), int(rng.integers(0, C))
                colour[b, R - n:, c] = 0
    else:
        raise ValueError(kind)
    return torch.from_numpy(np.ascontiguousarray(colour, dtype=np.int32))


# (R, C, K): the configs' shapes (10x10 with 4 and 6 colours, 20x20x6), the
# smallest config's, 32x32, rows or columns of 32 cells, an odd shape, and
# 35x35 (beyond the other kernels' libraries of one shape); each with every
# kind of ``line_boards``
LINE_SHAPES = [(5, 5, 3), (10, 10, 4), (10, 10, 6), (20, 20, 6), (32, 32, 5), (6, 32, 4),
               (32, 6, 4), (9, 7, 4), (35, 35, 6)]
LINE_KINDS = ["random", "sparse", "painted", "zeros"]
LINE_CASES = [(R, C, K, kind) for R, C, K in LINE_SHAPES for kind in LINE_KINDS]


def line_case_ids(cases):
    return [f"{R}x{C}x{K}-{kind}" for R, C, K, kind in cases]


def plain_line_test(colour):
    """The plain version's (member mask, any) on the CPU."""
    from tile_match_tpu_torch.ops import lines as tl

    colour = colour.cpu()
    return tl.plain_run_member_mask(None, colour), tl.plain_has_any_line(None, colour)


@pytest.mark.cuda
@pytest.mark.parametrize("R,C,K,kind", LINE_CASES, ids=line_case_ids(LINE_CASES))
def test_line_test_kernel_matches_plain_version(cuda_device, R, C, K, kind):
    """The line test on the card equals the plain version bit for bit, one
    launch a call."""
    from tile_match_tpu_torch.ops import lines as tl

    colour = line_boards(kind, R, C, K, 61, seed=R * C + K + LINE_KINDS.index(kind))
    want_member, want_any = plain_line_test(colour)
    assert 0 < int(want_any.sum()) or kind == "sparse"
    x = colour.to(cuda_device)
    before = cuda_build.launches["line_test"]
    member, any_ = tl.run_member_mask(None, x), tl.has_any_line(None, x)
    torch.cuda.synchronize()
    assert cuda_build.launches["line_test"] == before + 2
    assert torch.equal(member.cpu(), want_member)
    assert torch.equal(any_.cpu(), want_any)


@pytest.mark.cuda
def test_line_test_one_board_empty_batch_and_strided_input(cuda_device):
    """B = 1; B = 0 (no launch, empty outputs); strided views (a batch
    stride, a transposed board) equal the plain version on the same view;
    a 16,384-board launch; a colour that is not int32 is refused."""
    from tile_match_tpu_torch.ops import lines as tl

    big_cpu = line_boards("random", 10, 10, 4, 16384, seed=5)
    big = big_cpu.to(cuda_device)
    one = line_boards("painted", 20, 20, 6, 1, seed=6)
    views = [lambda t: t[:1], lambda t: t[::3], lambda t: t.transpose(1, 2), lambda t: t]
    assert not big[::3].is_contiguous() and not big.transpose(1, 2).is_contiguous()
    for x, x_cpu in [(view(big), view(big_cpu)) for view in views] + [(one.to(cuda_device), one)]:
        want_member, want_any = plain_line_test(x_cpu)
        assert torch.equal(tl.run_member_mask(None, x).cpu(), want_member)
        assert torch.equal(tl.has_any_line(None, x).cpu(), want_any)
    empty = torch.zeros(0, 10, 10, dtype=torch.int32, device=cuda_device)
    before = cuda_build.launches["line_test"]
    member, any_ = tl.run_member_mask(None, empty), tl.has_any_line(None, empty)
    assert cuda_build.launches["line_test"] == before
    assert member.shape == (0, 10, 10) and member.dtype == torch.bool
    assert any_.shape == (0,) and any_.dtype == torch.bool
    with pytest.raises(ValueError):
        tl.has_any_line(None, big[:4].to(torch.int64))


@pytest.mark.cuda
def test_line_test_launches_in_span_only_under_profiler(cuda_device):
    """Each launch is one program span ``line_test`` with the launch's
    boards and its entry point, recorded only while a profiler runs."""
    from torch.profiler import ProfilerActivity, profile

    from tile_match_tpu_torch import profiling
    from tile_match_tpu_torch.ops import lines as tl

    x = line_boards("random", 10, 10, 4, 300, seed=7).to(cuda_device)
    profiling.clear_spans()
    tl.has_any_line(None, x)
    assert profiling.spans() == []
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        tl.run_member_mask(None, x)
        tl.has_any_line(None, x[:7])
        torch.cuda.synchronize()
    got = [(s.name, s.attrs) for s in profiling.spans()]
    profiling.clear_spans()
    assert got == [("line_test", {"boards": 300, "what": "member"}),
                   ("line_test", {"boards": 7, "what": "any"})]
