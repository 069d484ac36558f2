"""The port's loader of the C++ engine (``tile_match_tpu_torch.native``):
it builds into the port's ``_build/`` and leaves the JAX package's
``csrc/libtmt.so`` alone; the engine is a third oracle of the port's
deterministic sub-steps, and a ``NativeEngine`` episode holds the port's
invariants and effective masks where ``tests/test_native_cpp.py`` holds
the JAX package's."""

import os

import numpy as np
import pytest
import torch

from tile_match_tpu_torch import native
from tile_match_tpu_torch.config import EnvConfig
from tile_match_tpu_torch.debug import validate_state
from tile_match_tpu_torch.ops.classify import process_colour_lines
from tile_match_tpu_torch.ops.effective import effective_mask
from tile_match_tpu_torch.ops.lines import get_colour_lines
from tile_match_tpu_torch.ops.resolve import resolve_colour_matches
from tile_match_tpu_torch.parity import ParityEngine
from tile_match_tpu_torch.state import action_table

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_loader_builds_into_the_port_build_dir():
    jax_lib = os.path.join(ROOT, "csrc", "libtmt.so")
    before = os.stat(jax_lib).st_mtime_ns if os.path.exists(jax_lib) else None
    path = native.build()
    assert os.path.dirname(path) == os.path.join(ROOT, "tile_match_tpu_torch", "_build")
    assert os.path.exists(path) and native.build() == path  # built once, then reused
    after = os.stat(jax_lib).st_mtime_ns if os.path.exists(jax_lib) else None
    assert before == after
    assert native.load().tmt_num_actions(5, 6) == EnvConfig(5, 6, 3).num_actions


def _rand_board(rng, shape, colours, n_specials):
    colour = rng.integers(1, colours + 1, size=shape).astype(np.int32)
    kind = np.ones(shape, np.int32)
    for _ in range(n_specials):
        r, c = rng.integers(0, shape[0]), rng.integers(0, shape[1])
        k = int(rng.choice([2, 3, 4, -1]))
        kind[r, c] = k
        if k == -1:
            colour[r, c] = 0
    return colour, kind


@pytest.mark.parametrize("seed", range(6))
def test_effective_mask_and_resolve_match_the_port(seed):
    lib = native.load()
    rng = np.random.default_rng(seed + 999)
    shape = [(5, 5), (6, 6), (8, 8)][seed % 3]
    colours = [2, 3][seed % 2]
    colour, kind = _rand_board(rng, shape, colours, int(rng.integers(1, 5)))
    cfg = EnvConfig(shape[0], shape[1], colours, 10)
    tc, tk = torch.from_numpy(colour)[None], torch.from_numpy(kind)[None]

    out = np.zeros((cfg.num_actions,), np.uint8)
    lib.tmt_effective_mask(colour.copy(), kind.copy(), shape[0], shape[1], out)
    assert np.array_equal(out.astype(bool), effective_mask(cfg, tc, tk)[0].numpy())

    c2, k2 = colour.copy(), kind.copy()
    stats = np.zeros((2,), np.int32)
    had = lib.tmt_resolve_once(c2, k2, shape[0], shape[1], native._flags(cfg), stats)
    jc, jk, act, new, _ = resolve_colour_matches(
        cfg, tc, tk, process_colour_lines(cfg, tc, get_colour_lines(cfg, tc))
    )
    if had:
        assert np.array_equal(c2, jc[0].numpy()) and np.array_equal(k2, jk[0].numpy())
        assert (int(stats[0]), int(stats[1])) == (int(act[0]), int(new[0]))
    else:
        assert int(act[0]) == 0 and int(new[0]) == 0


def test_native_engine_episode():
    """An episode of the native engine (its own RNG): every board passes the
    port's ``validate_state``, its effective mask equals the port's parity
    engine's on the same board, and every move eliminates."""
    cfg = EnvConfig(6, 6, 4, 8)
    eng = native.NativeEngine(cfg, seed=1)
    eng.generate_board()
    validate_state(cfg, eng.colour, eng.kind)
    port = ParityEngine(cfg, np.random.default_rng(0), device="cpu")
    c1t, c2t = action_table(cfg)
    total = 0
    for t in range(cfg.num_moves):
        mask = eng.effective_mask()
        port.board[:] = eng.board
        assert np.array_equal(mask, port.effective_mask()), t
        assert mask.any()
        a = int(np.nonzero(mask)[0][t % mask.sum()])
        elim, comb, new, act, shuf = eng.move(tuple(c1t[a]), tuple(c2t[a]))
        assert elim >= 3
        total += elim
        validate_state(cfg, eng.colour, eng.kind)
    assert total > 0


def test_native_batch_engine_masks_match_the_port():
    cfg = EnvConfig(5, 5, 3, 4)
    eng = native.NativeBatchEngine(cfg, 16, seed=2)
    mask = eng.reset()
    for _ in range(6):  # across an auto-reset
        want = effective_mask(cfg, torch.from_numpy(eng.colour), torch.from_numpy(eng.kind)).numpy()
        assert np.array_equal(mask, want)
        actions = np.argmax(mask, axis=1).astype(np.int32)
        rewards, dones, _ = eng.step(actions)
        assert (rewards >= 3).all()
        mask = eng.effective_mask()
