"""The recorded JAX scale-out fixture (``tests/data/
torch_port_fixture_sharded.npz``, written by ``tools/
make_torch_port_fixture.py``) replayed through the port on the CPU by
``chip_smoke.py``'s own phase 16-19 functions, as the card replays it;
the file equals a fresh recording."""

import os
import sys

import numpy as np
import pytest
import torch
import torch.distributed as dist

from tile_match_tpu_torch import cuda_build
from tile_match_tpu_torch.parallel import launch, make_mesh
from tests.torch_port_helpers import change_tol
from tools import make_torch_port_fixture as fixture_tool

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
import chip_smoke  # noqa: E402

WALL = 240


@pytest.fixture(scope="module")
def mesh():
    """A one-rank gloo group in this process and its mesh."""
    m = make_mesh(["cpu"], dp=1, tp=1)
    yield m
    dist.destroy_process_group()


def test_sharded_rollout_replays_the_recorded_jax_rollout(mesh):
    counts = chip_smoke.replay_sharded_rollout(mesh)
    # plain versions on the CPU
    assert counts == dict.fromkeys(cuda_build.KERNELS, 0)


def test_sharded_train_steps_replay_the_recorded_jax_steps(mesh):
    rec = chip_smoke.replay_sharded_train(mesh)
    assert rec["state"].step_count == fixture_tool.SHARDED_TRAIN_STEPS
    assert rec["gaps"]["grad"] < chip_smoke.LEARNER_GRAD_REL
    assert max(rec["gaps"].values()) < chip_smoke.LEARNER_DRIFT_REL


def test_two_ranks_equal_one_rank_board_for_board(mesh):
    """Phase 17's rank function on two CPU ranks against ``sharded_run`` on
    one rank (config 3, 32 boards, 3 steps)."""
    one = chip_smoke.sharded_run(chip_smoke._config(10, 10, 4, 30, chip_smoke.ALL_SPECIALS),
                                 mesh, 32, 3, 0, "one rank")
    outs = launch(2, chip_smoke.rollout_ranks, chip_smoke.ALL_SPECIALS, 32, 3, 0, "cpu",
                  timeout=WALL)
    for name, want in one["boards"].items():
        assert np.array_equal(outs[0]["boards"][name], want), name
    assert "boards" not in outs[1]
    for o in outs:
        assert o["stats"]["trips_sum"] == one["stats"]["trips_sum"]
        assert o["board_steps_per_s"] > 0


def test_tp2_train_ranks_within_tolerance_of_one_rank():
    """Phase 18's rank function at (1, 2) against (1, 1), on the CPU, held
    as phase 18 holds it: each leaf's change from the seeded start (within
    ``change_tol``, the port's limit for a change against JAX's), and the
    losses."""
    one = launch(1, chip_smoke.train_ranks, 1, 1, "cpu", timeout=WALL)[0]
    two = launch(2, chip_smoke.train_ranks, 2, 1, "cpu", timeout=WALL)
    whole = chip_smoke._whole_params([o["params"] for o in sorted(two, key=lambda o: o["tp_rank"])])
    f = chip_smoke._fixture_tool()
    seeded = f.port_leaves(f.seeded_qnet_params(
        one["params"]["dense1.weight"].shape[1], f.DQN_HIDDEN,
        one["params"]["head.weight"].shape[0], f.QNET_SEED))
    for name, want in one["params"].items():
        assert whole[name].shape == want.shape
        gap = chip_smoke._rel_gap(whole[name] - seeded[name], want - seeded[name])
        assert gap < change_tol(want.size), (name, gap)
    np.testing.assert_allclose(two[0]["losses"], one["losses"], rtol=5e-2)


def test_checked_step_and_debug_checks():
    assert chip_smoke.check_debug("cpu") == {"steps": 29, "boards": 32}


def test_fixture_is_up_to_date():
    saved = np.load(fixture_tool.FIXTURE_SHARDED)
    fresh = fixture_tool.record_sharded()
    assert sorted(saved.files) == sorted(fresh)
    for k, v in fresh.items():
        assert saved[k].dtype == v.dtype and np.array_equal(saved[k], v), k
