"""The recorded JAX training-path fixture (``tests/data/
torch_port_fixture_dqn.npz``, written by ``tools/make_torch_port_fixture.py``)
replayed through the port on the CPU, as ``chip_smoke.py`` replays it on
the card: the draws, the first DQN train steps, the Q-network on the
seeded weights, and the entry's forward."""

import os
import sys

import numpy as np

import jax
import torch

from tile_match_tpu_torch import cuda_build
from tools import make_torch_port_fixture as fixture_tool

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
import chip_smoke  # noqa: E402

FIXTURE = fixture_tool.FIXTURE_DQN


def test_draws_equal_the_recorded_jax_draws():
    n = chip_smoke.check_draws("cpu")
    assert n["boards"] == 16384 and n["empty_rows"] == 169


def test_dqn_steps_equal_the_recorded_jax_run():
    """The first 6 of the 40 recorded train steps at batch 256, hidden 512,
    from the seeded weights: the env side bit for bit, loss and |TD|, and
    the learner after steps 1 and 5 (the card replays all 40, the learner
    after step 40 and the final state)."""
    run = chip_smoke.replay_dqn("cpu", steps=6)
    assert run["state"].step_count == 6
    assert run["gaps"]["grad"] < chip_smoke.LEARNER_GRAD_REL
    assert max(run["gaps"].values()) < chip_smoke.LEARNER_DRIFT_REL


def test_qnetwork_equals_the_recorded_flax_q():
    assert chip_smoke.check_qnet("cpu") < 2e-2


def test_entry_equals_the_recorded_jax_entry():
    assert chip_smoke.check_entry("cpu") == dict.fromkeys(cuda_build.KERNELS, 0)


def test_fixture_draws_and_q_are_up_to_date():
    """The draws and the flax Q on the stored boards, recomputed with JAX."""
    from tile_match_tpu.models.dqn import QNetwork, _encode
    from tile_match_tpu.state import EnvState

    saved = np.load(FIXTURE)
    for k, v in fixture_tool.record_draws().items():
        assert saved[k].dtype == v.dtype and np.array_equal(saved[k], v), k
    n = fixture_tool.Q_BOARDS
    final = EnvState(
        colour=jax.numpy.asarray(saved["dqn_colour"][:n].astype(np.int32)),
        kind=jax.numpy.asarray(saved["dqn_kind"][:n].astype(np.int32)),
        timer=jax.numpy.asarray(saved["dqn_timer"][:n].astype(np.int32)),
        key=jax.numpy.asarray(saved["dqn_key"][:n]),
    )
    cfg = fixture_tool.dqn_config()
    planes, moves = _encode(cfg, final)
    params = fixture_tool.seeded_qnet_params(int(np.prod(planes.shape[1:])) + 1,
                                             fixture_tool.DQN_HIDDEN, cfg.num_actions,
                                             fixture_tool.QNET_SEED)
    q = QNetwork(num_actions=cfg.num_actions, hidden=fixture_tool.DQN_HIDDEN).apply(
        jax.tree.map(jax.numpy.asarray, params), planes, moves)
    assert np.array_equal(np.asarray(q), saved["flax_q"])
    assert os.path.getsize(FIXTURE) < 400_000
