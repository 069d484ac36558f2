"""The port's tabular Q-learning against the JAX package's on the CPU: the
host agent driving each package's Gym adapter (threefry mode) builds the
same Q-table, and the dense device table equals the JAX one within 1e-5
(the scatter-add's sums may run in another order)."""

import numpy as np
import pytest

import jax
import torch

from tile_match_tpu.config import EnvConfig as JaxConfig
from tile_match_tpu.envs.gym_env import TileMatchEnv as JaxGymEnv
from tile_match_tpu.models import q_learning as jql
from tile_match_tpu.wrappers import ProportionRewardWrapper as JaxProportion
from tile_match_tpu_torch.config import EnvConfig
from tile_match_tpu_torch.envs.gym_env import TileMatchEnv
from tile_match_tpu_torch.models import q_learning as tql
from tile_match_tpu_torch.wrappers import ProportionRewardWrapper

torch.set_num_threads(1)


def _agent(module, env):
    return module.QLearningAgent(lr=0.3, epsilon_decay_dur=100, gamma=0.9,
                                 num_actions=env.unwrapped.num_actions,
                                 rng=np.random.default_rng(0))


def test_host_agent_table_equals_jax():
    """tests/test_utils_models.py's run: 3x3, 2 colours, 5 moves, no
    specials, 30 episodes."""
    jenv = JaxProportion(JaxGymEnv(3, 3, 2, 5, [], [], seed=1, rng_mode="threefry"))
    tenv = ProportionRewardWrapper(TileMatchEnv(3, 3, 2, 5, [], [], seed=1, rng_mode="threefry",
                                                device="cpu"))
    jr, jeff, jseen, jagent = jql.train(_agent(jql, jenv), jenv, num_episodes=30)
    tr, teff, tseen, tagent = tql.train(_agent(tql, tenv), tenv, num_episodes=30)
    assert np.array_equal(tr, jr) and np.array_equal(teff, jeff)
    assert dict(tseen) == dict(jseen)
    assert set(tagent.q_table) == set(jagent.q_table)
    for s, q in jagent.q_table.items():
        assert np.array_equal(tagent.q_table[s], q), s
    assert tagent.epsilon == jagent.epsilon


def test_save_results_layout(tmp_path):
    tql.save_results({"r": [1.0], "eff_a": [2], "obs_seen": {(1,): 1}, "extra": 3}, tmp_path)
    assert (tmp_path / "results.json").exists() and (tmp_path / "results.pkl").exists()


def test_dense_table_equals_jax():
    """tests/test_utils_models.py's run: EnvConfig(3, 3, 2, 5) (its default
    specials), 50 steps of 16 boards."""
    want, wr = jql.train_dense(JaxConfig(3, 3, 2, 5), num_steps=50, batch_size=16)
    got, gr = tql.train_dense(EnvConfig(3, 3, 2, 5), num_steps=50, batch_size=16, device="cpu")
    want = np.asarray(want)
    assert got.shape == want.shape and got.dtype == torch.float32
    assert np.abs(want).sum() > 0
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)
    np.testing.assert_allclose(gr, wr, rtol=1e-6)


def test_pack_state_matches_jax():
    cfg, jcfg = EnvConfig(3, 3, 2, 5), JaxConfig(3, 3, 2, 5)
    colour = np.random.default_rng(1).integers(1, 3, size=(20, 3, 3)).astype(np.int32)
    moves = np.arange(20, dtype=np.int32) % 6
    want = np.asarray(jql._pack_state(jcfg, jax.numpy.asarray(colour), jax.numpy.asarray(moves)))
    got = tql._pack_state(cfg, torch.from_numpy(colour), torch.from_numpy(moves))
    assert np.array_equal(got.numpy(), want)


def test_dense_table_guard():
    with pytest.raises(ValueError, match="too large"):
        tql.train_dense(EnvConfig(6, 6, 4, 5), num_steps=1, device="cpu")
