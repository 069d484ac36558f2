"""The port's Gym entry point equals the JAX package's: ``TileMatchEnv``
episode by episode in both RNG modes over five special sets, the golden
episodes, in-place board edits, the spaces, the wrappers and the
registration; the recorded Gym episodes replay, and the JAX engines' state
carries into the port's engines."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from tile_match_tpu.config import EnvConfig as JaxConfig
from tile_match_tpu.envs.gym_env import TileMatchEnv as JaxEnv
from tile_match_tpu.wrappers import OneHotWrapper as JaxOneHot
from tile_match_tpu.wrappers import ProportionRewardWrapper as JaxProportion
from tile_match_tpu.wrappers import one_hot_board as jax_one_hot
from tile_match_tpu_torch.config import EnvConfig
from tile_match_tpu_torch.envs.gym_env import TileMatchEnv
from tile_match_tpu_torch.interop import load_engine_state
from tile_match_tpu_torch.parity import ParityEngine
from tile_match_tpu_torch.wrappers import OneHotWrapper, ProportionRewardWrapper, one_hot_board
from tools import make_torch_port_fixture as fixture_tool

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the special sets of tests/envs/test_wrappers_diff.py
SPEC_SETS = [
    (["cookie"], ["vertical_laser", "horizontal_laser", "bomb"]),
    ([], []),
    ([], ["bomb"]),
    (["cookie"], []),
    ([], ["vertical_laser", "horizontal_laser"]),
]
FULL = SPEC_SETS[0]


def _pair(R, C, K, M, specials, seed, rng_mode, wrap=None):
    j = JaxEnv(R, C, K, M, *specials, seed=seed, rng_mode=rng_mode)
    t = TileMatchEnv(R, C, K, M, *specials, seed=seed, rng_mode=rng_mode, device="cpu")
    return (wrap[0](j), wrap[1](t)) if wrap else (j, t)


def _assert_same(out_j, out_t, tag):
    obs_j, obs_t = out_j[0], out_t[0]
    assert list(obs_j) == list(obs_t), tag
    for k in obs_j:
        assert np.array_equal(np.asarray(obs_j[k]), np.asarray(obs_t[k])), f"{k} @ {tag}"
        assert np.asarray(obs_j[k]).dtype == np.asarray(obs_t[k]).dtype, f"{k} dtype @ {tag}"
    assert out_j[1:] == out_t[1:], tag


def _play(j, t, steps, seed, tag):
    """Reset both envs, then step both with actions from the JAX env's
    effective actions, resetting when done; every output must agree."""
    out_j, out_t = j.reset(), t.reset()
    _assert_same(out_j, out_t, f"{tag} reset")
    pick = np.random.default_rng(seed)
    for s in range(steps):
        eff = out_j[-1]["effective_actions"]
        a = int(pick.choice(eff)) if eff else 0
        out_j, out_t = j.step(a), t.step(a)
        _assert_same(out_j, out_t, f"{tag} step {s}")
        if out_j[2]:
            out_j, out_t = j.reset(), t.reset()
            _assert_same(out_j, out_t, f"{tag} reset after step {s}")


@pytest.mark.parametrize("rng_mode", ["numpy", "threefry"])
@pytest.mark.parametrize("spec_i", range(len(SPEC_SETS)))
def test_gym_env_matches_jax_env(rng_mode, spec_i):
    j, t = _pair(5, 6, 4, 4, SPEC_SETS[spec_i], seed=spec_i + 3, rng_mode=rng_mode)
    assert t.engine.device == torch.device("cpu")
    _play(j, t, steps=5, seed=spec_i, tag=f"{rng_mode} {SPEC_SETS[spec_i]}")


def test_golden_episodes_replay():
    """tests/golden_episodes.json through the port's adapter, as
    tests/test_golden_episodes.py replays it through the JAX one."""
    with open(os.path.join(ROOT, "tests", "golden_episodes.json")) as f:
        episodes = json.load(f)
    for ep in episodes:
        R, C, K, M, seed = ep["config"]
        env = TileMatchEnv(R, C, K, M, ["cookie"], ["bomb", "vertical_laser", "horizontal_laser"],
                           seed=seed, device="cpu")
        obs, info = env.reset()
        assert np.array_equal(obs["board"], np.asarray(ep["reset_board"]))
        assert info["effective_actions"] == ep["reset_effective"]
        for step in ep["steps"]:
            obs, reward, done, trunc, info = env.step(step["action"])
            assert (reward, done, trunc) == (step["reward"], step["done"], False)
            assert np.array_equal(obs["board"], np.asarray(step["board"]))
            assert dict(info) == step["info"]


def test_recorded_gym_episodes_replay_and_record():
    """The recorded JAX Gym episodes replay through the port's engines
    (what the card's check runs), and the tool still records the same
    episodes (one mode here: both take a minute)."""
    sys.path.insert(0, ROOT)
    import chip_smoke

    out = chip_smoke.replay_gym("cpu")
    assert sorted(out) == sorted((m, n) for m in ("threefry", "numpy") for n, _, _ in fixture_tool.GYM_SETS)
    with open(fixture_tool.FIXTURE_GYM) as f:
        saved = [ep for ep in json.load(f) if ep["rng_mode"] == "numpy"]
    assert saved == json.loads(json.dumps(fixture_tool.record_gym(modes=("numpy",))))


@pytest.mark.parametrize("rng_mode", ["numpy", "threefry"])
def test_in_place_board_edits(rng_mode):
    """Code written for the original game edits ``env.board.board`` in
    place and asks again; both adapters honour the edit alike."""
    j, t = _pair(5, 6, 4, 4, FULL, seed=11, rng_mode=rng_mode)
    j.reset()
    t.reset()
    rng = np.random.default_rng(11)
    for trial in range(4):
        colour = rng.integers(1, 5, size=(5, 6)).astype(np.int32)
        kind = np.ones((5, 6), np.int32)
        if trial >= 1:
            r, c = rng.integers(0, 5), rng.integers(0, 6)
            k = int(rng.choice([2, 3, 4, -1]))
            kind[r, c] = k
            colour[r, c] = 0 if k == -1 else colour[r, c]
        for env in (j, t):
            env.board.board[0] = colour
            env.board.board[1] = kind
        eff = t._get_effective_actions()
        assert eff == j._get_effective_actions()
        if eff:
            _assert_same(j.step(eff[0]), t.step(eff[0]), f"{rng_mode} edit {trial}")


def test_spaces_and_protocol():
    j, t = _pair(4, 5, 3, 6, FULL, seed=2, rng_mode="numpy")
    assert t.observation_space == j.observation_space
    assert t.action_space == j.action_space
    assert t.observation_space["board"].dtype == j.observation_space["board"].dtype
    t.set_seed(9)
    j.set_seed(9)
    assert t.action_space.sample() == j.action_space.sample()
    with pytest.raises(Exception, match="reset before"):
        t.step(0)
    _assert_same(j.reset(), t.reset(), "reset")
    assert np.array_equal(t._get_obs()["board"], j._get_obs()["board"])
    assert t.board.board is t.engine.board


def test_wrappers_match_jax_wrappers():
    wraps = (lambda e: JaxProportion(JaxOneHot(e)), lambda e: ProportionRewardWrapper(OneHotWrapper(e)))
    for i, specials in enumerate(SPEC_SETS):
        j, t = _pair(4, 5, 3, 4, specials, seed=i, rng_mode="numpy", wrap=wraps)
        assert t.observation_space == j.observation_space
        _play(j, t, steps=3, seed=i, tag=f"wrapped {specials}")


@pytest.mark.parametrize("spec_i", range(len(SPEC_SETS)))
def test_one_hot_board_matches_jax(spec_i):
    colourless, colour = SPEC_SETS[spec_i]
    jc = JaxConfig.create(6, 7, 4, colourless_specials=colourless, colour_specials=colour)
    tc = EnvConfig.create(6, 7, 4, colourless_specials=colourless, colour_specials=colour)
    rng = np.random.default_rng(spec_i)
    colour_b = rng.integers(0, 5, size=(8, 6, 7)).astype(np.int32)
    kind_b = rng.choice(np.array([-1, 0, 1, 2, 3, 4], np.int32), size=(8, 6, 7))
    boards = np.stack([colour_b, kind_b], axis=1)
    want = np.asarray(jax.vmap(lambda b: jax_one_hot(jc, b))(jnp.asarray(boards)))
    got = one_hot_board(tc, torch.from_numpy(boards))
    assert got.dtype == torch.float32 and np.array_equal(got.numpy(), want)


@pytest.mark.parametrize("rng_mode", ["numpy", "threefry"])
def test_engine_state_carries_over(rng_mode):
    """A JAX engine's board and randomness, carried mid-episode into a
    fresh port engine, give the same moves from there on."""
    specials = (["cookie"], ["vertical_laser", "horizontal_laser"])
    j, t = _pair(6, 6, 4, 12, specials, seed=5, rng_mode=rng_mode)
    out_j = j.reset()
    for a in range(3):
        out_j = j.step(out_j[-1]["effective_actions"][a])
    fresh = TileMatchEnv(6, 6, 4, 12, *specials, seed=123, rng_mode=rng_mode, device="cpu")
    fresh.reset()
    rng = j.engine.np_random if rng_mode == "numpy" else np.asarray(j.engine.key)
    load_engine_state(fresh.engine, j.engine.board, rng)
    fresh.timer = j.timer
    for s in range(4):
        a = out_j[-1]["effective_actions"][s % len(out_j[-1]["effective_actions"])]
        out_j, out_t = j.step(a), fresh.step(a)
        _assert_same(out_j, out_t, f"{rng_mode} carried step {s}")
    with pytest.raises(ValueError):
        load_engine_state(fresh.engine, j.engine.board, np.zeros(2, np.int64))


def test_device_defaults_to_the_card():
    cfg = EnvConfig.create(5, 5, 3)
    if torch.cuda.is_available():
        assert ParityEngine(cfg, np.random.default_rng(0)).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            TileMatchEnv(5, 5, 3, 4, *FULL)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            TileMatchEnv(5, 5, 3, 4, *FULL, rng_mode="threefry")


def test_registration_and_import_without_gymnasium():
    import gymnasium as gym

    env = gym.make("TileMatchTorch-v0", num_rows=4, num_cols=4, num_colours=3, num_moves=2,
                   colourless_specials=[], colour_specials=[], device="cpu")
    assert isinstance(env.unwrapped, TileMatchEnv)
    env.close()
    code = (
        "import sys\n"
        "import tile_match_tpu_torch\n"
        "import tile_match_tpu_torch.parity, tile_match_tpu_torch.envs._threefry_driver\n"
        "assert 'gymnasium' not in sys.modules\n"
        "sys.modules['gymnasium'] = None\n"
        "import importlib, tile_match_tpu_torch.wrappers as w\n"
        "importlib.reload(w)\n"
        "assert w.OneHotWrapper is None and w.one_hot_board is not None\n"
        "print('ok')\n"
    )
    out = subprocess.run([sys.executable, "-c", code], env=dict(os.environ, PYTHONPATH=ROOT),
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr
