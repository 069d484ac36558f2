"""The port's specials step equals the JAX package's, exactly: the
auto-resetting ``batched_step`` (K2 and K3's plain versions with the
machinery) and ``BatchedTileMatchEnv`` against the JAX batched env
(``jax.vmap(engine.step)`` plus its auto-reset) for configs 2 and 3 at small
sizes, ``engine.step`` against ``jax.vmap(engine.step)``, and the recorded
config-3 rollout."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from tests.torch_port_helpers import INFO_FIELDS, assert_info, assert_state, policy_np
from tile_match_tpu import engine as je
from tile_match_tpu.config import EnvConfig as JaxConfig
from tile_match_tpu.envs import batched as jbat
from tile_match_tpu_torch import engine as te
from tile_match_tpu_torch import random as trandom
from tile_match_tpu_torch.config import EnvConfig
from tile_match_tpu_torch.envs import batched as tbat
from tile_match_tpu_torch.tools.parity_check import replay_fixture
from tools import make_torch_port_fixture as fixture_tool

torch.set_num_threads(1)

LASERS_BOMB = ((), ("vertical_laser", "horizontal_laser", "bomb"))  # config 2
ALL = (("cookie",), ("vertical_laser", "horizontal_laser", "bomb"))  # config 3
NO_BOMB = (("cookie",), ("vertical_laser", "horizontal_laser"))  # config 3 without the bomb


def _cfgs(R, C, K, moves, specials):
    kw = dict(colourless_specials=specials[0], colour_specials=specials[1])
    return JaxConfig.create(R, C, K, moves, **kw), EnvConfig.create(R, C, K, moves, **kw)


def _assert_ts(tts, jts, tag):
    for f in ("obs_board", "obs_moves_left", "reward", "done"):
        assert np.array_equal(getattr(tts, f).numpy(), np.asarray(getattr(jts, f))), f"{f} @ {tag}"
    assert_info(tts.info, jts.info, tag)


@pytest.mark.parametrize(
    "R,K,specials,seed",
    [(6, 3, ALL, 0), (8, 4, ALL, 1), (6, 3, LASERS_BOMB, 2)],
    ids=["cfg3-6x6", "cfg3-8x8", "cfg2-6x6"],
)
def test_batched_step_auto_reset_matches_jax(R, K, specials, seed):
    jc, tc = _cfgs(R, R, K, 4, specials)
    B = 24
    jstep = jax.jit(
        lambda s, a, m: jbat.batched_step(jc, s, a, auto_reset=True, eff_mask=m)
    )
    jstates, jts = jbat.batched_reset(jc, jax.random.PRNGKey(seed), B)
    tstates, tts = tbat.batched_reset(tc, trandom.PRNGKey(seed, "cpu"), B)
    assert_state(tstates, jstates, "reset")
    _assert_ts(tts, jts, "reset")
    for t in range(5):  # crosses the reset after move 4
        acts = policy_np(t + seed, np.asarray(jts.info.effective_actions))
        jstates, jts = jstep(jstates, jnp.asarray(acts), jts.info.effective_actions)
        tstates, tts = tbat.batched_step(
            tc, tstates, torch.from_numpy(acts), eff_mask=tts.info.effective_actions
        )
        assert_state(tstates, jstates, f"step {t}")
        _assert_ts(tts, jts, f"step {t}")


def test_batched_env_matches_jax_env():
    jc, tc = _cfgs(8, 8, 4, 3, ALL)
    jenv = jbat.BatchedTileMatchEnv(jc, 16)
    tenv = tbat.BatchedTileMatchEnv(tc, 16, device="cpu")
    jstates, jts = jenv.reset(jax.random.PRNGKey(11))
    tstates, tts = tenv.reset(trandom.PRNGKey(11, "cpu"))
    for t in range(4):
        acts = policy_np(t, np.asarray(jts.info.effective_actions))
        jstates, jts = jenv.step(jstates, jnp.asarray(acts))
        te.reset_cascade_stats()
        tstates, tts = tenv.step(tstates, torch.from_numpy(acts))
        assert_state(tstates, jstates, f"env step {t}")
        _assert_ts(tts, jts, f"env step {t}")
        assert te.cascade_stats["rounds"] >= 1


def test_engine_step_matches_jax():
    """``engine.step`` itself, with no incoming mask, on K2 and K3's plain
    versions and the machinery."""
    jc, tc = _cfgs(6, 6, 3, 10, ALL)
    B = 24
    jkeys = jax.random.split(jax.random.PRNGKey(5), B)
    jstate, jinfo = jax.vmap(lambda k: je.reset(jc, k))(jkeys)
    tstate, tinfo = te.reset(tc, torch.from_numpy(np.asarray(jkeys).astype(np.int64)))
    assert_state(tstate, jstate, "reset")
    jstep = jax.jit(jax.vmap(lambda s, a, m: je.step(jc, s, a, eff_mask=m)))
    for t in range(3):
        acts = policy_np(t, np.asarray(jinfo.effective_actions))
        jstate, jrew, jdone, jinfo = jstep(jstate, jnp.asarray(acts), jinfo.effective_actions)
        tstate, trew, tdone, tinfo = te.step(
            tc, tstate, torch.from_numpy(acts), eff_mask=tinfo.effective_actions
        )
        assert_state(tstate, jstate, f"step {t}")
        assert_info(tinfo, jinfo, f"step {t}")
        assert np.array_equal(trew.numpy(), np.asarray(jrew))


def test_specials_without_bomb_are_refused():
    """Specials without the bomb are no longer refused: ``engine.step``
    on K2's no-bomb case table equals ``jax.vmap(engine.step)``."""
    jc, tc = _cfgs(6, 6, 3, 10, NO_BOMB)
    B = 24
    jkeys = jax.random.split(jax.random.PRNGKey(8), B)
    jstate, jinfo = jax.vmap(lambda k: je.reset(jc, k))(jkeys)
    tstate, tinfo = te.reset(tc, torch.from_numpy(np.asarray(jkeys).astype(np.int64)))
    assert_state(tstate, jstate, "reset")
    jstep = jax.jit(jax.vmap(lambda s, a, m: je.step(jc, s, a, eff_mask=m)))
    te.reset_cascade_stats()
    for t in range(3):
        acts = policy_np(t, np.asarray(jinfo.effective_actions))
        jstate, jrew, _, jinfo = jstep(jstate, jnp.asarray(acts), jinfo.effective_actions)
        tstate, trew, _, tinfo = te.step(
            tc, tstate, torch.from_numpy(acts), eff_mask=tinfo.effective_actions
        )
        assert_state(tstate, jstate, f"step {t}")
        assert_info(tinfo, jinfo, f"step {t}")
        assert np.array_equal(trew.numpy(), np.asarray(jrew))
    assert te.cascade_stats["rounds"] >= 3


def test_cfg3_fixture_replays_exactly():
    d = np.load(fixture_tool.FIXTURE_CFG3)
    assert list(d["config"]) == [10, 10, 4, 30] and list(d["specials"]) == [1, 1, 1, 1]
    assert d["colour"].shape[1] == fixture_tool.BATCH_CFG3
    # the rollout exercises combinations, new specials and the reset
    assert d["is_combination_match"].any() and d["num_new_specials"].any() and d["done"].any()
    assert set(INFO_FIELDS) <= set(d.files)
    assert replay_fixture("cpu", fixture_tool.FIXTURE_CFG3) == fixture_tool.STEPS_CFG3


def test_nobomb_fixture_replays_and_records():
    """The recorded no-bomb rollout (the JAX machinery's, on the CPU)
    replays through the port, and the tool still writes the same arrays."""
    d = np.load(fixture_tool.FIXTURE_NOBOMB)
    assert list(d["config"]) == [10, 10, 4, 30] and list(d["specials"]) == [1, 1, 1, 0]
    assert d["num_new_specials"].any() and d["is_combination_match"].any() and d["done"].any()
    assert replay_fixture("cpu", fixture_tool.FIXTURE_NOBOMB) == fixture_tool.STEPS_CFG3
    fresh = fixture_tool.record(fixture_tool.BATCH_CFG3, fixture_tool.STEPS_CFG3,
                                fixture_tool.SPECIALS_NOBOMB)
    assert sorted(fresh) == sorted(d.files)
    for k in d.files:
        assert np.array_equal(fresh[k], d[k]) and fresh[k].dtype == d[k].dtype, k
