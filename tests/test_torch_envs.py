"""The port's batched env equals the JAX package's, exactly: auto-resetting
``batched_step`` and ``rollout`` against their JAX counterparts, the
recorded JAX fixture, and the state carried across through numpy."""

import dataclasses
import os

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from tests.torch_port_helpers import (
    INFO_FIELDS,
    STATE_FIELDS,
    assert_info,
    assert_state,
    cfgs,
    policy_np,
)
from tile_match_tpu.envs import batched as jbat
from tile_match_tpu_torch import random as trandom
from tile_match_tpu_torch.envs import batched as tbat
from tile_match_tpu_torch.interop import (
    info_to_numpy,
    state_from_numpy,
    state_to_numpy,
    timestep_to_numpy,
)
from tile_match_tpu_torch.tools.parity_check import replay_fixture
from tools import make_torch_port_fixture as fixture_tool

torch.set_num_threads(1)

FIXTURE = fixture_tool.FIXTURE


@pytest.mark.parametrize("pass_mask", [True, False])
def test_batched_step_auto_reset_matches_jax(pass_mask):
    jc, tc = cfgs(0)
    B = 130
    jstates, jts = jbat.batched_reset(jc, jax.random.PRNGKey(8), B)
    tstates, tts = tbat.batched_reset(tc, trandom.PRNGKey(8, "cpu"), B)
    jstep = jax.jit(
        lambda s, a, m: jbat.batched_step(jc, s, a, eff_mask=m if pass_mask else None)
    )
    for t in range(12):  # crosses the reset after move 10
        acts = policy_np(t, np.asarray(jts.info.effective_actions))
        jstates, jts = jstep(jstates, jnp.asarray(acts), jts.info.effective_actions)
        tstates, tts = tbat.batched_step(
            tc, tstates, torch.from_numpy(acts),
            eff_mask=tts.info.effective_actions if pass_mask else None,
        )
        assert_state(tstates, jstates, t)
        assert_info(tts.info, jts.info, t)
        for f in ("obs_board", "obs_moves_left", "reward", "done"):
            assert np.array_equal(getattr(tts, f).numpy(), np.asarray(getattr(jts, f))), f"{f} @ {t}"
    assert tts.reward.dtype == torch.float32


def _jax_policy(k, ts):
    mask = ts.info.effective_actions
    n = mask.sum(-1)
    pick = ((k[1] % 97).astype(jnp.int32) + 7 * jnp.arange(mask.shape[0])) % jnp.maximum(n, 1)
    hit = mask & (jnp.cumsum(mask, -1) == pick[:, None] + 1)
    return jnp.where(n > 0, jnp.argmax(hit, -1), 0).astype(jnp.int32)


def _torch_policy(k, ts):
    mask = ts.info.effective_actions
    n = mask.sum(-1)
    pick = (k[1] % 97 + 7 * torch.arange(mask.shape[0])) % n.clamp(min=1)
    hit = mask & (mask.cumsum(-1) == pick[:, None] + 1)
    return torch.where(n > 0, hit.to(torch.int32).argmax(-1), 0)


@pytest.mark.parametrize("idx,B,T", [(0, 130, 12), (1, 24, 32)])
def test_rollout_matches_jax(idx, B, T):
    jc, tc = cfgs(idx)
    jstates, jr, jd = jax.jit(
        lambda k: jbat.rollout(jc, k, B, T, policy=_jax_policy)
    )(jax.random.PRNGKey(idx + 20))
    tstates, tr, td = tbat.rollout(tc, trandom.PRNGKey(idx + 20, "cpu"), B, T, policy=_torch_policy)
    assert_state(tstates, jstates, "final")
    assert np.array_equal(tr.numpy(), np.asarray(jr))
    assert np.array_equal(td.numpy(), np.asarray(jd))
    assert td.any()  # an auto-reset happened


@pytest.mark.parametrize("idx,B,T", [(0, 130, 12), (1, 24, 32)])
def test_default_rollout_matches_jax(idx, B, T):
    """Without a policy both rollouts draw ``categorical`` over the masked
    logits from the same keys: the same boards, rewards and dones."""
    jc, tc = cfgs(idx)
    jstates, jr, jd = jax.jit(lambda k: jbat.rollout(jc, k, B, T))(jax.random.PRNGKey(idx + 40))
    tstates, tr, td = tbat.rollout(tc, trandom.PRNGKey(idx + 40, "cpu"), B, T)
    assert_state(tstates, jstates, "final")
    assert np.array_equal(tr.numpy(), np.asarray(jr))
    assert np.array_equal(td.numpy(), np.asarray(jd))


def test_batched_env_takes_the_reference_arguments():
    """``BatchedTileMatchEnv(cfg, B, False)`` as in the reference: the
    third argument is ``auto_reset``; done boards stay and keep no mask."""
    jc, tc = cfgs(0)
    jenv = jbat.BatchedTileMatchEnv(jc, 6, False)
    tenv = tbat.BatchedTileMatchEnv(tc, 6, False, device="cpu")
    assert tenv.auto_reset is False and tenv.device == torch.device("cpu")
    jstates, jts = jenv.reset(jax.random.PRNGKey(3))
    tstates, tts = tenv.reset(trandom.PRNGKey(3, "cpu"))
    for t in range(tc.num_moves):
        acts = policy_np(t, np.asarray(jts.info.effective_actions))
        jstates, jts = jenv.step(jstates, jnp.asarray(acts))
        tstates, tts = tenv.step(tstates, torch.from_numpy(acts))
        assert_state(tstates, jstates, t)
        assert_info(tts.info, jts.info, t)
    assert tts.done.all() and not tts.info.effective_actions.any()
    with pytest.raises(TypeError):
        tbat.BatchedTileMatchEnv(tc, 6, False, "cpu")


def test_rollout_default_policy_plays_effective_moves():
    _, tc = cfgs(0)
    _, rewards, dones = tbat.rollout(tc, trandom.PRNGKey(1, "cpu"), 16, 12)
    assert rewards.shape == (12, 16) and (rewards > 0).all()
    assert dones[9].all() and not dones[10].any()


def test_batched_env_matches_functional_api():
    _, tc = cfgs(0)
    env = tbat.BatchedTileMatchEnv(tc, 20, device="cpu")
    key = trandom.PRNGKey(2, "cpu")
    states, ts = env.reset(key)
    fstates, fts = tbat.batched_reset(tc, key, 20)
    acts = tbat.random_effective(key, ts)
    assert ts.info.effective_actions.gather(1, acts[:, None]).all()
    s1, t1 = env.step(states, acts)
    s2, t2 = tbat.batched_step(tc, fstates, acts)
    assert torch.equal(s1.colour, s2.colour) and torch.equal(s1.key, s2.key)
    assert torch.equal(t1.reward, t2.reward)


def test_batched_env_default_device_is_the_card(monkeypatch):
    """``device=None`` means the card: without one it raises, and nothing
    falls back to the CPU; a device passed by name still runs there."""
    _, tc = cfgs(0)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tbat.BatchedTileMatchEnv(tc, 4)
    assert tbat.BatchedTileMatchEnv(tc, 4, device="cpu").device == torch.device("cpu")


def test_interop_round_trip():
    """The JAX package's state and TimeStep, as recorded in the fixture."""
    d = np.load(FIXTURE)
    arrays = {f: d[f][0].astype(np.uint32 if f == "key" else np.int32) for f in STATE_FIELDS}
    state = state_from_numpy(device="cpu", **arrays)
    back = state_to_numpy(state)
    for f in STATE_FIELDS:
        assert back[f].dtype == arrays[f].dtype
        assert np.array_equal(back[f], arrays[f])
    _, tc = cfgs(1)
    _, tts = tbat.batched_reset(tc, trandom.PRNGKey(int(d["seed"]), "cpu"), d["colour"].shape[1])
    tsn = timestep_to_numpy(tts)
    assert set(tsn) == {f.name for f in dataclasses.fields(jbat.TimeStep)}
    assert set(tsn["info"]) == set(INFO_FIELDS)
    for f in ("obs_board", "obs_moves_left", "reward", "done"):
        assert np.array_equal(tsn[f], d[f][0])
    for f in INFO_FIELDS:
        assert np.array_equal(tsn["info"][f], d[f][0])
    assert info_to_numpy(tts.info).keys() == tsn["info"].keys()
    with pytest.raises(ValueError):
        state_from_numpy(arrays["colour"], arrays["kind"], arrays["timer"],
                         arrays["key"].astype(np.int64), "cpu")


def test_fixture_replays_exactly():
    assert replay_fixture("cpu") == 40


def test_fixture_is_up_to_date():
    saved = np.load(FIXTURE)
    fresh = fixture_tool.record()
    assert set(saved.files) == set(fresh)
    for k, v in fresh.items():
        assert saved[k].dtype == v.dtype and np.array_equal(saved[k], v), k
    assert os.path.getsize(FIXTURE) < 500_000
