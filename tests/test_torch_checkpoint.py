"""Checkpoint / resume of the port (as ``tests/test_aux_subsystems.py``
does for the JAX package): a restored state reproduces the exact future
trajectory — for an env state, and for a whole agent state (networks,
Adam's state, env states, observation, mask, replay buffer, step count)."""

import dataclasses

import numpy as np
import pytest

import jax
import torch

from tile_match_tpu.checkpoint import restore_env_state as jax_restore
from tile_match_tpu.checkpoint import save_env_state as jax_save
from tile_match_tpu.config import EnvConfig as JaxConfig
from tile_match_tpu.engine import reset as jax_reset
from tile_match_tpu_torch import random as trandom
from tile_match_tpu_torch.checkpoint import (
    restore_env_state,
    restore_pytree,
    save_env_state,
    save_pytree,
)
from tile_match_tpu_torch.config import EnvConfig
from tile_match_tpu_torch.engine import reset, step
from tile_match_tpu_torch.interop import state_to_numpy
from tile_match_tpu_torch.models import dqn, dqn_replay

torch.set_num_threads(1)

CFG = EnvConfig(5, 5, 3, 6)
SMALL = EnvConfig.create(4, 4, 3, 5, colourless_specials=(), colour_specials=())


def test_env_state_resume_exact(tmp_path):
    st, info = reset(CFG, trandom.split(trandom.PRNGKey(0, "cpu"), 8))
    a = info.effective_actions.to(torch.int64).argmax(-1)
    st1, r1, d1, i1 = step(CFG, st, a)
    path = str(tmp_path / "ck.pt")
    save_env_state(path, st)
    st_restored = restore_env_state(path, st)
    st2, r2, d2, i2 = step(CFG, st_restored, a)
    for f in dataclasses.fields(st1):
        assert torch.equal(getattr(st1, f.name), getattr(st2, f.name)), f.name
    assert torch.equal(r1, r2) and torch.equal(i1.effective_actions, i2.effective_actions)


def test_env_state_restores_a_jax_checkpoint_state(tmp_path):
    """The JAX package's checkpointed board, carried through numpy, resets
    to the same state as the port's: same keys, same boards."""
    jst, _ = jax.jit(lambda k: jax_reset(JaxConfig(5, 5, 3, 6), k))(jax.random.PRNGKey(0))
    jax_save(str(tmp_path / "jax_ck"), jst)
    back = jax_restore(str(tmp_path / "jax_ck"), jax.tree.map(np.asarray, jst))
    st, _ = reset(CFG, trandom.PRNGKey(0, "cpu")[None])
    got = state_to_numpy(st)
    for f in ("colour", "kind", "timer", "key"):
        assert np.array_equal(got[f][0], np.asarray(getattr(back, f))), f


def test_restore_checks_shapes(tmp_path):
    st, _ = reset(CFG, trandom.split(trandom.PRNGKey(1, "cpu"), 4))
    save_env_state(str(tmp_path / "ck.pt"), st)
    other, _ = reset(CFG, trandom.split(trandom.PRNGKey(1, "cpu"), 5))
    with pytest.raises(ValueError, match="expected"):
        restore_env_state(str(tmp_path / "ck.pt"), other)


def _run(train_step, state, key, steps):
    for _ in range(steps):
        key, k = trandom.split(key)
        state, metrics = train_step(state, k)
    return state, metrics


def _snapshot(state):
    out = {f"env.{f}": getattr(state.env_states, f).clone() for f in ("colour", "kind", "timer", "key")}
    out.update({f"net.{n}": v.clone() for n, v in state.params.state_dict().items()})
    out.update({f"target.{n}": v.clone() for n, v in state.target_params.state_dict().items()})
    for i, s in enumerate(state.opt_state.state.values()):
        out.update({f"adam{i}.{n}": v.clone() for n, v in s.items()})
    out["mask"] = state.eff_mask.clone()
    return out


@pytest.mark.parametrize("agent", ["dqn", "dqn_replay"])
def test_agent_state_resume_exact(tmp_path, agent):
    """Save after 3 steps, run 4, restore into the same modules, run the
    same 4: every tensor of the state equal (torch.equal)."""
    if agent == "dqn":
        init_fn, train_step, _ = dqn.make_dqn(SMALL, batch_size=16, hidden=32, target_period=5,
                                              device="cpu")
    else:
        init_fn, train_step, _ = dqn_replay.make_dqn_replay(
            SMALL, env_batch=16, train_batch=16, replay_capacity=40, hidden=32,
            target_period=5, learning_starts=32, device="cpu")
    key, k_init = trandom.split(trandom.PRNGKey(3, "cpu"))
    state, _ = _run(train_step, init_fn(k_init), key, 3)
    path = str(tmp_path / "agent.pt")
    save_pytree(path, state)
    a, ma = _run(train_step, state, key, 4)
    snap_a = _snapshot(a)
    b = restore_pytree(path, state)
    assert b.step_count == 3
    b, mb = _run(train_step, b, key, 4)
    snap_b = _snapshot(b)
    assert snap_a.keys() == snap_b.keys() and any(k.startswith("adam") for k in snap_a)
    for name in snap_a:
        assert torch.equal(snap_a[name], snap_b[name]), name
    assert torch.equal(ma["loss"], mb["loss"])
    if agent == "dqn_replay":
        for f in ("boards", "actions", "rewards", "next_eff"):
            assert torch.equal(getattr(a.replay, f), getattr(b.replay, f)), f
        assert (a.replay.ptr, a.replay.size) == (b.replay.ptr, b.replay.size)
