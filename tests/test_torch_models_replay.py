"""The port's replay buffer and DQN with replay against the JAX package's
on the CPU: the buffer word for word (add, wrap-around, sample), ten train
steps bit for bit on the env and buffer side, and no update of the network
or of Adam's state before ``learning_starts``."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from tile_match_tpu.config import EnvConfig as JaxConfig
from tile_match_tpu.models import dqn_replay as jr
from tile_match_tpu.models import replay as jrb
from tile_match_tpu_torch.config import EnvConfig
from tile_match_tpu_torch.models import dqn as tdqn
from tile_match_tpu_torch.models import dqn_replay as tr
from tile_match_tpu_torch.models import replay as trb
from tests.torch_port_helpers import assert_changes, assert_moments, port_moments

torch.set_num_threads(1)

SIZE = (4, 4, 3, 5)
NO_SPECIALS = dict(colourless_specials=(), colour_specials=())
FIELDS = ("boards", "moves", "actions", "rewards", "dones", "next_boards", "next_moves",
          "next_eff", "ptr", "size")
STATE_FIELDS = ("colour", "kind", "timer", "key")
LR = 3e-4


def _tkey(k):
    return torch.from_numpy(np.asarray(k).astype(np.int64))


def _batch(cfg, B, seed):
    rng = np.random.default_rng(seed)
    R, C, A = cfg.num_rows, cfg.num_cols, cfg.num_actions
    return {
        "boards": rng.integers(-1, 5, size=(B, 2, R, C)).astype(np.int32),
        "moves": rng.integers(0, 6, size=B).astype(np.int32),
        "actions": rng.integers(0, A, size=B).astype(np.int32),
        "rewards": rng.random(B).astype(np.float32),
        "dones": rng.random(B) < 0.2,
        "next_boards": rng.integers(-1, 5, size=(B, 2, R, C)).astype(np.int32),
        "next_moves": rng.integers(0, 6, size=B).astype(np.int32),
        "next_eff": rng.random((B, A)) < 0.3,
    }


def _assert_buffers(trep, jrep, tag):
    for f in FIELDS:
        assert np.array_equal(np.asarray(getattr(trep, f)), np.asarray(getattr(jrep, f))), (tag, f)


@pytest.mark.parametrize("capacity,B", [(50, 12), (64, 16), (7, 7)])
def test_buffer_add_wrap_and_sample_equal_jax(capacity, B):
    """Adds past the end of the ring (ptr wraps, size caps), and samples of
    the partly and the wholly filled buffer, with the size as the tensor
    ``maxval`` of ``randint``."""
    cfg = EnvConfig.create(*SIZE)
    jrep = jrb.replay_init(JaxConfig.create(*SIZE), capacity)
    trep = trb.replay_init(cfg, capacity, "cpu")
    _assert_buffers(trep, jrep, "init")
    for i in range(6):
        batch = _batch(cfg, B, seed=i)
        jrep = jrb.replay_add(jrep, {k: jnp.asarray(v) for k, v in batch.items()})
        trep = trb.replay_add(trep, {k: torch.from_numpy(v) for k, v in batch.items()})
        _assert_buffers(trep, jrep, i)
        key = jax.random.PRNGKey(100 + i)
        want = jrb.replay_sample(jrep, key, 33)
        got = trb.replay_sample(trep, _tkey(key), 33)
        for k, v in want.items():
            assert got[k].numpy().dtype == np.asarray(v).dtype, k
            assert np.array_equal(got[k].numpy(), np.asarray(v)), (i, k)
    assert int(trep.size) == capacity


def test_sample_of_an_empty_buffer_draws_slot_0():
    cfg = EnvConfig.create(*SIZE)
    trep = trb.replay_init(cfg, 10, "cpu")
    got = trb.replay_sample(trep, _tkey(jax.random.PRNGKey(0)), 5)
    want = jrb.replay_sample(jrb.replay_init(JaxConfig.create(*SIZE), 10), jax.random.PRNGKey(0), 5)
    assert np.array_equal(got["actions"].numpy(), np.asarray(want["actions"]))


def _pair(learning_starts, capacity=80):
    kw = dict(env_batch=32, train_batch=32, replay_capacity=capacity, hidden=128,
              learning_starts=learning_starts, eps_start=1.0, eps_end=1.0)
    jinit, jstep, _ = jr.make_dqn_replay(JaxConfig.create(*SIZE, **NO_SPECIALS), **kw)
    tinit, tstep, _ = tr.make_dqn_replay(EnvConfig.create(*SIZE, **NO_SPECIALS), device="cpu", **kw)
    key, k_init = jax.random.split(jax.random.PRNGKey(4))
    js = jax.jit(jinit)(k_init)
    ts = tinit(_tkey(k_init))
    sd = tdqn.params_from_flax(jax.tree.map(np.asarray, js.params))
    ts.params.load_state_dict(sd)
    ts.target_params.load_state_dict(sd)
    return key, js, jax.jit(jstep), ts, tstep


def test_train_steps_match_jax():
    """Capacity 80 at 32 transitions a step: the buffer wraps at step 3;
    updates start at step 1 (64 transitions).  Once they do, Adam's first
    moment and each leaf's change from the carried weights against the
    JAX agent's, leaf by leaf by relative norm."""
    key, js, jstep, ts, tstep = _pair(learning_starts=64)
    w0 = ts.params.head.weight.detach().clone()
    start = {n: v.clone() for n, v in ts.params.state_dict().items()}
    for k in range(10):
        key, kk = jax.random.split(key)
        js, jm = jstep(js, kk)
        ts, tm = tstep(ts, _tkey(kk))
        for f in STATE_FIELDS:
            assert np.array_equal(getattr(ts.env_states, f).numpy(),
                                  np.asarray(getattr(js.env_states, f))), (k, f)
        _assert_buffers(ts.replay, js.replay, k)
        assert int(tm["replay_size"]) == int(jm["replay_size"])
        for name in ("loss", "td_abs"):
            np.testing.assert_allclose(float(tm[name]), float(jm[name]), rtol=5e-2)
        # step 0 holds 32 < 64 transitions: k updates after step k
        jparams = tdqn.params_from_flax(jax.tree.map(np.asarray, js.params))
        for name, want in jparams.items():
            assert (ts.params.state_dict()[name] - want).abs().max() < 3 * LR * max(k, 1)
        if k == 0:
            assert torch.equal(ts.params.head.weight, w0)
        else:
            assert_moments(port_moments(ts.params, ts.opt_state),
                           tdqn.params_from_flax(jax.tree.map(np.asarray, js.opt_state[0].mu)), k)
            assert_changes(dict(ts.params.named_parameters()), jparams, start, k)
    assert not torch.equal(ts.params.head.weight, w0)


def test_no_update_before_learning_starts():
    """Below ``learning_starts`` the loss is reported, but neither the
    network nor Adam's state moves: Adam's step count stays unset, so the
    first real update is Adam's step 1 as in the JAX package."""
    key, js, jstep, ts, tstep = _pair(learning_starts=200, capacity=400)
    before = {n: v.clone() for n, v in ts.params.state_dict().items()}
    for k in range(6):
        key, kk = jax.random.split(key)
        js, jm = jstep(js, kk)
        ts, tm = tstep(ts, _tkey(kk))
        assert np.isfinite(float(tm["loss"]))
    for n, v in ts.params.state_dict().items():
        assert torch.equal(v, before[n]), n
    assert not ts.opt_state.state
    assert int(np.asarray(js.opt_state[0].count)) == 0
    key, kk = jax.random.split(key)  # 7 x 32 = 224 >= 200: the first update
    js, _ = jstep(js, kk)
    ts, _ = tstep(ts, _tkey(kk))
    assert int(np.asarray(js.opt_state[0].count)) == 1
    assert all(float(s["step"]) == 1.0 for s in ts.opt_state.state.values())
    jparams = tdqn.params_from_flax(jax.tree.map(np.asarray, js.params))
    for name, want in jparams.items():
        assert (ts.params.state_dict()[name] - want).abs().max() < 3 * LR
    assert_moments(port_moments(ts.params, ts.opt_state),
                   tdqn.params_from_flax(jax.tree.map(np.asarray, js.opt_state[0].mu)), "first")
    assert_changes(dict(ts.params.named_parameters()), jparams, before, "first")


def test_env_batch_above_capacity_is_refused():
    with pytest.raises(ValueError, match="exceeds replay_capacity"):
        tr.make_dqn_replay(EnvConfig.create(*SIZE), env_batch=64, replay_capacity=32, device="cpu")
