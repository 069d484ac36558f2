"""The port's QR-DQN against the JAX package's on the CPU (4x4 boards, 3
colours, 5 moves, batch 32, hidden 128, 75 quantiles)."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from tile_match_tpu.config import EnvConfig as JaxConfig
from tile_match_tpu.models import qrdqn as jq
from tile_match_tpu_torch.config import EnvConfig
from tile_match_tpu_torch.models import dqn as tdqn
from tile_match_tpu_torch.models import qrdqn as tq
from tile_match_tpu_torch.wrappers import one_hot_board
from tests.torch_port_helpers import assert_changes, assert_moments, port_moments

torch.set_num_threads(1)

SIZE = (4, 4, 3, 5)
NO_SPECIALS = dict(colourless_specials=(), colour_specials=())
KW = dict(batch_size=32, hidden=128, eps_start=1.0, eps_end=1.0)
LR = 3e-4
STATE_FIELDS = ("colour", "kind", "timer", "key")


def _tkey(k):
    return torch.from_numpy(np.asarray(k).astype(np.int64))


def _flax_params(params):
    return tdqn.params_from_flax(jax.tree.map(np.asarray, params))


def test_quantile_network_matches_flax():
    """Carried flax weights (layers ``Dense_0..2``): rtol 2e-2, atol 2e-2."""
    jc, tc = JaxConfig.create(*SIZE), EnvConfig.create(*SIZE)
    rng = np.random.default_rng(0)
    colour = rng.integers(1, 4, size=(40, 4, 4))
    kind = rng.choice(np.array([1, 1, 2, 3, 4, -1]), size=(40, 4, 4))
    colour[kind == -1] = 0
    boards = np.stack([colour, kind], 1).astype(np.int32)
    moves = rng.integers(1, 6, size=40).astype(np.int32)
    planes = one_hot_board(tc, torch.from_numpy(boards))
    net = jq.QuantileQNetwork(num_actions=jc.num_actions, num_quantiles=75, hidden=128)
    params = net.init(jax.random.PRNGKey(2), jnp.asarray(planes.numpy()), jnp.asarray(moves))
    assert set(params["params"]) == {"Dense_0", "Dense_1", "Dense_2"}
    want = np.asarray(net.apply(params, jnp.asarray(planes.numpy()), jnp.asarray(moves)))
    tnet = tq.QuantileQNetwork(tc.num_actions, 75, 128, in_features=tdqn.input_size(tc))
    tnet.load_state_dict(_flax_params(params))
    with torch.no_grad():
        got = tnet(planes, torch.from_numpy(moves))
    assert tuple(got.shape) == want.shape == (40, tc.num_actions, 75)
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-2, atol=2e-2)


@pytest.fixture(scope="module")
def run():
    """Ten train steps of each package at epsilon 1 from the same key and
    carried weights; after each, the JAX state and metrics and the port's,
    with its weights, target and Adam's first moment by name."""
    jinit, jstep, _ = jq.make_qrdqn(JaxConfig.create(*SIZE, **NO_SPECIALS), **KW)
    tinit, tstep, _ = tq.make_qrdqn(EnvConfig.create(*SIZE, **NO_SPECIALS), device="cpu", **KW)
    key, k_init = jax.random.split(jax.random.PRNGKey(1))
    js = jax.jit(jinit)(k_init)
    ts = tinit(_tkey(k_init))
    start = _flax_params(js.params)
    ts.params.load_state_dict(start)
    ts.target_params.load_state_dict(start)
    jstep = jax.jit(jstep)
    steps = []
    for _ in range(10):
        key, kk = jax.random.split(key)
        js, jm = jstep(js, kk)
        ts, tm = tstep(ts, _tkey(kk))
        steps.append(dict(
            jax=js, jm=jm, port=ts, tm=tm,
            params={n: v.detach().clone() for n, v in ts.params.named_parameters()},
            target={n: v.detach().clone() for n, v in ts.target_params.named_parameters()},
            mu=port_moments(ts.params, ts.opt_state),
        ))
    return start, steps


def test_train_steps_match_jax(run):
    """Ten train steps at epsilon 1 from the same key and carried weights:
    the env side bit for bit, loss and |TD| within rtol 5e-2, each leaf's
    change from the carried weights within ``change_tol`` of JAX's by
    relative norm and the weights within 3 lr k after k steps, the target
    copied after step 0."""
    start, steps = run
    for k, s in enumerate(steps, start=1):
        js, jm, ts, tm = s["jax"], s["jm"], s["port"], s["tm"]
        for f in STATE_FIELDS:
            assert np.array_equal(getattr(ts.env_states, f).numpy(),
                                  np.asarray(getattr(js.env_states, f))), (k, f)
        assert np.array_equal(ts.eff_mask.numpy(), np.asarray(js.eff_mask))
        assert float(tm["reward_mean"]) == float(jm["reward_mean"])
        for name in ("loss", "td_abs"):
            np.testing.assert_allclose(float(tm[name]), float(jm[name]), rtol=5e-2)
        jparams = _flax_params(js.params)
        assert_changes(s["params"], jparams, start, k)
        for name, want in jparams.items():
            assert (s["params"][name] - want).abs().max() < 3 * LR * k, (k, name)
        if k == 1:
            for name, p in s["params"].items():
                assert torch.equal(p, s["target"][name])
    assert steps[-1]["port"].step_count == 10


def test_adam_first_moments_match_jax(run):
    """Adam's first moment after each step against optax's ``mu``, leaf by
    leaf, within a relative norm of ``MU_REL``: the quantile Huber loss's
    backward pass."""
    _, steps = run
    for k, s in enumerate(steps, start=1):
        assert_moments(s["mu"], _flax_params(s["jax"].opt_state[0].mu), k)
