"""The port's DQN against the JAX package's on the CPU, at the sizes of
``tests/test_utils_models.py`` (4x4 boards, 3 colours, 5 moves, batch 32,
hidden 128): the same keys and the same (carried) weights give the same
env side bit for bit, and a learner within float tolerance."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from tile_match_tpu.config import EnvConfig as JaxConfig
from tile_match_tpu.models import dqn as jdqn
from tile_match_tpu_torch.config import EnvConfig
from tile_match_tpu_torch.models import dqn as tdqn
from tile_match_tpu_torch.wrappers import one_hot_board
from tests.torch_port_helpers import assert_changes, assert_moments, port_moments

torch.set_num_threads(1)

SIZE = (4, 4, 3, 5)
KW = dict(batch_size=32, hidden=128, eps_start=1.0, eps_end=1.0)
STEPS = 10
LR = 3e-4
STATE_FIELDS = ("colour", "kind", "timer", "key")


def _tkey(k):
    return torch.from_numpy(np.asarray(k).astype(np.int64))


def _flax_params(params):
    return tdqn.params_from_flax(jax.tree.map(np.asarray, params))


@pytest.fixture(scope="module")
def runs():
    """Ten train steps of each package at epsilon 1 from the same key, the
    port's networks carrying the JAX package's initial weights; per step
    the actions (by ``act_fn`` on the same inputs), state and metrics."""
    jc = JaxConfig.create(*SIZE, colourless_specials=(), colour_specials=())
    tc = EnvConfig.create(*SIZE, colourless_specials=(), colour_specials=())
    jinit, jstep, jact = jdqn.make_dqn(jc, **KW)
    tinit, tstep, tact = tdqn.make_dqn(tc, device="cpu", **KW)
    key, k_init = jax.random.split(jax.random.PRNGKey(0))
    js = jax.jit(jinit)(k_init)
    ts = tinit(_tkey(k_init))
    ts.params.load_state_dict(_flax_params(js.params))
    ts.target_params.load_state_dict(_flax_params(js.params))
    jstep, jact = jax.jit(jstep), jax.jit(jact)
    out = {"jax": [], "port": [], "start": _flax_params(js.params)}
    for _ in range(STEPS):
        key, k = jax.random.split(key)
        k_act = jax.random.split(k)[1]
        ja = jact(js.params, js.obs_planes, js.obs_moves, js.eff_mask, k_act, 1.0)
        ta = tact(ts.params, ts.obs_planes, ts.obs_moves, ts.eff_mask, _tkey(k_act), 1.0)
        js, jm = jstep(js, k)
        ts, tm = tstep(ts, _tkey(k))
        out["jax"].append(dict(
            actions=np.asarray(ja), metrics={n: float(v) for n, v in jm.items()},
            env={f: np.asarray(getattr(js.env_states, f)) for f in STATE_FIELDS},
            eff=np.asarray(js.eff_mask), planes=np.asarray(js.obs_planes),
            params=_flax_params(js.params), target=_flax_params(js.target_params),
            mu=_flax_params(js.opt_state[0].mu),
        ))
        out["port"].append(dict(
            actions=ta.numpy(), metrics={n: float(v) for n, v in tm.items()},
            env={f: getattr(ts.env_states, f).numpy() for f in STATE_FIELDS},
            eff=ts.eff_mask.numpy(), planes=ts.obs_planes.numpy(),
            params={n: v.clone() for n, v in ts.params.state_dict().items()},
            target={n: v.clone() for n, v in ts.target_params.state_dict().items()},
            mu=port_moments(ts.params, ts.opt_state),
        ))
    return out


def test_env_side_is_bit_exact(runs):
    dones = 0
    for t, (j, p) in enumerate(zip(runs["jax"], runs["port"])):
        assert p["actions"].dtype == np.int32
        assert np.array_equal(p["actions"], j["actions"]), t
        for f in STATE_FIELDS:
            assert np.array_equal(p["env"][f], j["env"][f]), (t, f)
        assert np.array_equal(p["eff"], j["eff"]), t
        assert np.array_equal(p["planes"], j["planes"]), t
        assert p["metrics"]["reward_mean"] == j["metrics"]["reward_mean"], t
        assert p["metrics"]["epsilon"] == j["metrics"]["epsilon"] == 1.0
        dones += int((p["env"]["timer"] == 0).all())
    assert dones == 2  # two auto-resets of every board in ten 5-move steps


def test_loss_and_td_within_tolerance(runs):
    for j, p in zip(runs["jax"], runs["port"]):
        for name in ("loss", "td_abs"):
            np.testing.assert_allclose(p["metrics"][name], j["metrics"][name], rtol=5e-2)


def test_adam_first_moments_match_jax(runs):
    """Adam's first moment after each step (0.1 g after step 1, then a
    running mean of the gradients) against optax's ``mu``, leaf by leaf,
    within a relative norm of ``MU_REL``: the backward pass of the Huber
    TD loss."""
    for k, (j, p) in enumerate(zip(runs["jax"], runs["port"]), start=1):
        assert_moments(p["mu"], j["mu"], k)


def test_params_within_adam_steps(runs):
    """Each leaf's change from the carried weights after k steps is within
    ``change_tol`` of the JAX package's change by relative norm: the
    direction of Adam's updates, which a gradient of the wrong sign
    reverses.  And, as each Adam step moves a weight by about lr at most,
    the weights differ by less than 3 lr k."""
    for k, (j, p) in enumerate(zip(runs["jax"], runs["port"]), start=1):
        assert_changes(p["params"], j["params"], runs["start"], k)
        for name, want in j["params"].items():
            assert (p["params"][name] - want).abs().max() < 3 * LR * k, (k, name)


def test_target_copied_after_step_0_update(runs):
    """The target takes the parameters after step 0's update (step count 0
    before its increment), then stays until step ``target_period``."""
    for run in (runs["jax"], runs["port"]):
        first, second = run[0], run[1]
        for name in first["params"]:
            assert torch.equal(torch.as_tensor(first["target"][name]),
                               torch.as_tensor(first["params"][name]))
            assert torch.equal(torch.as_tensor(second["target"][name]),
                               torch.as_tensor(first["params"][name]))
        assert not torch.equal(torch.as_tensor(second["params"]["head.weight"]),
                               torch.as_tensor(first["params"]["head.weight"]))


def _boards(cfg, B, seed):
    """Random boards with every enabled special, as int32[B, 2, R, C], and
    moves left."""
    rng = np.random.default_rng(seed)
    R, C = cfg.num_rows, cfg.num_cols
    colour = rng.integers(1, cfg.num_colours + 1, size=(B, R, C))
    kind = rng.choice(np.array([1, 1, 1, -1, 2, 3, 4]), size=(B, R, C))
    colour[kind == -1] = 0
    moves = rng.integers(1, cfg.num_moves + 1, size=B)
    return np.stack([colour, kind], 1).astype(np.int32), moves.astype(np.int32)


@pytest.mark.parametrize("specials", [True, False])
def test_qnetwork_matches_flax(specials):
    """Carried flax weights, planes of every enabled special: rtol 2e-2,
    atol 2e-2 (bfloat16 hidden layers, rounded at other places)."""
    common = {} if specials else dict(colourless_specials=(), colour_specials=())
    jc, tc = JaxConfig.create(*SIZE, **common), EnvConfig.create(*SIZE, **common)
    boards, moves = _boards(tc, 48, seed=int(specials))
    jplanes = jax.vmap(lambda b: jdqn.one_hot_board(jc, b))(jnp.asarray(boards))
    tplanes = one_hot_board(tc, torch.from_numpy(boards))
    assert np.array_equal(tplanes.numpy(), np.asarray(jplanes))
    net = jdqn.QNetwork(num_actions=jc.num_actions, hidden=128)
    params = net.init(jax.random.PRNGKey(3), jplanes, jnp.asarray(moves))
    want = np.asarray(net.apply(params, jplanes, jnp.asarray(moves)))
    tnet = tdqn.QNetwork(tc.num_actions, 128, in_features=tdqn.input_size(tc))
    tnet.load_state_dict(_flax_params(params))
    with torch.no_grad():
        got = tnet(tplanes, torch.from_numpy(moves))
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-2, atol=2e-2)


def test_greedy_actions_match_away_from_ties():
    """At epsilon 0 both act greedily over the masked Q; compared where the
    top two masked Q lie further apart than the tolerance."""
    jc = JaxConfig.create(*SIZE, colourless_specials=(), colour_specials=())
    tc = EnvConfig.create(*SIZE, colourless_specials=(), colour_specials=())
    _, _, jact = jdqn.make_dqn(jc, batch_size=64, hidden=128)
    _, _, tact = tdqn.make_dqn(tc, batch_size=64, hidden=128, device="cpu")
    boards, moves = _boards(tc, 64, seed=5)
    mask = np.random.default_rng(6).random((64, tc.num_actions)) < 0.3
    mask[::9] = False
    jplanes = jax.vmap(lambda b: jdqn.one_hot_board(jc, b))(jnp.asarray(boards))
    net = jdqn.QNetwork(num_actions=jc.num_actions, hidden=128)
    params = net.init(jax.random.PRNGKey(8), jplanes, jnp.asarray(moves))
    tnet = tdqn.QNetwork(tc.num_actions, 128, in_features=tdqn.input_size(tc))
    tnet.load_state_dict(_flax_params(params))
    k = jax.random.PRNGKey(9)
    want = np.asarray(jact(params, jplanes, jnp.asarray(moves), jnp.asarray(mask), k, 0.0))
    got = tact(tnet, one_hot_board(tc, torch.from_numpy(boards)), torch.from_numpy(moves),
               torch.from_numpy(mask), _tkey(k), 0.0).numpy()
    q = np.where(mask, np.asarray(net.apply(params, jplanes, jnp.asarray(moves))), -np.inf)
    top2 = np.sort(np.where(np.isfinite(q), q, -1e9), -1)[:, -2:]
    clear = (top2[:, 1] - top2[:, 0] > 4e-2) | ~mask.any(-1)
    assert clear.sum() > 32
    assert np.array_equal(got[clear], want[clear])
    assert (got[~mask.any(-1)] == 0).all()


def test_train_history_with_specials():
    """``train`` on the specials config of ``tests/test_utils_models.py``."""
    state, history = tdqn.train(EnvConfig(*SIZE), num_steps=12, batch_size=32, hidden=128,
                                log_every=5, device="cpu")
    assert [h["step"] for h in history] == [5, 10, 12]
    assert all(np.isfinite(h["loss"]) for h in history)
    assert state.step_count == 12 and 0.0 < history[-1]["epsilon"] < 1.0


def test_init_is_seeded_and_lecun_scaled():
    """The initial weights come from the key alone: equal for one key,
    different for another, with variance about 1 / fan-in."""
    tc = EnvConfig.create(*SIZE, colourless_specials=(), colour_specials=())
    nets = []
    for seed in (1, 1, 2):
        net = tdqn.QNetwork(tc.num_actions, 128, in_features=tdqn.input_size(tc))
        tdqn.init_params(net, torch.tensor([0, seed], dtype=torch.int64))
        nets.append(net)
    assert torch.equal(nets[0].dense2.weight, nets[1].dense2.weight)
    assert not torch.equal(nets[0].dense2.weight, nets[2].dense2.weight)
    w = nets[0].dense2.weight.detach()
    assert w.abs().max() <= 2.0 / np.sqrt(128) / 0.8796 + 1e-6
    assert abs(float(w.var()) * 128 - 1.0) < 0.1
    assert not nets[0].head.bias.any()


def test_default_device_is_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tdqn.make_dqn(EnvConfig(*SIZE))


def test_epsilon_schedules_follow_xla_float32():
    """The host-side epsilons equal what XLA computes for the JAX
    package's expressions (``models/dqn.py:131-132``,
    ``models/q_learning.py:136``) on the CPU, bit for bit."""
    from tile_match_tpu_torch.models import q_learning as tql

    for decay, start, end in ((10_000, 1.0, 0.05), (333, 0.9, 0.1)):
        f = jax.jit(jax.vmap(lambda sc: start + jnp.clip(sc / decay, 0.0, 1.0) * (end - start)))
        sc = np.arange(0, decay + 50, dtype=np.int32)
        want = np.asarray(f(sc))
        got = np.array([tdqn.epsilon_at(int(s), start, end, decay) for s in sc], np.float32)
        assert np.array_equal(got, want)
    g = jax.jit(jax.vmap(lambda si: jnp.clip(1.0 - si / 1000, 0.0, 1.0)))
    steps = np.arange(0, 80, dtype=np.int32)
    want = np.asarray(g(steps.astype(np.float32) * 16))
    got = np.array([tql.dense_epsilon(int(i), 16, 1000) for i in steps], np.float32)
    assert np.array_equal(got, want)


@pytest.mark.parametrize("R,C", [(4, 4), (5, 5), (6, 6), (10, 10), (20, 20)])
def test_scaled_reward_follows_xla_float32(R, C):
    """``reward / flat_size`` inside the JAX train step is a product with
    the float32 reciprocal (XLA's rewrite); the port computes that product
    on either device."""
    cfg = EnvConfig.create(R, C, 3, colourless_specials=(), colour_specials=())
    r = np.arange(0, 4 * R * C, dtype=np.float32)
    want = np.asarray(jax.jit(lambda x: x / cfg.flat_size)(r))
    got = tdqn.scaled_reward(cfg, torch.from_numpy(r)).numpy()
    assert np.array_equal(got, want)
