"""The port's scale-out layer against the JAX package's on the CPU.

* the counter offsets of ``random``: a slice of a draw equals the same
  slice of JAX's whole draw, word for word;
* ``sharded_rollout`` on one rank (a one-rank group in this process)
  equals JAX's on the 8-device virtual mesh, and on 2 and 4 ranks
  (spawned, gloo) equals one rank board for board, with each rank drawing
  only its own boards' words;
* ``sharded_train_step`` on (dp, tp) = (2, 2) for two steps from JAX's
  weights: env side bit for bit at epsilon 1, loss within rtol 5e-2 and
  each leaf's change within ``change_tol`` of JAX's ``sharded_train_step``
  (bfloat16 partial sums over tp round differently);
* ``dryrun_multichip`` over 2 and 4 ranks.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch
import torch.distributed as dist

from tile_match_tpu.config import EnvConfig as JaxConfig
from tile_match_tpu.parallel import sharding as jsharding
from tile_match_tpu_torch import entry
from tile_match_tpu_torch import random as trandom
from tile_match_tpu_torch.config import EnvConfig
from tile_match_tpu_torch.models import dqn as tdqn
from tile_match_tpu_torch.parallel import launch, make_mesh, sharded_train_step
from tests.test_torch_distributed import STATE_FIELDS, WALL, rollout_rank, train_rank
from tests.torch_port_helpers import assert_changes

torch.set_num_threads(1)

SIZE = (5, 5, 3, 4)  # every special on
BATCH, STEPS, SEED = 32, 5, 3
ACTIONS = EnvConfig(*SIZE).num_actions
TRAIN_KW = dict(batch_size=32, hidden=128, eps_start=1.0, eps_end=1.0)


@pytest.fixture(scope="module")
def one_rank():
    """A one-rank gloo group in this process (``make_mesh`` starts it) and
    its mesh; the group ends with the module."""
    mesh = make_mesh(["cpu"], dp=1, tp=1)
    yield mesh
    dist.destroy_process_group()


def _tkey(k):
    return torch.from_numpy(np.asarray(k).astype(np.int64))


@pytest.mark.parametrize("draw", ["split", "random_bits", "uniform", "categorical"])
def test_offset_draws_are_slices_of_jax_draws(draw):
    """Rows [24, 40) of a 64-row draw, computed alone from their offset."""
    key = jax.random.PRNGKey(11)
    lo, n = 24, 16
    if draw == "split":
        want = np.asarray(jax.random.split(key, 64))[lo : lo + n]
        got = trandom.split(_tkey(key), n, offset=lo).numpy()
    elif draw == "random_bits":
        want = np.asarray(jax.random.bits(key, (64, 7), jnp.uint32))[lo : lo + n]
        got = trandom.random_bits(_tkey(key), (n, 7), offset=lo * 7).numpy()
    elif draw == "uniform":
        want = np.asarray(jax.random.uniform(key, (64,)))[lo : lo + n].view(np.uint32)
        got = trandom.uniform(_tkey(key), (n,), offset=lo).numpy().view(np.uint32)
    else:
        mask = np.random.default_rng(0).random((64, ACTIONS)) < 0.2
        mask[5] = False
        logits = np.where(mask, 0.0, -np.inf).astype(np.float32)
        want = np.asarray(jax.random.categorical(key, jnp.asarray(logits), axis=-1))[lo : lo + n]
        got = trandom.categorical(_tkey(key), torch.from_numpy(logits[lo : lo + n]), axis=-1,
                                  offset=lo * ACTIONS).numpy()
    assert np.array_equal(got.astype(np.int64), want.astype(np.int64))


@pytest.fixture(scope="module")
def jax_rollouts():
    """JAX's sharded rollout on the 8-device mesh and on a 4-device one."""
    cfg = JaxConfig(*SIZE)
    out = {}
    for dp in (8, 4):
        mesh = jsharding.make_mesh(jax.devices()[:dp], dp=dp, tp=1)
        states, rew, stats = jsharding.sharded_rollout(cfg, mesh, BATCH, STEPS)(
            jax.random.PRNGKey(SEED)
        )
        out[dp] = {
            "states": {f: np.asarray(getattr(states, f)) for f in STATE_FIELDS},
            "reward": np.asarray(rew),
            "stats": {k: np.asarray(v) for k, v in stats.items()},
        }
    return out


@pytest.fixture(scope="module")
def port_one_rank(one_rank):
    return rollout_rank(1, 1, SIZE, BATCH, STEPS, SEED)


def _assert_same_boards(got, want, tag):
    assert np.array_equal(got["reward"], want["reward"]), tag
    for f in STATE_FIELDS:
        assert np.array_equal(got["states"][f], want["states"][f]), (tag, f)
    for name in ("steps_done", "trips_sum"):
        assert got["stats"][name] == want["stats"][name], (tag, name)


def test_sharded_rollout_on_one_rank_matches_jax(port_one_rank, jax_rollouts):
    _assert_same_boards(port_one_rank, jax_rollouts[8], "one rank vs JAX dp=8")
    assert port_one_rank["reward"].sum() > 0
    assert port_one_rank["stats"]["shard_max_trips"].shape == (1,)
    # the spy sees the global draws of one rank: B reset keys, B*A words
    assert port_one_rank["max_words"] == BATCH * ACTIONS
    assert port_one_rank["collectives"] == 0


@pytest.mark.parametrize("dp,tp", [(2, 1), (4, 1), (2, 2)], ids=["2x1", "4x1", "2x2"])
def test_sharded_rollout_ranks_match_one_rank(dp, tp, port_one_rank, jax_rollouts):
    """Every rank gathers the global batch equal to one rank's, board for
    board; the stats agree (``shard_max_trips`` with JAX's at dp=4), and no
    rank drew more than its own boards' words."""
    outs = launch(dp * tp, rollout_rank, dp, tp, SIZE, BATCH, STEPS, SEED, timeout=WALL)
    for rank, o in enumerate(outs):
        _assert_same_boards(o, port_one_rank, f"rank {rank} of {dp}x{tp}")
        assert o["stats"]["shard_max_trips"].shape == (dp,)
        assert np.array_equal(o["stats"]["shard_max_trips"], outs[0]["stats"]["shard_max_trips"])
        if dp == 4:
            assert np.array_equal(o["stats"]["shard_max_trips"],
                                  jax_rollouts[4]["stats"]["shard_max_trips"])
        assert o["max_words"] == BATCH // dp * ACTIONS
        assert o["collectives"] == 2  # the stats' two all_reduces over dp, none a step


@pytest.fixture(scope="module")
def jax_train():
    """Two steps of JAX's ``sharded_train_step`` on a (2, 2) mesh: its
    start weights, keys and per-step metrics, env side and weights."""
    cfg = JaxConfig(*SIZE)
    mesh = jsharding.make_mesh(jax.devices()[:4], dp=2, tp=2)
    init, step = jsharding.sharded_train_step(cfg, mesh, make_dqn_kwargs=TRAIN_KW)
    keys = [jax.random.PRNGKey(0), jax.random.PRNGKey(1), jax.random.PRNGKey(2)]
    out = []
    with mesh:
        state = init(keys[0])
        start = jax.tree.map(np.asarray, state.params)
        for k in keys[1:]:
            state, metrics = step(state, k)
            out.append({
                "metrics": {n: float(v) for n, v in metrics.items()},
                "env": {f: np.asarray(getattr(state.env_states, f)) for f in STATE_FIELDS},
                "eff": np.asarray(state.eff_mask),
                "params": tdqn.params_from_flax(jax.tree.map(np.asarray, state.params)),
            })
    return {"start": start, "keys": [np.asarray(k) for k in keys], "steps": out}


def _whole(shards: list) -> dict:
    """A whole network's state dict from its tp shards (numpy), in tp order."""
    out = {n: torch.from_numpy(v) for n, v in shards[0].items()}
    out["dense1.weight"] = torch.from_numpy(np.concatenate([s["dense1.weight"] for s in shards], 0))
    out["dense1.bias"] = torch.from_numpy(np.concatenate([s["dense1.bias"] for s in shards], 0))
    out["dense2.weight"] = torch.from_numpy(np.concatenate([s["dense2.weight"] for s in shards], 1))
    return out


def test_sharded_train_step_matches_jax(jax_train):
    outs = launch(4, train_rank, 2, 2, SIZE, TRAIN_KW, jax_train["start"], jax_train["keys"], 2,
                  timeout=WALL)
    assert [(o["dp_rank"], o["tp_rank"]) for o in outs] == [(0, 0), (0, 1), (1, 0), (1, 1)]
    start = tdqn.params_from_flax(jax_train["start"])
    for t, want in enumerate(jax_train["steps"]):
        for o in outs:
            got = o["steps"][t]
            for f in STATE_FIELDS:
                assert np.array_equal(got["env"][f], want["env"][f]), (t, f)
            assert np.array_equal(got["eff"], want["eff"]), t
            for name in ("loss", "td_abs"):
                np.testing.assert_allclose(got["metrics"][name], want["metrics"][name], rtol=5e-2)
            np.testing.assert_allclose(got["metrics"]["reward_mean"],
                                       want["metrics"]["reward_mean"], rtol=1e-6)
            assert got["metrics"]["epsilon"] == 1.0
            # three forward passes over tp (act, online, target), then the
            # gradients and the metrics over dp
            assert got["collectives"] == 5
        # the dp replicas hold equal weights; the tp shards make the network
        for tp_rank in (0, 1):
            a, b = outs[tp_rank]["steps"][t]["params"], outs[2 + tp_rank]["steps"][t]["params"]
            assert all(np.array_equal(a[n], b[n]) for n in a)
        whole = _whole([outs[0]["steps"][t]["params"], outs[1]["steps"][t]["params"]])
        assert_changes(whole, want["params"], start, t + 1)


def test_one_rank_train_step_matches_make_dqn(one_rank):
    """At (1, 1) the sharded step is ``make_dqn``'s: from the same key the
    same weights, env side, loss and weights after each step, bit for
    bit."""
    cfg = EnvConfig(*SIZE)
    init, step = sharded_train_step(cfg, one_rank, make_dqn_kwargs=TRAIN_KW)
    tinit, tstep, _ = tdqn.make_dqn(cfg, device="cpu", **TRAIN_KW)
    key = trandom.PRNGKey(5, "cpu")
    s, u = init(key), tinit(key)
    for name, v in u.params.state_dict().items():
        assert torch.equal(s.params.state_dict()[name], v), name
    for t in range(3):
        k = trandom.fold_in(key, t)
        s, m = step(s, k)
        u, mu = tstep(u, k)
        for f in STATE_FIELDS:
            assert torch.equal(getattr(s.env_states, f), getattr(u.env_states, f)), (t, f)
        assert torch.equal(s.eff_mask, u.eff_mask), t
        for name in ("loss", "td_abs", "reward_mean"):
            assert torch.equal(m[name], mu[name]), (t, name)
        for name, v in u.params.state_dict().items():
            assert torch.equal(s.params.state_dict()[name], v), (t, name)


@pytest.mark.parametrize("n", [2, 4])
def test_dryrun_multichip(n):
    entry.dryrun_multichip(n, device="cpu", timeout=WALL)
