"""The port's process groups on the CPU (counterpart of
``tests/parallel/test_distributed.py``): ranks spawned by
``parallel.launch`` join a gloo group through ``initialize_distributed``
and reduce a rank-local scalar with ``all_hosts_mean``; a failed or hung
rank ends the launch instead of the test run.

This module imports no JAX: the rank functions below are imported by name
in every spawned rank (``tests/test_torch_parallel.py`` launches them
too), and each rank stays a plain torch process.
"""

import os
import socket
import time

import numpy as np
import pytest
import torch
import torch.distributed as dist

from tile_match_tpu_torch import random as trandom
from tile_match_tpu_torch.config import EnvConfig
from tile_match_tpu_torch.parallel import (
    all_hosts_mean,
    gather_boards,
    initialize_distributed,
    launch,
    make_mesh,
    shard_env_batch,
    sharded_rollout,
    sharded_train_step,
)
from tile_match_tpu_torch.parallel.sharding import params_from_flax
from tile_match_tpu_torch.state import EnvState

torch.set_num_threads(1)

# every launch of these tests ends within this many seconds, or fails
WALL = 120
STATE_FIELDS = ("colour", "kind", "timer", "key")


# ---------------------------------------------------------------------------
# Rank functions (run in spawned ranks; module level, so they pickle by name)
# ---------------------------------------------------------------------------
def _mean_rank():
    return {
        "initialized": dist.is_initialized(),
        "world_size": dist.get_world_size(),
        "rank": dist.get_rank(),
        "mean": float(all_hosts_mean(torch.tensor(float(dist.get_rank() + 1)))),
    }


def _failing_rank():
    if dist.get_rank() == 1:
        raise ValueError("rank 1 fails on purpose")
    dist.all_reduce(torch.zeros(1))  # rank 0 waits here for rank 1


def _sleeping_rank():
    time.sleep(60)


class _Counting:
    """Within: every call of ``module.name`` is counted (``calls``), and
    ``record`` keeps the first argument of each."""

    def __init__(self, module, name, record=False):
        self.module, self.name, self.record = module, name, record
        self.calls, self.args = 0, []

    def __enter__(self):
        real = self.real = getattr(self.module, self.name)

        def counting(*args, **kwargs):
            self.calls += 1
            if self.record:
                self.args.append(args[0])
            return real(*args, **kwargs)

        setattr(self.module, self.name, counting)
        return self

    def __exit__(self, *exc):
        setattr(self.module, self.name, self.real)


def rollout_rank(dp, tp, size, batch, steps, seed):
    """A sharded rollout of ``EnvConfig(*size)`` on a (dp, tp) CPU mesh, the
    boards gathered; also the largest count of words any single-key draw
    asked for (a rank draws its own boards' words only) and the
    collectives the rollout made."""
    mesh = make_mesh(["cpu"] * (dp * tp), dp=dp, tp=tp)
    with _Counting(trandom, "_counters", record=True) as words, \
            _Counting(dist, "all_reduce") as collectives:
        states, rew, stats = sharded_rollout(EnvConfig(*size), mesh, batch, steps)(
            trandom.PRNGKey(seed, "cpu")
        )
    states = gather_boards(states, mesh)
    return {
        "states": {f: getattr(states, f).numpy() for f in STATE_FIELDS},
        "reward": gather_boards(rew, mesh).numpy(),
        "stats": {k: v.numpy() for k, v in stats.items()},
        "max_words": max(words.args),
        "collectives": collectives.calls,
    }


def train_rank(dp, tp, size, kwargs, flax_params, key_words, steps):
    """``sharded_train_step`` on a (dp, tp) CPU mesh from the JAX package's
    weights (``flax_params``) and keys (``key_words``: init, then a key a
    step); per step the metrics, the gathered env states and masks, and
    this rank's parameter shard, and the collectives of the step."""
    mesh = make_mesh(["cpu"] * (dp * tp), dp=dp, tp=tp)
    init, step = sharded_train_step(EnvConfig(*size), mesh, make_dqn_kwargs=kwargs)
    keys = [torch.from_numpy(np.asarray(k, np.int64)) for k in key_words]
    state = init(keys[0])
    shard = params_from_flax(flax_params, mesh)
    state.params.load_state_dict(shard)
    state.target_params.load_state_dict(shard)
    out = []
    for k in keys[1 : steps + 1]:
        with _Counting(dist, "all_reduce") as collectives:
            state, metrics = step(state, k)
        env = gather_boards(state.env_states, mesh)
        out.append({
            "collectives": collectives.calls,
            "metrics": {n: float(v) for n, v in metrics.items()},
            "env": {f: getattr(env, f).numpy() for f in STATE_FIELDS},
            "eff": gather_boards(state.eff_mask, mesh).numpy(),
            "params": {n: v.numpy().copy() for n, v in state.params.state_dict().items()},
        })
    return {"dp_rank": mesh.get_local_rank("dp"), "tp_rank": mesh.get_local_rank("tp"), "steps": out}


# ---------------------------------------------------------------------------
# Tests
# ---------------------------------------------------------------------------
def test_two_process_distributed_mean():
    outs = launch(2, _mean_rank, timeout=WALL)
    for rank, o in enumerate(outs):
        assert o["initialized"] is True
        assert o["world_size"] == 2
        assert o["rank"] == rank
        # mean of rank-local scalars 1.0 (rank 0) and 2.0 (rank 1)
        assert o["mean"] == pytest.approx(1.5)


def test_single_process_does_not_initialize(monkeypatch):
    for name in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK", "LOCAL_RANK"):
        monkeypatch.delenv(name, raising=False)
    assert initialize_distributed() is False
    assert not dist.is_initialized()
    x = torch.tensor(3.0)
    assert all_hosts_mean(x) is x


def test_initialize_distributed_needs_all_three(monkeypatch):
    """An address without the world size and rank is refused, not guessed."""
    for name in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK", "LOCAL_RANK"):
        monkeypatch.delenv(name, raising=False)
    with pytest.raises(ValueError, match="number of processes"):
        initialize_distributed("localhost:29500")
    monkeypatch.setenv("WORLD_SIZE", "2")
    with pytest.raises(ValueError, match="this process's rank"):
        initialize_distributed("localhost:29500")
    assert not dist.is_initialized()


def test_launch_raises_when_a_rank_fails():
    """Rank 1 raises while rank 0 waits in a collective: the launch
    raises at once (with the error of whichever rank it saw end first: rank
    1's, or rank 0's broken collective), and rank 0 is gone."""
    t0 = time.monotonic()
    with pytest.raises(Exception, match="terminated with the following error"):
        launch(2, _failing_rank, timeout=WALL)
    assert time.monotonic() - t0 < 50  # well before the group's 60 s timeout


def test_launch_kills_ranks_past_its_timeout():
    with pytest.raises(TimeoutError):
        launch(2, _sleeping_rank, timeout=3)


def test_make_mesh_rejects_bad_dp_tp():
    with pytest.raises(ValueError, match=r"dp\*tp = 2\*2 != 2 devices"):
        make_mesh(["cpu", "cpu"], dp=2, tp=2)
    with pytest.raises(ValueError, match=r"dp\*tp = 3\*1 != 4 devices"):
        make_mesh(["cpu"] * 4, dp=3)


def test_launch_environment_is_torchruns():
    """Each rank sees torchrun's variables and one CPU thread."""
    outs = launch(2, _environment_rank, timeout=WALL)
    for rank, o in enumerate(outs):
        assert o == {"RANK": str(rank), "WORLD_SIZE": "2", "LOCAL_RANK": str(rank),
                     "MASTER_ADDR": "localhost", "threads": 1}


def test_launch_moves_off_a_taken_port(monkeypatch):
    """A port another process holds when rank 0 binds it: the launch
    starts again on another."""
    from tile_match_tpu_torch.parallel import distributed

    with socket.socket() as held:
        held.bind(("localhost", 0))
        held.listen()
        ports = [held.getsockname()[1]]
        real = distributed._free_port
        monkeypatch.setattr(distributed, "_free_port", lambda: ports.pop() if ports else real())
        assert launch(2, _rank_of, timeout=WALL) == [0, 1]
        assert not ports


def _rank_of():
    return dist.get_rank()


def _shard_rank():
    """``shard_env_batch`` of a global state of 8 boards whose every field
    holds the board's index, on a (2, 2) mesh."""
    mesh = make_mesh(["cpu"] * 4, dp=2, tp=2)
    b = torch.arange(8, dtype=torch.int32)
    states = EnvState(colour=b[:, None, None].expand(8, 3, 3), kind=b[:, None, None].expand(8, 3, 3),
                      timer=b, key=b.long()[:, None].expand(8, 2))
    local = shard_env_batch(states, mesh)
    return {f: getattr(local, f).numpy() for f in STATE_FIELDS}


def test_shard_env_batch_takes_the_ranks_boards():
    """dp rank d holds boards [4d, 4d + 4), the same on both tp ranks."""
    outs = launch(4, _shard_rank, timeout=WALL)
    for rank, o in enumerate(outs):
        first = 4 * (rank // 2)
        for f in STATE_FIELDS:
            assert o[f].shape[0] == 4
            assert (o[f].reshape(4, -1) == np.arange(first, first + 4)[:, None]).all(), (rank, f)


def _environment_rank():
    names = ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR")
    return {**{n: os.environ[n] for n in names}, "threads": torch.get_num_threads()}
