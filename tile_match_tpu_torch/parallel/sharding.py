"""Meshes, sharded rollout and sharded DQN train step (counterpart of
``tile_match_tpu.parallel.sharding``) on ``torch.distributed``.

One rank is one process with one device.  A (dp, tp) ``DeviceMesh``
orders the ranks as the JAX package reshapes its devices: rank r is dp
rank ``r // tp`` and tp rank ``r % tp``.  The env batch is split over dp
and replicated over tp; boards are independent, so the step path carries
no collective.  The rollout's stats, the learner's gradients and metrics
reduce over dp, and the Q-network's hidden layers split over tp.

Sharding changes no board: a rank draws exactly the threefry words that
the unsharded program draws for its boards (``random``'s ``offset``), and
no others.  The collectives are ``all_reduce`` alone, which both NCCL and
gloo (on CPU and CUDA tensors) take, so two ranks may share one card over
gloo.
"""

from __future__ import annotations

import dataclasses
import functools
import inspect

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from .. import random as trandom
from ..config import EnvConfig
from ..cuda_build import resolve_device
from ..envs.batched import batched_reset, batched_step, random_effective
from ..models import dqn
from .distributed import TIMEOUT, all_hosts_mean


def make_mesh(devices=None, dp=None, tp: int = 1, axis_names=("dp", "tp")) -> DeviceMesh:
    """A (dp, tp) mesh over ranks 0..n-1, where ``devices`` holds each
    rank's device (one type for all; default: the card of every rank of
    the world).  ``dp`` defaults to n // tp.  Without a process group, a
    one-rank mesh starts a one-rank group in this process."""
    if devices is None:
        n = dist.get_world_size() if dist.is_initialized() else 1
        devices = [resolve_device(None)] * n
    types = {torch.device(d).type for d in devices}
    if len(types) != 1:
        raise ValueError(f"the ranks' devices must share one type, got {sorted(types)}")
    n = len(devices)
    if dp is None:
        dp = n // tp
    if dp * tp != n:
        raise ValueError(f"dp*tp = {dp}*{tp} != {n} devices")
    if not dist.is_initialized():
        if n != 1:
            raise RuntimeError(f"a mesh of {n} ranks needs a process group: see initialize_distributed")
        dist.init_process_group("gloo", store=dist.HashStore(), rank=0, world_size=1, timeout=TIMEOUT)
    (device_type,) = types
    if n == dist.get_world_size():
        return init_device_mesh(device_type, (dp, tp), mesh_dim_names=tuple(axis_names))
    # a mesh over the first n ranks (every rank of the world builds it)
    return DeviceMesh(device_type, torch.arange(n).reshape(dp, tp), mesh_dim_names=tuple(axis_names))


def mesh_device(mesh: DeviceMesh) -> torch.device:
    """This rank's device."""
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


def _axis(mesh: DeviceMesh, i: int):
    """(size, this rank's index, group) of mesh axis i (0: dp, 1: tp)."""
    name = mesh.mesh_dim_names[i]
    return mesh.size(i), mesh.get_local_rank(name), mesh.get_group(name)


def _slice(mesh: DeviceMesh, batch: int):
    """(dp, this rank's first board, boards a rank) of a global batch."""
    dp, d, _ = _axis(mesh, 0)
    if batch % dp:
        raise ValueError(f"global_batch {batch} not divisible by dp={dp}")
    b = batch // dp
    return dp, d * b, b


def shard_env_batch(states, mesh: DeviceMesh):
    """This rank's boards of a global batched ``EnvState`` (or tensor), on
    its device: boards ``[d*b, (d+1)*b)`` for dp rank d, b = B / dp."""
    if torch.is_tensor(states):
        _, first, b = _slice(mesh, states.shape[0])
        return states[first : first + b].to(mesh_device(mesh))
    return dataclasses.replace(states, **{
        f.name: shard_env_batch(getattr(states, f.name), mesh) for f in dataclasses.fields(states)
    })


def gather_boards(x, mesh: DeviceMesh):
    """The global batch of a per-rank tensor (or ``EnvState``) [b, ...], on
    every rank: an ``all_reduce`` sum over dp of a [dp, b, ...] zero buffer
    holding this rank's slice in its slot (gloo has no ``all_gather`` on
    CUDA tensors).  Not on the step path."""
    if not torch.is_tensor(x):
        return dataclasses.replace(x, **{
            f.name: gather_boards(getattr(x, f.name), mesh) for f in dataclasses.fields(x)
        })
    dp, d, group = _axis(mesh, 0)
    if dp == 1:
        return x
    wire = torch.int32 if x.dtype == torch.bool else x.dtype
    buf = torch.zeros((dp, *x.shape), dtype=wire, device=x.device)
    buf[d] = x
    dist.all_reduce(buf, group=group)
    return buf.to(x.dtype).reshape(dp * x.shape[0], *x.shape[1:])


def sharded_rollout(cfg: EnvConfig, mesh: DeviceMesh, global_batch: int, num_steps: int):
    """A rollout of ``global_batch`` boards split over dp, replicated over tp.

    Returns fn(key int64[2]) -> (states, per_board_reward, stats): this
    rank's boards' final ``EnvState`` and total rewards float32[b], and
    ``stats``, equal on every rank: ``steps_done`` (int32), ``trips_sum``
    (float32, cascade trips summed over boards and steps) and
    ``shard_max_trips`` (float32[dp]: per dp shard, the sum over steps of
    the largest trip count among its boards).  The JAX package's rollout
    body: reset from ``split(key, global_batch)``, then each step ``key, ka
    = split(key)`` and a uniform draw among the effective actions.  Only
    the final stats cross ranks (two ``all_reduce``s over dp).
    """
    dp, first, b = _slice(mesh, global_batch)
    _, d, group = _axis(mesh, 0)
    device = mesh_device(mesh)

    def rollout_fn(key):
        key = key.to(device)
        states, ts = batched_reset(cfg, key, b, offset=first)
        rew = torch.zeros(b, dtype=torch.float32, device=device)
        trips_sum = torch.zeros((), dtype=torch.float32, device=device)
        shard_max = torch.zeros(dp, dtype=torch.float32, device=device)
        for _ in range(num_steps):
            key, ka = trandom.split(key)
            mask = ts.info.effective_actions
            acts = random_effective(ka, ts, offset=first)
            states, ts = batched_step(cfg, states, acts, eff_mask=mask)
            trips = ts.info.cascade_trips.to(torch.float32)
            trips_sum = trips_sum + trips.sum()
            shard_max[d] += trips.max()
            rew = rew + ts.reward
        if dp > 1:
            dist.all_reduce(trips_sum, group=group)
            dist.all_reduce(shard_max, group=group)
        stats = {
            "steps_done": torch.tensor(num_steps * global_batch, dtype=torch.int32),
            "trips_sum": trips_sum,
            "shard_max_trips": shard_max,
        }
        return states, rew, stats

    return rollout_fn


def params_from_flax(tree, mesh: DeviceMesh) -> dict:
    """The JAX package's ``QNetwork`` parameters (nested dicts of numpy
    arrays, as ``dqn.params_from_flax`` takes them) as this rank's shard
    of ``QNetwork``'s tp layout."""
    tp, t, _ = _axis(mesh, 1)
    return dqn.shard_state_dict(dqn.params_from_flax(tree), t, tp)


def sharded_train_step(cfg: EnvConfig, mesh: DeviceMesh, make_dqn_kwargs=None):
    """(init, step) of ``dqn.make_dqn``'s train step laid out over a (dp,
    tp) mesh, as the JAX package lays it out.

    Env states, observations and masks: this rank's dp slice of
    ``batch_size`` boards, with its words of every draw (reset keys,
    epsilon-greedy uniforms and categorical).  The network: ``QNetwork``'s
    tp layout (dense1 column-parallel, dense2 row-parallel, head
    replicated); the target network and Adam's moments follow their
    parameters.  The loss is this rank's mean; the gradients are averaged
    over dp by one ``all_reduce`` (the shards are equal, so this is the
    gradient of the global mean), and the metrics by another.  At one rank
    this is ``make_dqn``'s step itself.  ``init(key)`` draws the whole
    network as ``make_dqn`` does and keeps this rank's shard;
    ``step(state, key)`` returns (state, metrics), the metrics equal on
    every rank.
    """
    kwargs = dict(make_dqn_kwargs or {})
    if "device" in kwargs or "layout" in kwargs:
        raise ValueError("sharded_train_step: the device and the layout are the mesh's")
    batch = kwargs.get("batch_size", inspect.signature(dqn.make_dqn).parameters["batch_size"].default)
    dp, first, b = _slice(mesh, batch)
    _, _, dp_group = _axis(mesh, 0)
    tp, t, tp_group = _axis(mesh, 1)
    dp_mean = functools.partial(all_hosts_mean, group=dp_group) if dp > 1 else None
    layout = dqn.Layout(first, b, tp, t, tp_group, dp_mean)
    init, step, _ = dqn.make_dqn(cfg, device=mesh_device(mesh), layout=layout, **kwargs)
    return init, step
