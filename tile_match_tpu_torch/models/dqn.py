"""Batched deep Q-learning on the native env (counterpart of
``tile_match_tpu.models.dqn``, the JAX package's flagship model).

One train step is one batched env step (the env's kernels on the card)
followed by one Q-learning update on the fresh transitions: epsilon-greedy
actions over the effective-action mask, a Huber TD loss against a target
network, Adam.  The networks are ``nn.Module``s and the optimiser
``torch.optim.Adam``; ``DQNState`` keeps the JAX field names, with the
modules and the optimiser in place of parameter PyTrees, and
``train_step`` updates them in place.

Every random number of a train step comes from its threefry key, split as
the JAX package splits it, so the env side (actions at epsilon 1, rewards,
dones, env states) equals the JAX run bit for bit.  The network's own
numbers differ only by rounding: its initial weights are drawn from
threefry here, from flax's initialiser there (``params_from_flax`` carries
the JAX package's weights across).  The step count and epsilon are
host-side numbers, so a train step reads nothing back from the card.
"""

from __future__ import annotations

import math
from typing import Any, Callable, NamedTuple

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn

from .. import random as trandom
from ..config import EnvConfig
from ..cuda_build import resolve_device
from ..envs.batched import batched_reset, batched_step
from ..state import EnvState
from ..wrappers import one_hot_board

# flax layer names -> the port's: QNetwork names its layers, and
# QuantileQNetwork's are flax's defaults
_FLAX_NAMES = {
    "dense1": "dense1", "dense2": "dense2", "head": "head",
    "Dense_0": "dense1", "Dense_1": "dense2", "Dense_2": "head",
}
# flax's lecun_normal: a normal truncated to [-2, 2], over its own std
_TRUNC_STD = 0.87962566103423978


class Dense(nn.Module):
    """flax ``nn.Dense(features, dtype=dtype)``: float32 parameters (weight
    [out, in]); the input, weight and bias are cast to ``dtype`` and the
    product and bias add run in it."""

    def __init__(self, in_features: int, out_features: int, dtype: torch.dtype, device=None):
        super().__init__()
        self.weight = nn.Parameter(torch.zeros(out_features, in_features, device=device))
        self.bias = nn.Parameter(torch.zeros(out_features, device=device))
        self.dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.linear(x.to(self.dtype), self.weight.to(self.dtype), self.bias.to(self.dtype))


def input_size(cfg: EnvConfig) -> int:
    """Inputs of the networks: the one-hot planes (colours, then enabled
    specials) of every cell, and moves left."""
    planes = cfg.num_colours + sum(
        (cfg.cookie, cfg.vertical_laser, cfg.horizontal_laser, cfg.bomb)
    )
    return planes * cfg.flat_size + 1


def _reciprocal(n: int) -> float:
    return float(np.float32(1.0 / n))


def scaled_reward(cfg: EnvConfig, reward: torch.Tensor) -> torch.Tensor:
    """The proportional reward ``reward / cfg.flat_size`` (`wrappers.py:
    71-77`) as XLA computes it in the JAX train step, a product with the
    float32 reciprocal; on the card torch's division by a scalar does the
    same, so both devices agree."""
    return reward * _reciprocal(cfg.flat_size)


def _features(board_planes: torch.Tensor, moves_left: torch.Tensor) -> torch.Tensor:
    x = board_planes.reshape(board_planes.shape[0], -1)
    ml = moves_left[:, None].to(torch.float32) * _reciprocal(100)
    return torch.cat([x, ml], dim=-1)


class _SumOverTP(torch.autograd.Function):
    """``all_reduce`` sum over a tp group.  The gradient passes through
    unchanged: the output is replicated over tp, so each tp rank already
    holds the whole gradient of each partial sum."""

    @staticmethod
    def forward(ctx, x, group):
        x = x.clone()
        dist.all_reduce(x, group=group)
        return x

    @staticmethod
    def backward(ctx, grad):
        return grad, None


class QNetwork(nn.Module):
    """MLP over flattened one-hot planes + the moves-left scalar: two
    hidden layers in bfloat16 (float32 parameters), the head in float32 on
    the bfloat16 activations.

    With ``tp`` > 1 the hidden layers are one rank's shard of a tp group
    (``parallel.sharded_train_step``), h = hidden / tp: ``dense1`` is
    column-parallel (rows ``[t*h, (t+1)*h)`` of its weight and bias for tp
    rank t), ``dense2`` row-parallel (the same columns of its weight).
    dense2's partial products are summed over ``tp_group`` by one
    ``all_reduce`` and its bias is added once.  The head is replicated.
    ``shard_state_dict`` cuts a whole network's weights to this layout."""

    def __init__(self, num_actions: int, hidden: int = 512, *, in_features: int, tp: int = 1,
                 tp_group=None, device=None):
        super().__init__()
        if hidden % tp:
            raise ValueError(f"hidden {hidden} not divisible by tp={tp}")
        self.dense1 = Dense(in_features, hidden // tp, torch.bfloat16, device)
        self.dense2 = Dense(hidden // tp, hidden, torch.bfloat16, device)
        self.head = Dense(hidden, num_actions, torch.float32, device)
        self.tp, self.tp_group = tp, tp_group

    def forward(self, board_planes: torch.Tensor, moves_left: torch.Tensor) -> torch.Tensor:
        x = F.relu(self.dense1(_features(board_planes, moves_left)))
        x = F.relu(self.dense2(x) if self.tp == 1 else self._dense2_over_tp(x))
        return self.head(x)

    def _dense2_over_tp(self, x: torch.Tensor) -> torch.Tensor:
        d2 = self.dense2
        # products of bfloat16 operands, exact in float32; the sum over tp
        # and the bias round to bfloat16 once
        y = F.linear(x.to(d2.dtype).float(), d2.weight.to(d2.dtype).float())
        y = _SumOverTP.apply(y, self.tp_group) + d2.bias.to(d2.dtype).float()
        return y.to(d2.dtype)


def shard_state_dict(state_dict: dict, tp_rank: int, tp: int) -> dict:
    """A whole ``QNetwork``'s state dict (weights [out, in]) cut to tp rank
    ``tp_rank``'s shard of the tp layout."""
    h = state_dict["dense1.weight"].shape[0] // tp
    rows = slice(tp_rank * h, (tp_rank + 1) * h)
    out = dict(state_dict)
    out["dense1.weight"] = state_dict["dense1.weight"][rows]
    out["dense1.bias"] = state_dict["dense1.bias"][rows]
    out["dense2.weight"] = state_dict["dense2.weight"][:, rows]
    return {k: v.contiguous() for k, v in out.items()}


def init_params(net: nn.Module, key: torch.Tensor) -> nn.Module:
    """Draw ``net``'s weights from threefry key int64[2]: each ``Dense``
    layer, in order, gets one key of ``split(key, layers)``; weights as
    flax's ``lecun_normal`` (a truncated normal of variance 1 / fan-in,
    by the inverse error function of a uniform draw), biases zero."""
    layers = [m for m in net.modules() if isinstance(m, Dense)]
    keys = trandom.split(key, len(layers))
    lo, hi = math.erf(-2 / math.sqrt(2)), math.erf(2 / math.sqrt(2))
    with torch.no_grad():
        for k, layer in zip(keys, layers):
            out_f, in_f = layer.weight.shape
            u = trandom.uniform(k, (out_f, in_f), minval=lo, maxval=hi)
            z = (math.sqrt(2) * torch.erfinv(u)).clamp(-2.0, 2.0)
            layer.weight.copy_(z * (math.sqrt(1.0 / in_f) / _TRUNC_STD))
            layer.bias.zero_()
    return net


def params_from_flax(tree) -> dict:
    """The JAX package's network parameters, as nested dicts of numpy
    arrays (``jax.tree.map(np.asarray, params)``, with or without the outer
    ``"params"``), as a state dict of the port's ``QNetwork`` or
    ``QuantileQNetwork``: each ``Dense`` kernel [in, out] becomes a weight
    [out, in]."""
    tree = tree.get("params", tree)
    out = {}
    for name, layer in tree.items():
        port = _FLAX_NAMES[name]
        out[f"{port}.weight"] = torch.from_numpy(np.array(layer["kernel"], np.float32).T.copy())
        out[f"{port}.bias"] = torch.from_numpy(np.array(layer["bias"], np.float32))
    return out


def epsilon_at(step_count: int, eps_start: float, eps_end: float, eps_decay_steps: int) -> float:
    """The JAX package's linear epsilon schedule as XLA computes it in
    float32: the division by the constant as a product with its float32
    reciprocal, then one fused multiply-add (taken in float64, where the
    product of two float32 values is exact)."""
    frac = float(np.float32(step_count) * np.float32(1.0 / eps_decay_steps))
    frac = min(max(frac, 0.0), 1.0)
    span, start = float(np.float32(eps_end - eps_start)), float(np.float32(eps_start))
    return float(np.float32(frac * span + start))


class DQNState(NamedTuple):
    params: Any  # QNetwork, trained in place
    target_params: Any  # QNetwork, the target copy
    opt_state: Any  # torch.optim.Adam over params
    env_states: EnvState
    obs_planes: torch.Tensor  # float32[B, P, R, C]
    obs_moves: torch.Tensor  # int32[B]
    eff_mask: torch.Tensor  # bool[B, A]
    step_count: int


class Layout(NamedTuple):
    """One rank's part of a train step laid out over ranks
    (``parallel.sharded_train_step`` builds it): the boards ``[first,
    first + boards)`` of the global batch, with their words of every draw;
    tp rank ``tp_rank`` of ``tp`` of the network (``QNetwork``'s tp
    layout); and ``dp_mean``, the mean of a tensor over the data-parallel
    ranks, applied to the gradients and the metrics (None: one rank)."""

    first: int
    boards: int
    tp: int = 1
    tp_rank: int = 0
    tp_group: Any = None
    dp_mean: Callable[[torch.Tensor], torch.Tensor] | None = None


def _encode(cfg: EnvConfig, states: EnvState):
    return one_hot_board(cfg, states.board), cfg.num_moves - states.timer


def act_greedy_or_random(q, eff_mask, key, epsilon, offset: int = 0) -> torch.Tensor:
    """Epsilon-greedy over the effective actions: greedy over the masked
    Q, else a uniform draw among the effective actions; action 0 where a
    board has none.  ``key, k_eps, k_rand`` as the JAX ``act_fn`` splits
    them.  ``offset``: the global index of the first board, where these
    are a rank's rows of a larger batch (its words of both draws)."""
    any_eff = eff_mask.any(-1)
    greedy = torch.where(any_eff, torch.where(eff_mask, q, -torch.inf).argmax(-1), 0)
    k_eps, k_rand = trandom.split(key)
    logits = torch.where(eff_mask, 0.0, -torch.inf)
    draw = trandom.categorical(k_rand, logits, axis=-1, offset=offset * logits.shape[-1])
    random_eff = torch.where(any_eff, draw, 0)
    explore = trandom.uniform(k_eps, greedy.shape, offset=offset) < epsilon
    return torch.where(explore, random_eff, greedy).to(torch.int32)


def masked_max(q, eff_mask) -> torch.Tensor:
    """Max of ``q`` over the effective actions, 0 where a board has none."""
    best = torch.where(eff_mask, q, -torch.inf).max(-1).values
    return torch.where(eff_mask.any(-1), best, 0.0)


def td_loss(q, actions, target) -> tuple:
    """(mean Huber loss with delta 1, mean |TD|) of the taken actions' Q
    against a target that carries no gradient."""
    q_a = q.gather(1, actions.long()[:, None])[:, 0]
    td = q_a - target.detach()
    loss = F.huber_loss(td, torch.zeros_like(td), reduction="mean", delta=1.0)
    return loss, td.detach().abs().mean()


def adam(net: nn.Module, lr: float) -> torch.optim.Adam:
    """``optax.adam(lr)``."""
    return torch.optim.Adam(net.parameters(), lr=lr, betas=(0.9, 0.999), eps=1e-8)


def sync_target(target: nn.Module, net: nn.Module) -> None:
    with torch.no_grad():
        for t, p in zip(target.parameters(), net.parameters()):
            t.copy_(p)


def make_dqn(
    cfg: EnvConfig,
    batch_size: int = 256,
    lr: float = 3e-4,
    gamma: float = 0.95,
    hidden: int = 512,
    target_period: int = 200,
    eps_start: float = 1.0,
    eps_end: float = 0.05,
    eps_decay_steps: int = 10_000,
    device=None,
    layout: Layout | None = None,
):
    """Returns (init_fn, train_step, act_fn), on ``device`` (the card by
    default; raises without one).

    train_step(state, key): one env step for the whole batch + one
    Q-learning update on the freshly collected transitions (online DQN).
    ``layout``: this rank's part of a step over ranks (default: all of
    it); ``init_fn`` draws the whole network and keeps this rank's shard.
    """
    device = resolve_device(device)
    layout = layout or Layout(0, batch_size)

    def make_net(tp=layout.tp):
        return QNetwork(cfg.num_actions, hidden, in_features=input_size(cfg), tp=tp,
                        tp_group=layout.tp_group, device=device)

    def init_fn(key) -> DQNState:
        k = trandom.split(key.to(device), 3)
        env_states, ts = batched_reset(cfg, k[1], layout.boards, offset=layout.first)
        planes, moves = _encode(cfg, env_states)
        net = init_params(make_net(tp=1), k[2])
        if layout.tp > 1:
            shard = shard_state_dict(net.state_dict(), layout.tp_rank, layout.tp)
            net = make_net()
            net.load_state_dict(shard)
        target = make_net()
        sync_target(target, net)
        return DQNState(
            params=net,
            target_params=target,
            opt_state=adam(net, lr),
            env_states=env_states,
            obs_planes=planes,
            obs_moves=moves,
            eff_mask=ts.info.effective_actions,
            step_count=0,
        )

    def act_fn(params, planes, moves, eff_mask, key, epsilon):
        with torch.no_grad():
            q = params(planes, moves)
        return act_greedy_or_random(q, eff_mask, key, epsilon, offset=layout.first)

    def loss_fn(params, target_params, batch):
        planes, moves, actions, rewards, dones, nplanes, nmoves, neff = batch
        q = params(planes, moves)
        with torch.no_grad():
            nq_max = masked_max(target_params(nplanes, nmoves), neff)
            target = rewards + gamma * (1.0 - dones) * nq_max
        return td_loss(q, actions, target)

    def train_step(state: DQNState, key):
        k_act = trandom.split(key)[1]
        epsilon = epsilon_at(state.step_count, eps_start, eps_end, eps_decay_steps)
        actions = act_fn(
            state.params, state.obs_planes, state.obs_moves, state.eff_mask, k_act, epsilon
        )
        env_states, ts = batched_step(cfg, state.env_states, actions, eff_mask=state.eff_mask)
        nplanes, nmoves = _encode(cfg, env_states)
        rewards = scaled_reward(cfg, ts.reward)
        batch = (
            state.obs_planes, state.obs_moves, actions, rewards,
            ts.done.to(torch.float32), nplanes, nmoves, ts.info.effective_actions,
        )
        opt = state.opt_state
        opt.zero_grad(set_to_none=True)
        loss, td = loss_fn(state.params, state.target_params, batch)
        loss.backward()
        if layout.dp_mean is not None:
            params = list(state.params.parameters())
            grads = layout.dp_mean(torch.cat([p.grad.reshape(-1) for p in params]))
            for p, g in zip(params, grads.split([p.numel() for p in params])):
                p.grad.copy_(g.view_as(p))
        opt.step()
        if state.step_count % target_period == 0:
            sync_target(state.target_params, state.params)
        new_state = state._replace(
            env_states=env_states,
            obs_planes=nplanes,
            obs_moves=nmoves,
            eff_mask=ts.info.effective_actions,
            step_count=state.step_count + 1,
        )
        loss, reward_mean = loss.detach(), rewards.mean()
        if layout.dp_mean is not None:
            loss, td, reward_mean = layout.dp_mean(torch.stack([loss, td, reward_mean]))
        metrics = {
            "loss": loss,
            "td_abs": td,
            "reward_mean": reward_mean,
            "epsilon": torch.tensor(epsilon, dtype=torch.float32),
        }
        return new_state, metrics

    return init_fn, train_step, act_fn


def train(
    cfg: EnvConfig,
    num_steps: int = 1000,
    batch_size: int = 256,
    seed: int = 0,
    log_every: int = 200,
    device=None,
    **kwargs,
):
    """Host loop over the train step, keyed as the JAX ``train``."""
    init_fn, train_step, _ = make_dqn(cfg, batch_size=batch_size, device=device, **kwargs)
    key = trandom.PRNGKey(seed, resolve_device(device))
    key, k_init = trandom.split(key)
    state = init_fn(k_init)
    history = []
    for t in range(num_steps):
        key, k = trandom.split(key)
        state, metrics = train_step(state, k)
        if (t + 1) % log_every == 0 or t == num_steps - 1:
            m = {k_: float(v) for k_, v in metrics.items()}
            m["step"] = t + 1
            history.append(m)
    return state, history
