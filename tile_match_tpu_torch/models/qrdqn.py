"""Quantile-regression DQN (counterpart of ``tile_match_tpu.models.qrdqn``).

A quantile head over the same one-hot observation as ``models.dqn``,
trained with the quantile Huber loss; Q-values are the quantile means.
"""

from __future__ import annotations

from typing import Any, NamedTuple

import torch
import torch.nn.functional as F
from torch import nn

from .. import random as trandom
from ..config import EnvConfig
from ..cuda_build import resolve_device
from ..envs.batched import batched_reset, batched_step
from ..state import EnvState
from .dqn import (
    Dense,
    _encode,
    _features,
    act_greedy_or_random,
    adam,
    epsilon_at,
    init_params,
    input_size,
    scaled_reward,
    sync_target,
)


class QuantileQNetwork(nn.Module):
    """``QNetwork``'s bfloat16 hidden layers and a float32 head of
    num_actions x num_quantiles outputs, reshaped to [B, A, Q]."""

    def __init__(self, num_actions: int, num_quantiles: int = 75, hidden: int = 512, *,
                 in_features: int, device=None):
        super().__init__()
        self.num_actions, self.num_quantiles = num_actions, num_quantiles
        self.dense1 = Dense(in_features, hidden, torch.bfloat16, device)
        self.dense2 = Dense(hidden, hidden, torch.bfloat16, device)
        self.head = Dense(hidden, num_actions * num_quantiles, torch.float32, device)

    def forward(self, board_planes: torch.Tensor, moves_left: torch.Tensor) -> torch.Tensor:
        x = F.relu(self.dense1(_features(board_planes, moves_left)))
        x = F.relu(self.dense2(x))
        return self.head(x).reshape(x.shape[0], self.num_actions, self.num_quantiles)


class QRDQNState(NamedTuple):
    params: Any  # QuantileQNetwork, trained in place
    target_params: Any  # QuantileQNetwork
    opt_state: Any  # torch.optim.Adam
    env_states: EnvState
    obs_planes: torch.Tensor
    obs_moves: torch.Tensor
    eff_mask: torch.Tensor
    step_count: int


def _take_action(theta: torch.Tensor, actions: torch.Tensor) -> torch.Tensor:
    """theta[b, actions[b], :] of theta[B, A, Q]."""
    idx = actions.long()[:, None, None].expand(-1, 1, theta.shape[2])
    return theta.gather(1, idx)[:, 0, :]


def make_qrdqn(
    cfg: EnvConfig,
    batch_size: int = 256,
    num_quantiles: int = 75,
    lr: float = 3e-4,
    gamma: float = 0.95,
    hidden: int = 512,
    target_period: int = 200,
    eps_start: float = 1.0,
    eps_end: float = 0.05,
    eps_decay_steps: int = 10_000,
    kappa: float = 1.0,
    device=None,
):
    """Returns (init_fn, train_step, act_fn) on ``device`` (the card by
    default; raises without one)."""
    device = resolve_device(device)
    # the quantile midpoints, divided on the CPU as the JAX package divides
    # them (torch's division by a scalar on the card takes the reciprocal)
    taus = ((torch.arange(num_quantiles, dtype=torch.float32) + 0.5) / num_quantiles).to(device)

    def new_net():
        return QuantileQNetwork(cfg.num_actions, num_quantiles, hidden,
                                in_features=input_size(cfg), device=device)

    def init_fn(key) -> QRDQNState:
        k = trandom.split(key.to(device), 3)
        env_states, ts = batched_reset(cfg, k[1], batch_size)
        planes, moves = _encode(cfg, env_states)
        net = init_params(new_net(), k[2])
        target = new_net()
        sync_target(target, net)
        return QRDQNState(net, target, adam(net, lr), env_states, planes, moves,
                          ts.info.effective_actions, 0)

    def act_fn(params, planes, moves, eff_mask, key, epsilon):
        with torch.no_grad():
            q = params(planes, moves).mean(-1)
        return act_greedy_or_random(q, eff_mask, key, epsilon)

    def loss_fn(params, target_params, batch):
        planes, moves, actions, rewards, dones, nplanes, nmoves, neff = batch
        theta_a = _take_action(params(planes, moves), actions)  # [B, Q]
        with torch.no_grad():
            ntheta = target_params(nplanes, nmoves)
            any_eff = neff.any(-1)
            na = torch.where(neff, ntheta.mean(-1), -torch.inf).argmax(-1)
            na = torch.where(any_eff, na, 0)
            ntheta_a = torch.where(any_eff[:, None], _take_action(ntheta, na), 0.0)
            target = rewards[:, None] + gamma * (1.0 - dones[:, None]) * ntheta_a
        # pairwise TD: u[b, i, j] = target_j - theta_i
        u = target[:, None, :] - theta_a[:, :, None]
        huber = torch.where(u.abs() <= kappa, 0.5 * u**2, kappa * (u.abs() - 0.5 * kappa))
        rho = (taus[None, :, None] - (u < 0).to(torch.float32)).abs() * huber / kappa
        return rho.sum(1).mean(), u.detach().abs().mean()

    def train_step(state: QRDQNState, key):
        k_act = trandom.split(key)[1]
        epsilon = epsilon_at(state.step_count, eps_start, eps_end, eps_decay_steps)
        actions = act_fn(state.params, state.obs_planes, state.obs_moves, state.eff_mask,
                         k_act, epsilon)
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
        opt.step()
        if state.step_count % target_period == 0:
            sync_target(state.target_params, state.params)
        new_state = state._replace(
            env_states=env_states, obs_planes=nplanes, obs_moves=nmoves,
            eff_mask=ts.info.effective_actions, step_count=state.step_count + 1,
        )
        return new_state, {"loss": loss.detach(), "td_abs": td, "reward_mean": rewards.mean(),
                           "epsilon": torch.tensor(epsilon, dtype=torch.float32)}

    return init_fn, train_step, act_fn
