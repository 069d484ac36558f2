"""DQN with experience replay (counterpart of
``tile_match_tpu.models.dqn_replay``).

collect (batched env step) -> store (ring buffer) -> sample -> TD update,
one train step each.  Until the buffer holds ``learning_starts``
transitions the loss is computed but neither the network nor Adam's state
(its step count included) moves, as in the JAX package.
"""

from __future__ import annotations

from typing import Any, NamedTuple

import torch

from .. import random as trandom
from ..config import EnvConfig
from ..cuda_build import resolve_device
from ..envs.batched import batched_reset, batched_step
from ..state import EnvState
from ..wrappers import one_hot_board
from .dqn import (
    QNetwork,
    act_greedy_or_random,
    adam,
    epsilon_at,
    init_params,
    input_size,
    masked_max,
    scaled_reward,
    sync_target,
    td_loss,
)
from .replay import Replay, replay_add, replay_init, replay_sample


class DQNReplayState(NamedTuple):
    params: Any  # QNetwork, trained in place
    target_params: Any  # QNetwork
    opt_state: Any  # torch.optim.Adam
    env_states: EnvState
    eff_mask: torch.Tensor  # bool[B, A]
    replay: Replay
    step_count: int


def make_dqn_replay(
    cfg: EnvConfig,
    env_batch: int = 128,
    train_batch: int = 256,
    replay_capacity: int = 50_000,
    lr: float = 3e-4,
    gamma: float = 0.95,
    hidden: int = 512,
    target_period: int = 200,
    eps_start: float = 1.0,
    eps_end: float = 0.05,
    eps_decay_steps: int = 10_000,
    learning_starts: int = 500,
    device=None,
):
    """Returns (init_fn, train_step, act) on ``device`` (the card by
    default; raises without one)."""
    device = resolve_device(device)
    if env_batch > replay_capacity:
        raise ValueError(f"env_batch {env_batch} exceeds replay_capacity {replay_capacity}")

    def init_fn(key) -> DQNReplayState:
        k = trandom.split(key.to(device), 3)
        env_states, ts = batched_reset(cfg, k[1], env_batch)
        net = QNetwork(cfg.num_actions, hidden, in_features=input_size(cfg), device=device)
        init_params(net, k[2])
        target = QNetwork(cfg.num_actions, hidden, in_features=input_size(cfg), device=device)
        sync_target(target, net)
        return DQNReplayState(
            params=net,
            target_params=target,
            opt_state=adam(net, lr),
            env_states=env_states,
            eff_mask=ts.info.effective_actions,
            replay=replay_init(cfg, replay_capacity, device),
            step_count=0,
        )

    def act(params, boards, moves, eff_mask, key, epsilon):
        with torch.no_grad():
            q = params(one_hot_board(cfg, boards), moves)
        return act_greedy_or_random(q, eff_mask, key, epsilon)

    def loss_fn(params, target_params, sample):
        q = params(one_hot_board(cfg, sample["boards"]), sample["moves"])
        with torch.no_grad():
            nq = target_params(one_hot_board(cfg, sample["next_boards"]), sample["next_moves"])
            dones = sample["dones"].to(torch.float32)
            target = sample["rewards"] + gamma * (1.0 - dones) * masked_max(nq, sample["next_eff"])
        return td_loss(q, sample["actions"], target)

    def train_step(state: DQNReplayState, key):
        k = trandom.split(key, 3)
        k_act, k_samp = k[1], k[2]
        epsilon = epsilon_at(state.step_count, eps_start, eps_end, eps_decay_steps)

        boards = state.env_states.board
        moves = cfg.num_moves - state.env_states.timer
        actions = act(state.params, boards, moves, state.eff_mask, k_act, epsilon)
        env_states, ts = batched_step(cfg, state.env_states, actions, eff_mask=state.eff_mask)
        rewards = scaled_reward(cfg, ts.reward)
        replay = replay_add(
            state.replay,
            {
                "boards": boards,
                "moves": moves,
                "actions": actions,
                "rewards": rewards,
                "dones": ts.done,
                "next_boards": ts.obs_board,
                "next_moves": ts.obs_moves_left,
                "next_eff": ts.info.effective_actions,
            },
        )

        sample = replay_sample(replay, k_samp, train_batch)
        opt = state.opt_state
        opt.zero_grad(set_to_none=True)
        if replay.size >= learning_starts:
            loss, td = loss_fn(state.params, state.target_params, sample)
            loss.backward()
            opt.step()
        else:
            with torch.no_grad():
                loss, td = loss_fn(state.params, state.target_params, sample)
        if state.step_count % target_period == 0:
            sync_target(state.target_params, state.params)
        new_state = state._replace(
            env_states=env_states,
            eff_mask=ts.info.effective_actions,
            replay=replay,
            step_count=state.step_count + 1,
        )
        metrics = {
            "loss": loss.detach(),
            "td_abs": td,
            "reward_mean": rewards.mean(),
            "epsilon": torch.tensor(epsilon, dtype=torch.float32),
            "replay_size": torch.tensor(replay.size, dtype=torch.int32),
        }
        return new_state, metrics

    return init_fn, train_step, act
