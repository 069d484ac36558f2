"""Tabular Q-learning (counterpart of ``tile_match_tpu.models.q_learning``).

* ``QLearningAgent`` + ``train``: host-side dict Q-table over hashed
  observations, stepping a Gymnasium env (the port's ``TileMatchEnv``) —
  the original game's example (same hyperparameters, epsilon decay,
  update rule), pure numpy.
* ``train_dense``: device-resident variant for tiny boards — the state
  packs into a base-K integer index, the Q-table is a dense [S, A] tensor,
  and a batch of boards updates it with scatter-adds every step.
"""

from __future__ import annotations

import json
import os
import pickle
from collections import defaultdict

import numpy as np
import torch

from .. import random as trandom
from ..config import EnvConfig
from ..cuda_build import resolve_device
from ..envs.batched import batched_reset, batched_step
from .dqn import scaled_reward


class QLearningAgent:
    """Epsilon-greedy tabular agent (`examples/q_learning.py:9-52`)."""

    def __init__(self, lr, epsilon_decay_dur, gamma, num_actions, rng):
        self.lr = lr
        self.epsilon_decay_dur = epsilon_decay_dur
        self.epsilon = 1.0
        self.gamma = gamma
        self.num_actions = num_actions
        self.q_table = defaultdict(
            lambda: np.zeros(self.num_actions, dtype=np.float32)
        )
        self.rng = rng

    def _key(self, obs):
        board, moves = obs["board"], obs["num_moves_left"]
        return tuple(np.asarray(board).flatten().tolist() + [int(moves)])

    def choose_action(self, obs, effective_actions=None):
        s = self._key(obs)
        if self.rng.random() < self.epsilon:
            if effective_actions:
                return int(self.rng.choice(effective_actions))
            return int(self.rng.choice(self.num_actions))
        q = self.q_table[s]
        if effective_actions:
            qs = q[effective_actions]
            return int(
                effective_actions[
                    self.rng.choice(np.flatnonzero(qs == qs.max()))
                ]
            )
        return int(self.rng.choice(np.flatnonzero(q == q.max())))

    def process_transition(self, obs, action, reward, next_obs, done):
        if self.epsilon > 0:
            self.epsilon -= 1.0 / self.epsilon_decay_dur
        s, ns = self._key(obs), self._key(next_obs)
        target = reward + self.gamma * (1 - done) * self.q_table[ns].max()
        self.q_table[s][action] += self.lr * (target - self.q_table[s][action])


def run_episode(agent, env, obs_seen):
    obs, info = env.reset()
    obs_seen[agent._key(obs)] += 1
    total, n_eff = 0.0, 0
    while True:
        action = agent.choose_action(obs)
        next_obs, reward, done, _, info = env.step(action)
        obs_seen[agent._key(next_obs)] += 1
        agent.process_transition(obs, action, reward, next_obs, done)
        n_eff += int(reward > 0)
        total += reward
        if done:
            return total, n_eff, obs_seen
        obs = next_obs


def train(agent, env, num_episodes: int = 1000):
    """`examples/q_learning.py:76-86`."""
    epi_r = np.zeros(num_episodes)
    eff = np.zeros(num_episodes)
    obs_seen = defaultdict(int)
    for i in range(num_episodes):
        r, n, obs_seen = run_episode(agent, env, obs_seen)
        epi_r[i] = r
        eff[i] = n
    return epi_r, eff, obs_seen, agent


def save_results(results, output_dir):
    """`examples/q_learning.py:88-107` layout."""
    os.makedirs(output_dir, exist_ok=True)
    json_results = {
        "epi_r": np.asarray(results["r"]).tolist(),
        "num_effective_actions": np.asarray(results["eff_a"]).tolist(),
        "num_obs_seen": len(results["obs_seen"]),
    }
    with open(os.path.join(output_dir, "results.json"), "w") as f:
        json.dump(json_results, f)
    rest = {k: v for k, v in results.items() if k not in json_results}
    with open(os.path.join(output_dir, "results.pkl"), "wb") as f:
        pickle.dump({k: v for k, v in rest.items() if k != "obs_seen"}, f)


# ---------------------------------------------------------------------------
# Device-resident dense-table variant
# ---------------------------------------------------------------------------
def _pack_state(cfg: EnvConfig, colour, moves_left):
    """Base-K packed state index (colours only; tiny no-special boards)."""
    flat = colour.reshape(colour.shape[0], -1).to(torch.int64) - 1
    # train_dense guards the table under 50M entries
    powers = cfg.num_colours ** torch.arange(cfg.flat_size, dtype=torch.int64, device=colour.device)
    board_idx = (flat * powers[None, :]).sum(-1)
    return board_idx * (cfg.num_moves + 1) + moves_left.to(torch.int64)


def dense_epsilon(i: int, batch_size: int, eps_decay: int) -> float:
    """``clip(1 - i * batch_size / eps_decay, 0, 1)`` as XLA computes it in
    float32: a product with eps_decay's float32 reciprocal fused into the
    subtraction (taken in float64, where that product is exact)."""
    recip = float(np.float32(1.0 / eps_decay))
    return min(max(float(np.float32(1.0 - float(np.float32(i * batch_size)) * recip)), 0.0), 1.0)


def _dense_step(cfg: EnvConfig, qtable, states, mask, key, eps: float, lr: float, gamma: float):
    """One epsilon-greedy step of every board and the scatter-add update of
    ``qtable`` (in place; several boards adding to one entry all count)."""
    k = trandom.split(key, 3)
    key, ke, ka = k[0], k[1], k[2]
    s_idx = _pack_state(cfg, states.colour, cfg.num_moves - states.timer)
    q_s = qtable[s_idx]
    greedy = torch.where(mask, q_s, -torch.inf).argmax(-1)
    rand_a = trandom.categorical(ka, torch.where(mask, 0.0, -torch.inf), axis=-1)
    explore = trandom.uniform(ke, greedy.shape) < eps
    acts = torch.where(mask.any(-1), torch.where(explore, rand_a, greedy), 0)

    nstates, ts = batched_step(cfg, states, acts.to(torch.int32), eff_mask=mask)
    reward = scaled_reward(cfg, ts.reward)
    ns_idx = _pack_state(cfg, nstates.colour, cfg.num_moves - nstates.timer)
    neff = ts.info.effective_actions
    nq_max = torch.where(neff, qtable[ns_idx], -torch.inf).max(-1).values
    nq_max = torch.where(neff.any(-1), nq_max, 0.0)
    target = reward + gamma * (1.0 - ts.done.to(torch.float32)) * nq_max
    td = target - qtable[s_idx, acts]
    qtable.index_put_((s_idx, acts), lr * td, accumulate=True)
    return nstates, neff, ts.reward, key


def train_dense(
    cfg: EnvConfig,
    num_steps: int = 2000,
    batch_size: int = 64,
    lr: float = 0.25,
    gamma: float = 0.9,
    eps_decay: int = 1000,
    seed: int = 0,
    device=None,
):
    """Tabular Q-learning over a dense packed-state table on ``device``.
    Returns (qtable float32[S, A], mean reward of each step, numpy)."""
    n_states = (cfg.num_colours**cfg.flat_size) * (cfg.num_moves + 1)
    if n_states > 50_000_000:
        raise ValueError(f"state space too large for dense table: {n_states}")
    device = resolve_device(device)
    qtable = torch.zeros((n_states, cfg.num_actions), dtype=torch.float32, device=device)
    key = trandom.PRNGKey(seed, device)
    key, kr = trandom.split(key)
    states, ts = batched_reset(cfg, kr, batch_size)
    mask = ts.info.effective_actions
    rewards = []
    for i in range(num_steps):
        eps = dense_epsilon(i, batch_size, eps_decay)
        states, mask, r, key = _dense_step(cfg, qtable, states, mask, key, eps, lr, gamma)
        rewards.append(r.mean())
    return qtable, torch.stack(rewards).cpu().numpy()
