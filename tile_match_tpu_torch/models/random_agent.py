"""Random-policy baseline on the batched env (counterpart of
``tile_match_tpu.models.random_agent``).

Per-episode returns and effective-action counts for a batch of boards at
once, drawn from threefry keys as the JAX package draws them; results
saved in the original game's JSON layout.
"""

from __future__ import annotations

import json
import os

import numpy as np
import torch

from .. import random as trandom
from ..config import EnvConfig
from ..cuda_build import resolve_device
from ..envs.batched import batched_reset, batched_step


def _step(cfg: EnvConfig, states, mask, key, use_effective: bool):
    """One step of every board under the random policy; returns (states,
    next mask, reward, key)."""
    key, ka = trandom.split(key)
    if use_effective:
        logits = torch.where(mask, 0.0, -torch.inf)
        acts = torch.where(mask.any(-1), trandom.categorical(ka, logits, axis=-1), 0)
    else:
        acts = trandom.randint(ka, mask.shape[:1], 0, cfg.num_actions)
    states, ts = batched_step(cfg, states, acts.to(torch.int32), eff_mask=mask)
    return states, ts.info.effective_actions, ts.reward, key


def run_random(
    cfg: EnvConfig,
    seed: int = 0,
    num_episodes: int = 1000,
    use_effective_actions: bool = False,
    batch_size: int = 256,
    proportion_reward: bool = True,
    device=None,
):
    """Returns (episode_returns, episode_effective_action_counts), numpy.

    Episodes are fixed length (num_moves) and auto-reset, so a T x B reward
    grid folds into episodes exactly; the effective-action count is the
    original game's accounting (the mask size of the pre-step observation
    of every step, reset included).
    """
    device = resolve_device(device)
    n_batches = -(-num_episodes // batch_size)
    all_returns, all_eff = [], []
    key = trandom.PRNGKey(seed, device)
    for _ in range(n_batches):
        key, kr = trandom.split(key)
        states, ts = batched_reset(cfg, kr, batch_size)
        mask = ts.info.effective_actions
        rewards, effs = [], [mask.sum(-1)]
        for t in range(cfg.num_moves):
            states, mask, r, key = _step(cfg, states, mask, key, use_effective_actions)
            rewards.append(r)
            if t < cfg.num_moves - 1:
                effs.append(mask.sum(-1))
        ret = torch.stack(rewards).cpu().numpy().sum(0)
        if proportion_reward:
            ret = ret / cfg.flat_size
        all_returns.append(ret)
        all_eff.append(torch.stack(effs).cpu().numpy().sum(0))
    returns = np.concatenate(all_returns)[:num_episodes]
    eff = np.concatenate(all_eff)[:num_episodes]
    return returns, eff


def save_results(results, output_dir):
    """Original-game results.json (`examples/random_agent.py:45-56`)."""
    os.makedirs(output_dir, exist_ok=True)
    r, env_eff_a = results
    with open(os.path.join(output_dir, "results.json"), "w") as f:
        json.dump(
            {
                "r": np.asarray(r).tolist(),
                "env_num_effective_actions": np.asarray(env_eff_a).tolist(),
            },
            f,
        )


def run_random_baseline(
    num_episodes,
    num_rows,
    num_cols,
    num_colours,
    num_moves,
    use_effective_actions=False,
    output_root="results",
    seed=0,
    device=None,
    **env_kwargs,
):
    cfg = EnvConfig.create(
        num_rows, num_cols, num_colours, num_moves,
        env_kwargs.pop("colourless_specials", []),
        env_kwargs.pop("colour_specials", ["vertical_laser"]),
    )
    out = f"{output_root}/{num_rows}_{num_cols}_{num_colours}_{num_moves}_specials"
    if use_effective_actions:
        out += "_effective_actions"
    results = run_random(cfg, seed, num_episodes, use_effective_actions, device=device)
    save_results(results, out)
    return results
