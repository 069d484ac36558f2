"""Tabular Q-learning hyperparameter sweep (the port's
``examples/q_learning_sweep.py``).

Counterpart of the original game's ``examples/q_learning.py:125-150``
(a 400-combination pool sweep on a 3x3x2 board).  Two modes:

* ``--device``: the dense-table learner (``train_dense``) on the device,
  each combination a whole batch of envs;
* default: the host dict-table agent through the Gymnasium adapter (the
  original game's behaviour), one spawned process per combination at a
  time, up to 8.

    python -m tile_match_tpu_torch.examples.q_learning_sweep [--episodes 2000] [--quick] [--device] [--torch-device cpu]

``--device`` keeps the JAX example's meaning, so the torch device (the
card by default) is ``--torch-device`` here.
"""

import argparse
import itertools
import json
import os

import numpy as np


def execute_run(eps_decay_frac, gamma, lr, seed, num_episodes, out_root, device):
    from ..envs.gym_env import TileMatchEnv
    from ..models.q_learning import QLearningAgent, save_results, train
    from ..wrappers import ProportionRewardWrapper

    num_moves = 10
    eps_decay = int(num_episodes * num_moves * eps_decay_frac)
    env = ProportionRewardWrapper(
        TileMatchEnv(3, 3, 2, num_moves, [], [], seed=seed, rng_mode="threefry", device=device)
    )
    agent = QLearningAgent(
        lr=lr, epsilon_decay_dur=eps_decay, gamma=gamma,
        num_actions=env.unwrapped.num_actions,
        rng=np.random.default_rng(seed),
    )
    r, eff, obs_seen, agent = train(agent, env, num_episodes)
    out = os.path.join(out_root, f"gamma_{gamma}_lr_{lr}_eps_{eps_decay}_seed_{seed}")
    save_results({"r": r, "eff_a": eff, "obs_seen": obs_seen,
                  "r_auc": float(np.trapezoid(r))}, out)
    row = {"gamma": gamma, "lr": lr, "eps_decay": eps_decay, "seed": seed,
           "auc": float(np.trapezoid(r))}
    print(json.dumps(row), flush=True)
    return row


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--episodes", type=int, default=2000)
    p.add_argument("--device", action="store_true",
                   help="the dense-table learner on the device (train_dense)")
    p.add_argument("--quick", action="store_true")
    p.add_argument("--out", type=str, default="results/qlearning")
    p.add_argument("--torch-device", default=None, help="torch device (default: the CUDA card)")
    args = p.parse_args(argv)

    lrs = [0.1, 0.25] if args.quick else [0.01, 0.1, 0.25, 0.5]
    eps_fracs = [0.3] if args.quick else [0.1, 0.3, 0.5, 0.7, 0.9]
    gammas = [0.9] if args.quick else [0.7, 0.8, 0.9, 0.95, 0.99]
    seeds = [1] if args.quick else [1, 2, 3, 4]

    if args.device:
        from ..config import EnvConfig
        from ..models.q_learning import train_dense

        cfg = EnvConfig(3, 3, 2, 10)
        rows = []
        for lr, gamma in itertools.product(lrs, gammas):
            _, rewards = train_dense(
                cfg, num_steps=args.episodes, batch_size=128, lr=lr, gamma=gamma,
                device=args.torch_device,
            )
            rows.append({"lr": lr, "gamma": gamma,
                         "final_reward_mean": float(rewards[-100:].mean())})
            print(json.dumps(rows[-1]))
        return rows

    import multiprocessing as mp

    params = list(itertools.product(eps_fracs, gammas, lrs, seeds))
    with mp.get_context("spawn").Pool(min(len(params), os.cpu_count() or 1, 8)) as pool:
        return pool.starmap(
            execute_run,
            [(e, g, l, s, args.episodes, args.out, args.torch_device) for (e, g, l, s) in params],
        )


if __name__ == "__main__":
    main()
