"""Random-agent baseline sweep over board configurations (the port's
``examples/random_baseline.py``).

Counterpart of the original game's ``examples/random_agent.py:101-142``
sweep, batched on the device: each (rows, cols, colours, moves) config
runs thousands of episodes at once.

    python -m tile_match_tpu_torch.examples.random_baseline [--episodes 3000] [--quick] [--device cpu]
"""

import argparse
import json

import numpy as np

from ..config import EnvConfig
from ..models.random_agent import run_random, save_results

COMBOS = [
    (3, 3, 2, 5), (3, 3, 2, 10),
    (4, 4, 3, 5), (4, 4, 3, 10),
    (5, 5, 3, 5), (5, 5, 3, 10),
    (5, 5, 4, 5), (5, 5, 4, 10),
    (6, 6, 3, 10), (7, 7, 4, 10),
    (8, 8, 4, 10), (9, 9, 5, 10),
    (10, 10, 4, 10), (10, 10, 5, 10),
    (15, 15, 5, 10), (20, 20, 10, 10),
]


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--episodes", type=int, default=3000)
    p.add_argument("--batch", type=int, default=512)
    p.add_argument("--quick", action="store_true", help="first 4 configs only")
    p.add_argument("--out", type=str, default="results")
    p.add_argument("--device", default=None, help="torch device (default: the CUDA card)")
    args = p.parse_args(argv)

    combos = COMBOS[:4] if args.quick else COMBOS
    rows = []
    for (R, C, K, M) in combos:
        cfg = EnvConfig.create(R, C, K, M, [], ["vertical_laser"])
        for use_eff in (False, True):
            r, eff = run_random(
                cfg, 0, args.episodes, use_eff, batch_size=args.batch, device=args.device
            )
            out_dir = f"{args.out}/{R}_{C}_{K}_{M}_specials" + (
                "_effective_actions" if use_eff else ""
            )
            save_results((r, eff), out_dir)
            stats = {
                "config": (R, C, K, M),
                "use_effective_actions": use_eff,
                "epi_rewards_mean": float(np.mean(r)),
                "epi_rewards_std": float(np.std(r)),
                "env_eff_a_mean": float(np.mean(eff / M)),
            }
            rows.append(stats)
            print(json.dumps(stats))
    return rows


if __name__ == "__main__":
    main()
