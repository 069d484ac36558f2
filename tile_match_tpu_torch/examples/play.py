"""Demo episode with rendering (the port's ``examples/play.py``).

    python -m tile_match_tpu_torch.examples.play                # ANSI string rendering, random agent
    python -m tile_match_tpu_torch.examples.play --render human # pygame window (needs display)

Needs gymnasium (the Gym adapter), which the card's machine lacks: run it
with ``--device cpu`` there.
"""

import argparse

import numpy as np


def main(argv=None):
    from ..envs.gym_env import TileMatchEnv

    p = argparse.ArgumentParser()
    p.add_argument("--rows", type=int, default=8)
    p.add_argument("--cols", type=int, default=8)
    p.add_argument("--colours", type=int, default=4)
    p.add_argument("--moves", type=int, default=10)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--render", choices=["string", "human", "rgb_array"], default="string")
    p.add_argument("--device", default=None, help="torch device (default: the CUDA card)")
    args = p.parse_args(argv)

    env = TileMatchEnv(
        args.rows, args.cols, args.colours, args.moves,
        ["cookie"], ["vertical_laser", "horizontal_laser", "bomb"],
        seed=args.seed, render_mode=args.render, device=args.device,
    )
    rng = np.random.default_rng(args.seed)
    obs, info = env.reset()
    env.render()
    total = 0
    done = False
    while not done:
        action = int(rng.choice(info["effective_actions"]))
        obs, reward, done, _, info = env.step(action)
        total += reward
        print(f"action={action} reward={reward} "
              f"specials+={info['num_new_specials']} "
              f"activated={info['num_specials_activated']}")
        env.render()
    print(f"episode return: {total}")
    env.close()
    return total


if __name__ == "__main__":
    main()
