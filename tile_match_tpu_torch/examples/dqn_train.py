"""Batched DQN training (the port's ``examples/dqn_train.py``).

Counterpart of the original game's SB3/QRDQN script
(``examples/qrdqn.py:15-67``): the env batch, masked epsilon-greedy and TD
update on the device; with ``--sharded``, ``parallel.sharded_train_step``
over ``--ranks`` ranks spawned by ``parallel.launch`` (``--tp`` of them
splitting the network's hidden layers; on one card the ranks share it
over gloo).

    python -m tile_match_tpu_torch.examples.dqn_train --steps 2000 [--rows 5 --cols 5] [--sharded [--ranks N] [--tp T]] [--device cpu]
"""

import argparse
import json

import numpy as np
import torch
import torch.distributed as dist

from .. import random as trandom
from ..config import EnvConfig
from ..cuda_build import resolve_device


def _sharded_rank(size, steps, batch, hidden, tp, device_type, log_every):
    """``sharded_train_step``'s loop on one rank; rank 0 prints."""
    from ..parallel import make_mesh, sharded_train_step
    from ..parallel.sharding import mesh_device

    n = dist.get_world_size()
    mesh = make_mesh([device_type] * n, dp=n // tp, tp=tp)
    init, step = sharded_train_step(EnvConfig(*size), mesh,
                                    make_dqn_kwargs=dict(batch_size=batch, hidden=hidden))
    key = trandom.PRNGKey(0, mesh_device(mesh))
    state = init(key)
    history = []
    for t in range(steps):
        key, k = trandom.split(key)
        state, metrics = step(state, k)
        if (t + 1) % log_every == 0 or t == steps - 1:
            history.append({k_: float(v) for k_, v in metrics.items()} | {"step": t + 1})
            if dist.get_rank() == 0:
                print(json.dumps(history[-1]), flush=True)
    return history


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--rows", type=int, default=5)
    p.add_argument("--cols", type=int, default=5)
    p.add_argument("--colours", type=int, default=3)
    p.add_argument("--moves", type=int, default=10)
    p.add_argument("--steps", type=int, default=2000)
    p.add_argument("--batch", type=int, default=256)
    p.add_argument("--hidden", type=int, default=512)
    p.add_argument("--sharded", action="store_true")
    p.add_argument("--ranks", type=int, default=None,
                   help="ranks of --sharded (default: one a card, or 1 on the CPU)")
    p.add_argument("--tp", type=int, default=1, help="ranks splitting the hidden layers")
    p.add_argument("--eval-episodes", type=int, default=64)
    p.add_argument("--device", default=None, help="torch device (default: the CUDA card)")
    args = p.parse_args(argv)

    device = resolve_device(args.device)
    size = (args.rows, args.cols, args.colours, args.moves)
    cfg = EnvConfig(*size)

    if args.sharded:
        from ..parallel import launch
        from ..parallel.distributed import default_backend

        n = args.ranks or (torch.cuda.device_count() if device.type == "cuda" else 1)
        outs = launch(n, _sharded_rank, size, args.steps, args.batch, args.hidden, args.tp,
                      device.type, 200, backend=default_backend(n, device.type))
        return outs[0]

    from ..envs.batched import batched_reset, batched_step
    from ..models.dqn import _encode, make_dqn, train

    state, history = train(
        cfg, num_steps=args.steps, batch_size=args.batch, hidden=args.hidden,
        log_every=200, device=device,
    )
    for h in history:
        print(json.dumps(h))

    # greedy evaluation
    _, _, act_fn = make_dqn(cfg, batch_size=args.eval_episodes, hidden=args.hidden, device=device)
    env_states, ts = batched_reset(cfg, trandom.PRNGKey(123, device), args.eval_episodes)
    mask = ts.info.effective_actions
    total = np.zeros(args.eval_episodes)
    for _ in range(cfg.num_moves):
        planes, moves = _encode(cfg, env_states)
        acts = act_fn(state.params, planes, moves, mask, trandom.PRNGKey(0, device), 0.0)
        env_states, ts = batched_step(cfg, env_states, acts, auto_reset=False)
        mask = ts.info.effective_actions
        total += ts.reward.cpu().numpy()
    out = {
        "eval_return_mean": float(total.mean() / cfg.flat_size),
        "eval_return_std": float(total.std() / cfg.flat_size),
    }
    print(json.dumps(out))
    return history + [out]


if __name__ == "__main__":
    main()
