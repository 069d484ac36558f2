"""Weak scaling of the sharded rollout over ranks (the port's
``examples/scaling.py``).

Measures batched board-steps/s at world sizes 1, 2, 4, ... up to
``--max-ranks`` with a fixed batch a rank, each world size a
``parallel.launch`` of ranks running ``parallel.sharded_rollout``.  Ranks
take the cards there are, one each where there are enough (NCCL); else
they share them over gloo.  On one card every rank shares it, so this
measures sharding overhead — processes, collectives and the card shared
in time — not multi-chip scaling.

    python -m tile_match_tpu_torch.examples.scaling --per-device-batch 64 --steps 8 [--max-ranks 4] [--device cpu]
"""

import argparse
import json
import time

import torch
import torch.distributed as dist

from .. import random as trandom
from ..config import EnvConfig
from ..cuda_build import resolve_device


def _rank(size, per_rank_batch, steps, device_type):
    """One rank's timed rollout (after one untimed one)."""
    from ..parallel import make_mesh, sharded_rollout
    from ..parallel.sharding import mesh_device

    n = dist.get_world_size()
    mesh = make_mesh([device_type] * n, dp=n, tp=1)
    device = mesh_device(mesh)
    fn = sharded_rollout(EnvConfig(*size), mesh, per_rank_batch * n, steps)

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    fn(trandom.PRNGKey(0, device))
    sync()
    dist.barrier()
    t0 = time.perf_counter()
    _, rew, stats = fn(trandom.PRNGKey(1, device))
    total = float(rew.sum())
    sync()
    return {
        "seconds": time.perf_counter() - t0,
        "reward": total,
        "trips_sum": float(stats["trips_sum"]),
        "shard_max_trips": stats["shard_max_trips"].cpu().tolist(),
    }


def main(argv=None):
    from ..parallel import launch
    from ..parallel.distributed import default_backend

    p = argparse.ArgumentParser()
    p.add_argument("--rows", type=int, default=10)
    p.add_argument("--cols", type=int, default=10)
    p.add_argument("--colours", type=int, default=4)
    p.add_argument("--per-device-batch", type=int, default=256)
    p.add_argument("--steps", type=int, default=16)
    p.add_argument("--max-ranks", type=int, default=None,
                   help="largest world size (default: the cards, at least 2)")
    p.add_argument("--device", default=None, help="torch device (default: the CUDA card)")
    args = p.parse_args(argv)

    device = resolve_device(args.device)
    cards = torch.cuda.device_count() if device.type == "cuda" else 0
    max_ranks = args.max_ranks or max(2, cards)
    size = (args.rows, args.cols, args.colours, 30)
    rows, base_sps = [], None
    for dp in [d for d in (1, 2, 4, 8, 16, 32) if d <= max_ranks]:
        outs = launch(dp, _rank, size, args.per_device_batch, args.steps, device.type,
                      backend=default_backend(dp, device.type))
        B = args.per_device_batch * dp
        sps = B * args.steps / max(o["seconds"] for o in outs)
        base_sps = base_sps or sps
        # per shard executed trips (sum over steps of the max over the
        # shard's boards): at a fixed batch a rank it does not depend on dp
        row = {
            "dp": dp,
            "global_batch": B,
            "backend": default_backend(dp, device.type),
            "steps_per_sec": sps,
            "per_rank_steps_per_sec": [args.per_device_batch * args.steps / o["seconds"] for o in outs],
            "scaling_efficiency": sps / (base_sps * dp),
            "total_reward": sum(o["reward"] for o in outs),
            "mean_trips_per_board_step": outs[0]["trips_sum"] / (B * args.steps),
            "shard_max_trips_per_step": [x / args.steps for x in outs[0]["shard_max_trips"]],
        }
        rows.append(row)
        print(json.dumps(row))
    return rows


if __name__ == "__main__":
    main()
