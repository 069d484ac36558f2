"""Kernel coverage of the port's specials cascade (counterpart of the JAX
package's ``tools/kernel_coverage.py``): which cascade trips K2
(``cascade_sp_chunk``) takes and which it leaves to the full machinery,
and why it froze a board.

    python -m tile_match_tpu_torch.tools.kernel_coverage [--config 2|3|4] [--batch 256] \\
        [--steps 30] [--json OUT.json] [--device cuda|cpu]

The JAX tool's rollout: ``key, k0 = split(PRNGKey(0))``, reset from
``k0``, then ``min(steps, moves)`` steps of ``batched_step_fused_sp(...,
compute_post_mask=False)`` with no auto-reset, each under ``key, ka =
split(key)`` and the categorical over the masked logits; the per-board
telemetry that the JAX step returns with ``with_stats=True`` is read from
``engine.last_cascade`` after each step.  Its JSON keys and definitions: trips split into kernel and full
machinery, the most full trips of one board in a step, the board-steps
that froze, board-steps with each reason bit (``ops.cascade_sp.REASON_*``,
a board-step may carry several) and the histogram of each board-step's
exact bit set.  ``rounds_total`` and ``rounds_mean_per_step`` are this
loop's own: the JAX loop takes at most 128 or 256 frozen boards a round,
this one every frozen board.  At more than 256 cells a board the JAX
kernel freezes on a leaner predicate than K2's case table, so config 4's
counts differ from the JAX tool's by design (only the trips agree).
"""

from __future__ import annotations

import argparse
import json
import sys

REASON_NAMES = {
    1: "cookie line >=9 or shared >=5",
    2: "extension >=5 (>=4 if no bomb)",
    4: "prim+ext pair outside case table",
    8: "cookie hit (closure)",
    16: "closure unconverged",
    32: "h x v crossing outside case table",
    64: "multi-share / overlapping exts",
}


def coverage(cfg, batch: int, steps: int, device) -> dict:
    """The JAX tool's counts for ``cfg`` over ``min(steps, moves)`` steps of
    ``batch`` boards on ``device`` (without its ``config`` key)."""
    import torch

    from .. import engine
    from .. import random as trandom
    from ..envs.batched import batched_reset, masked_categorical
    from ..envs.fused import batched_step_fused_sp

    if not cfg.any_special:
        raise ValueError("coverage telemetry is for specials configs")
    n_steps = min(steps, cfg.num_moves)
    key, k0 = trandom.split(trandom.PRNGKey(0, device))
    states, ts = batched_reset(cfg, k0, batch)
    mask = ts.info.effective_actions
    bits = torch.tensor(list(REASON_NAMES), dtype=torch.int32, device=device)
    trips = full = max_full = frozen = rounds = 0
    per_reason = torch.zeros(len(bits), dtype=torch.int64, device=device)
    hist = torch.zeros(128, dtype=torch.int64, device=device)
    for _ in range(n_steps):
        key, ka = trandom.split(key)
        states, _, _, infos = batched_step_fused_sp(
            cfg, states, masked_categorical(ka, mask), mask, compute_post_mask=False,
        )
        mask, stats = infos.effective_actions, engine.last_cascade
        reasons = stats["reasons"]
        trips += infos.cascade_trips.sum()
        full += stats["full_trips"].sum()
        max_full = max(max_full, int(stats["full_trips"].max()))
        frozen += (reasons > 0).sum()
        rounds += stats["rounds"]
        per_reason += ((reasons[:, None] & bits) > 0).sum(0)
        hist += torch.bincount(reasons.long(), minlength=128)
    trips, full, frozen = int(trips), int(full), int(frozen)
    return {
        "batch": batch,
        "steps": n_steps,
        "board_steps": batch * n_steps,
        "trips_total": trips,
        "trips_full_machinery": full,
        "trips_kernel": trips - full,
        "kernel_fraction": round((trips - full) / max(trips, 1), 4),
        "rounds_total": rounds,
        "rounds_mean_per_step": round(rounds / max(n_steps, 1), 2),
        "max_full_trips_one_board": max_full,
        "frozen_board_steps": frozen,
        "defer_reasons": {REASON_NAMES[b]: int(n) for b, n in zip(REASON_NAMES, per_reason)},
        "mask_hist": {str(m): int(n) for m, n in enumerate(hist.tolist()) if n and m},
    }


def main(argv=None) -> int:
    from ..bench import make_config
    from ..cuda_build import resolve_device

    ap = argparse.ArgumentParser(description="K2's coverage of the specials cascade")
    ap.add_argument("--config", type=int, default=3)
    ap.add_argument("--batch", type=int, default=256)
    ap.add_argument("--steps", type=int, default=30)
    ap.add_argument("--json", type=str, default=None)
    ap.add_argument("--device", default=None, help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    result = {"config": args.config,
              **coverage(make_config(args.config), args.batch, args.steps, device)}
    print(json.dumps(result, indent=2))
    if args.json:
        with open(args.json, "w") as f:
            json.dump(result, f, indent=2)
    return 0


if __name__ == "__main__":
    sys.exit(main())
