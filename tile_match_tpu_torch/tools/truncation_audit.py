"""Truncation audit of the port (counterpart of the JAX package's
``tools/truncation_audit.py``): run the batched step at an operating batch
and count the board-steps whose ``StepInfo.truncated`` is set (a capacity
or iteration cap fired: the cascade cap, the classify and activation slot
caps, the regeneration cap) over a random effective rollout.

    python -m tile_match_tpu_torch.tools.truncation_audit [--config 3] [--batch 4096] \\
        [--steps 32] [--json OUT.json] [--device cuda|cpu]

The JAX tool's rollout: ``key, k0 = split(PRNGKey(0))``, reset from
``k0``, then each step ``key, ka = split(key)``, the categorical over the
masked logits and ``batched_step(..., eff_mask=mask)`` (auto-reset on).
Prints its JSON keys; ``backend`` is the card's name.
"""

from __future__ import annotations

import argparse
import json
import sys


def audit(cfg, batch: int, steps: int, device) -> int:
    """Truncated board-steps of ``cfg`` over the rollout, ``batch`` boards
    for ``steps`` steps on ``device``."""
    from .. import random as trandom
    from ..envs.batched import batched_reset, batched_step, masked_categorical

    key, k0 = trandom.split(trandom.PRNGKey(0, device))
    states, ts = batched_reset(cfg, k0, batch)
    mask = ts.info.effective_actions
    total = 0
    for _ in range(steps):
        key, ka = trandom.split(key)
        states, ts = batched_step(cfg, states, masked_categorical(ka, mask), eff_mask=mask)
        mask = ts.info.effective_actions
        total = total + ts.info.truncated.sum()
    return int(total)


def main(argv=None) -> int:
    import torch

    from ..bench import make_config
    from ..cuda_build import resolve_device

    ap = argparse.ArgumentParser(description="truncated board-steps of a rollout")
    ap.add_argument("--config", type=int, default=3)
    ap.add_argument("--batch", type=int, default=4096)
    ap.add_argument("--steps", type=int, default=32)
    ap.add_argument("--json", type=str, default=None)
    ap.add_argument("--device", default=None, help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    total = audit(make_config(args.config), args.batch, args.steps, device)
    result = {
        "config": args.config,
        "batch": args.batch,
        "steps": args.steps,
        "board_steps": args.batch * args.steps,
        "truncated_board_steps": total,
        "backend": torch.cuda.get_device_name(device) if device.type == "cuda" else str(device),
    }
    print(json.dumps(result))
    if args.json:
        with open(args.json, "w") as f:
            json.dump(result, f, indent=2)
    return 0


if __name__ == "__main__":
    sys.exit(main())
