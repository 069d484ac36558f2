#!/usr/bin/env python3
"""Time the PyTorch port's batched step on one card, for the port package
of a given checkout.

    python tools/torch_step_times.py [--root DIR] [--config 1|3|3-no-bomb]

Runs ``chip_smoke.drive`` of this checkout on ``--root``'s
``tile_match_tpu_torch`` (default: this checkout): the main path of
``chip_smoke.py`` phase 5, 6 or 7 (config 1, config 3, or config 3
without the bomb) at ``chip_smoke.MAIN_BATCH`` boards from reset,
``chip_smoke.MAIN_STEPS`` auto-resetting steps under a random effective
policy, a host clock around each step ending in a device synchronisation.
Prints one JSON line: the card's name and power limit, the root, the ms of
every step, their mean and median, the mean of the steps without an
auto-reset, the auto-reset steps alone, the launches a step of each
kernel wrapper, the combination boards a step, and the host
synchronisations of every step (torch's sync debug mode, in a second run
of the same steps, which its warnings slow).  Run it for two checkouts in turns (parent, change,
change, parent) to compare them on one card.  Imports no JAX.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=HERE)
    ap.add_argument("--config", default="1", choices=("1", "3", "3-no-bomb"))
    args = ap.parse_args()
    root = os.path.abspath(args.root)
    sys.path[:0] = [root, HERE]  # the root's package, this checkout's chip_smoke
    import torch

    if not torch.cuda.is_available():
        print("torch_step_times: needs a CUDA card", file=sys.stderr)
        return 1
    import chip_smoke

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()
    tag, specials, _ = chip_smoke.MAIN_PATHS[args.config]
    cfg = chip_smoke._config(10, 10, 4, 30, specials)
    with contextlib.redirect_stdout(sys.stderr):  # drive's report; stdout holds the JSON
        run = chip_smoke.drive(cfg, torch.device("cuda", 0), smi, tag, required=())
        counted = chip_smoke.drive(cfg, torch.device("cuda", 0), smi, tag, required=(),
                                   host_syncs=True)
    step_ms, resets = run["step_ms"], run["reset_steps"]
    steady = [ms for t, ms in enumerate(step_ms) if t not in resets]
    print(json.dumps({
        "smi": smi, "root": root, "config": args.config, "batch": chip_smoke.MAIN_BATCH,
        "step_ms": step_ms,
        "mean_ms": sum(step_ms) / len(step_ms),
        "median_ms": sorted(step_ms)[len(step_ms) // 2],
        "steady_mean_ms": sum(steady) / max(len(steady), 1),
        "reset_step_ms": [step_ms[t] for t in resets],
        "launches_per_step": {n: c / len(step_ms) for n, c in run["launches"].items()},
        "combs_per_step": run["combs_per_step"],
        "host_syncs": counted["syncs"],
        "host_syncs_per_step": sum(counted["syncs"]) / len(counted["syncs"]),
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
