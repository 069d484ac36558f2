"""The control: the plain reference in the program's place, with one of the
configurations' guarantees broken, through the whole harness and check.

    python3 tmt_bench/control.py --workload <name> --seeds 11,12,13 [--steps 31] [--draw philox]

The reference (``program.ReferenceProgram``) steps the cell's own batch
from the seed; with ``--draw philox`` (the control) its actions come from
torch's Philox generator in place of the threefry key, and the check has to
read it as not correct.  ``--draw threefry`` runs the reference as it is,
which the check has to pass.  The window is ``--steps`` steps after the
reset (31 by default: one auto-reset); each seed prints one JSON line
with ``correct`` and the numbers compared.  On the card when there is one.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
if os.path.dirname(HERE) not in sys.path:
    sys.path.insert(0, os.path.dirname(HERE))

import torch  # noqa: E402

from tmt_bench import check, harness, manifest  # noqa: E402
from tmt_bench.program import ReferenceProgram  # noqa: E402


def control_run(cell: dict, seed: int, steps: int, device, draw: str = "philox",
                check_boards: int = check.BOARDS, check_chunk: int = check.CHUNK) -> dict:
    """One run of ``cell`` with the reference in the program's place, no
    warm-up, ``steps`` steps in the window."""
    cell = dict(cell, traffic=dict(cell["traffic"], warmup_episodes=0))

    def program(config, dev, s):
        return ReferenceProgram(config, dev, s, draw=draw)

    res = harness.run_cell(cell, seed, 0, False, device, program, time.time(),
                           max_steps=steps, check_boards=check_boards,
                           check_chunk=check_chunk)
    return {"seed": seed, "draw": draw, "correct": check.passed(res["checks"]),
            "checks": {c["name"]: c["value"] for c in res["checks"]}, "checked": res["checked"]}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--steps", type=int, default=31)
    p.add_argument("--draw", choices=("philox", "threefry"), default="philox")
    args = p.parse_args(argv)
    cell = manifest.cell(manifest.load(), args.workload)
    device = torch.device("cuda", 0) if torch.cuda.is_available() else torch.device("cpu")
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.time()
        out = control_run(cell, seed, args.steps, device, args.draw)
        out["seconds"] = time.time() - t0
        out["device"] = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
        print(json.dumps(dict(workload=args.workload, **out)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
