"""Run cells several times, one process a run, and summarise the spread.

    python3 tmt_bench/sweep.py --workload <name> --seeds 1,2,3 --seconds <s> [--trace 0|1] \
        [--out chiprun_out/<file>.jsonl] [--sets 2]

Runs ``run.py`` once per seed (with ``--sets 2`` the same seeds twice,
set after set), appends each run's result line, exit code, seconds and the
end of its standard error to ``--out``, and prints for each metric of each
set its median and spread (the distance between the quartiles over the
median, ``statistics.quantiles(values, n=4)``), the readings of the
numbers compared, and whether every run was correct.  On the machine it
is started on; no run of it is timed twice at once.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from tmt_bench.stats import spread  # noqa: E402


def one(workload: str, seed: int, seconds, trace: int) -> dict:
    t0 = time.time()
    proc = subprocess.run(
        [sys.executable, os.path.join(HERE, "run.py"), "--workload", workload, "--seed", str(seed),
         "--seconds", str(seconds), "--trace", str(trace)],
        cwd=ROOT, capture_output=True, text=True)
    lines = proc.stdout.strip().splitlines()
    try:
        result = json.loads(lines[-1]) if proc.returncode == 0 and lines else None
    except json.JSONDecodeError:
        result = None
    return {"workload": workload, "seed": seed, "trace": trace, "rc": proc.returncode,
            "seconds": time.time() - t0, "result": result, "stderr": proc.stderr[-3000:]}


def summary(runs: list) -> dict:
    out = {}
    good = [r["result"] for r in runs if r["result"]]
    for name in sorted({m for r in good for m in r["metrics"]}):
        vals = [r["metrics"][name]["value"] for r in good if name in r["metrics"]]
        row = {"median": statistics.median(vals), "min": min(vals), "max": max(vals), "n": len(vals)}
        if len(vals) >= 2 and row["median"]:
            row["spread"] = spread(vals)
        out[name] = row
    out["correct"] = [r["correct"] for r in good]
    out["rcs"] = [r["rc"] for r in runs]
    out["checks"] = [{k: v["value"] for k, v in r["checks"].items()} for r in good]
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--seconds", required=True)
    p.add_argument("--trace", type=int, default=0)
    p.add_argument("--sets", type=int, default=1)
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)
    seeds = [int(s) for s in args.seeds.split(",")]
    for k in range(args.sets):
        runs = []
        for seed in seeds:
            r = one(args.workload, seed, args.seconds, args.trace)
            r["set"] = k
            runs.append(r)
            if args.out:
                os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
                with open(args.out, "a") as f:
                    f.write(json.dumps(r) + "\n")
            print(json.dumps({"seed": seed, "set": k, "rc": r["rc"], "seconds": round(r["seconds"], 1),
                              "metrics": {n: m["value"] for n, m in (r["result"] or {}).get("metrics", {}).items()},
                              "correct": (r["result"] or {}).get("correct"),
                              "failed": (r["result"] or {}).get("failed")}), flush=True)
            if r["rc"] != 0:
                print(r["stderr"], file=sys.stderr)
        print(json.dumps({"workload": args.workload, "set": k, "summary": summary(runs)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
