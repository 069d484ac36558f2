"""Run one cell of the benchmark once.

    python3 tmt_bench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

(or ``python -m tmt_bench`` with the same arguments), from the root of a
checkout.  The cell, its configuration, its traffic mix and its metrics
come from ``BENCHMARK.json`` by name (``manifest``).  The last line of
standard output is the result: ``correct``, ``attempted`` (board-steps in
the window), ``failed`` (those whose ``truncated`` flag is set: a cap
fired), ``metrics`` (the cell's end-to-end metrics, or with ``--trace 1``
its per-layer ones), ``device``, with ``--trace 1`` a ``breakdown``, and
last ``checks``: each number the check compared, with its limit, which
also end standard error.

Exits non-zero with no result when there is no CUDA card or fewer than the
cell's chips, when the program is missing, and when ``jax``, ``jaxlib``,
``flax`` or ``tile_match_tpu`` is loaded in this process after the window.
Every build and kernel cache goes to a fixed directory inside the
checkout.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from tmt_bench.harness import process_start  # noqa: E402

T_START = process_start()

FORBIDDEN = ("jax", "jaxlib", "flax", "tile_match_tpu")
CACHES = {"TRITON_CACHE_DIR": "triton", "TORCHINDUCTOR_CACHE_DIR": "inductor",
          "TORCH_EXTENSIONS_DIR": "torch_extensions", "CUDA_CACHE_PATH": "cuda"}
CACHE_ROOT = os.path.join(ROOT, ".tmt_bench_cache")


def parse(argv):
    p = argparse.ArgumentParser(description="run one cell of the benchmark once")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def forbidden_modules() -> list:
    """Top-level names of the loaded modules that the benchmark must not
    load, compared whole."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def card_line() -> str:
    """``nvidia-smi``'s name and power limit of the card, or why not."""
    import subprocess

    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30).stdout.strip().splitlines()[0]
    except (OSError, IndexError, subprocess.SubprocessError) as e:
        return f"nvidia-smi unavailable: {e}"


def result_line(cell: dict, res: dict, trace: bool, kind: str, chips: int) -> dict:
    """The result's JSON object, ``checks`` last."""
    from tmt_bench import check, manifest, trace as tr

    run = dict(res, device_kind=kind)
    metrics = manifest.read_metrics(cell["per_layer"] if trace else cell["end_to_end"], run)
    win = res["window"]
    device = {"platform": "gpu", "kind": kind, "count": chips,
              "memory_peak_bytes": res["memory_peak_bytes"]}
    out = {"correct": check.passed(res["checks"]), "attempted": win["batch"] * win["steps"],
           "failed": win["truncated"], "metrics": metrics, "device": device}
    prof = res["profile"]
    if trace and prof is not None:
        device["busy_s"] = tr.busy_s(prof)
        device["window_s"] = prof["wall_s"]
        ops = sorted(tr.device_s_by_name(prof).items(), key=lambda kv: -kv[1])[:10]
        out["breakdown"] = {"device_ops": [[n, s] for n, s in ops],
                            "idle_gaps": [[n, s] for n, s in tr.gaps(prof)[:10]]}
    out["card"] = card_line()
    out["checked"] = res["checked"]
    out["checks"] = {c["name"]: {"value": c["value"], c["kind"]: c["limit"]} for c in res["checks"]}
    return out


def main(argv=None) -> int:
    args = parse(sys.argv[1:] if argv is None else argv)
    for var, sub in CACHES.items():
        os.environ[var] = os.path.join(CACHE_ROOT, sub)

    import torch

    from tmt_bench import harness, manifest
    from tmt_bench.program import PortProgram

    torch.set_num_threads(1)  # one process with few threads: the work is on the card

    cell = manifest.cell(manifest.load(), args.workload)
    chips = cell["workload"]["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"tmt_bench: {args.workload} needs {chips} CUDA card(s); "
              f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 3
    device = torch.device("cuda", 0)
    res = harness.run_cell(cell, args.seed, args.seconds, bool(args.trace), device,
                           PortProgram, T_START)
    found = forbidden_modules()
    if found:
        print(f"tmt_bench: loaded in this process: {', '.join(found)}", file=sys.stderr)
        return 4
    out = result_line(cell, res, bool(args.trace), torch.cuda.get_device_name(device), chips)
    print(json.dumps(out), flush=True)
    print(f"tmt_bench: {args.workload} seed {args.seed}: {out['card']}; checked "
          f"{json.dumps(res['checked'])}", file=sys.stderr)
    for c in res["checks"]:
        op = "<=" if c["kind"] == "max" else ">="
        print(f"check {c['name']} {c['value']} (limit {op} {c['limit']})", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
