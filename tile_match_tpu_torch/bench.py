"""Benchmark of the port: batched env-steps/s on one CUDA card (counterpart
of the JAX package's ``bench.py``).

    python -m tile_match_tpu_torch.bench [--config N] [--device cuda|cpu]

Configs: ``bench.py``'s five rows, chosen by ``--config N`` (0-4) or the
environment's ``TMT_BENCH_CONFIG``, default 3 (10x10, 4 colours, every
special: the flagship).  ``TMT_BENCH_BATCH`` (default the config's batch
of ``CONFIG_BATCH``), ``TMT_BENCH_CHUNK`` (8), ``TMT_BENCH_STEPS`` (2) and
``TMT_BENCH_REPS`` (3) size the run.

Protocol (``bench.py``'s ``measure_ours``): boards reset from
``PRNGKey(0)``, the policy keyed from ``PRNGKey(1)``; each step takes
``key, ka = split(key)``, draws a categorical over the masked logits
(action 0 where a board has none: ``envs.batched.random_effective``) and
calls ``batched_step(..., eff_mask=mask)``.  One warm chunk runs first,
then ``reps`` windows of ``steps * chunk`` steps, each ended by a device
synchronisation; the result is the best window's board-steps/s
(``profiling.timed_windows``).

Before anything is timed the parity gate runs (``tools.parity_check.gate``:
the recorded JAX rollout of the config replays bit for bit, then the step
on the card equals the same step on the CPU, and without specials K1
equals its plain version at the bench's batch).  If the gate fails, the
bench raises and prints no metric.  It then fails unless the timed windows
launched the kernels of the config's path: K1 without specials; K5, K2,
K4 and K3 with them.

Lines before the last: the card's name and power limit, the gate's lines,
each window's seconds and whether it held the auto-reset step (every
board starts at timer 0, so all regenerate at the same step), each
kernel's launches a step, and the median step ms.  The last line is
``bench.py``'s: ``{"metric", "value", "unit", "vs_baseline"}``, where
``vs_baseline`` is the rate over the config's ``baseline_steps_per_s`` in
``bench_baseline.json``, a CPU rate of the reference game that
``bench.py`` calibrated on another machine (method ``calibrated-v5``), not
a number of the card.  The file is read, never written; without it or
the config's entry the line has no ``vs_baseline``.

No fallback: without a card the bench raises unless ``--device cpu`` is
given, and no ``try`` wraps the gate, a kernel or the step.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BASELINE_FILE = os.path.join(ROOT, "bench_baseline.json")
BASELINE_METHOD = "calibrated-v5"

# bench.py's five configs: (R, C, colours, moves, colourless, colour specials)
CONFIGS = [
    (5, 5, 3, 10, (), ()),
    (10, 10, 4, 30, (), ()),
    (10, 10, 4, 30, (), ("vertical_laser", "horizontal_laser", "bomb")),
    (10, 10, 4, 30, ("cookie",), ("vertical_laser", "horizontal_laser", "bomb")),
    (20, 20, 6, 100, ("cookie",), ("vertical_laser", "horizontal_laser", "bomb")),
]
# bench.py's batch of each config
CONFIG_BATCH = [32768, 16384, 16384, 16384, 8192]
# the kernels each config's step must launch
PATH_KERNELS = {False: ("fused_cascade", "threefry_words"),
                True: ("combination_trip", "cascade_sp_chunk", "specials_trip", "settled_mask_sp",
                       "threefry_words")}


def make_config(idx: int):
    from .config import EnvConfig

    R, C, K, moves, colourless, colour = CONFIGS[idx]
    return EnvConfig.create(R, C, K, moves, colourless_specials=colourless,
                            colour_specials=colour)


def metric_name(idx: int, batch: int) -> str:
    """``bench.py``'s metric: env_steps_per_sec_{R}x{C}x{K}_{label}_b{batch}."""
    R, C, K, _, colourless, colour = CONFIGS[idx]
    label = ("no_specials" if not (colourless or colour)
             else ("full_specials" if colourless else "colour_specials"))
    return f"env_steps_per_sec_{R}x{C}x{K}_{label}_b{batch}"


def config_index(argv) -> int:
    """``--config N`` or ``TMT_BENCH_CONFIG``, with ``bench.py``'s messages."""
    if "--config" in argv:
        idx = argv.index("--config")
        if idx + 1 >= len(argv):
            sys.exit("bench.py: --config requires an integer argument 0-4")
        try:
            n = int(argv[idx + 1])
        except ValueError:
            sys.exit(f"bench.py: --config must be an integer, got {argv[idx + 1]!r}")
    else:
        n = int(os.environ.get("TMT_BENCH_CONFIG", "3"))
    if not 0 <= n < len(CONFIGS):
        sys.exit(f"bench.py: config index {n} out of range 0-{len(CONFIGS) - 1}")
    return n


def baseline(idx: int, path: str = BASELINE_FILE):
    """The config's calibrated reference rate from ``bench_baseline.json``,
    or None where the file or the entry is missing."""
    if not os.path.exists(path):
        return None
    with open(path) as f:
        entry = json.load(f).get(str(idx), {})
    if "baseline_steps_per_s" in entry and entry.get("method") == BASELINE_METHOD:
        return entry["baseline_steps_per_s"]
    return None


def card_line(device) -> str:
    """``nvidia-smi``'s name and power limit of the card, or the device."""
    if device.type != "cuda":
        return f"device {device} (no card)"
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()


def _option(argv, name):
    if name not in argv:
        return None
    idx = argv.index(name)
    if idx + 1 >= len(argv):
        sys.exit(f"bench: {name} requires an argument")
    return argv[idx + 1]


def main(argv=None) -> int:
    from .cuda_build import resolve_device
    from .profiling import timed_windows
    from .tools.parity_check import gate

    argv = list(sys.argv[1:] if argv is None else argv)
    idx = config_index(argv)
    device = resolve_device(_option(argv, "--device"))
    batch = int(os.environ.get("TMT_BENCH_BATCH", str(CONFIG_BATCH[idx])))
    chunk = int(os.environ.get("TMT_BENCH_CHUNK", "8"))
    steps = int(os.environ.get("TMT_BENCH_STEPS", "2"))
    reps = int(os.environ.get("TMT_BENCH_REPS", "3"))
    cfg = make_config(idx)
    print(card_line(device))

    gate(idx, device, batch)

    run = timed_windows(cfg, batch, steps * chunk, reps, seed=0, device=device, warmup=chunk)
    for i, (sec, ms, dones) in enumerate(zip(run["times"], run["step_ms"], run["dones"])):
        held = "held the auto-reset step" if dones else "no auto-reset"
        print(f"bench: window {i}: {sec:.6f} s, {batch * steps * chunk / sec:.1f} board-steps/s, "
              f"{held} ({dones} dones)")
    n = reps * steps * chunk
    print("bench: launches a step: "
          + ", ".join(f"{k} {c / n:.3f}" for k, c in run["launches"].items()))
    step_ms = [ms for window in run["step_ms"] for ms in window]
    print(f"bench: median step {statistics.median(step_ms):.3f} ms over {len(step_ms)} steps "
          f"(config {idx}, B={batch}, chunk {chunk}, steps {steps}, reps {reps})")
    if device.type == "cuda":
        missing = [k for k in PATH_KERNELS[cfg.any_special] if run["launches"][k] == 0]
        if missing:
            raise RuntimeError(f"bench: the timed windows launched no {', '.join(missing)}")

    sps = run["steps_per_sec"]
    line = {"metric": metric_name(idx, batch), "value": round(sps, 1), "unit": "steps/s"}
    base = baseline(idx)
    if base is not None:
        line["vs_baseline"] = round(sps / base, 2)
    print(json.dumps(line))
    return 0


if __name__ == "__main__":
    sys.exit(main())
