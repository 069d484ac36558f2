#!/usr/bin/env python3
"""Drive the PyTorch port's main path once on one CUDA card.

    python3 chip_smoke.py

Phases, one line each; any failure exits non-zero:
  1. needs a CUDA device; prints the card's name and power limit;
  2. builds the CUDA kernel from tile_match_tpu_torch/csrc/;
  3. holds the kernel against its plain PyTorch version on the card, bit
     for bit in all five outputs, at 10x10x4 B=16384, 5x5x3 B=1000 and
     20x20x6 B=1024, and times both at 10x10x4 B=16384;
  4. replays the recorded JAX rollout (tests/data/torch_port_fixture_cfg1.npz)
     through BatchedTileMatchEnv on the card, bit for bit in every field;
  5. runs config 1 (10x10, 4 colours, 30 moves, no specials) at batch 16384
     for 64 auto-resetting steps under a random effective policy, checks the
     kernel ran on every step, and times the steps.
The line before the last is the kernels' JSON record; the last line is
{"ok": true, "device": {...}}.  Imports no JAX.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
FIXTURE = os.path.join(ROOT, "tests", "data", "torch_port_fixture_cfg1.npz")
KERNEL_SOURCE = "tile_match_tpu_torch/csrc/cascade.cu"
KERNEL_REPLACES = "tile_match_tpu/ops/pallas_cascade.py:1106"
MAIN_BATCH = 16384
MAIN_STEPS = 64
SEED = 0


def check(cond, msg: str) -> None:
    if not cond:
        raise RuntimeError(msg)


def _no_specials(R, C, K, moves=30):
    from tile_match_tpu_torch.config import EnvConfig

    return EnvConfig.create(R, C, K, moves, colourless_specials=(), colour_specials=())


def replay_fixture(device, path: str = FIXTURE) -> int:
    """Replay the recorded JAX rollout through ``BatchedTileMatchEnv`` on
    ``device``; raises on the first field that differs.  Returns the number
    of steps replayed."""
    import torch

    from tile_match_tpu_torch import random as trandom
    from tile_match_tpu_torch.envs.batched import BatchedTileMatchEnv
    from tile_match_tpu_torch.interop import state_to_numpy, timestep_to_numpy

    d = np.load(path)
    R, C, K, moves = (int(v) for v in d["config"])
    env = BatchedTileMatchEnv(_no_specials(R, C, K, moves), d["colour"].shape[1], device)

    def compare(t, states, ts):
        got = state_to_numpy(states)
        tsn = timestep_to_numpy(ts)
        got.update({k: v for k, v in tsn.items() if k != "info"})
        got.update(tsn["info"])
        for name, value in got.items():
            check(
                np.array_equal(value, d[name][t]),
                f"fixture step {t}: field {name} differs from the JAX rollout",
            )

    states, ts = env.reset(trandom.PRNGKey(int(d["seed"]), device))
    compare(0, states, ts)
    actions = d["actions"]
    for t in range(actions.shape[0]):
        acts = torch.as_tensor(actions[t].astype(np.int64), device=device)
        states, ts = env.step(states, acts)
        compare(t + 1, states, ts)
    return actions.shape[0]


def _random_inputs(R, C, K, B, seed, device):
    import torch

    rng = np.random.default_rng(seed)
    colour = rng.integers(1, K + 1, size=(B, R, C)).astype(np.int32)
    keys = rng.integers(0, 1 << 32, size=(B, 2), dtype=np.uint64).astype(np.int64)
    return torch.as_tensor(colour, device=device), torch.as_tensor(keys, device=device)


def _time_ms(fn, reps: int) -> float:
    import torch

    fn()  # warm-up
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def main() -> int:
    import torch

    # 1. the card
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; needs a CUDA card",
              file=sys.stderr)
        return 1
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()
    print(smi)
    device = torch.device("cuda", 0)
    kind = torch.cuda.get_device_name(0)
    print(f"phase 1 ok: {kind}, torch {torch.__version__}, CUDA {torch.version.cuda}")

    from tile_match_tpu_torch import cuda_build
    from tile_match_tpu_torch.ops import cascade
    from tile_match_tpu_torch.ops.lines import has_any_line

    # 2. build
    t0 = time.perf_counter()
    cuda_build.load("cascade")
    ptxas = " ".join(
        ln.strip() for ln in cuda_build.build_logs.get("cascade", "").splitlines()
        if "registers" in ln or "spill" in ln
    )
    print(f"phase 2 ok: built {KERNEL_SOURCE} in {time.perf_counter() - t0:.1f} s; {ptxas}")

    # 3. kernel against the plain version, bit for bit
    names = ("colour", "elim", "trips", "truncated", "mask")
    max_err = 0
    for R, C, K, B in ((10, 10, 4, MAIN_BATCH), (5, 5, 3, 1000), (20, 20, 6, 1024)):
        cfg = _no_specials(R, C, K)
        colour, sub = _random_inputs(R, C, K, B, seed=R * 1000 + B, device=device)
        got = cascade.fused_cascade(cfg, colour, sub)
        want = cascade.cascade_reference(cfg, colour, sub)
        torch.cuda.synchronize()
        for name, g, w in zip(names, got, want):
            check(g.shape == w.shape and g.dtype == w.dtype,
                  f"{R}x{R}x{K} B={B}: {name} shape/dtype differs")
            err = int((g.to(torch.int64) - w.to(torch.int64)).abs().max())
            max_err = max(max_err, err)
            check(err == 0, f"{R}x{C}x{K} B={B}: kernel {name} differs from the plain version")
        print(f"phase 3: {R}x{C}x{K} B={B} kernel == plain in {', '.join(names)}; "
              f"mean trips {got[2].float().mean().item():.2f}")
    cfg1 = _no_specials(10, 10, 4)
    colour, sub = _random_inputs(10, 10, 4, MAIN_BATCH, seed=7, device=device)
    kernel_ms = _time_ms(lambda: cascade.fused_cascade(cfg1, colour, sub), reps=20)
    plain_ms = _time_ms(lambda: cascade.cascade_reference(cfg1, colour, sub), reps=3)
    print(f"phase 3 ok: 10x10x4 B={MAIN_BATCH} uniform random boards: kernel "
          f"{kernel_ms:.4f} ms, plain {plain_ms:.4f} ms ({smi})")

    # 4. the recorded JAX rollout, on the card
    n = replay_fixture(device)
    print(f"phase 4 ok: replayed {n} steps of the JAX fixture bit for bit")

    # 5. the main path
    from tile_match_tpu_torch import random as trandom
    from tile_match_tpu_torch.envs.batched import BatchedTileMatchEnv

    env = BatchedTileMatchEnv(cfg1, MAIN_BATCH, device)
    gen = torch.Generator(device=device)
    gen.manual_seed(SEED)
    cascade.launches = 0
    states, ts = env.reset(trandom.PRNGKey(SEED, device))
    torch.cuda.synchronize()
    truncated = 0
    dones = 0
    step_ms = []
    for t in range(MAIN_STEPS):
        mask = ts.info.effective_actions
        check(bool(mask.any(-1).all()), f"step {t}: a board has no effective action")
        scores = torch.rand(mask.shape, generator=gen, device=device)
        actions = torch.where(mask, scores, -1.0).argmax(-1)
        check(bool(mask.gather(1, actions[:, None]).all()), f"step {t}: ineffective action")
        before = cascade.launches
        t0 = time.perf_counter()
        states, ts = env.step(states, actions)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        check(cascade.launches > before, f"step {t}: the cascade kernel was not launched")
        check(bool((ts.reward > 0).all()), f"step {t}: an effective move scored 0")
        truncated += int(ts.info.truncated.sum())
        dones += int(ts.done.sum())
    launches = cascade.launches
    board_steps = MAIN_BATCH * MAIN_STEPS
    check(dones == 2 * MAIN_BATCH, f"expected two auto-resets of every board, saw {dones} dones")
    check(truncated * 10000 < board_steps, f"{truncated} truncated board-steps of {board_steps}")
    check(tuple(ts.obs_board.shape) == (MAIN_BATCH, 2, 10, 10), "obs_board shape")
    check(bool(((states.colour >= 1) & (states.colour <= 4)).all()), "colour out of range")
    check(not bool(has_any_line(cfg1, states.colour).any()), "a settled board holds a line")
    total_ms = sum(step_ms)
    print(f"phase 5 ok: config 1 B={MAIN_BATCH} {MAIN_STEPS} steps, {launches} kernel "
          f"launches, {dones} dones, {truncated} truncated of {board_steps} board-steps")
    print(f"phase 5 time: {total_ms / MAIN_STEPS:.3f} ms/step (median "
          f"{sorted(step_ms)[MAIN_STEPS // 2]:.3f} ms), "
          f"{board_steps / (total_ms / 1e3):.1f} steps/s ({smi})")

    print(json.dumps({"kernels": [{
        "name": "fused_cascade",
        "route": "cuda",
        "source": KERNEL_SOURCE,
        "replaces": KERNEL_REPLACES,
        "launches": launches,
        "max_abs_err": max_err,
        "ms": kernel_ms,
        "plain_ms": plain_ms,
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
