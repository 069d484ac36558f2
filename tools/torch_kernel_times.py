#!/usr/bin/env python3
"""Time the PyTorch port's CUDA kernels on one card, for the port package
of a given checkout.

    python tools/torch_kernel_times.py [--root DIR] [--reps 20] [--trips-only | --line-test]

``--root`` is the root of a checkout whose ``tile_match_tpu_torch`` is
imported and built (default: this one), so that two versions compare in
one call on one card: run it for each in turns (parent, change, change,
parent).  Prints one JSON line: the card's name and power limit, the root,
and the mean ms per launch of

- K4 on the inputs of its first launch in a config-3 step at B=16384 (the
  boards K2 froze in the first cascade round, ``chip_smoke.
  main_path_trip_inputs``), and K5 (where the package has it) on the inputs
  of its launch in step 20 of config 3 at B=16384 (``chip_smoke.
  main_path_comb_inputs``), each queued and as called (``*_called_ms``),
  with the boards each launch works on; K5 also with every flag clear
  (``K5_clear_*``) and with only the board of the longest chain flagged
  (``K5_longest_*``), each launch on a fresh copy of its inputs (the
  kernel updates its boards in place), and the micro-steps of the flagged
  boards' chains by the plain machine (``K5_steps_max``, ``_p99``,
  ``_mean``; ``chip_smoke.k5_readings``); with ``--trips-only`` nothing
  else;

- with ``--line-test`` (alone): ``ops.lines.run_member_mask`` and
  ``has_any_line`` on CUDA tensors, whatever the checkout runs there (the
  run-extent scans in torch ops, or one launch of ``csrc/line_test.cu``),
  on uniform random boards at 10x10x4 B=16384 and B=256 and 20x20x6
  B=8192, queued and as called (``line_*``); with the kernels a call runs
  on the card, the boards with a line, and the outputs' digest;

- ``chip_smoke.py`` phase 3's inputs at 10x10x4 B=16384: K1 on uniform
  random boards (also with no trip allowed, which leaves its load, mask
  and store), K2 with the bomb and without it on sprinkled boards (limit
  64), K3 on K2's output boards; K1 and K2 also on the first wave of
  boards alone and on the boards with the most trips, one a streaming
  multiprocessor (the latency of a lone board);
- K1 on config 1's main path: the input of its launch in the second step
  of a 16384-board ``BatchedTileMatchEnv`` (captured from ``engine``), in
  full, its first 4224 boards, one board at a time (16 boards in turn, as
  the Gym adapter's threefry engine launches it), and its longest board
  alone; K2 one sprinkled board at a time;
- K1 and K2 (with the bomb) at shapes outside ``bench.py``'s configs:
  8x8x4 B=16384 and 36x36x6 B=256;
- K3 on K2's output boards: 10x10x4 B=16384 also with the L2 cache flushed
  before each launch, each launch timed alone (``K3_cold_ms``: behind a
  write of 64 MiB, more than the card's 50 MB L2, which leaves the L2
  dirty; ``K3_cold_read_ms``: behind a read of 64 MiB, which leaves it
  clean; ``*_each_ms`` every launch's time), one board at a time (16
  in turn), config 4's 20x20x6 at its batch of 8192 and 36x36x6 B=256; and
  without specials on K1's output boards at 10x10x4 B=16384 (config 1's
  mask).

Times are CUDA events around ``--reps`` launches after a warm-up, queued
behind a sleep on the card so that the launches run back to back and a
short one is timed without the host's call; the single-board times also
as called, the host's wrapper included (``*_called_ms``).  With them the
trips per board, and a digest of every output, equal for two versions
that compute the same function.  Imports no JAX.
"""

from __future__ import annotations

import argparse
import dataclasses
import hashlib
import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FLUSH_BYTES = 64 << 20  # more than the H100's 50 MB L2


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=HERE)
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--trips-only", action="store_true", help="time K4 and K5 alone")
    ap.add_argument("--line-test", action="store_true",
                    help="time run_member_mask and has_any_line alone")
    args = ap.parse_args()
    root = os.path.abspath(args.root)
    sys.path.insert(0, HERE)
    import chip_smoke  # input makers and timer of this checkout

    sys.path.insert(0, root)
    import torch

    if not torch.cuda.is_available():
        print("torch_kernel_times: needs a CUDA card", file=sys.stderr)
        return 1
    from tile_match_tpu_torch import cuda_build, engine
    from tile_match_tpu_torch import random as trandom
    from tile_match_tpu_torch.envs.batched import BatchedTileMatchEnv
    from tile_match_tpu_torch.ops import cascade, cascade_sp, mask_sp, trip_sp

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()
    dev = torch.device("cuda", 0)
    digest = hashlib.sha1()

    def queued_ms(fn):
        return chip_smoke._queued_ms(fn, args.reps)

    flush = torch.zeros(FLUSH_BYTES // 8, dtype=torch.int64, device=dev)

    def cold_ms(fn, evict):
        """The ms of each of fn's launches, timed alone after ``evict``
        has moved more bytes than the L2 holds."""
        fn()  # warm-up
        pairs = [(torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
                 for _ in range(args.reps)]
        torch.cuda.synchronize()
        torch.cuda._sleep(chip_smoke.SLEEP_CYCLES)
        for start, end in pairs:
            evict()
            start.record()
            fn()
            end.record()
        torch.cuda.synchronize()
        return [start.elapsed_time(end) for start, end in pairs]

    def timed(fn):
        out = fn()
        torch.cuda.synchronize()
        for t in out:
            digest.update(t.cpu().numpy().tobytes())
        return out, queued_ms(fn)

    def one_at_a_time(kernel, boards):
        """kernel on each single-board input of `boards` in turn: queued, and as called"""
        it = iter(range(1 << 30))
        fn = lambda: kernel(*boards[next(it) % len(boards)])  # noqa: E731
        for b in boards:
            for t in kernel(*b):
                digest.update(t.cpu().numpy().tobytes())
        return queued_ms(fn), chip_smoke._time_ms(fn, args.reps)

    rec = {"smi": smi, "root": root, "package": os.path.dirname(cascade.__file__)}
    if args.line_test:
        rec.update(line_test_times(dev, digest, args.reps, chip_smoke))
        rec["outputs_sha1"] = digest.hexdigest()
        print(json.dumps(rec))
        return 0
    # K4 and K5 on their main-path inputs
    cfg_t, trip_in = chip_smoke.main_path_trip_inputs(dev)
    rec["K4_boards"] = int(trip_in[0].shape[0])
    _, rec["K4_ms"] = timed(lambda: trip_sp.specials_trip(cfg_t, *trip_in))
    rec["K4_called_ms"] = chip_smoke._time_ms(lambda: trip_sp.specials_trip(cfg_t, *trip_in),
                                              args.reps)
    if hasattr(engine, "combination_trip"):  # absent from older checkouts
        from tile_match_tpu_torch.ops import combination

        cfg_c, comb_in = chip_smoke.main_path_comb_inputs(dev)
        for t in combination.combination_trip(cfg_c, *(t.clone() for t in comb_in)):
            digest.update(t.cpu().numpy().tobytes())
        readings = chip_smoke.k5_readings(cfg_c, comb_in, args.reps)
        for name, key in (("ms", "K5_called_ms"), ("queued_ms", "K5_ms"),
                          ("clear_ms", "K5_clear_called_ms"), ("clear_queued_ms", "K5_clear_ms"),
                          ("longest_ms", "K5_longest_called_ms"),
                          ("longest_queued_ms", "K5_longest_ms")):
            rec[key] = readings.pop(name, None)
        rec.update({f"K5_{name}": v for name, v in readings.items()})
    if args.trips_only:
        rec["outputs_sha1"] = digest.hexdigest()
        print(json.dumps(rec))
        return 0
    B = chip_smoke.MAIN_BATCH
    cfg1 = chip_smoke._config(10, 10, 4)
    colour, sub = chip_smoke._random_inputs(10, 10, 4, B, seed=7, device=dev)
    out1, rec["K1_ms"] = timed(lambda: cascade.fused_cascade(cfg1, colour, sub))
    wave = torch.cuda.get_device_properties(dev).multi_processor_count * 32  # boards in flight
    rec["wave"] = wave
    _, rec["K1_one_wave_ms"] = timed(lambda: cascade.fused_cascade(cfg1, colour[:wave], sub[:wave]))
    cfg0 = dataclasses.replace(cfg1, max_cascades=0)  # no trip: the load, the mask, the store
    _, rec["K1_no_trip_ms"] = timed(lambda: cascade.fused_cascade(cfg0, colour, sub))
    cfg3 = chip_smoke._config(10, 10, 4, 30, chip_smoke.ALL_SPECIALS)
    inputs = chip_smoke.sprinkled_inputs(10, 10, 4, B, seed=11, device=dev)
    out, rec["K2_ms"] = timed(lambda: cascade_sp.cascade_sp_chunk(cfg3, *inputs, limit=64))
    first = [t[:wave] for t in inputs]
    _, rec["K2_one_wave_ms"] = timed(lambda: cascade_sp.cascade_sp_chunk(cfg3, *first, limit=64))
    for name, trips in (("K1", out1[2]), ("K2", out[2] - inputs[3])):
        rec[f"{name}_trips_mean"] = float(trips.float().mean())
        rec[f"{name}_trips_max"] = int(trips.max())
    # one board a streaming multiprocessor: the boards with the most trips
    sms = wave // 32
    top1 = out1[2].topk(sms).indices
    _, rec["K1_lone_ms"] = timed(lambda: cascade.fused_cascade(cfg1, colour[top1], sub[top1]))
    top2 = (out[2] - inputs[3]).topk(sms).indices
    lone = [t[top2] for t in inputs]
    _, rec["K2_lone_ms"] = timed(lambda: cascade_sp.cascade_sp_chunk(cfg3, *lone, limit=64))
    cfg_nb = chip_smoke._config(10, 10, 4, 30, chip_smoke.NO_BOMB)
    nb = chip_smoke.sprinkled_inputs(10, 10, 4, B, seed=10 * 100 + B + 1, device=dev,
                                     kinds=[2, 3, -1])
    _, rec["K2_nobomb_ms"] = timed(lambda: cascade_sp.cascade_sp_chunk(cfg_nb, *nb, limit=64))
    k3 = lambda: (mask_sp.settled_mask_sp(cfg3, out[0], out[1]),)  # noqa: E731
    _, rec["K3_ms"] = timed(k3)
    for name, evict in (("K3_cold", flush.zero_), ("K3_cold_read", flush.sum)):
        rec[f"{name}_each_ms"] = each = cold_ms(k3, evict)
        rec[f"{name}_ms"] = sum(each) / len(each)
    singles = [(cfg3, out[0][b:b + 1].clone(), out[1][b:b + 1].clone()) for b in range(16)]
    rec["K3_b1_ms"], rec["K3_b1_called_ms"] = one_at_a_time(
        lambda *a: (mask_sp.settled_mask_sp(*a),), singles)
    cfg1_kind = torch.ones_like(out1[0])
    _, rec["K3_nospecials_ms"] = timed(
        lambda: (mask_sp.settled_mask_sp(cfg1, out1[0], cfg1_kind),))
    for R, C, K, b in ((20, 20, 6, 8192), (36, 36, 6, 256)):
        cfg_sp = chip_smoke._config(R, C, K, 30, chip_smoke.ALL_SPECIALS)
        sp = chip_smoke.sprinkled_inputs(R, C, K, b, seed=R * C + 2, device=dev)
        settled = cascade_sp.cascade_sp_chunk(cfg_sp, *sp, limit=64)
        _, rec[f"K3_{R}x{C}x{K}_b{b}_ms"] = timed(
            lambda: (mask_sp.settled_mask_sp(cfg_sp, settled[0], settled[1]),))

    # config 1's main path: K1's input in the second step of the batched env
    captured = []
    launch = engine.fused_cascade

    def capture(cfg, moved, keys):
        captured.append((moved.clone(), keys.clone()))
        return launch(cfg, moved, keys)

    engine.fused_cascade = capture
    try:
        env = BatchedTileMatchEnv(cfg1, B, device=dev)
        gen = torch.Generator(device=dev)
        gen.manual_seed(chip_smoke.SEED)
        states, ts = env.reset(trandom.PRNGKey(chip_smoke.SEED, dev))
        for _ in range(2):
            mask = ts.info.effective_actions
            scores = torch.rand(mask.shape, generator=gen, device=dev)
            states, ts = env.step(states, torch.where(mask, scores, -1.0).argmax(-1))
    finally:
        engine.fused_cascade = launch
    moved, keys = captured[-1]
    main_out, rec["K1_main_ms"] = timed(lambda: cascade.fused_cascade(cfg1, moved, keys))
    rec["K1_main_trips_mean"] = float(main_out[2].float().mean())
    rec["K1_main_trips_max"] = int(main_out[2].max())
    _, rec["K1_main_b4224_ms"] = timed(lambda: cascade.fused_cascade(cfg1, moved[:4224], keys[:4224]))
    singles = [(cfg1, moved[b:b + 1].clone(), keys[b:b + 1].clone()) for b in range(16)]
    rec["K1_b1_ms"], rec["K1_b1_called_ms"] = one_at_a_time(cascade.fused_cascade, singles)
    worst = int(main_out[2].argmax())
    longest = [(cfg1, moved[worst:worst + 1].clone(), keys[worst:worst + 1].clone())]
    rec["K1_b1_longest_ms"], _ = one_at_a_time(cascade.fused_cascade, longest)
    singles = [(cfg3, *(t[b:b + 1].clone() for t in inputs)) for b in range(16)]
    rec["K2_b1_ms"], rec["K2_b1_called_ms"] = one_at_a_time(
        lambda *a: cascade_sp.cascade_sp_chunk(*a, limit=64), singles)

    # shapes outside bench.py's configs
    for R, C, K, b in ((8, 8, 4, B), (36, 36, 6, 256)):
        tag = f"{R}x{C}x{K}_b{b}"
        cfg = chip_smoke._config(R, C, K)
        colour, sub = chip_smoke._random_inputs(R, C, K, b, seed=R * C, device=dev)
        cfg_sp = chip_smoke._config(R, C, K, 30, chip_smoke.ALL_SPECIALS)
        sp = chip_smoke.sprinkled_inputs(R, C, K, b, seed=R * C + 1, device=dev)
        try:
            _, rec[f"K1_{tag}_ms"] = timed(lambda: cascade.fused_cascade(cfg, colour, sub))
            _, rec[f"K2_{tag}_ms"] = timed(
                lambda: cascade_sp.cascade_sp_chunk(cfg_sp, *sp, limit=64))
        except ValueError as e:  # a version that refuses the shape
            rec[f"{tag}_refused"] = str(e)

    rec["outputs_sha1"] = digest.hexdigest()
    summary = getattr(cuda_build, "ptxas_summary", None)  # absent from older checkouts
    rec["ptxas"] = {  # registers and spills of each kernel built by this process
        src: summary(log) for src, log in cuda_build.build_logs.items()
    } if summary else None
    print(json.dumps(rec))
    return 0


def line_test_times(dev, digest, reps: int, chip_smoke) -> dict:
    """The line test's times (ms a call, queued and as called) of the
    imported package on uniform random boards, the kernels a call runs on
    the card (by the profiler; one for the kernel, 49–50 for the scans) and
    the boards with a line."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from tile_match_tpu_torch.ops import lines

    rec = {}
    for R, C, K, B in ((10, 10, 4, 16384), (20, 20, 6, 8192), (10, 10, 4, 256)):
        colour, _ = chip_smoke._random_inputs(R, C, K, B, seed=R * C + B, device=dev)
        for what, fn in (("member", lines.run_member_mask), ("any", lines.has_any_line)):
            call = lambda: fn(None, colour)  # noqa: E731
            out = call()
            torch.cuda.synchronize()
            digest.update(out.cpu().numpy().tobytes())
            tag = f"line_{what}_{R}x{C}x{K}_b{B}"
            rec[f"{tag}_ms"] = chip_smoke._queued_ms(call, reps)
            rec[f"{tag}_called_ms"] = chip_smoke._time_ms(call, reps)
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                call()
                torch.cuda.synchronize()
            rec[f"{tag}_kernels"] = sum(
                1 for e in prof.profiler.kineto_results.events()
                if e.device_type() == DeviceType.CUDA
                and not any(k in e.name().lower() for k in ("memcpy", "memset")))
            if what == "any":
                rec[f"line_{R}x{C}x{K}_b{B}_boards_with_a_line"] = int(out.sum())
    return rec


if __name__ == "__main__":
    sys.exit(main())
