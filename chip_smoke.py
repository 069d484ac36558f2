#!/usr/bin/env python3
"""Drive the PyTorch port's main paths once on one CUDA card.

    python3 chip_smoke.py

Phases, one line each or more; any failure exits non-zero:
  1. needs a CUDA device; prints the card's name and power limit;
  2. builds the five CUDA kernels from tile_match_tpu_torch/csrc/ — each
     once for every board shape of at most 32 by 32 that the run uses and
     once for larger boards — and the threefry words (one library for
     every shape), one nvcc a library, all at once, and prints
     their registers and spills and the boards each keeps in flight per SM
     at 10x10 and 36x36;
  3. holds each kernel against its plain PyTorch version on the card, bit
     for bit in every output — K1 fused_cascade at 10x10x4 B=16384 and
     B=1000, 5x5x3 B=1000 and B=32768 (its warps-a-board variants below and
     above 8,192 boards, at configs 0's and 1's bench batches too), 20x20x6
     B=1024 and 36x36x6 B=256 (1,296 cells); K2
     cascade_sp_chunk and K3 settled_mask_sp at 10x10x4 B=16384, 6x6x3
     B=1000, 20x20x6 B=1024 and 36x36x6 B=256 on boards with sprinkled
     specials, and K2's no-bomb case table with K3 on its output at 10x10x4
     B=16384 (cookie and both lasers), 6x6x3 B=1000 (both lasers), 8x8x4
     B=1000 (cookie), 20x20x6 B=1024 and 36x36x6 B=256 (cookie and both
     lasers), and on 8x8x4 B=1024 boards where two cookie lines cross in
     both tails — and times both versions at 10x10x4 B=16384 (each kernel
     as called, back to back with the host's call, the kernels line's
     ``ms``; and queued behind a sleep on the card, the device alone);
     then K3 alone at 10x10x4 B=1, 130 and 16384, 20x20x6 B=1024
     and 36x36x6 B=256, with specials and without (``any_special``), on
     sprinkled boards; then K4 specials_trip, the full-machinery trip, on
     the boards K2's kernel froze and on raw boards with sprinkled specials
     at 10x10x4 B=16384, 6x6x3 B=1000, 20x20x6 B=1024, 36x36x6 B=256,
     80x80x6 B=16 (raw; its scratch in device memory) and at 10x10x3
     B=4096 with max_lines=2 and with max_stack=2 (the caps fire), and
     times it on the inputs of its first launch in a config-3 step at
     B=16384 (the frozen boards of the cascade's first round); then K5
     combination_trip, the combination branch, on boards whose swap cells
     hold all 25 ordered pairs of kinds (and boards whose flag is clear,
     which must come back unchanged) at 10x10x4 B=16384, 6x6x3 B=1000,
     20x20x6 B=1024, 36x36x6 B=256, 80x80x6 B=16, 100x100x6 B=8 (its
     scratch in device memory) and at 10x10x3 B=4096 with max_stack=2 and
     with max_activation_steps=8 (the caps fire), with every flag clear
     (the boards byte for byte as they were: it updates the flagged ones
     in place), with one flag set and at B=1, and times it on the inputs
     of its launch in step 20 of config 3 at B=16384: as they are, with
     every flag clear and with only the longest chain's board flagged,
     with the chains' micro-steps by the plain machine (``k5_readings``);
     then the threefry words (``random.py`` on CUDA tensors) against the
     plain version at the main path's shapes, each one launch, timed
     beside its bound and the plain version's time: one key's split,
     categorical over 16384 x 180 (and its uniform launch alone) and
     draw_colour_grid on 16384 keys (``check_threefry``);
  4-19 run with the plain settled mask, the plain trip and the plain
     combination branch refused on CUDA tensors (``plain_mask_refused``,
     ``plain_trip_refused``, ``plain_combination_refused``): K3 computes
     every settled mask, K4 every full-machinery trip and K5 every
     combination branch on the card;
  4. replays the recorded JAX rollouts (tests/data/torch_port_fixture_cfg0
     to _cfg4 and _nobomb.npz) through BatchedTileMatchEnv on the card
     (``tools.parity_check.replay_fixture``), every field;
  5. runs config 1 (10x10, 4 colours, 30 moves, no specials) at batch 16384
     for 32 auto-resetting steps under a random effective policy, checks
     that K1, K3 and the threefry words (the move's split) ran on every
     step, prints the launches a step, and
     times the steps;
  6. runs config 3 (the same with cookie, both lasers and bomb), the
     flagship, the same way: K5, K2, K4 and K3 on every step, board
     invariants, truncation, the combination boards a step and the
     cascade's telemetry;
  7. runs config 3 without the bomb the same way: K5, K2's no-bomb case
     table, K4 and K3 on every step;
  8. drives the Gym adapter's two engines on the card, one board at a
     time: replays tests/golden_episodes.json through the numpy-parity
     engine and the recorded JAX Gym episodes (tests/data/
     torch_port_gym_episodes.json: threefry and numpy modes; all, no,
     laser-only and cookie-only specials) through ThreefryDriver and
     ParityEngine, bit for bit, checks that the threefry episodes launched
     the kernels, and prints ms per step;
  9-15 run the training path, the plain mask and trip still refused:
  9. replays the recorded JAX draws (tests/data/torch_port_fixture_dqn.npz):
     ``uniform`` over [16384] and the [16384, 180] uniforms of
     ``categorical`` bit for bit, its argmax on every board;
  10. trains the DQN on config 1 at full width (batch 256, hidden 512):
     40 steps at epsilon 1 from numpy-seeded weights against the recorded
     JAX run — actions, rewards, dones and the final env state bit for
     bit, across the auto-reset; loss and |TD| every step; after steps 1,
     5 and 40 Adam's first moment and the weights' change from the seeded
     start, leaf by leaf by relative norm (step 1's moment, the gradient
     of the same weights and batch, within LEARNER_GRAD_REL) — then 60
     steps of the default schedule, timed: ms a step, the env step and the
     learner apart (CUDA events), host syncs a step, reward mean; K1 on
     every step (a train step passes the env the previous mask and K1
     returns the next, as the reference's ``batched_step`` does with
     ``eff_mask``: tile_match_tpu/envs/batched.py:91), K3 where boards
     regenerate (the auto-reset), the loss finite;
  11. holds the Q-network on numpy-seeded weights to the recorded flax Q;
  12. trains the DQN on config 3 for 8 steps: K5, K2 and K3 on every step;
  13. runs DQN with replay (60 steps, updates from step 20 on, none
     before), QR-DQN (30 steps, 75 quantiles), ``run_random`` in both
     modes and ``train_dense`` at 3x3x2x5;
  14. saves the DQN state, runs 8 steps, restores it and runs the same 8:
     env states, parameters and Adam moments equal (torch.equal);
  15. runs ``entry()``'s forward (every special, B=64) on the seeded
     weights against the recorded JAX entry: K2 and K3 launch;
  16-19 run the scale-out layer (``tile_match_tpu_torch.parallel``), the
     plain mask and trip still refused:
  16. starts a one-rank NCCL group (``initialize_distributed`` on a free
     localhost port); ``sharded_rollout`` on ``make_mesh(dp=1)`` replays
     the recorded JAX ``sharded_rollout`` (tests/data/
     torch_port_fixture_sharded.npz: config 3, 64 boards, 8 steps) bit for
     bit; then config 1 and config 3 at B=16384 for 8 steps: K1 (config 1)
     and K5, K2 and K3 (config 3) on every step, K3 at config 1's reset;
     board-steps/s and launches a step;
  17. two ranks sharing the card over gloo (``parallel.launch``): dp=2 on
     config 3 at B=16384 for 8 steps equals phase 16's run board for board
     (``gather_boards``), each rank's board-steps/s; ``dryrun_multichip(2)``;
  18. ``sharded_train_step`` at (dp, tp) = (1, 1) over NCCL replays the two
     recorded JAX sharded train steps (config 1, B=256, hidden 512,
     epsilon 1, seeded weights): the env side bit for bit, loss within
     rtol 5e-2, the learner leaf by leaf; ``make_dqn``'s unsharded step
     from the same weights: env side, losses and weights bit for bit;
     then (1, 2) on two ranks sharing the card over gloo against (1, 1):
     losses within rtol 5e-2, each leaf's change within LEARNER_DRIFT_REL;
     ms a step;
  19. ``debug.checked_step`` over the recorded config-3 boards (its full
     trips through K4); a painted ``max_lines=1`` board raises on the
     card, as does a step cut at ``max_cascades=0``; a painted board for
     each of K4's caps (lines, classify queue, emissions, stack) raises
     through K4 the message the plain trip raises on the CPU, and K5
     under max_stack=2 and under max_activation_steps=3 the plain
     branch's;
     ``profiling.measure_throughput`` on config 1 at B=16384 prints its
     JSON;
  20. runs the port's bench (``python -m tile_match_tpu_torch.bench``) in
     a process of its own for each of bench.py's five configs, on the
     libraries phase 2 built: configs 1 and 3 at the bench's defaults,
     configs 0, 2 and 4 cut to TMT_BENCH_STEPS=1 TMT_BENCH_REPS=1; each
     must exit 0 after its parity gate (on configs 0-1 it also holds K1
     against its plain version at the bench's batch), launch its path's
     kernels (K1 on configs 0-1, K5, K2, K4 and K3 on configs 2-4) in the
     timed windows and end
     with bench.py's line (metric, value above 0, unit, vs_baseline); its
     gate and window lines are echoed;
  21. the gate tools on the card: ``tools.parity_check`` (every check;
     it holds K1 against its plain version on the card, so the plain mask
     runs there), then, with the plain mask, trip and combination branch
     refused again,
     ``tools.kernel_coverage`` on config 3 (B=256, 30 steps) and
     ``tools.truncation_audit`` on config 3 (B=4096, 32 steps, truncated
     board-steps under 0.01%).
The line before the last is the kernels' JSON record (``launches``: over
the batched drives of phases 5-7, the main paths; the training path's
launches stand on its phase lines, phases 10 and 12 a step); the last
line is
{"ok": true, "device": {...}}.  Imports no JAX.
"""

from __future__ import annotations

import contextlib
import ctypes
import dataclasses
import json
import os
import subprocess
import sys
import time

import numpy as np

from tile_match_tpu_torch import cuda_build

ROOT = os.path.dirname(os.path.abspath(__file__))
FIXTURE_CFG3 = os.path.join(ROOT, "tests", "data", "torch_port_fixture_cfg3.npz")
FIXTURE_NOBOMB = os.path.join(ROOT, "tests", "data", "torch_port_fixture_nobomb.npz")
# phase 4 replays every recorded batched rollout: bench.py's five configs
# and config 3 without the bomb
FIXTURES_BATCHED = tuple(os.path.join(ROOT, "tests", "data", f"torch_port_fixture_{name}.npz")
                         for name in ("cfg0", "cfg1", "cfg2", "cfg3", "cfg4", "nobomb"))
FIXTURE_GYM = os.path.join(ROOT, "tests", "data", "torch_port_gym_episodes.json")
FIXTURE_DQN = os.path.join(ROOT, "tests", "data", "torch_port_fixture_dqn.npz")
FIXTURE_SHARDED = os.path.join(ROOT, "tests", "data", "torch_port_fixture_sharded.npz")
GOLDEN = os.path.join(ROOT, "tests", "golden_episodes.json")
# the TPU kernel each of the port's kernels (``cuda_build.KERNELS``)
# replaces; the threefry words and the line test replace XLA's own
REPLACES = {
    "fused_cascade": "tile_match_tpu/ops/pallas_cascade.py:1107",
    "cascade_sp_chunk": "tile_match_tpu/ops/pallas_cascade.py:1434",
    "settled_mask_sp": "tile_match_tpu/ops/pallas_cascade.py:1039",
    # no Pallas kernel: the XLA program of the full-machinery trip
    "specials_trip": "tile_match_tpu/engine.py:173",
    # no Pallas kernel: the XLA combination round
    "combination_trip": "tile_match_tpu/envs/fused.py:469",
}
SHAPES = ((10, 10, 4, 16384), (6, 6, 3, 1000), (20, 20, 6, 1024), (36, 36, 6, 256))
# K1 alone: (R, C, K, B); it takes four warps a board below 8,192 boards a
# launch and one from there, so each variant runs at 5x5 and 10x10 (config
# 0's bench batch is 32768, config 1's 16384)
K1_SHAPES = ((10, 10, 4, 16384), (10, 10, 4, 1000), (5, 5, 3, 1000), (5, 5, 3, 32768),
             (20, 20, 6, 1024), (36, 36, 6, 256))
# the board shapes the kernels' libraries are built for in phase 2: they
# take their shape at compile time, and 36x36 stands for every board above
# 32 by 32 (one library whose geometry is read at run time)
LIBRARY_SHAPES = {
    "cascade": ((10, 10), (5, 5), (20, 20), (36, 36)),
    "cascade_sp": ((10, 10), (5, 5), (6, 6), (8, 8), (20, 20), (36, 36)),
    "mask_sp": ((10, 10), (5, 5), (6, 6), (8, 8), (20, 20), (36, 36)),
    "trip_sp": ((10, 10), (5, 5), (6, 6), (8, 8), (20, 20), (36, 36)),
    "combination": ((10, 10), (5, 5), (6, 6), (8, 8), (20, 20), (36, 36)),
}
# K4 on K2's frozen boards and on raw boards: (R, C, K, B, config overrides);
# 80x80's scratch exceeds a block's shared memory and lies in device memory
K4_SHAPES = ((10, 10, 4, 16384, {}), (6, 6, 3, 1000, {}),
             (20, 20, 6, 1024, {}), (36, 36, 6, 256, {}), (80, 80, 6, 16, {}),
             (10, 10, 3, 4096, {"max_lines": 2}), (10, 10, 3, 4096, {"max_stack": 2}))
# K5 on boards whose swap cells hold every ordered pair of kinds: (R, C, K,
# B, config overrides); 80x80's scratch takes a block's shared memory for
# one board, 100x100's lies in device memory, and the tight caps fire on
# some boards
K5_SHAPES = ((10, 10, 4, 16384, {}), (6, 6, 3, 1000, {}), (20, 20, 6, 1024, {}),
             (36, 36, 6, 256, {}), (80, 80, 6, 16, {}), (100, 100, 6, 8, {}),
             (10, 10, 3, 4096, {"max_stack": 2}), (10, 10, 3, 4096, {"max_activation_steps": 8}))
# the config-3 step whose K5 inputs phase 3 times (late in the episode,
# where the boards hold the most specials; the auto-reset is at step 29)
K5_MAIN_STEP = 20
# K3 alone, with specials and without: (R, C, K, B)
K3_SHAPES = ((10, 10, 4, 1), (10, 10, 4, 130), (10, 10, 4, 16384), (20, 20, 6, 1024),
             (36, 36, 6, 256))
# K2's no-bomb case table: (R, C, K, B, (cookie, vertical laser, horizontal laser))
NO_BOMB_SHAPES = ((10, 10, 4, 16384, (1, 1, 1)), (6, 6, 3, 1000, (0, 1, 1)),
                  (8, 8, 4, 1000, (1, 0, 0)), (20, 20, 6, 1024, (1, 1, 1)),
                  (36, 36, 6, 256, (1, 1, 1)))
ALL_SPECIALS = (1, 1, 1, 1)
NO_BOMB = (1, 1, 1, 0)
# phases 5-7, the batched main paths at 10x10x4, 30 moves: name -> (tag,
# specials, the kernels every step must launch)
MAIN_PATHS = {
    "1": ("phase 5 (config 1)", (0, 0, 0, 0), ("fused_cascade", "settled_mask_sp", "threefry_words")),
    "3": ("phase 6 (config 3)", ALL_SPECIALS,
          ("combination_trip", "cascade_sp_chunk", "specials_trip", "settled_mask_sp",
           "threefry_words", "line_test")),
    "3-no-bomb": ("phase 7 (config 3 without the bomb)", NO_BOMB,
                  ("combination_trip", "cascade_sp_chunk", "specials_trip", "settled_mask_sp",
                   "threefry_words", "line_test")),
}
MAIN_BATCH = 16384
MAIN_STEPS = 32
# phases 16-17: steps of each sharded rollout; phase 18: timed train steps
SCALE_STEPS = 8
SCALE_TRAIN_STEPS = 20
# phase 20: the port's bench, (config, TMT_BENCH_* environment); configs
# 1 and 3 at the bench's defaults, the others cut to one window of one chunk
BENCH_CUT = {"TMT_BENCH_STEPS": "1", "TMT_BENCH_REPS": "1"}
BENCH_RUNS = ((1, {}), (3, {}), (0, BENCH_CUT), (2, BENCH_CUT), (4, BENCH_CUT))
BENCH_TIMEOUT = 300
# phase 21: kernel_coverage's and truncation_audit's runs (their tools' defaults)
COVERAGE_BATCH, COVERAGE_STEPS = 256, 30
AUDIT_BATCH, AUDIT_STEPS = 4096, 32
SLEEP_CYCLES = 20_000_000  # ~10 ms on the card: longer than the host takes to queue the launches
SEED = 0
# phase 10's learner against the recorded JAX one, leaf by leaf by relative
# norm on the recorded entries.  After step 1 Adam's first moment is 0.1 g
# on the same weights and batch: the backward pass alone, whose bfloat16
# hidden layers the two packages round at different places (under 0.05
# for the port on the CPU).  Later moments, and the weights' changes, hold
# two runs whose weights drift apart by rounding, and Adam's first step
# moves each entry by lr sign(g), which flips where g lies within rounding
# of 0 (dense1's change after step 1: 0.33 on the CPU).  A gradient of the
# wrong sign reads 2 on either, a zero one 1.
LEARNER_GRAD_REL = 0.1
LEARNER_DRIFT_REL = 0.5
# H100 SXM peaks (published datasheet): HBM bytes/s, and the
# non-tensor float32 rate, used as the ceiling for the integer work
PEAK_BYTES = 3.35e12
PEAK_OPS = 67e12
# integer operations of the refill: 2 threefry-2x32 hashes of 20 rounds, 3
# operations a round, per refilled cell, and 3 per board-trip for its keys
OPS_PER_REFILL = 2 * 20 * 3
OPS_PER_TRIP_KEYS = 3 * 20 * 3
# the combination branch's keys: split(key), then split(kd) for the refill
OPS_PER_COMB_KEYS = 4 * 20 * 3
# one threefry-2x32 hash, by the count above (the random words of
# random.py's kernel, csrc/threefry_words.cu)
OPS_PER_HASH = 20 * 3
# the line test's work a cell (csrc/line_test.cu): eight neighbour
# compares, their conjunctions and two sums
OPS_PER_LINE_CELL = 16
# phase 3's line test: the main paths' shapes, (R, C, K, B)
LINE_TEST_SHAPES = ((10, 10, 4, 16384), (20, 20, 6, 8192))
# K5's latency floor: the longest chain's micro-steps, each at least one
# dependent warp vote and one shuffle (~25 cycles of latency each on
# Hopper: an estimate, not a measurement), at the H100 SXM's boost clock
FLOOR_CYCLES_PER_MICRO_STEP = 50
CLOCK_HZ = 1.98e9


def check(cond, msg: str) -> None:
    if not cond:
        raise RuntimeError(msg)


def _config(R, C, K, moves=30, specials=(0, 0, 0, 0)):
    """EnvConfig with the given (cookie, vertical laser, horizontal laser,
    bomb) flags."""
    from tile_match_tpu_torch.config import EnvConfig

    cookie, v_laser, h_laser, bomb = (bool(f) for f in specials)
    return EnvConfig(R, C, K, moves, cookie=cookie, vertical_laser=v_laser,
                     horizontal_laser=h_laser, bomb=bomb)


def play_episode(engine, cfg, ep) -> list:
    """Play one recorded Gym episode through a Gym engine (``ParityEngine``
    or ``ThreefryDriver``) as ``TileMatchEnv`` does — reset, then per step
    the move, its info dict and the effective actions, none once done —
    and check every observation, reward and info against the record.
    Returns the host milliseconds of each step."""
    import torch

    from tile_match_tpu_torch.state import action_table

    c1, c2 = action_table(cfg)
    engine.generate_board()
    check(np.array_equal(engine.board, np.asarray(ep["reset_board"])), "gym reset board differs")
    check(np.flatnonzero(engine.effective_mask()).tolist() == ep["reset_effective"],
          "gym reset effective actions differ")
    ms = []
    for t, want in enumerate(ep["steps"]):
        a = want["action"]
        t0 = time.perf_counter()
        elim, comb, new, act, shuffled = engine.move(tuple(c1[a]), tuple(c2[a]))
        done = t + 1 == cfg.num_moves
        eff = [] if done else np.flatnonzero(engine.effective_mask()).tolist()
        if engine.device.type == "cuda":
            torch.cuda.synchronize(engine.device)
        ms.append((time.perf_counter() - t0) * 1e3)
        info = {"is_combination_match": comb, "num_new_specials": new,
                "num_specials_activated": act, "shuffled": shuffled, "effective_actions": eff}
        check(np.array_equal(engine.board, np.asarray(want["board"])), f"gym step {t}: board differs")
        check(elim == want["reward"] and done == want["done"], f"gym step {t}: reward or done differs")
        check(info == want["info"], f"gym step {t}: info differs: {info} != {want['info']}")
    return ms


def replay_gym(device, path: str = FIXTURE_GYM) -> dict:
    """Replay the recorded JAX Gym episodes through the port's engines on
    ``device``; raises on the first difference.  Returns {(rng_mode, name):
    host ms of each step}."""
    import json

    from tile_match_tpu_torch.config import EnvConfig
    from tile_match_tpu_torch.envs._threefry_driver import ThreefryDriver
    from tile_match_tpu_torch.parity import ParityEngine

    with open(path) as f:
        episodes = json.load(f)
    out = {}
    for ep in episodes:
        R, C, K, M = ep["config"]
        cfg = EnvConfig.create(R, C, K, M, colourless_specials=ep["specials"][0],
                               colour_specials=ep["specials"][1])
        if ep["rng_mode"] == "threefry":
            engine = ThreefryDriver(cfg, ep["seed"], device)
        else:
            engine = ParityEngine(cfg, np.random.default_rng(ep["seed"]), device)
        out[(ep["rng_mode"], ep["name"])] = play_episode(engine, cfg, ep)
    return out


def replay_golden(device, path: str = GOLDEN) -> list:
    """Replay tests/golden_episodes.json (numpy mode, every special)
    through ``ParityEngine`` on ``device``.  Returns the host ms of each
    step."""
    import json

    from tile_match_tpu_torch.parity import ParityEngine

    with open(path) as f:
        episodes = json.load(f)
    ms = []
    for ep in episodes:
        R, C, K, M, seed = ep["config"]
        cfg = _config(R, C, K, M, ALL_SPECIALS)
        engine = ParityEngine(cfg, np.random.default_rng(seed), device)
        ms += play_episode(engine, cfg, ep)
    return ms


def _random_inputs(R, C, K, B, seed, device):
    import torch

    rng = np.random.default_rng(seed)
    colour = rng.integers(1, K + 1, size=(B, R, C)).astype(np.int32)
    keys = rng.integers(0, 1 << 32, size=(B, 2), dtype=np.uint64).astype(np.int64)
    return torch.as_tensor(colour, device=device), torch.as_tensor(keys, device=device)


def sprinkled_inputs(R, C, K, B, seed, device, kinds=(2, 3, 4, -1)):
    """K2's inputs from numpy: uniform random boards with 0-5 specials each
    of ``kinds`` (by default vertical and horizontal lasers, bombs, cookies
    — colour 0), threefry keys, starting trip counts 0-2, eliminations 0-9
    and 5% frozen boards.  Returns (colour, kind, sub_keys, trips, elim,
    frozen)."""
    import torch

    rng = np.random.default_rng(seed)
    colour = rng.integers(1, K + 1, size=(B, R, C)).astype(np.int32)
    kind = np.ones_like(colour)
    n_sp = rng.integers(0, 6, size=B)
    for b in range(B):
        cells = rng.choice(R * C, size=n_sp[b], replace=False)
        ks = rng.choice(np.array(kinds, np.int32), size=n_sp[b])
        kind[b].reshape(-1)[cells] = ks
        colour[b].reshape(-1)[cells[ks == -1]] = 0
    keys = rng.integers(0, 1 << 32, size=(B, 2), dtype=np.uint64).astype(np.int64)
    trips = rng.integers(0, 3, size=B).astype(np.int32)
    elim = rng.integers(0, 10, size=B).astype(np.int32)
    frozen = (rng.random(B) < 0.05).astype(np.int32)
    return tuple(torch.as_tensor(a, device=device) for a in (colour, kind, keys, trips, elim, frozen))


KINDS = (-1, 1, 2, 3, 4)
PAIRS = tuple((a, b) for a in KINDS for b in KINDS)  # every ordered pair of swap-cell kinds


def combination_inputs(R, C, K, B, seed, device, kinds=(2, 3, 4, -1)):
    """K5's inputs from numpy: uniform random boards with 0-9 specials each
    of ``kinds`` (by default lasers, bombs, cookies — colour 0), a swap of a
    random cell and its right or lower neighbour whose two cells hold the
    25 ordered pairs of kinds (cookie, normal, vertical laser, horizontal
    laser, bomb) in turn, threefry keys, and the combination flag: both
    cells special or one a cookie (``ops.combination.is_combination``),
    less one board in ten (a move that was not effective).  Returns
    (colour, kind, keys, coord1, coord2, comb)."""
    import torch

    rng = np.random.default_rng(seed)
    colour = rng.integers(1, K + 1, size=(B, R, C)).astype(np.int32)
    kind = np.ones_like(colour)
    n_sp = rng.integers(0, 10, size=B) if kinds else np.zeros(B, int)
    for b in range(B):
        cells = rng.choice(R * C, size=n_sp[b], replace=False)
        ks = rng.choice(np.array(kinds, np.int32), size=n_sp[b])
        kind[b].reshape(-1)[cells] = ks
        colour[b].reshape(-1)[cells[ks == -1]] = 0
    c1 = np.stack([rng.integers(0, R - 1, B), rng.integers(0, C - 1, B)], 1).astype(np.int32)
    right = rng.random(B) < 0.5
    c2 = (c1 + np.where(right[:, None], [0, 1], [1, 0])).astype(np.int32)
    bi = np.arange(B)
    pair = np.array(PAIRS, np.int32)[bi % len(PAIRS)]
    for j, c in enumerate((c1, c2)):
        kind[bi, c[:, 0], c[:, 1]] = pair[:, j]
        colour[bi, c[:, 0], c[:, 1]] = np.where(pair[:, j] == -1, 0, rng.integers(1, K + 1, B))
    k1, k2 = pair[:, 0], pair[:, 1]
    comb = (((k1 > 1) | (k1 < 0)) & ((k2 > 1) | (k2 < 0))) | (k1 < 0) | (k2 < 0)
    comb &= rng.random(B) < 0.9
    keys = rng.integers(0, 1 << 32, size=(B, 2), dtype=np.uint64).astype(np.int64)
    return tuple(torch.as_tensor(a, device=device) for a in (colour, kind, keys, c1, c2, comb))


def corner_boards(B, seed):
    """Boards with an L of two cookie lines, lengths 6 or 7, whose shared
    corner lies in the tails of both: a horizontal line in row 6 or 7 and a
    vertical line ending on its last or second-to-last cell, on a
    line-free two-colour base (colours 1 and 2, the L in 3 or 4)."""
    rng = np.random.default_rng(seed)
    rows, cols = np.indices((8, 8))
    colour = np.where((rows + cols) % 2 == 0, 1, 2)[None].repeat(B, 0).astype(np.int32)
    for b in range(B):
        hl, vl = int(rng.integers(6, 8)), int(rng.integers(6, 8))
        r, c0 = int(rng.integers(6, 8)), int(rng.integers(0, 9 - hl))
        cross = c0 + hl - 1 - int(rng.integers(0, hl - 5))
        pc = int(rng.integers(3, 5))
        colour[b, r, c0 : c0 + hl] = pc
        colour[b, r - vl + 1 : r + 1, cross] = pc
    return colour, np.ones_like(colour)


def _filler(R, C):
    """A line-free grid of colours 1-3 (period-2 checker)."""
    r = np.arange(R)[:, None]
    c = np.arange(C)[None, :]
    return (((r % 2) * 2 + (c % 2)) % 3 + 1).astype(np.int32)


# K4's capacity caps, each with a board on which it fires in a whole trip
CAPS = ("lines", "queue", "emit", "stack")


def cap_board(cap):
    """(R, C, K, config overrides, colour, kind) of a board on which the
    given cap fires in one full-machinery trip."""
    if cap == "lines":  # two vertical lines, room for one
        colour = _filler(5, 5)
        colour[2:5, 0] = colour[2:5, 2] = 4
        return 5, 5, 4, dict(max_lines=1), colour, np.ones_like(colour)
    if cap == "queue":  # two crossing 13-lines: cookies whose remainders re-queue
        colour = _filler(13, 13)
        colour[:, 0] = colour[6, :] = 4
        return 13, 13, 4, dict(max_lines=2), colour, np.ones_like(colour)
    if cap == "emit":  # one 13-line, three matches (cookie, cookie, normal), room for two
        colour = _filler(13, 13)
        colour[:, 0] = 4
        return 13, 13, 4, dict(max_lines=1), colour, np.ones_like(colour)
    # stack: an h-laser in a line whose row holds a v-laser, one frame of room
    colour = _filler(5, 5)
    colour[2:5, 0] = 4
    kind = np.ones_like(colour)
    kind[3, 0], kind[3, 2] = 3, 2
    return 5, 5, 4, dict(max_stack=1), colour, kind


def _queued_ms(fn, reps: int) -> float:
    """Mean device ms of fn's launches, queued behind a sleep on the card so
    that they run back to back and a short kernel is timed without the
    host's call."""
    import torch

    fn()  # warm-up
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    torch.cuda._sleep(SLEEP_CYCLES)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


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


def _kernel_ms(fn, reps: int):
    """(mean ms of fn as called, back to back with the host's call: the
    kernels line's ``ms``; mean ms queued behind a sleep: the device's time
    alone)."""
    return _time_ms(fn, reps), _queued_ms(fn, reps)


def cascade_ops(cfg, refilled: int, trips: int) -> int:
    """Integer operations a cascade's inputs need: the refill's hashes of
    every refilled cell and the keys of every board-trip, and one a cell a
    trip."""
    return OPS_PER_REFILL * refilled + (OPS_PER_TRIP_KEYS + cfg.flat_size) * trips


def _nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def bound(nbytes: int, ops: int):
    """(least time in ms the card could take, "bytes" or "operations"): the
    bytes moved once over the memory rate against the operations over the
    peak rate, whichever is larger."""
    t_bytes, t_ops = nbytes / PEAK_BYTES, ops / PEAK_OPS
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def _assert_equal(got, want, names, tag) -> int:
    import torch

    err = 0
    for name, g, w in zip(names, got, want):
        check(g.shape == w.shape and g.dtype == w.dtype, f"{tag}: {name} shape/dtype differs")
        e = int((g.to(torch.int64) - w.to(torch.int64)).abs().max()) if g.numel() else 0
        err = max(err, e)
        check(e == 0, f"{tag}: kernel {name} differs from the plain version")
    return err


def check_kernels(device, smi):
    """Phase 3: every kernel against its plain version, and timed.  Returns
    {name: record} with max_abs_err, ms, plain_ms, bound_ms, bound_by."""
    import torch

    from tile_match_tpu_torch.ops import cascade, cascade_sp, mask_sp
    from tile_match_tpu_torch.ops.effective import effective_mask_settled

    rec = {}
    # K1
    names = ("colour", "elim", "trips", "truncated", "mask")
    err = 0
    for R, C, K, B in K1_SHAPES:
        cfg = _config(R, C, K)
        colour, sub = _random_inputs(R, C, K, B, seed=R * 1000 + B, device=device)
        got = cascade.fused_cascade(cfg, colour, sub)
        want = cascade.cascade_reference(cfg, colour, sub)
        torch.cuda.synchronize()
        err = max(err, _assert_equal(got, want, names, f"K1 {R}x{C}x{K} B={B}"))
        print(f"phase 3: K1 {R}x{C}x{K} B={B} kernel == plain in {', '.join(names)}; "
              f"mean trips {got[2].float().mean().item():.2f}")
    cfg1 = _config(10, 10, 4)
    colour, sub = _random_inputs(10, 10, 4, MAIN_BATCH, seed=7, device=device)
    out = cascade.fused_cascade(cfg1, colour, sub)
    ms, queued = _kernel_ms(lambda: cascade.fused_cascade(cfg1, colour, sub), reps=20)
    plain_ms = _time_ms(lambda: cascade.cascade_reference(cfg1, colour, sub), reps=2)
    ops = cascade_ops(cfg1, int(out[1].sum()), int(out[2].sum()))
    b_ms, b_by = bound(_nbytes(colour, sub, *out), ops)
    rec["fused_cascade"] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by)
    print(f"phase 3 ok: K1 10x10x4 B={MAIN_BATCH} uniform random boards: kernel {ms:.4f} ms "
          f"(queued {queued:.4f} ms), "
          f"plain {plain_ms:.4f} ms, bound {b_ms:.4f} ms ({b_by}) ({smi})")

    # K2 and K3, on boards with sprinkled specials
    names = ("colour", "kind", "trips", "elim", "new", "act", "frozen", "active", "reasons")
    err2 = err3 = 0
    for R, C, K, B in SHAPES:
        cfg = _config(R, C, K, 30, ALL_SPECIALS)
        inputs = sprinkled_inputs(R, C, K, B, seed=R * 100 + B, device=device)
        got = cascade_sp.cascade_sp_chunk(cfg, *inputs, limit=cfg.max_cascades)
        want = cascade_sp.cascade_sp_reference(cfg, *inputs, limit=cfg.max_cascades)
        torch.cuda.synchronize()
        err2 = max(err2, _assert_equal(got, want, names, f"K2 {R}x{C}x{K} B={B}"))
        m_got = mask_sp.settled_mask_sp(cfg, got[0], got[1])
        m_want = effective_mask_settled(cfg, got[0], got[1])
        torch.cuda.synchronize()
        err3 = max(err3, _assert_equal((m_got,), (m_want,), ("mask",), f"K3 {R}x{C}x{K} B={B}"))
        frozen = int(got[6].sum()) - int(inputs[5].sum())
        print(f"phase 3: K2 {R}x{C}x{K} B={B} kernel == plain in {', '.join(names)}; "
              f"mean trips {(got[2] - inputs[3]).float().mean().item():.2f}, {frozen} boards "
              f"frozen; K3 kernel == plain on its output")
    cfg3 = _config(10, 10, 4, 30, ALL_SPECIALS)
    inputs = sprinkled_inputs(10, 10, 4, MAIN_BATCH, seed=11, device=device)
    T = cfg3.max_cascades
    out = cascade_sp.cascade_sp_chunk(cfg3, *inputs, limit=T)
    ms, queued = _kernel_ms(lambda: cascade_sp.cascade_sp_chunk(cfg3, *inputs, limit=T), reps=20)
    plain_ms = _time_ms(lambda: cascade_sp.cascade_sp_reference(cfg3, *inputs, limit=T), reps=2)
    refilled = int((out[3] - inputs[4]).sum())
    ops = cascade_ops(cfg3, refilled, int((out[2] - inputs[3]).sum()))
    b_ms, b_by = bound(_nbytes(*inputs, *out), ops)
    rec["cascade_sp_chunk"] = dict(max_abs_err=err2, ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by)
    print(f"phase 3 ok: K2 10x10x4 B={MAIN_BATCH} sprinkled boards: kernel {ms:.4f} ms "
          f"(queued {queued:.4f} ms), "
          f"plain {plain_ms:.4f} ms, bound {b_ms:.4f} ms ({b_by}) ({smi})")
    # K2's no-bomb case table, with K3 on its output
    for R, C, K, B, flags in NO_BOMB_SHAPES:
        cfg = _config(R, C, K, 30, (*flags, 0))
        kinds = [k for k, on in ((2, flags[1]), (3, flags[2]), (-1, flags[0])) if on]
        inputs = sprinkled_inputs(R, C, K, B, seed=R * 100 + B + 1, device=device, kinds=kinds)
        got = cascade_sp.cascade_sp_chunk(cfg, *inputs, limit=cfg.max_cascades)
        want = cascade_sp.cascade_sp_reference(cfg, *inputs, limit=cfg.max_cascades)
        torch.cuda.synchronize()
        tag = f"K2 no-bomb {R}x{C}x{K} B={B} (cookie, v-laser, h-laser) = {flags}"
        err2 = max(err2, _assert_equal(got, want, names, tag))
        m_got = mask_sp.settled_mask_sp(cfg, got[0], got[1])
        m_want = effective_mask_settled(cfg, got[0], got[1])
        torch.cuda.synchronize()
        err3 = max(err3, _assert_equal((m_got,), (m_want,), ("mask",), f"K3 on {tag}"))
        fresh = (got[6] > 0) & (inputs[5] == 0)
        by_bit = [int(((got[8][fresh] >> b) & 1).sum()) for b in range(7)]
        print(f"phase 3: {tag} kernel == plain in {', '.join(names)}; mean trips "
              f"{(got[2] - inputs[3]).float().mean().item():.2f}, {int(fresh.sum())} boards "
              f"frozen, per reason bit {by_bit}; K3 kernel == plain on its output")
        if (R, C, K, B) == (10, 10, 4, MAIN_BATCH):
            ms_nb, q_nb = _kernel_ms(lambda: cascade_sp.cascade_sp_chunk(cfg, *inputs, limit=T),
                                     reps=20)
            plain_nb = _time_ms(lambda: cascade_sp.cascade_sp_reference(cfg, *inputs, limit=T), reps=2)
            refilled = int((got[3] - inputs[4]).sum())
            ops = cascade_ops(cfg, refilled, int((got[2] - inputs[3]).sum()))
            b_nb, by_nb = bound(_nbytes(*inputs, *got), ops)
            print(f"phase 3 ok: {tag}: kernel {ms_nb:.4f} ms (queued {q_nb:.4f} ms), "
                  f"plain {plain_nb:.4f} ms, "
                  f"bound {b_nb:.4f} ms ({by_nb}) ({smi})")
    # the corner in the tails of two crossing cookie lines survives
    cfg = _config(8, 8, 4, 30, NO_BOMB)
    colour, kind = (torch.as_tensor(a, device=device) for a in corner_boards(1024, seed=5))
    keys = torch.arange(2048, dtype=torch.int64, device=device).reshape(1024, 2)
    z = torch.zeros(1024, dtype=torch.int32, device=device)
    inputs = (colour, kind, keys, z, z, z)
    got = cascade_sp.cascade_sp_chunk(cfg, *inputs, limit=1)
    want = cascade_sp.cascade_sp_reference(cfg, *inputs, limit=1)
    torch.cuda.synchronize()
    err2 = max(err2, _assert_equal(got, want, names, "K2 no-bomb crossing cookie tails"))
    check(bool((got[4] == 2).all()), "K2 no-bomb crossing cookie tails: not two cookies a board")
    print("phase 3: K2 no-bomb 8x8x4 B=1024 crossing cookie tails kernel == plain, two cookies "
          "a board in closed form")
    rec["cascade_sp_chunk"]["max_abs_err"] = err2

    colour, kind = out[0], out[1]
    mask = mask_sp.settled_mask_sp(cfg3, colour, kind)
    ms, queued = _kernel_ms(lambda: mask_sp.settled_mask_sp(cfg3, colour, kind), reps=50)
    plain_ms = _time_ms(lambda: effective_mask_settled(cfg3, colour, kind), reps=5)
    b_ms, b_by = bound(_nbytes(colour, kind, mask), 24 * mask.numel())
    rec["settled_mask_sp"] = dict(max_abs_err=err3, ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by)
    print(f"phase 3 ok: K3 10x10x4 B={MAIN_BATCH} K2's output boards: kernel {ms:.4f} ms "
          f"(queued {queued:.4f} ms), "
          f"plain {plain_ms:.4f} ms, bound {b_ms:.4f} ms ({b_by}) ({smi})")
    # K3 alone: one board (the Gym adapter's), a batch that fills no whole
    # block of boards, the main batch, config 4's shape and a board above
    # 32x32, each with specials and without
    for R, C, K, B in K3_SHAPES:
        colour, kind = sprinkled_inputs(R, C, K, B, seed=R * 10 + B, device=device)[:2]
        for flags in (ALL_SPECIALS, (0, 0, 0, 0)):
            cfg = _config(R, C, K, 30, flags)
            before = cuda_build.launches["settled_mask_sp"]
            got = mask_sp.settled_mask_sp(cfg, colour, kind)
            want = effective_mask_settled(cfg, colour, kind)
            torch.cuda.synchronize()
            check(cuda_build.launches["settled_mask_sp"] == before + 1,
                  "K3: the wrapper did not launch the kernel")
            tag = f"K3 {R}x{C}x{K} B={B} any_special={cfg.any_special}"
            err3 = max(err3, _assert_equal((got,), (want,), ("mask",), tag))
        print(f"phase 3: K3 {R}x{C}x{K} B={B} kernel == plain with specials and without")
    rec["settled_mask_sp"]["max_abs_err"] = err3
    rec["specials_trip"] = check_trip(device, smi)
    rec["combination_trip"] = check_combination(device, smi)
    rec["threefry_words"] = check_threefry(device, smi)
    rec["line_test"] = check_line_test(device, smi)
    return rec


def check_line_test(device, smi) -> dict:
    """Phase 3, the line test kernel (``ops/lines.py`` on CUDA tensors)
    against its plain version, the run-extent scans on the CPU, bit for
    bit at the main paths' shapes: ``run_member_mask`` and ``has_any_line``
    on uniform random boards, one launch a call; each timed as called and
    queued, with its bytes bound and the plain version's time on the card.
    Returns the kernels-line record (10x10x4 B=MAIN_BATCH's mask, each
    case's under ``cases``)."""
    import torch

    from tile_match_tpu_torch.ops import lines

    out = {}
    for R, C, K, B in LINE_TEST_SHAPES:
        colour, _ = _random_inputs(R, C, K, B, seed=R * C + B, device=device)
        cells = B * R * C
        for what, fn, plain, out_bytes in (
                ("member", lines.run_member_mask, lines.plain_run_member_mask, cells),
                ("any", lines.has_any_line, lines.plain_has_any_line, B)):
            name = f"{what} {R}x{C}x{K} B={B}"
            before = cuda_build.launches["line_test"]
            got = fn(None, colour)
            torch.cuda.synchronize()
            count = cuda_build.launches["line_test"] - before
            check(count == 1, f"line test {name}: {count} launches")
            want = plain(None, colour.cpu())
            check(got.dtype == want.dtype and got.shape == want.shape
                  and torch.equal(got.cpu(), want),
                  f"line test {name}: the kernel differs from the plain version")
            ms, queued = _kernel_ms(lambda: fn(None, colour), reps=50)
            plain_ms = _time_ms(lambda: plain(None, colour), reps=5)
            b_ms, b_by = bound(4 * cells + out_bytes, OPS_PER_LINE_CELL * cells)
            out[name] = dict(ms=ms, queued_ms=queued, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by)
            print(f"phase 3: line test {name}: kernel == plain ({int(want.sum())} true); kernel "
                  f"{ms:.4f} ms (queued {queued:.4f} ms), plain {plain_ms:.4f} ms, bound "
                  f"{b_ms:.4f} ms ({b_by}) ({smi})")
    head = out[f"member 10x10x4 B={MAIN_BATCH}"]
    print(f"phase 3 ok: line test: one launch a call, equal to the plain version ({smi})")
    return dict(max_abs_err=0, **head, cases=out)


def check_threefry(device, smi) -> dict:
    """Phase 3, the threefry kernel (``random.py`` on CUDA tensors) against
    the plain version on the card at the main path's shapes: one key's
    split (the harness's and the move's), categorical over MAIN_BATCH boards
    of 180 actions (the policy draw; the kernel's launch is its uniforms)
    and draw_colour_grid over MAIN_BATCH keys (a regeneration iteration's
    randint); each timed as called and queued, with the bound of the
    kernel's launch and the plain version's time.  Returns the kernels-line
    record (the categorical's uniform launch, each case's under ``cases``)."""
    import torch

    from tile_match_tpu_torch import random as trandom
    from tile_match_tpu_torch.ops.board_ops import draw_colour_grid

    cfg = _config(10, 10, 4)
    A, n = cfg.num_actions, cfg.flat_size
    key = trandom.PRNGKey(SEED, device)
    keys = trandom.plain_split(key, MAIN_BATCH)
    gen = torch.Generator(device=device)
    gen.manual_seed(SEED)
    logits = torch.where(torch.rand(MAIN_BATCH, A, generator=gen, device=device) < 0.3, 0.0, -torch.inf)
    tiny = float(np.finfo(np.float32).tiny)

    def plain_categorical():
        u = trandom.plain_uniform(key, logits.shape, tiny, 1.0)
        return torch.argmax(-torch.log(-torch.log(u)) + logits, dim=-1)

    cases = (  # name, the kernel path, the plain version, its launch (bytes, operations)
        ("split, one key", lambda: trandom.split(key), lambda: trandom.plain_split(key),
         (16 + 32, 2 * OPS_PER_HASH)),
        (f"categorical {MAIN_BATCH}x{A}", lambda: trandom.categorical(key, logits), plain_categorical,
         (16 + 4 * MAIN_BATCH * A, MAIN_BATCH * A * OPS_PER_HASH)),
        (f"uniform {MAIN_BATCH}x{A} (categorical's launch)",
         lambda: trandom.uniform(key, logits.shape, tiny, 1.0),
         lambda: trandom.plain_uniform(key, logits.shape, tiny, 1.0),
         (16 + 4 * MAIN_BATCH * A, MAIN_BATCH * A * OPS_PER_HASH)),
        (f"draw_colour_grid {MAIN_BATCH} keys", lambda: draw_colour_grid(keys, cfg),
         lambda: trandom.plain_randint(keys, (10, 10), 1, 5),
         (16 * MAIN_BATCH + 4 * MAIN_BATCH * n, MAIN_BATCH * n * 4 * OPS_PER_HASH)),
    )
    out = {}
    for name, kernel, plain, (nbytes, ops) in cases:
        before = cuda_build.launches["threefry_words"]
        got = kernel()
        torch.cuda.synchronize()
        count = cuda_build.launches["threefry_words"] - before
        check(count == 1, f"threefry {name}: {count} launches")
        want = plain()
        check(got.dtype == want.dtype and got.shape == want.shape and torch.equal(got, want),
              f"threefry {name}: the kernel differs from the plain version")
        ms, queued = _kernel_ms(kernel, reps=50)
        plain_ms = _time_ms(plain, reps=5)
        b_ms, b_by = bound(nbytes, ops)
        out[name] = dict(ms=ms, queued_ms=queued, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by)
        print(f"phase 3: threefry {name}: kernel == plain; kernel {ms:.4f} ms (queued "
              f"{queued:.4f} ms), plain {plain_ms:.4f} ms, bound {b_ms:.4f} ms ({b_by}) ({smi})")
    head = out[cases[2][0]]
    print(f"phase 3 ok: threefry words: one launch a call, equal to the plain version ({smi})")
    return dict(max_abs_err=0, **head, cases=out)


def frozen_trip_inputs(cfg, B, seed, device):
    """K4's inputs from K2: the boards that K2's kernel froze among B boards
    with sprinkled specials, as K2 left them, with their keys and trips."""
    import torch

    from tile_match_tpu_torch.ops import cascade_sp

    colour, kind, keys = sprinkled_inputs(cfg.num_rows, cfg.num_cols, cfg.num_colours, B, seed,
                                          device)[:3]
    z = torch.zeros(B, dtype=torch.int32, device=device)
    out = cascade_sp.cascade_sp_chunk(cfg, colour, kind, keys, z, z, z, limit=cfg.max_cascades)
    f = out[6] > 0
    return out[0][f].contiguous(), out[1][f].contiguous(), keys[f].contiguous(), out[2][f].contiguous()


def main_path_trip_inputs(device):
    """The inputs of K4's first launch in config 3's first step at
    MAIN_BATCH from reset (the boards K2 froze in the cascade's first
    round), recorded on their way to the kernel."""
    import torch

    from tile_match_tpu_torch import engine
    from tile_match_tpu_torch import random as trandom
    from tile_match_tpu_torch.envs.batched import BatchedTileMatchEnv

    cfg = _config(10, 10, 4, 30, ALL_SPECIALS)
    env = BatchedTileMatchEnv(cfg, MAIN_BATCH, device=device)
    states, ts = env.reset(trandom.PRNGKey(SEED, device))
    mask = ts.info.effective_actions
    gen = torch.Generator(device=device)
    gen.manual_seed(SEED)
    actions = torch.where(mask, torch.rand(mask.shape, generator=gen, device=device), -1.0).argmax(-1)
    seen, real = [], engine.specials_trip

    def record(cfg_, *args):
        if not seen:
            seen.append(tuple(a.clone() for a in args))
        return real(cfg_, *args)

    engine.specials_trip = record
    try:
        env.step(states, actions)
    finally:
        engine.specials_trip = real
    return cfg, seen[0]


def check_trip(device, smi) -> dict:
    """Phase 3, K4: the full-machinery trip against the plain trip on the
    card, on K2's frozen boards, raw boards, tight caps and a board whose
    scratch lies in device memory; then timed on the inputs of a main-path
    launch.  Returns its kernels-line record."""
    import torch

    from tile_match_tpu_torch import engine
    from tile_match_tpu_torch.ops import trip_sp

    names = ("colour", "kind", "elim", "act", "new", "ovf")
    err = 0
    for R, C, K, B, caps in K4_SHAPES:
        cfg = dataclasses.replace(_config(R, C, K, 30, ALL_SPECIALS), **caps)
        sets = [("raw boards", sprinkled_inputs(R, C, K, B, seed=R * 7 + B, device=device)[:4])]
        if R * C <= 1296:
            sets.append(("K2's frozen boards", frozen_trip_inputs(cfg, B, R * 5 + B, device)))
        for what, inputs in sets:
            before = cuda_build.launches["specials_trip"]
            got = trip_sp.specials_trip(cfg, *inputs)
            want = engine.specials_cascade_trip(cfg, *inputs)
            torch.cuda.synchronize()
            check(cuda_build.launches["specials_trip"] == before + 1,
                  "K4: the wrapper did not launch the kernel")
            tag = f"K4 {R}x{C}x{K} {caps or ''} {what} ({inputs[0].shape[0]})"
            err = max(err, _assert_equal(got, want, names, tag))
            print(f"phase 3: {tag} kernel == plain in {', '.join(names)}; activated "
                  f"{int(got[3].sum())}, created {int(got[4].sum())}, ovf {int(got[5].sum())}")
    cfg, inputs = main_path_trip_inputs(device)
    out = trip_sp.specials_trip(cfg, *inputs)
    err = max(err, _assert_equal(out, engine.specials_cascade_trip(cfg, *inputs), names,
                                 "K4 main-path launch"))
    ms, queued = _kernel_ms(lambda: trip_sp.specials_trip(cfg, *inputs), reps=20)
    plain_ms = _time_ms(lambda: engine.specials_cascade_trip(cfg, *inputs), reps=2)
    n = inputs[0].shape[0]
    b_ms, b_by = bound(_nbytes(*inputs, *out), cascade_ops(cfg, int(out[2].sum()), n))
    print(f"phase 3 ok: K4 10x10x4 config 3's first cascade round at B={MAIN_BATCH}, {n} frozen "
          f"boards: kernel {ms:.4f} ms (queued {queued:.4f} ms), plain {plain_ms:.4f} ms, "
          f"bound {b_ms:.4f} ms ({b_by}) ({smi})")
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by)


def main_path_comb_inputs(device):
    """The inputs of K5's launch in step K5_MAIN_STEP of config 3 at
    MAIN_BATCH from reset under the random effective policy of ``drive``,
    recorded on their way to the kernel."""
    import torch

    from tile_match_tpu_torch import engine
    from tile_match_tpu_torch import random as trandom
    from tile_match_tpu_torch.envs.batched import BatchedTileMatchEnv

    cfg = _config(10, 10, 4, 30, ALL_SPECIALS)
    env = BatchedTileMatchEnv(cfg, MAIN_BATCH, device=device)
    gen = torch.Generator(device=device)
    gen.manual_seed(SEED)
    states, ts = env.reset(trandom.PRNGKey(SEED, device))
    seen, real = [], engine.combination_trip

    def record(cfg_, *args):
        seen[:] = [tuple(a.clone() for a in args)]
        return real(cfg_, *args)

    engine.combination_trip = record
    try:
        for _ in range(K5_MAIN_STEP + 1):
            mask = ts.info.effective_actions
            scores = torch.rand(mask.shape, generator=gen, device=device)
            states, ts = env.step(states, torch.where(mask, scores, -1.0).argmax(-1))
    finally:
        engine.combination_trip = real
    return cfg, seen[-1]


def chain_lengths(cfg, inputs):
    """The activation machine's micro-steps on each flagged board of K5's
    inputs, counted by the plain machine (``ops.activate.machine_step``
    until every stack drains, as ``run_machine`` runs it, summing the
    boards whose stack is not empty): (the flagged boards' indices, their
    micro-steps)."""
    import torch

    from tile_match_tpu_torch import engine
    from tile_match_tpu_torch.ops import activate, combination

    counts, real = [], combination.run_machine

    def counting(cfg_, st):
        n = torch.zeros_like(st.sp)
        for _ in range(cfg_.activation_steps_max):
            go = st.sp > 0
            if not bool(go.any()):
                break
            n += go.to(n.dtype)
            st = activate.machine_step(cfg_, st, go)
        counts.append(n)
        return dataclasses.replace(st, ovf=st.ovf | (st.sp > 0))

    combination.run_machine = counting
    try:
        engine.combination_branch(cfg, *inputs)
    finally:
        combination.run_machine = real
    flagged = inputs[5].nonzero()[:, 0]
    return flagged, counts[0] if counts else torch.zeros_like(flagged)


def k5_ms(cfg, inputs, reps: int):
    """K5 on ``inputs``, each launch on a fresh copy of them (the kernel
    updates its boards in place; the copies are made before the clock
    starts): (mean ms as called, mean ms queued)."""
    from tile_match_tpu_torch.ops import combination

    def on_copies():
        copies = [tuple(t.clone() for t in inputs) for _ in range(reps + 1)]
        return lambda: combination.combination_trip(cfg, *copies.pop())

    return _time_ms(on_copies(), reps), _queued_ms(on_copies(), reps)


def k5_readings(cfg, inputs, reps: int) -> dict:
    """K5's readings on one launch's inputs: the inputs as they are
    (``ms``, ``queued_ms``), with every flag clear (the launch without its
    boards: ``clear_*``), with only the board of the longest chain flagged
    (``longest_*``), and the micro-steps of the flagged boards' chains by
    the plain machine (``steps_max``, ``steps_p99``, ``steps_mean``)."""
    import torch

    flagged, steps = chain_lengths(cfg, inputs)
    comb = inputs[5]
    rec = {"boards": int(flagged.numel())}
    rec["ms"], rec["queued_ms"] = k5_ms(cfg, inputs, reps)
    clear = (*inputs[:5], torch.zeros_like(comb))
    rec["clear_ms"], rec["clear_queued_ms"] = k5_ms(cfg, clear, reps)
    if flagged.numel():
        longest = flagged[steps.argmax()]
        alone = (*inputs[:5], torch.zeros_like(comb).index_fill_(0, longest[None], True))
        rec["longest_ms"], rec["longest_queued_ms"] = k5_ms(cfg, alone, reps)
        s = steps.double()
        rec.update(longest_board=int(longest), steps_max=int(steps.max()),
                   steps_p99=float(s.quantile(0.99)), steps_mean=float(s.mean()))
    return rec


def k5_bound(cfg, inputs, out):
    """K5's bound on one launch: (ms, "bytes" or "operations"), with the
    bytes that the function must move (each read once, each written once):
    every board's flag and key in, key and counts (elim, act, ovf, and the
    cap bits and frames live) out; a flagged board's cells and swap
    coordinates in and its cells out (an unflagged board's cells are
    neither read nor written); and the operations of the refill's hashes
    and the keys' splits."""
    colour, kind, key, coord1, coord2, comb = inputs
    n = int(comb.sum())
    every = _nbytes(comb[:1], key[:1], out[2][:1], out[3][:1], out[4][:1], out[5][:1]) + 8
    flagged = 2 * _nbytes(colour[:1], kind[:1]) + _nbytes(coord1[:1], coord2[:1])
    return bound(comb.numel() * every + n * flagged,
                 OPS_PER_REFILL * int(out[3].sum()) + OPS_PER_COMB_KEYS * n)


def check_combination(device, smi) -> dict:
    """Phase 3, K5: the combination branch against the plain branch on the
    card at K5_SHAPES, with every flag clear, with one flag set and on one
    board; then timed on the inputs of a main-path launch with the
    readings of ``k5_readings``.  Returns its kernels-line record."""
    import torch

    from tile_match_tpu_torch import engine
    from tile_match_tpu_torch.ops import combination

    names = ("colour", "kind", "key", "elim", "act", "ovf")
    err = 0

    def held(cfg, inputs, tag):
        """K5 (on a copy: it updates the boards in place) against the plain
        branch; the unflagged boards untouched.  Returns K5's outputs."""
        nonlocal err
        before = cuda_build.launches["combination_trip"]
        got = combination.combination_trip(cfg, *(t.clone() for t in inputs))
        want = engine.combination_branch(cfg, *inputs)
        torch.cuda.synchronize()
        check(cuda_build.launches["combination_trip"] == before + 1,
              f"{tag}: the wrapper did not launch the kernel")
        err = max(err, _assert_equal(got, want, names, tag))
        comb = inputs[5]
        check(bool((got[3][~comb] == 0).all()) and torch.equal(got[0][~comb], inputs[0][~comb])
              and torch.equal(got[1][~comb], inputs[1][~comb]),
              f"{tag}: a board whose flag is clear changed")
        return got

    for R, C, K, B, caps in K5_SHAPES:
        cfg = dataclasses.replace(_config(R, C, K, 30, ALL_SPECIALS), **caps)
        inputs = combination_inputs(R, C, K, B, seed=R * 11 + B, device=device)
        tag = f"K5 {R}x{C}x{K} B={B} {caps or ''}"
        got = held(cfg, inputs, tag)
        if caps:
            check(bool(got[5].any()), f"{tag}: the cap fired on no board")
        print(f"phase 3: {tag} kernel == plain in {', '.join(names)}; {int(inputs[5].sum())} "
              f"flagged boards, activated {int(got[4].sum())}, eliminated {int(got[3].sum())}, ovf "
              f"{int(got[5].sum())}")
    # every flag clear: the caller's boards byte for byte as they were; one
    # flag set; one board (the Gym adapter's threefry engine)
    cfg = _config(10, 10, 4, 30, ALL_SPECIALS)
    inputs = combination_inputs(10, 10, 4, MAIN_BATCH, seed=13, device=device)
    mine = tuple(t.clone() for t in inputs[:2])
    out = combination.combination_trip(cfg, *mine, *inputs[2:5], torch.zeros_like(inputs[5]))
    torch.cuda.synchronize()
    check(out[0] is mine[0] and out[1] is mine[1], "K5: the board outputs are not the caller's tensors")
    check(torch.equal(mine[0], inputs[0]) and torch.equal(mine[1], inputs[1])
          and torch.equal(out[2], inputs[2]) and not any(bool(t.any()) for t in out[3:]),
          "K5 with every flag clear: a board, key or count changed")
    first = int(inputs[5].nonzero()[0, 0])
    one = torch.zeros_like(inputs[5])
    one[first] = True
    held(cfg, (*inputs[:5], one), "K5 10x10x4 one flag set")
    held(cfg, tuple(t[first:first + 1].contiguous() for t in inputs), "K5 10x10x4 B=1")
    print(f"phase 3: K5 10x10x4 B={MAIN_BATCH} with every flag clear left the boards byte for byte "
          f"as they were; kernel == plain with one flag set and at B=1")

    cfg, inputs = main_path_comb_inputs(device)
    out = held(cfg, inputs, "K5 main-path launch")
    r = k5_readings(cfg, inputs, reps=20)
    plain_ms = _time_ms(lambda: engine.combination_branch(cfg, *inputs), reps=2)
    b_ms, b_by = k5_bound(cfg, inputs, out)
    floor_ms = r.get("steps_max", 0) * FLOOR_CYCLES_PER_MICRO_STEP / CLOCK_HZ * 1e3
    print(f"phase 3 ok: K5 10x10x4 config 3's step {K5_MAIN_STEP} at B={MAIN_BATCH}, {r['boards']} "
          f"flagged boards (activated {int(out[4].sum())}, max {int(out[4].max())}): kernel "
          f"{r['ms']:.4f} ms (queued {r['queued_ms']:.4f} ms); every flag clear {r['clear_ms']:.4f} "
          f"(queued {r['clear_queued_ms']:.4f}); the longest chain alone {r.get('longest_ms', 0):.4f} "
          f"(queued {r.get('longest_queued_ms', 0):.4f}); micro-steps a flagged board max "
          f"{r.get('steps_max')}, p99 {r.get('steps_p99')}, mean {r.get('steps_mean', 0):.2f}; plain "
          f"{plain_ms:.4f} ms, bound {b_ms:.6f} ms ({b_by}), latency floor {floor_ms:.6f} ms "
          f"({FLOOR_CYCLES_PER_MICRO_STEP} cycles a micro-step of the longest chain at "
          f"{CLOCK_HZ / 1e9:.2f} GHz) ({smi})")
    return dict(max_abs_err=err, ms=r["ms"], plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by)


@contextlib.contextmanager
def plain_combination_refused():
    """Within: the plain combination branch (``engine.combination_branch``)
    raises on a CUDA tensor, so that it provably serves nothing on the card;
    K5's wrapper serves every combination branch there."""
    from tile_match_tpu_torch import engine

    plain = engine.combination_branch

    def refused(cfg, colour, *args):
        check(colour.device.type != "cuda", "the plain combination branch ran on a CUDA tensor")
        return plain(cfg, colour, *args)

    engine.combination_branch = refused
    try:
        yield
    finally:
        engine.combination_branch = plain


@contextlib.contextmanager
def plain_mask_refused():
    """Within: the plain settled mask (``ops.effective.effective_mask_settled``)
    raises on a CUDA tensor, in every module of the port that bound it, so
    that it provably serves nothing on the card; K3's wrapper serves every
    settled mask there."""
    from tile_match_tpu_torch import engine, parity  # noqa: F401  (bind before patching)
    from tile_match_tpu_torch.envs import _threefry_driver, batched  # noqa: F401
    from tile_match_tpu_torch.ops import cascade, effective, mask_sp  # noqa: F401

    plain = effective.effective_mask_settled

    def refused(cfg, colour, kind):
        check(colour.device.type != "cuda", "the plain settled mask ran on a CUDA tensor")
        return plain(cfg, colour, kind)

    bound = [m for name, m in list(sys.modules.items())
             if name.startswith("tile_match_tpu_torch") and
             getattr(m, "effective_mask_settled", None) is plain]
    for m in bound:
        m.effective_mask_settled = refused
    try:
        yield
    finally:
        for m in bound:
            m.effective_mask_settled = plain


@contextlib.contextmanager
def plain_trip_refused():
    """Within: the plain full-machinery trip (``engine.specials_cascade_trip``
    and ``specials_cascade_trip_grid``) raises on a CUDA tensor, so that it
    provably serves nothing on the card; K4's wrapper serves every full
    trip there."""
    from tile_match_tpu_torch import engine

    saved = {name: getattr(engine, name)
             for name in ("specials_cascade_trip", "specials_cascade_trip_grid")}

    def refusing(name, plain):
        def refused(cfg, colour, *args):
            check(colour.device.type != "cuda", f"the plain trip ({name}) ran on a CUDA tensor")
            return plain(cfg, colour, *args)

        return refused

    for name, plain in saved.items():
        setattr(engine, name, refusing(name, plain))
    try:
        yield
    finally:
        for name, plain in saved.items():
            setattr(engine, name, plain)


def drive(cfg, device, smi, tag, required, host_syncs=False):
    """Run ``cfg`` at MAIN_BATCH for MAIN_STEPS auto-resetting steps through
    BatchedTileMatchEnv under a random effective policy.  Every kernel
    named in ``required`` must launch on every step.  Returns the launch
    count of each kernel over the run (``launches``), the host-clock ms of
    every step, each ending in a device synchronisation (``step_ms``), the
    steps in which boards auto-reset (``reset_steps``), the combination
    boards a step (``combs_per_step``) and, with ``host_syncs``, the host
    synchronisations of each step by torch's sync debug mode
    (``syncs``; its warnings slow the step, so time another run)."""
    import torch

    from tile_match_tpu_torch import engine
    from tile_match_tpu_torch import random as trandom
    from tile_match_tpu_torch.envs.batched import BatchedTileMatchEnv
    from tile_match_tpu_torch.ops.lines import plain_has_any_line

    env = BatchedTileMatchEnv(cfg, MAIN_BATCH, device=device)
    gen = torch.Generator(device=device)
    gen.manual_seed(SEED)
    _zero_launch_counts()
    states, ts = env.reset(trandom.PRNGKey(SEED, device))
    engine.reset_cascade_stats()
    torch.cuda.synchronize()
    truncated = dones = trips = combs = 0
    step_ms, reset_steps, syncs = [], [], []
    for t in range(MAIN_STEPS):
        mask = ts.info.effective_actions
        check(bool(mask.any(-1).all()), f"{tag} step {t}: a board has no effective action")
        scores = torch.rand(mask.shape, generator=gen, device=device)
        actions = torch.where(mask, scores, -1.0).argmax(-1)
        check(bool(mask.gather(1, actions[:, None]).all()), f"{tag} step {t}: ineffective action")
        before = _launch_counts()
        t0 = time.perf_counter()
        with count_syncs() if host_syncs else contextlib.nullcontext([]) as caught:
            states, ts = env.step(states, actions)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        syncs.append(_syncs(caught))
        for n in required:
            check(cuda_build.launches[n] > before[n], f"{tag} step {t}: kernel {n} was not launched")
        check(bool((ts.reward > 0).all()), f"{tag} step {t}: an effective move scored 0")
        truncated += int(ts.info.truncated.sum())
        done = int(ts.done.sum())
        dones += done
        if done:
            reset_steps.append(t)
        trips += int(ts.info.cascade_trips.sum())
        combs += int(ts.info.is_combination_match.sum())
    launches = _launch_counts()
    print(f"{tag} launches a step: "
          f"{', '.join(f'{n} {c / MAIN_STEPS:.3f}' for n, c in launches.items())}")
    board_steps = MAIN_BATCH * MAIN_STEPS
    check(dones == MAIN_BATCH, f"{tag}: expected one auto-reset of every board, saw {dones} dones")
    check(truncated * 10000 < board_steps, f"{tag}: {truncated} truncated board-steps of {board_steps}")
    R, C = cfg.num_rows, cfg.num_cols
    check(tuple(ts.obs_board.shape) == (MAIN_BATCH, 2, R, C), f"{tag}: obs_board shape")
    check(not bool(plain_has_any_line(cfg, states.colour.cpu()).any()),
          f"{tag}: a settled board holds a line")
    kinds = states.kind
    check(bool(((kinds == -1) | ((kinds >= 1) & (kinds <= 4))).all()), f"{tag}: kind out of range")
    check(bool(((states.colour == 0) == (kinds == -1)).all()),
          f"{tag}: colour is not 0 exactly where kind is -1 (cookies)")
    check(bool((states.colour <= cfg.num_colours).all()), f"{tag}: colour out of range")
    total_ms = sum(step_ms)
    print(f"{tag} ok: B={MAIN_BATCH} {MAIN_STEPS} steps, launches "
          f"{', '.join(f'{n} {c}' for n, c in launches.items())}, {dones} dones, "
          f"{truncated} truncated of {board_steps} board-steps, "
          f"{combs / MAIN_STEPS:.1f} combination boards per step")
    print(f"{tag} time: {total_ms / MAIN_STEPS:.3f} ms/step (median "
          f"{sorted(step_ms)[MAIN_STEPS // 2]:.3f} ms), "
          f"{board_steps / (total_ms / 1e3):.1f} steps/s ({smi})")
    stats = engine.cascade_stats
    if stats["rounds"]:
        from tile_match_tpu_torch.ops.cascade_sp import REASON_MULTI

        full_trips = stats["full_trips"]
        reasons = engine.last_cascade["reasons"]
        froze = [int(((reasons >> i) & 1).sum()) for i in range(REASON_MULTI.bit_length())]
        print(f"{tag} cascade: {stats['rounds'] / MAIN_STEPS:.2f} machinery rounds per step, "
              f"{full_trips / MAIN_STEPS:.1f} full-machinery trips per step, "
              f"{trips / MAIN_STEPS:.1f} trips per step, "
              f"{1 - full_trips / max(trips, 1):.4f} of trips taken in the kernel, "
              f"boards frozen by K2 per reason bit in the last step {froze}")
    return {"launches": launches, "step_ms": step_ms, "reset_steps": reset_steps,
            "combs_per_step": combs / MAIN_STEPS, "syncs": syncs}


def main_paths(device, smi):
    """Phases 4-8, the port's main paths on the card.  Returns each
    kernel's launches over the batched drives (phases 5-7)."""
    from tile_match_tpu_torch.tools.parity_check import replay_fixture

    # 4. the recorded JAX rollouts, on the card
    for path in FIXTURES_BATCHED:
        n = replay_fixture(device, path)
        print(f"phase 4 ok: replayed {n} steps of {os.path.basename(path)} bit for bit")

    # 5-7. the batched main paths; each kernel's launches summed over them
    launches = dict.fromkeys(cuda_build.KERNELS, 0)
    for tag, specials, required in MAIN_PATHS.values():
        run = drive(_config(10, 10, 4, 30, specials), device, smi, tag, required)
        for name, n in run["launches"].items():
            launches[name] += n

    # 8. the Gym entry point: its two engines, one board at a time
    gym_kernels = ("fused_cascade", "cascade_sp_chunk", "settled_mask_sp", "combination_trip")
    _zero_launch_counts()
    golden_ms = replay_golden(device)
    check(sum(cuda_build.launches[n] for n in gym_kernels) == 0,
          "phase 8: the numpy-parity engine launched a kernel")
    print(f"phase 8 ok: replayed {len(golden_ms)} steps of golden_episodes.json bit for bit "
          f"through ParityEngine: {sum(golden_ms) / len(golden_ms):.1f} ms/step ({smi})")
    gym_ms = replay_gym(device)
    gym_launches = {n: cuda_build.launches[n] for n in gym_kernels}
    check(all(n > 0 for n in gym_launches.values()),
          f"phase 8: the threefry episodes did not launch every kernel: {gym_launches}")
    for (mode, name), ms in gym_ms.items():
        print(f"phase 8: {mode} engine, specials {name}: {len(ms)} steps bit for bit, "
              f"{sum(ms) / len(ms):.1f} ms/step (median {sorted(ms)[len(ms) // 2]:.1f} ms) ({smi})")
    print(f"phase 8 ok: replayed {len(gym_ms)} recorded JAX Gym episodes; threefry-engine "
          f"launches {gym_launches}")
    return launches


# ---------------------------------------------------------------------------
# Phases 9-15: the training path
# ---------------------------------------------------------------------------
def _fixture_tool():
    """The recorder's constants and numpy weights (imports no JAX)."""
    if ROOT not in sys.path:
        sys.path.insert(0, ROOT)
    from tools import make_torch_port_fixture

    return make_torch_port_fixture


def check_draws(device) -> dict:
    """Phase 9: the recorded JAX draws on ``device``: ``uniform`` over
    [16384] bit for bit, the categorical's [16384, 180] uniforms bit for
    bit (64 rows in full, all by digest) and its argmax on every row.
    Returns counts for the report."""
    import torch

    from tile_match_tpu_torch import random as trandom

    f = _fixture_tool()
    d = np.load(FIXTURE_DQN)
    k_mask, k_cat, k_unif = trandom.split(trandom.PRNGKey(f.DRAW_SEED, device), 3)
    mask = trandom.random_bits(k_mask, f.DRAW_SHAPE) % 5 == 0
    mask[::97] = False
    u = trandom.uniform(k_unif, f.DRAW_SHAPE[:1]).cpu().numpy()
    check(np.array_equal(u.view(np.uint32), d["draw_uniform"].view(np.uint32)),
          "draws: uniform differs from jax.random.uniform")
    cu = trandom.uniform(k_cat, f.DRAW_SHAPE, minval=np.finfo(np.float32).tiny, maxval=1.0)
    cu = cu.cpu().numpy()
    bits = cu.view(np.uint32).astype(np.uint64)
    digest = [int(bits.sum()) % (1 << 63), int(np.bitwise_xor.reduce(bits.reshape(-1)))]
    check(np.array_equal(cu[: f.DRAW_ROWS].view(np.uint32),
                         d["draw_cat_uniform_rows"].view(np.uint32))
          and digest == d["draw_cat_uniform_digest"].tolist(),
          "draws: the categorical's uniforms differ from jax.random.uniform")
    cat = trandom.categorical(k_cat, torch.where(mask, 0.0, -torch.inf), axis=-1).cpu().numpy()
    flips = np.flatnonzero(cat != d["draw_categorical"])
    check(flips.size == 0, f"draws: categorical argmax differs from jax.random.categorical on "
                           f"boards {flips[:20].tolist()}")
    return {"uniforms": int(cu.size + u.size), "boards": int(cat.size),
            "empty_rows": int((~mask.any(-1)).sum())}


@contextlib.contextmanager
def env_step_probe(module, device):
    """Within: ``module.batched_step`` (an agent's env step) also records
    its actions, rewards and dones, and on the card a CUDA event on each
    side of it.  Yields the list of records, one a call."""
    import torch

    real = module.batched_step
    records = []

    def probed(cfg, states, actions, **kw):
        rec = {"actions": actions}
        if device.type == "cuda":
            rec["start"] = torch.cuda.Event(enable_timing=True)
            rec["end"] = torch.cuda.Event(enable_timing=True)
            rec["start"].record()
        states, ts = real(cfg, states, actions, **kw)
        if device.type == "cuda":
            rec["end"].record()
        rec.update(rewards=ts.reward, dones=ts.done)
        records.append(rec)
        return states, ts

    module.batched_step = probed
    try:
        yield records
    finally:
        module.batched_step = real


@contextlib.contextmanager
def count_syncs():
    """Within: every host synchronisation with the card is recorded (torch's
    sync debug mode).  Yields the list of warnings; count those that name a
    synchronizing operation."""
    import warnings

    import torch

    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            yield caught
    finally:
        torch.cuda.set_sync_debug_mode("default")


def _syncs(caught) -> int:
    return sum("synchroniz" in str(w.message) for w in caught)


def _launch_counts():
    return dict(cuda_build.launches)


def _zero_launch_counts():
    """Set every kernel's count to 0: a path's run starts from here."""
    cuda_build.launches.update(dict.fromkeys(cuda_build.launches, 0))


def _dqn_cfg(specials=(0, 0, 0, 0)):
    return _config(10, 10, 4, 30, specials)


def _rel_gap(got, want) -> float:
    """|got - want| / |want| in float64."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def replay_dqn(device, steps=None) -> dict:
    """Phase 10a: 40 ``make_dqn`` train steps on config 1 at batch 256,
    hidden 512, epsilon held at 1, keyed as the JAX ``train`` loop, from the
    seeded weights, against the recorded JAX run: every step's actions,
    rewards and dones, and the final env state and mask, bit for bit; every
    step's loss and mean |TD| within rtol 5e-2; after the recorded steps
    (1, 5 and 40), leaf by leaf on the recorded entries, Adam's first moment
    within a relative norm of LEARNER_GRAD_REL after step 1 (the gradient
    of the same weights and batch) and LEARNER_DRIFT_REL later, and the
    weights' change from the seeded start within LEARNER_DRIFT_REL
    (``steps``: the first few only, without the final state).  Returns the
    launches of each kernel a step, the final state and the largest learner
    gaps."""
    import torch

    from tile_match_tpu_torch import random as trandom
    from tile_match_tpu_torch.interop import state_to_numpy
    from tile_match_tpu_torch.models import dqn

    device = torch.device(device)
    f = _fixture_tool()
    d = np.load(FIXTURE_DQN)
    cfg = _dqn_cfg()
    init_fn, train_step, _ = dqn.make_dqn(cfg, batch_size=f.DQN_BATCH, hidden=f.DQN_HIDDEN,
                                          eps_start=1.0, eps_end=1.0, device=device)
    key, k_init = trandom.split(trandom.PRNGKey(f.DQN_SEED, device))
    state = init_fn(k_init)
    tree = f.seeded_qnet_params(dqn.input_size(cfg), f.DQN_HIDDEN, cfg.num_actions, f.QNET_SEED)
    state.params.load_state_dict(dqn.params_from_flax(tree))
    dqn.sync_target(state.target_params, state.params)
    start = f.port_leaves(tree)
    per_step, losses, tds, learner = [], [], [], []
    _zero_launch_counts()
    with env_step_probe(dqn, device) as records:
        for t in range(steps or f.DQN_STEPS):
            key, k = trandom.split(key)
            before = _launch_counts()
            state, metrics = train_step(state, k)
            after = _launch_counts()
            per_step.append({n: after[n] - before[n] for n in after})
            losses.append(metrics["loss"])
            tds.append(metrics["td_abs"])
            rec = records[-1]
            for name in ("actions", "rewards", "dones"):
                got = rec[name].cpu().numpy()
                check(np.array_equal(got, d[f"dqn_{name}"][t].astype(got.dtype)),
                      f"DQN step {t}: {name} differ from the recorded JAX run")
            if t + 1 in f.LEARNER_STEPS:
                opt = state.opt_state
                named = list(state.params.named_parameters())
                mu = {n: opt.state[p]["exp_avg"].cpu().numpy() for n, p in named}
                change = {n: p.detach().cpu().numpy() - start[n] for n, p in named}
                learner.append((t + 1, f.learner_samples(mu), f.learner_samples(change)))
    n = len(losses)
    gaps = {"loss": 0.0, "grad": 0.0, "mu": 0.0, "change": 0.0}
    for name in ("loss", "td_abs"):
        got = torch.stack(losses if name == "loss" else tds).cpu().numpy()
        want = d[f"dqn_{name}"][:n]
        check(bool(np.isfinite(got).all()), f"DQN: {name} is not finite")
        err = np.abs(got - want) / np.abs(want)
        check(bool((err < 5e-2).all()), f"DQN: {name} differs from the recorded JAX run by "
                                        f"rtol {err.max():.4f} (step {int(err.argmax())})")
        gaps["loss"] = max(gaps["loss"], float(err.max()))
    for i, (k, mu, change) in enumerate(learner):
        for leaf in mu:
            g_mu = _rel_gap(mu[leaf], d[f"dqn_mu_{leaf}"][i])
            g_ch = _rel_gap(change[leaf], d[f"dqn_change_{leaf}"][i])
            check(g_mu < (LEARNER_GRAD_REL if k == 1 else LEARNER_DRIFT_REL),
                  f"DQN step {k}: Adam's first moment of {leaf} differs from the recorded JAX "
                  f"run by a relative norm of {g_mu:.4f}")
            check(g_ch < LEARNER_DRIFT_REL, f"DQN step {k}: the change of {leaf} differs from "
                                            f"the recorded JAX run by a relative norm of {g_ch:.4f}")
            moment = "grad" if k == 1 else "mu"
            gaps[moment], gaps["change"] = max(gaps[moment], g_mu), max(gaps["change"], g_ch)
    if steps:
        return {"launches": per_step, "state": state, "gaps": gaps}
    got = state_to_numpy(state.env_states)
    for name in ("colour", "kind", "timer", "key"):
        check(np.array_equal(got[name], d[f"dqn_{name}"].astype(got[name].dtype)),
              f"DQN: final env {name} differs from the recorded JAX run")
    check(np.array_equal(state.eff_mask.cpu().numpy(), d["dqn_eff_mask"]),
          "DQN: final effective-action mask differs from the recorded JAX run")
    return {"launches": per_step, "state": state, "gaps": gaps}


def check_qnet(device, state=None) -> float:
    """Phase 11: the port's QNetwork under the seeded weights against the
    recorded flax Q on the recorded final boards (rtol 2e-2, atol 2e-2:
    bfloat16 hidden layers, rounded at other places).  Returns the largest
    error."""
    import torch

    from tile_match_tpu_torch.interop import state_from_numpy
    from tile_match_tpu_torch.models import dqn

    f = _fixture_tool()
    d = np.load(FIXTURE_DQN)
    cfg = _dqn_cfg()
    n = f.Q_BOARDS
    states = state_from_numpy(d["dqn_colour"][:n], d["dqn_kind"][:n], d["dqn_timer"][:n],
                              d["dqn_key"][:n], device)
    net = dqn.QNetwork(cfg.num_actions, f.DQN_HIDDEN, in_features=dqn.input_size(cfg),
                       device=device)
    tree = f.seeded_qnet_params(dqn.input_size(cfg), f.DQN_HIDDEN, cfg.num_actions, f.QNET_SEED)
    net.load_state_dict(dqn.params_from_flax(tree))
    with torch.no_grad():
        q = net(*dqn._encode(cfg, states)).cpu()
    want = torch.from_numpy(d["flax_q"])
    err = float((q - want).abs().max())
    check(torch.allclose(q, want, rtol=2e-2, atol=2e-2),
          f"QNetwork differs from the recorded flax Q by {err}")
    return err


def check_entry(device) -> dict:
    """Phase 15: ``entry()``'s forward under the seeded weights against the
    recorded ``__graft_entry__.entry`` forward: the reset boards, rewards
    and next boards bit for bit, Q within rtol 2e-2, atol 2e-2.  Returns
    each kernel's launches in the forward."""
    import torch

    from tile_match_tpu_torch.entry import entry
    from tile_match_tpu_torch.interop import state_to_numpy
    from tile_match_tpu_torch.models import dqn

    device = torch.device(device)
    f = _fixture_tool()
    d = np.load(FIXTURE_DQN)
    forward, (net, states, actions) = entry(device)
    head = net.head.weight.shape[0]
    tree = f.seeded_qnet_params(net.dense1.weight.shape[1], f.DQN_HIDDEN, head, f.QNET_SEED)
    net.load_state_dict(dqn.params_from_flax(tree))
    before = _launch_counts()
    q, reward, next_states = forward(net, states, actions)
    if device.type == "cuda":
        torch.cuda.synchronize()
    after = _launch_counts()
    for prefix, st in (("entry_reset", states), ("entry_next", next_states)):
        got = state_to_numpy(st)
        for name in ("colour", "kind", "timer", "key"):
            check(np.array_equal(got[name], d[f"{prefix}_{name}"].astype(got[name].dtype)),
                  f"entry: {prefix} {name} differs from the recorded JAX entry")
    check(np.array_equal(reward.cpu().numpy(), d["entry_reward"]),
          "entry: rewards differ from the recorded JAX entry")
    want = torch.from_numpy(d["entry_q"])
    check(tuple(q.shape) == tuple(want.shape) and torch.allclose(q.cpu(), want, rtol=2e-2, atol=2e-2),
          "entry: Q differs from the recorded flax Q")
    return {n: after[n] - before[n] for n in after}


def _timed_steps(train_step, state, key, steps, device, required, tag, module):
    """Run ``steps`` train steps; every kernel in ``required`` must launch on
    each.  Returns (state, report): host ms a step, the env step's and the
    learner's ms by CUDA events, host syncs a step, reward and loss means,
    and each kernel's launches over the run."""
    import torch

    from tile_match_tpu_torch import random as trandom

    host, env, learner, syncs, rewards, losses = [], [], [], [], [], []
    _zero_launch_counts()
    with env_step_probe(module, device) as records:
        for t in range(steps):
            key, k = trandom.split(key)
            before = _launch_counts()
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            with count_syncs() as caught:
                start.record()
                state, metrics = train_step(state, k)
                end.record()
            torch.cuda.synchronize()
            host.append((time.perf_counter() - t0) * 1e3)
            syncs.append(_syncs(caught))
            after = _launch_counts()
            for n in required:
                check(after[n] > before[n], f"{tag} step {t}: kernel {n} was not launched")
            rec = records[-1]
            total = start.elapsed_time(end)
            env.append(rec["start"].elapsed_time(rec["end"]))
            learner.append(total - env[-1])
            rewards.append(metrics["reward_mean"])
            losses.append(metrics["loss"])
    losses = torch.stack(losses)
    check(bool(torch.isfinite(losses).all()), f"{tag}: a loss is not finite")
    report = {
        "host_ms": sum(host) / steps, "median_ms": sorted(host)[steps // 2],
        "env_ms": sum(env) / steps, "learner_ms": sum(learner) / steps,
        "syncs": sum(syncs) / steps, "reward_mean": float(torch.stack(rewards).mean()),
        "loss_last": float(losses[-1]), "launches": _launch_counts(),
    }
    return state, key, report


def _print_report(tag, steps, r, smi):
    print(f"{tag}: {steps} steps, {r['host_ms']:.3f} ms a step (median {r['median_ms']:.3f}): "
          f"env step {r['env_ms']:.3f} ms, learner {r['learner_ms']:.3f} ms (CUDA events); "
          f"{r['syncs']:.2f} host syncs a step; launches a step "
          f"{', '.join(f'{n} {c / steps:.3f}' for n, c in r['launches'].items())}; "
          f"reward mean {r['reward_mean']:.6f}, last loss {r['loss_last']:.6f} ({smi})")


def training_path(device, smi) -> None:
    """Phases 9-15, each path's launches on its own phase lines."""
    import torch

    from tile_match_tpu_torch import random as trandom
    from tile_match_tpu_torch.checkpoint import restore_pytree, save_pytree
    from tile_match_tpu_torch.models import dqn, dqn_replay, q_learning, qrdqn, random_agent

    f = _fixture_tool()
    # 9. the draws
    n = check_draws(device)
    print(f"phase 9 ok: {n['uniforms']} uniforms bit for bit and {n['boards']} categorical draws "
          f"({n['empty_rows']} boards with no effective action) equal to the recorded JAX draws")

    # 10. DQN on config 1 at full width
    t0 = time.perf_counter()
    run = replay_dqn(device)
    # a train step hands the env the previous step's mask and K1 returns the
    # next one, so K3 runs where boards are regenerated: the auto-reset step
    cfg1 = _dqn_cfg()
    for t, step in enumerate(run["launches"]):
        check(step["fused_cascade"] > 0, f"phase 10 DQN step {t}: K1 was not launched")
    reset_step = run["launches"][cfg1.num_moves - 1]
    check(reset_step["settled_mask_sp"] > 0, "phase 10 DQN: K3 did not run at the auto-reset")
    gaps = run["gaps"]
    print(f"phase 10 ok: {f.DQN_STEPS} DQN train steps (config 1, B={f.DQN_BATCH}, hidden "
          f"{f.DQN_HIDDEN}, epsilon 1, seeded weights) equal the recorded JAX run bit for bit in "
          f"actions, rewards, dones and the final env state, auto-reset crossed; learner: loss "
          f"and |TD| within rtol {gaps['loss']:.4f}, step 1's gradient (Adam's first moment) "
          f"within a relative norm of {gaps['grad']:.4f} (limit {LEARNER_GRAD_REL}), later "
          f"moments {gaps['mu']:.4f} and weight changes {gaps['change']:.4f} (limit "
          f"{LEARNER_DRIFT_REL}); K1 on every step ({sum(s['fused_cascade'] for s in run['launches'])}"
          f" launches), K3 {sum(s['settled_mask_sp'] for s in run['launches'])} launches "
          f"(auto-reset step {reset_step['settled_mask_sp']}) ({time.perf_counter() - t0:.1f} s)")
    init_fn, train_step, _ = dqn.make_dqn(cfg1, batch_size=256, hidden=512, device=device)
    key, k_init = trandom.split(trandom.PRNGKey(SEED, device))
    state = init_fn(k_init)
    steps = 60
    state, key, r = _timed_steps(train_step, state, key, steps, device, ("fused_cascade",),
                                 "phase 10 DQN", dqn)
    check(r["launches"]["settled_mask_sp"] > 0, "phase 10 DQN: K3 did not run at the auto-resets")
    _print_report("phase 10 ok: DQN config 1 B=256 hidden 512, default epsilon", steps, r, smi)

    # 11. the Q-network against flax
    err = check_qnet(device)
    print(f"phase 11 ok: QNetwork on seeded weights within rtol 2e-2, atol 2e-2 of the "
          f"recorded flax Q (max abs err {err:.6f})")

    # 12. DQN on config 3
    cfg3 = _dqn_cfg(ALL_SPECIALS)
    init3, step3, _ = dqn.make_dqn(cfg3, batch_size=256, hidden=512, device=device)
    key3, k_init = trandom.split(trandom.PRNGKey(SEED, device))
    state3 = init3(k_init)
    state3, key3, r = _timed_steps(step3, state3, key3, 8, device,
                                   ("combination_trip", "cascade_sp_chunk", "settled_mask_sp"),
                                   "phase 12 DQN", dqn)
    _print_report("phase 12 ok: DQN config 3 B=256 hidden 512", 8, r, smi)

    # 13. the other agents
    learning_starts = 20 * 128
    init_r, step_r, _ = dqn_replay.make_dqn_replay(cfg1, learning_starts=learning_starts,
                                                   device=device)
    key_r, k_init = trandom.split(trandom.PRNGKey(SEED, device))
    state_r = init_r(k_init)
    w0 = state_r.params.head.weight.detach().clone()
    state_r, key_r, r = _timed_steps(step_r, state_r, key_r, 19, device,
                                     ("fused_cascade",), "phase 13 DQN-replay", dqn_replay)
    check(torch.equal(state_r.params.head.weight, w0) and not state_r.opt_state.state,
          "phase 13 DQN-replay: an update before learning_starts")
    state_r, key_r, r2 = _timed_steps(step_r, state_r, key_r, 41, device,
                                      ("fused_cascade",), "phase 13 DQN-replay", dqn_replay)
    check(not torch.equal(state_r.params.head.weight, w0), "phase 13 DQN-replay: no update")
    _print_report(f"phase 13: DQN with replay config 1 (env batch 128, train batch 256, capacity "
                  f"50,000; learning_starts {learning_starts}), steps 20-60", 41, r2, smi)
    init_q, step_q, _ = qrdqn.make_qrdqn(cfg1, device=device)
    key_q, k_init = trandom.split(trandom.PRNGKey(SEED, device))
    state_q, key_q, r = _timed_steps(step_q, init_q(k_init), key_q, 30, device,
                                     ("fused_cascade",), "phase 13 QR-DQN", qrdqn)
    _print_report("phase 13: QR-DQN config 1 B=256 hidden 512, 75 quantiles", 30, r, smi)
    for effective in (False, True):
        t0 = time.perf_counter()
        ret, eff = random_agent.run_random(cfg1, SEED, num_episodes=256,
                                           use_effective_actions=effective, device=device)
        check(ret.shape == (256,) and np.isfinite(ret).all() and (eff > 0).all(),
              f"phase 13 run_random(effective={effective}): bad returns or counts")
        check(not effective or (ret > 0).all(), "phase 13 run_random: an effective episode scored 0")
        print(f"phase 13: run_random config 1, effective actions {effective}: 256 episodes, mean "
              f"return {ret.mean():.6f} ({time.perf_counter() - t0:.1f} s)")
    from tile_match_tpu_torch.config import EnvConfig

    qtable, _ = q_learning.train_dense(EnvConfig(3, 3, 2, 5), num_steps=50, batch_size=16,
                                       device=device)
    check(bool(torch.isfinite(qtable).all()) and bool(qtable.abs().sum() > 0),
          "phase 13 train_dense: table not finite or empty")
    print("phase 13 ok: DQN with replay, QR-DQN, run_random in both modes and train_dense "
          "(3x3x2x5) ran; losses and tables finite; no update before learning_starts")

    # 14. checkpoint: save mid-run, run 8 steps, restore, run the same 8
    def eight(state, key):
        for _ in range(8):
            key, k = trandom.split(key)
            state, _ = train_step(state, k)
        opt = state.opt_state
        moments = [opt.state[p][m].clone() for p in state.params.parameters()
                   for m in ("exp_avg", "exp_avg_sq")]
        params = [p.detach().clone() for p in state.params.parameters()]
        return state, params, moments

    ckpt_dir = os.path.join(ROOT, "tile_match_tpu_torch", "_build")
    os.makedirs(ckpt_dir, exist_ok=True)
    path = os.path.join(ckpt_dir, f"chip_smoke_ckpt_{os.getpid()}.pt")
    try:
        save_pytree(path, state)
        saved_key = key.clone()
        a, a_params, a_moments = eight(state, key)
        b = restore_pytree(path, state)
        b, b_params, b_moments = eight(b, saved_key)
    finally:
        os.remove(path)
    for name in ("colour", "kind", "timer", "key"):
        check(torch.equal(getattr(a.env_states, name), getattr(b.env_states, name)),
              f"phase 14: env {name} differs after the restored run")
    check(all(torch.equal(x, y) for x, y in zip(a_params, b_params)),
          "phase 14: parameters differ after the restored run")
    check(all(torch.equal(x, y) for x, y in zip(a_moments, b_moments)),
          "phase 14: Adam moments differ after the restored run")
    print("phase 14 ok: a DQN state saved at step 60 and restored reran 8 steps equal in env "
          "states, parameters and Adam moments (torch.equal)")

    # 15. the entry: env step fused with the Q-network forward
    counts = check_entry(device)
    for name in ("combination_trip", "cascade_sp_chunk", "settled_mask_sp"):
        check(counts[name] > 0, f"phase 15: entry forward did not launch {name}")
    print(f"phase 15 ok: entry() forward at B=64 (EnvConfig(10, 10, 4, 30): every special) on "
          f"the seeded weights equals the recorded JAX entry: boards and rewards bit for bit, "
          f"Q within rtol 2e-2, atol 2e-2; launches {counts}")


# ---------------------------------------------------------------------------
# Phases 16-19: the scale-out layer, debug checks and throughput
# ---------------------------------------------------------------------------
def sharded_run(cfg, mesh, batch, steps, seed, tag, required=()):
    """``parallel.sharded_rollout`` of ``cfg`` on ``mesh`` for ``steps``
    steps from ``PRNGKey(seed)``, each step timed by the host clock up to a
    device synchronisation, and each kernel's launches counted by step:
    every kernel in ``required`` must launch on every step.  Returns this
    rank's board-steps/s, the launches a step, those of the whole run (the
    reset's too), the stats and the gathered boards and rewards (numpy)."""
    import torch

    from tile_match_tpu_torch import random as trandom
    from tile_match_tpu_torch.interop import state_to_numpy
    from tile_match_tpu_torch.parallel import gather_boards, sharding

    device = sharding.mesh_device(mesh)
    real = sharding.batched_step
    per_step, step_s = [], []

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    def probed(*args, **kwargs):
        sync()
        before = _launch_counts()
        t0 = time.perf_counter()
        out = real(*args, **kwargs)
        sync()
        step_s.append(time.perf_counter() - t0)
        after = _launch_counts()
        per_step.append({n: after[n] - before[n] for n in after})
        return out

    sharding.batched_step = probed
    start = _launch_counts()
    try:
        states, rew, stats = sharding.sharded_rollout(cfg, mesh, batch, steps)(
            trandom.PRNGKey(seed, device))
    finally:
        sharding.batched_step = real
    end = _launch_counts()
    for t, counts in enumerate(per_step):
        for name in required:
            check(counts[name] > 0, f"{tag} step {t}: kernel {name} was not launched")
    check(len(per_step) == steps, f"{tag}: {len(per_step)} steps of {steps}")
    local = rew.shape[0]
    boards = state_to_numpy(gather_boards(states, mesh))
    boards["reward"] = gather_boards(rew, mesh).cpu().numpy()
    return {
        "board_steps_per_s": local * steps / sum(step_s),
        "launches_per_step": {n: sum(c[n] for c in per_step) / steps for n in start},
        "launches": {n: end[n] - start[n] for n in start},  # the reset's too
        "stats": {k: v.cpu().numpy() for k, v in stats.items()},
        "boards": boards,
    }


def replay_sharded_rollout(mesh) -> dict:
    """Phase 16a: ``sharded_rollout`` on a one-rank ``mesh`` against the
    recorded JAX ``sharded_rollout`` (config 3, 64 boards, 8 steps):
    per-board rewards, every state leaf and the stats, bit for bit.
    Returns each kernel's launches."""
    import torch

    from tile_match_tpu_torch import random as trandom
    from tile_match_tpu_torch.interop import state_to_numpy
    from tile_match_tpu_torch.parallel import sharding

    f = _fixture_tool()
    d = np.load(FIXTURE_SHARDED)
    device = sharding.mesh_device(mesh)
    before = _launch_counts()
    states, rew, stats = sharding.sharded_rollout(
        _config(10, 10, 4, 30, ALL_SPECIALS), mesh, f.SHARDED_BATCH, f.SHARDED_STEPS
    )(trandom.PRNGKey(f.SHARDED_SEED, device))
    after = _launch_counts()
    got = state_to_numpy(states)
    for name in ("colour", "kind", "timer", "key"):
        check(np.array_equal(got[name], d[f"rollout_{name}"].astype(got[name].dtype)),
              f"sharded rollout: final {name} differs from the recorded JAX rollout")
    check(np.array_equal(rew.cpu().numpy(), d["rollout_reward"]),
          "sharded rollout: per-board rewards differ from the recorded JAX rollout")
    for name in ("steps_done", "trips_sum", "shard_max_trips"):
        check(np.array_equal(np.asarray(stats[name].cpu()), d[f"rollout_{name}"]),
              f"sharded rollout: stats {name} differ from the recorded JAX rollout")
    return {n: after[n] - before[n] for n in after}


def _sharded_trainer(mesh, f):
    """``sharded_train_step`` on config 1 at the recorded sizes, epsilon 1,
    started from the recorded keys and the seeded weights."""
    from tile_match_tpu_torch import random as trandom
    from tile_match_tpu_torch.models import dqn
    from tile_match_tpu_torch.parallel import sharding

    cfg = _dqn_cfg()
    init, step = sharding.sharded_train_step(cfg, mesh, make_dqn_kwargs=dict(
        batch_size=f.DQN_BATCH, hidden=f.DQN_HIDDEN, eps_start=1.0, eps_end=1.0))
    device = sharding.mesh_device(mesh)
    keys = trandom.split(trandom.PRNGKey(f.SHARDED_SEED, device), f.SHARDED_TRAIN_STEPS + 1)
    state = init(keys[0])
    tree = f.seeded_qnet_params(dqn.input_size(cfg), f.DQN_HIDDEN, cfg.num_actions, f.QNET_SEED)
    shard = sharding.params_from_flax(tree, mesh)
    state.params.load_state_dict(shard)
    state.target_params.load_state_dict(shard)
    return state, step, keys, tree


def replay_sharded_train(mesh) -> dict:
    """Phase 18a: two ``sharded_train_step``s on a one-rank ``mesh`` against
    the recorded JAX ones (config 1, batch 256, hidden 512, epsilon 1, the
    seeded weights): the final env state and mask bit for bit, loss and
    |TD| within rtol 5e-2, the reward mean within rtol 1e-6, and after each
    step Adam's first moment and the weights' change leaf by leaf on the
    recorded entries (LEARNER_GRAD_REL after step 1, else
    LEARNER_DRIFT_REL).  Then the same two steps of ``make_dqn``'s
    unsharded train step from the same weights, which the one-rank step
    is: the env side, the losses and the weights bit for bit.  Returns the
    largest gaps and the sharded state."""
    import torch

    from tile_match_tpu_torch.interop import state_to_numpy
    from tile_match_tpu_torch.models import dqn
    from tile_match_tpu_torch.parallel import sharding

    f = _fixture_tool()
    d = np.load(FIXTURE_SHARDED)
    device = sharding.mesh_device(mesh)
    state, step, keys, tree = _sharded_trainer(mesh, f)
    start = f.port_leaves(tree)
    gaps = {"loss": 0.0, "grad": 0.0, "mu": 0.0, "change": 0.0}
    losses = []
    for t in range(f.SHARDED_TRAIN_STEPS):
        state, metrics = step(state, keys[t + 1])
        got = np.asarray([float(metrics[n]) for n in ("loss", "td_abs", "reward_mean")])
        want = d["train_metrics"][t]
        err = np.abs(got - want) / np.abs(want)
        check(bool((err[:2] < 5e-2).all()) and err[2] < 1e-6,
              f"sharded train step {t + 1}: loss, |TD|, reward mean {got.tolist()} against the "
              f"recorded {want.tolist()}")
        gaps["loss"] = max(gaps["loss"], float(err[:2].max()))
        losses.append(got[0])
        named = list(state.params.named_parameters())
        opt = state.opt_state
        mu = f.learner_samples({n: opt.state[p]["exp_avg"].cpu().numpy() for n, p in named})
        change = f.learner_samples({n: p.detach().cpu().numpy() - start[n] for n, p in named})
        for leaf in mu:
            g_mu = _rel_gap(mu[leaf], d[f"train_mu_{leaf}"][t])
            g_ch = _rel_gap(change[leaf], d[f"train_change_{leaf}"][t])
            check(g_mu < (LEARNER_GRAD_REL if t == 0 else LEARNER_DRIFT_REL),
                  f"sharded train step {t + 1}: Adam's first moment of {leaf} differs from the "
                  f"recorded JAX run by a relative norm of {g_mu:.4f}")
            check(g_ch < LEARNER_DRIFT_REL, f"sharded train step {t + 1}: the change of {leaf} "
                                            f"differs from the recorded JAX run by {g_ch:.4f}")
            moment = "grad" if t == 0 else "mu"
            gaps[moment], gaps["change"] = max(gaps[moment], g_mu), max(gaps["change"], g_ch)
    got = state_to_numpy(state.env_states)
    for name in ("colour", "kind", "timer", "key"):
        check(np.array_equal(got[name], d[f"train_{name}"].astype(got[name].dtype)),
              f"sharded train step: final env {name} differs from the recorded JAX run")
    check(np.array_equal(state.eff_mask.cpu().numpy(), d["train_eff_mask"]),
          "sharded train step: final mask differs from the recorded JAX run")

    # make_dqn's unsharded step from the same weights and keys
    init_fn, train_step, _ = dqn.make_dqn(_dqn_cfg(), batch_size=f.DQN_BATCH, hidden=f.DQN_HIDDEN,
                                          eps_start=1.0, eps_end=1.0, device=device)
    plain = init_fn(keys[0])
    plain.params.load_state_dict(dqn.params_from_flax(tree))
    dqn.sync_target(plain.target_params, plain.params)
    for t in range(f.SHARDED_TRAIN_STEPS):
        plain, metrics = train_step(plain, keys[t + 1])
        check(float(metrics["loss"]) == losses[t],
              f"sharded train step {t + 1}: loss {losses[t]} against make_dqn's "
              f"{float(metrics['loss'])}")
    for name in ("colour", "kind", "timer", "key"):
        check(torch.equal(getattr(plain.env_states, name), getattr(state.env_states, name)),
              f"sharded train step: env {name} differs from make_dqn's")
    check(torch.equal(plain.eff_mask, state.eff_mask), "sharded train step: mask differs from make_dqn's")
    for name, v in plain.params.state_dict().items():
        check(torch.equal(v, state.params.state_dict()[name]),
              f"sharded train step: weight {name} differs from make_dqn's")
    return {"gaps": gaps, "state": state, "step": step}


def train_ranks(tp: int, timed_steps: int, device_type: str = "cuda") -> dict:
    """Phase 18b, in each rank of a (1, tp) mesh: the recorded two train
    steps, then ``timed_steps`` more, timed.  Returns the losses, this
    rank's weights after the two (numpy) and ms a step."""
    import torch
    import torch.distributed as dist

    from tile_match_tpu_torch import random as trandom
    from tile_match_tpu_torch.parallel import make_mesh

    f = _fixture_tool()
    mesh = make_mesh([device_type] * dist.get_world_size(), dp=1, tp=tp)
    sync = torch.cuda.synchronize if device_type == "cuda" else (lambda: None)
    state, step, keys, _ = _sharded_trainer(mesh, f)
    losses = []
    for k in keys[1:]:
        state, metrics = step(state, k)
        losses.append(float(metrics["loss"]))
    # a copy: on the CPU, numpy() shares the weights the timed steps change
    params = {n: v.detach().cpu().numpy().copy() for n, v in state.params.state_dict().items()}
    key = keys[-1]
    sync()
    t0 = time.perf_counter()
    for _ in range(timed_steps):
        key, k = trandom.split(key)
        state, metrics = step(state, k)
    sync()
    return {"losses": losses, "params": params, "tp_rank": mesh.get_local_rank("tp"),
            "ms": (time.perf_counter() - t0) * 1e3 / timed_steps}


def rollout_ranks(specials, batch, steps, seed, device_type: str = "cuda") -> dict:
    """Phase 17, in each rank: ``sharded_run`` over every rank of the world
    (dp = world size) on the shared card."""
    import torch.distributed as dist

    from tile_match_tpu_torch.parallel import make_mesh

    n = dist.get_world_size()
    mesh = make_mesh([device_type] * n, dp=n, tp=1)
    _zero_launch_counts()
    # on the CPU the wrappers run their plain versions: no launch to require
    required = (("combination_trip", "cascade_sp_chunk", "settled_mask_sp")
                if device_type == "cuda" else ())
    run = sharded_run(_config(10, 10, 4, 30, specials), mesh, batch, steps, seed,
                      f"phase 17 rank {dist.get_rank()}", required)
    if dist.get_rank():
        run.pop("boards")  # rank 0 brings the gathered boards back
    return run


def check_debug(device) -> dict:
    """Phase 19a: ``debug.checked_step`` over the recorded config-3 fixture
    boards (every step before the auto-reset: each next state equals the
    recorded one, and no check fires); a painted board with two lines
    raises ``lines_max overflow`` at ``max_lines=1``; a step cut at
    ``max_cascades=0`` raises ``matches remain after step``; each of K4's
    capacity caps, on a painted board, raises through the kernel (on the
    card) the message the plain trip raises on the CPU.  Returns the steps
    checked."""
    import torch

    from tile_match_tpu_torch import debug, engine
    from tile_match_tpu_torch import random as trandom
    from tile_match_tpu_torch.interop import state_from_numpy, state_to_numpy
    from tile_match_tpu_torch.ops import combination, trip_sp
    from tile_match_tpu_torch.ops.lines import get_colour_lines

    device = torch.device(device)
    d = np.load(FIXTURE_CFG3)
    R, C, K, moves = (int(v) for v in d["config"])
    cfg = _config(R, C, K, moves, d["specials"])
    fn = debug.checked_step(cfg)
    state = state_from_numpy(d["colour"][0], d["kind"][0], d["timer"][0], d["key"][0], device)
    for t in range(moves - 1):
        state, _, done, _ = fn(state, torch.from_numpy(d["actions"][t].astype(np.int64)).to(device))
        got = state_to_numpy(state)
        for name in ("colour", "kind", "timer", "key"):
            check(np.array_equal(got[name], d[name][t + 1].astype(got[name].dtype)),
                  f"checked_step {t}: {name} differs from the recorded JAX rollout")
        check(not bool(done.any()), f"checked_step {t}: a board is done before the last move")

    colour = _filler(5, 5)
    colour[2:5, 0] = 4
    colour[2:5, 2] = 4
    painted = dataclasses.replace(_config(5, 5, 4, 30, ALL_SPECIALS), max_lines=1, debug_checks=True)
    try:
        get_colour_lines(painted, torch.from_numpy(colour)[None].to(device))
        raise AssertionError("no error")
    except RuntimeError as e:
        check("lines_max overflow: 2 detected lines exceed capacity 1" in str(e),
              f"debug_checks: the painted board raised {e!r}")

    # K4's caps: each painted board raises, through the kernel on the card,
    # the message the plain trip raises on the CPU
    for cap in CAPS:
        R, C, K, kw, colour, kind = cap_board(cap)
        cfg = dataclasses.replace(_config(R, C, K, 30, ALL_SPECIALS), debug_checks=True, **kw)
        inputs = (torch.from_numpy(colour)[None], torch.from_numpy(kind)[None],
                  torch.tensor([[3, 4]]), torch.zeros(1, dtype=torch.int32))
        messages = []
        for dev in (torch.device("cpu"), device):
            before = cuda_build.launches["specials_trip"]
            try:
                trip_sp.specials_trip(cfg, *(t.to(dev) for t in inputs))
                messages.append("")
            except RuntimeError as e:
                messages.append(str(e))
        check(device.type != "cuda" or cuda_build.launches["specials_trip"] == before + 1,
              f"debug_checks {cap}: K4 did not launch")
        check(messages[0] != "" and messages[1] == messages[0],
              f"debug_checks {cap}: K4 raised {messages[1]!r}, the plain trip {messages[0]!r}")
        print(f"phase 19: K4 {cap} cap on the card raised {messages[1]!r}, as the plain trip")

    # K5's caps: a tight stack and a tight step budget raise, through the
    # kernel on the card, the message the plain branch raises on the CPU
    inputs = combination_inputs(8, 8, 3, 256, seed=19, device="cpu")
    for kw in (dict(max_stack=2), dict(max_activation_steps=3)):
        cfg = dataclasses.replace(_config(8, 8, 3, 30, ALL_SPECIALS), debug_checks=True, **kw)
        messages = []
        for dev in (torch.device("cpu"), device):
            before = cuda_build.launches["combination_trip"]
            try:
                combination.combination_trip(cfg, *(t.to(dev) for t in inputs))
                messages.append("")
            except RuntimeError as e:
                messages.append(str(e))
        check(device.type != "cuda" or cuda_build.launches["combination_trip"] == before + 1,
              f"debug_checks {kw}: K5 did not launch")
        check(messages[0] != "" and messages[1] == messages[0],
              f"debug_checks {kw}: K5 raised {messages[1]!r}, the plain branch {messages[0]!r}")
        print(f"phase 19: K5 {kw} on the card raised {messages[1]!r}, as the plain branch")

    cut = dataclasses.replace(_config(5, 5, 3, 10), max_cascades=0)
    states, info = engine.reset(cut, trandom.split(trandom.PRNGKey(0, device), 4))
    action = info.effective_actions.to(torch.int64).argmax(-1)
    try:
        debug.checked_step(cut)(states, action)
        raise AssertionError("no error")
    except RuntimeError as e:
        check("matches remain after step" in str(e), f"checked_step: the cut cascade raised {e!r}")
    return {"steps": moves - 1, "boards": int(d["colour"].shape[1])}


def scale_out(device, smi) -> None:
    """Phases 16-19, each path's launches on its own phase lines."""
    import socket

    import torch
    import torch.distributed as dist

    from tile_match_tpu_torch import profiling
    from tile_match_tpu_torch import random as trandom
    from tile_match_tpu_torch.entry import dryrun_multichip
    from tile_match_tpu_torch.parallel import initialize_distributed, launch, make_mesh

    # 16. world size 1 over NCCL
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    check(initialize_distributed(f"localhost:{port}", 1, 0, backend="nccl"),
          "phase 16: initialize_distributed did not start a group")
    try:
        check(dist.get_backend() == "nccl" and dist.get_world_size() == 1,
              "phase 16: not a one-rank NCCL group")
        mesh = make_mesh([device], dp=1, tp=1)
        _zero_launch_counts()
        counts = replay_sharded_rollout(mesh)
        print(f"phase 16 ok: one-rank NCCL group; sharded_rollout replayed the recorded JAX "
              f"sharded_rollout (config 3, 64 boards, 8 steps) bit for bit: rewards, every state "
              f"leaf, stats; launches {counts}")
        runs = {}
        for name, specials, required in (("config 1", (0, 0, 0, 0), ("fused_cascade",)),
                                         ("config 3", ALL_SPECIALS,
                                          ("combination_trip", "cascade_sp_chunk",
                                           "settled_mask_sp"))):
            _zero_launch_counts()
            runs[name] = run = sharded_run(_config(10, 10, 4, 30, specials), mesh, MAIN_BATCH,
                                           SCALE_STEPS, SEED, f"phase 16 {name}", required)
            print(f"phase 16 ok: {name} B={MAIN_BATCH} {SCALE_STEPS} steps on one rank: "
                  f"{run['board_steps_per_s']:.1f} board-steps/s, launches a step "
                  f"{run['launches_per_step']}, in all with the reset {run['launches']} ({smi})")
        # config 1's step takes its settled mask from K1; K3 computes the reset's
        check(runs["config 1"]["launches"]["settled_mask_sp"] > 0,
              "phase 16 config 1: K3 did not run at the reset")

        # 17. two ranks sharing the card over gloo
        outs = launch(2, rollout_ranks, ALL_SPECIALS, MAIN_BATCH, SCALE_STEPS, SEED,
                      backend="gloo", timeout=600)
        one = runs["config 3"]
        for name, want in one["boards"].items():
            check(np.array_equal(outs[0]["boards"][name], want),
                  f"phase 17: dp=2 {name} differs from the one-rank run")
        for name in ("steps_done", "trips_sum"):
            check(np.array_equal(outs[0]["stats"][name], one["stats"][name]),
                  f"phase 17: dp=2 stats {name} differ from the one-rank run")
        for rank, o in enumerate(outs):
            print(f"phase 17: rank {rank} of 2 (gloo, one card): {o['board_steps_per_s']:.1f} "
                  f"board-steps/s, launches a step {o['launches_per_step']} ({smi})")
        t0 = time.perf_counter()
        dryrun_multichip(2)
        print(f"phase 17 ok: dp=2 over gloo on one card equals the one-rank run board for board "
              f"(config 3, B={MAIN_BATCH}, {SCALE_STEPS} steps); dryrun_multichip(2) passed in "
              f"{time.perf_counter() - t0:.1f} s ({smi})")

        # 18. the sharded train step
        _zero_launch_counts()
        rec = replay_sharded_train(mesh)
        counts = _launch_counts()
        state, step = rec["state"], rec["step"]
        key = trandom.PRNGKey(SEED, device)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(SCALE_TRAIN_STEPS):
            key, k = trandom.split(key)
            state, metrics = step(state, k)
        torch.cuda.synchronize()
        ms1 = (time.perf_counter() - t0) * 1e3 / SCALE_TRAIN_STEPS
        print(f"phase 18 ok: sharded_train_step (1, 1) over NCCL replayed two recorded JAX steps "
              f"(config 1, B=256, hidden 512): env side bit for bit, gaps {rec['gaps']}; "
              f"launches {counts}; {ms1:.3f} ms a step over {SCALE_TRAIN_STEPS} ({smi})")
        f = _fixture_tool()
        one_rank = launch(1, train_ranks, 1, SCALE_TRAIN_STEPS, backend="gloo", timeout=600)[0]
        two = launch(2, train_ranks, 2, SCALE_TRAIN_STEPS, backend="gloo", timeout=600)
        whole = _whole_params([o["params"] for o in sorted(two, key=lambda o: o["tp_rank"])])
        ref = one_rank["params"]
        tree = f.seeded_qnet_params(ref["dense1.weight"].shape[1], f.DQN_HIDDEN,
                                    ref["head.weight"].shape[0], f.QNET_SEED)
        seeded = f.port_leaves(tree)
        worst = 0.0
        for name in ref:
            gap = _rel_gap(whole[name] - seeded[name], ref[name] - seeded[name])
            check(gap < LEARNER_DRIFT_REL, f"phase 18: (1, 2) change of {name} differs from (1, 1) "
                                           f"by a relative norm of {gap:.4f}")
            worst = max(worst, gap)
        for t, (a, b) in enumerate(zip(two[0]["losses"], one_rank["losses"])):
            check(abs(a - b) / abs(b) < 5e-2, f"phase 18: (1, 2) loss {a} against (1, 1) {b} at "
                                              f"step {t + 1}")
        print(f"phase 18 ok: (dp, tp) = (1, 2) on one card over gloo: losses {two[0]['losses']} "
              f"against (1, 1)'s {one_rank['losses']}, largest leaf change gap {worst:.5f}; "
              f"ms a step: (1, 1) {one_rank['ms']:.3f}, (1, 2) ranks "
              f"{[round(o['ms'], 3) for o in two]} ({smi})")
    finally:
        dist.destroy_process_group()

    # 19. checked_step and measure_throughput
    _zero_launch_counts()
    n = check_debug(device)
    print(f"phase 19 ok: checked_step passed {n['steps']} recorded config-3 steps of {n['boards']} "
          f"boards bit for bit; a painted max_lines=1 board raised lines_max overflow on the card, "
          f"K4 raised each cap's message, "
          f"a max_cascades=0 step raised matches remain; launches {_launch_counts()}")
    _zero_launch_counts()
    out = profiling.measure_throughput(_config(10, 10, 4, 30), batch_size=MAIN_BATCH)
    check(out["steps_per_sec"] > 0 and out["device"] == torch.cuda.get_device_name(0),
          "phase 19: measure_throughput")
    print(f"phase 19: measure_throughput config 1 B={MAIN_BATCH}: {json.dumps(out)} "
          f"launches {_launch_counts()} ({smi})")
    print("phase 19 ok")


# ---------------------------------------------------------------------------
# Phases 20-21: the port's bench and its gate tools
# ---------------------------------------------------------------------------
def run_bench(config: int, cut: dict, smi) -> dict:
    """Phase 20: ``python -m tile_match_tpu_torch.bench --config N`` in a
    subprocess, with the environment's ``TMT_BENCH_*`` replaced by ``cut``.
    Checks its exit code, its last line (bench.py's four keys, a value
    above 0) and the path's kernels in its launches line; echoes its gate
    and bench lines.  Returns the last line."""
    from tile_match_tpu_torch.bench import PATH_KERNELS

    env = {k: v for k, v in os.environ.items() if not k.startswith("TMT_BENCH_")}
    env.update(cut)
    tag = f"phase 20 config {config}"
    t0 = time.perf_counter()
    out = subprocess.run(
        [sys.executable, "-m", "tile_match_tpu_torch.bench", "--config", str(config)],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=BENCH_TIMEOUT,
    )
    check(out.returncode == 0, f"{tag}: the bench exited {out.returncode}: {out.stderr[-3000:]}")
    lines = out.stdout.strip().splitlines()
    for line in lines[:-1]:
        if line.startswith(("gate:", "bench:")):
            print(f"{tag}: {line}")
    last = json.loads(lines[-1])
    check(set(last) == {"metric", "value", "unit", "vs_baseline"} and last["value"] > 0,
          f"{tag}: the bench's last line {lines[-1]}")
    launches = next(line for line in lines if line.startswith("bench: launches a step:"))
    counts = {name: float(n) for name, n in
              (item.split() for item in launches.split(":", 2)[2].split(","))}
    required = PATH_KERNELS[config >= 2]  # configs 2-4 hold specials
    check(all(counts[name] > 0 for name in required),
          f"{tag}: the timed windows did not launch {required}: {counts}")
    cut_note = f", cut to {cut}" if cut else ", the bench's defaults"
    print(f"{tag} ok: gate passed, {lines[-1]} in {time.perf_counter() - t0:.1f} s with the "
          f"process's start{cut_note} ({smi})")
    return last


def gate_tools(device, smi) -> None:
    """Phase 21: ``parity_check``'s checks, ``kernel_coverage`` on config 3
    and ``truncation_audit`` on config 3, on the card; the last two with
    the plain settled mask refused there (``parity_check`` holds K1
    against its plain version on the card, whose mask is the plain one)."""
    import io

    from tile_match_tpu_torch.bench import make_config
    from tile_match_tpu_torch.tools import kernel_coverage, parity_check, truncation_audit

    _zero_launch_counts()
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        parity_check.main([])
    for line in buf.getvalue().splitlines():
        print(f"phase 21: parity_check: {line}")
    counts = _launch_counts()
    check(all(n > 0 for n in counts.values()), f"phase 21: parity_check launches {counts}")
    print(f"phase 21 ok: parity_check passed on the card; launches {counts}")

    _zero_launch_counts()
    t0 = time.perf_counter()
    with plain_mask_refused(), plain_trip_refused(), plain_combination_refused():
        cov = kernel_coverage.coverage(make_config(3), COVERAGE_BATCH, COVERAGE_STEPS, device)
    counts = _launch_counts()
    check(cov["trips_total"] > 0 and cov["trips_kernel"] > 0 and counts["cascade_sp_chunk"] > 0,
          f"phase 21: kernel_coverage {cov}, launches {counts}")
    print(f"phase 21 ok: kernel_coverage config 3 B={COVERAGE_BATCH} {COVERAGE_STEPS} steps: "
          f"{json.dumps(cov)}; launches {counts}; {time.perf_counter() - t0:.1f} s ({smi})")

    _zero_launch_counts()
    t0 = time.perf_counter()
    with plain_mask_refused(), plain_trip_refused(), plain_combination_refused():
        n = truncation_audit.audit(make_config(3), AUDIT_BATCH, AUDIT_STEPS, device)
    board_steps = AUDIT_BATCH * AUDIT_STEPS
    check(n * 10000 < board_steps, f"phase 21: {n} truncated board-steps of {board_steps}")
    print(f"phase 21 ok: truncation_audit config 3 B={AUDIT_BATCH} {AUDIT_STEPS} steps: {n} "
          f"truncated of {board_steps} board-steps (limit 0.01%); launches {_launch_counts()}; "
          f"{time.perf_counter() - t0:.1f} s ({smi})")


def _whole_params(shards) -> dict:
    """A whole network's weights from its tp shards (numpy), in tp order."""
    out = dict(shards[0])
    for name, dim in (("dense1.weight", 0), ("dense1.bias", 0), ("dense2.weight", 1)):
        out[name] = np.concatenate([s[name] for s in shards], dim)
    return out


def main() -> int:
    import torch

    t_start = time.perf_counter()
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

    # 2. build, one nvcc per library, all at once
    t0 = time.perf_counter()
    libs = [(src, cuda_build.shape_of(R, C)) for src, shapes in LIBRARY_SHAPES.items()
            for R, C in shapes]
    libs += [(k.source, None) for k in cuda_build.KERNELS.values()
             if k.source not in LIBRARY_SHAPES]
    cuda_build.build_all(libs)
    stems = [src if shape is None else f"{src}-{shape[0]}x{shape[1]}" for src, shape in libs]
    for lib in libs:
        cuda_build.load(*lib)
    print(f"phase 2 ok: built {', '.join(stems)} in {time.perf_counter() - t0:.1f} s")
    for stem in stems:
        log = cuda_build.build_logs.get(stem)
        ptxas = cuda_build.ptxas_summary(log) if log else "library up to date, not rebuilt"
        print(f"phase 2: {stem}: ptxas [board shape, registers, spill stores, spill loads] {ptxas}")
    for name in REPLACES:  # the board kernels, K1-K5
        per_sm = {}
        for R, C in ((10, 10), (36, 36)):
            # K4 and K5: and 6 colours
            args = (R, C, 6) if name in ("specials_trip", "combination_trip") else (R, C)
            lib = cuda_build.library(name, device, (R, C))
            fn = cuda_build.c_function(lib, f"tmt_{name}_occupancy", [ctypes.c_int] * len(args))
            per_sm[f"{R}x{C}"] = fn(*args)
        print(f"phase 2: {name}: boards in flight per SM {per_sm} "
              f"(cudaOccupancyMaxActiveBlocksPerMultiprocessor)")

    # 3. kernels against their plain versions
    rec = check_kernels(device, smi)

    # 4-8. the main paths, with the plain settled mask, the plain trip and
    # the plain combination branch refused on the card
    with plain_mask_refused(), plain_trip_refused(), plain_combination_refused():
        launches = main_paths(device, smi)
    print("phases 4-8 ok: the plain settled mask, the plain trip and the plain combination "
          "branch ran on no CUDA tensor")

    # 9-15. the training path
    with plain_mask_refused(), plain_trip_refused(), plain_combination_refused():
        training_path(device, smi)

    # 16-19. the scale-out layer, debug checks and throughput
    with plain_mask_refused(), plain_trip_refused(), plain_combination_refused():
        scale_out(device, smi)

    # 20. the port's bench on every config, each in its own process
    torch.cuda.empty_cache()
    for config, cut in BENCH_RUNS:
        run_bench(config, cut, smi)

    # 21. the gate tools
    gate_tools(device, smi)

    print(f"all phases ok in {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": [
        {
            "name": name,
            "route": "cuda",
            "source": f"tile_match_tpu_torch/csrc/{kernel.source}.cu",
            "replaces": REPLACES.get(name),
            "launches": launches[name],
            **rec[name],
            "library_ms": None,
        }
        for name, kernel in cuda_build.KERNELS.items()
    ]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
