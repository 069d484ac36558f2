"""Tracing and throughput of the PyTorch port (counterpart of
``tile_match_tpu.profiling``, on ``torch.profiler``).

``trace(logdir)`` is a ``torch.profiler`` context that writes a Chrome
trace into ``logdir`` (a no-op for ``None``); ``timed_windows`` times the
batched step under the random effective policy, keyed as the JAX
package's, and ``measure_throughput`` reports its best window.  As a CLI,
with the JAX package's flags:

    python -m tile_match_tpu_torch.profiling --rows 10 --cols 10 --colours 4 \
        --batch 1024 --steps 32 [--reps 3] [--no-specials] [--trace DIR] [--device cpu]

prints ``measure_throughput``'s JSON.  The step's profile on the card:

    python -m tile_match_tpu_torch.profiling --profile [--config 3] [--no-bomb] [--batch 16384] [--steps 10] [--dqn]

Builds config ``--config`` of ``bench.py`` (0-4), without the bomb with
``--no-bomb`` (K2's no-bomb case table), resets a batch, runs 4
warm-up steps through ``BatchedTileMatchEnv`` under a random effective
policy, then ``--steps`` steps under ``torch.profiler`` (no auto-reset falls
in the window).  Prints, for the window: wall time per step, device busy
time and share (the union of kernel intervals on the card), kernel launches
per step and those of each of the port's kernels (their wrappers' counts),
device time of the port's CUDA kernels against all other device work, and
the ten kernels with the most device time.  Then ``--steps`` more
steps without the profiler, with a host clock (after a device
synchronisation) around the step's parts — the combination branch (K5's
wrapper ``combination_trip``), the specials cascade and its kernel
launches (K2, K4), the post-move mask (K3) and the playability loop —
printed in ms per step (nested parts count in their callers too).
With ``--dqn`` the step is ``models.dqn.make_dqn``'s train step (hidden
512, default epsilon schedule) on a batch of ``--batch`` boards, and the
launches a step are also split between the env step, the epsilon-greedy
draw (``act_greedy_or_random``) and the rest (network passes, loss,
backward, Adam).  Every number is the card's; the card's name and power
limit head the output.  Imports no JAX.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import sys
import time

PORT_KERNELS = ("cascade_kernel", "cascade_sp_kernel", "mask_sp_kernel", "specials_trip_kernel",
                "combination_trip_kernel")


def _busy_us(intervals) -> float:
    """Length of the union of [start, end) intervals, in microseconds."""
    total, cur_s, cur_e = 0.0, None, None
    for s, e in sorted(intervals):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total


def kernel_modules() -> dict:
    """The modules of the port's kernel wrappers by kernel name; each counts
    its kernel's launches in ``launches``."""
    from .ops import cascade, cascade_sp, combination, mask_sp, trip_sp

    return {"fused_cascade": cascade, "cascade_sp_chunk": cascade_sp, "settled_mask_sp": mask_sp,
            "specials_trip": trip_sp, "combination_trip": combination}


@contextlib.contextmanager
def trace(logdir: str | None):
    """``torch.profiler`` trace context writing a Chrome trace
    (``*.pt.trace.json``) into ``logdir``; a no-op when logdir is None.
    Traces the card's kernels too where there is a card."""
    if logdir is None:
        yield
        return
    import torch
    from torch.profiler import ProfilerActivity, profile, tensorboard_trace_handler

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities, on_trace_ready=tensorboard_trace_handler(logdir)):
        yield


# the keys of the JAX package's ``measure_throughput``
THROUGHPUT_KEYS = ("steps_per_sec", "batch_size", "num_steps", "times", "device")


def timed_windows(
    cfg,
    batch_size: int,
    num_steps: int,
    reps: int,
    seed: int = 0,
    logdir: str | None = None,
    device=None,
    warmup: int = 1,
) -> dict:
    """The batched step under the random effective policy, timed in
    windows (``device``: the card unless the caller names another).

    The JAX package's loop and draws: boards reset from ``PRNGKey(seed)``,
    the policy keyed from ``PRNGKey(seed + 1)`` (``key, ka = split(key)``
    each step), ``warmup`` warm-up steps, then ``reps`` timed windows of
    ``num_steps`` steps, each ended by a device synchronisation.  A CUDA
    event after each step times it on the card with no host
    synchronisation inside a window.  Returns ``measure_throughput``'s keys
    (the best window's board-steps/s, the sizes, each window's seconds, the
    device's name) and ``step_ms`` (each window's steps), ``dones`` (each
    window's finished episodes), ``rewards`` (each step's reward summed
    over the boards), ``launches`` (each kernel wrapper's launches over the
    windows) and the final ``states`` and ``ts``."""
    import torch

    from . import random as trandom
    from .envs.batched import batched_reset, batched_step, random_effective
    from .parity import resolve_device

    device = resolve_device(device)
    kernels = kernel_modules()

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    def mark():
        if device.type != "cuda":
            return time.perf_counter()
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        return ev

    def elapsed_ms(a, b):
        return a.elapsed_time(b) if device.type == "cuda" else (b - a) * 1e3

    def step_random(states, ts, key):
        key, ka = trandom.split(key)
        acts = random_effective(ka, ts)
        states, ts = batched_step(cfg, states, acts, eff_mask=ts.info.effective_actions)
        return states, ts, key

    states, ts = batched_reset(cfg, trandom.PRNGKey(seed, device), batch_size)
    key = trandom.PRNGKey(seed + 1, device)
    for _ in range(warmup):
        states, ts, key = step_random(states, ts, key)
    sync()

    times, step_ms, dones, rewards = [], [], [], []
    before = {n: m.launches for n, m in kernels.items()}
    with trace(logdir):
        for _ in range(reps):
            t0 = time.perf_counter()
            marks, run_dones, run_rewards = [mark()], [], []
            for _ in range(num_steps):
                states, ts, key = step_random(states, ts, key)
                marks.append(mark())
                run_dones.append(ts.done)
                run_rewards.append(ts.reward)
            sync()
            times.append(time.perf_counter() - t0)
            step_ms.append([elapsed_ms(a, b) for a, b in zip(marks, marks[1:])])
            dones.append(int(torch.stack(run_dones).sum()))
            rewards += torch.stack(run_rewards).double().sum(1).tolist()
    return {
        "steps_per_sec": max(batch_size * num_steps / dt for dt in times),
        "batch_size": batch_size,
        "num_steps": num_steps,
        "times": times,
        "device": torch.cuda.get_device_name(device) if device.type == "cuda" else str(device),
        "step_ms": step_ms,
        "dones": dones,
        "rewards": rewards,
        "launches": {n: m.launches - before[n] for n, m in kernels.items()},
        "states": states,
        "ts": ts,
    }


def measure_throughput(
    cfg,
    batch_size: int = 1024,
    num_steps: int = 32,
    reps: int = 3,
    seed: int = 0,
    logdir: str | None = None,
    device=None,
) -> dict:
    """Board-steps/s of the batched step under the random effective policy
    (``device``: the card unless the caller names another): ``timed_windows``
    after one warm-up step.  Returns the best rate, the sizes, each run's
    seconds and the device's name."""
    run = timed_windows(cfg, batch_size, num_steps, reps, seed, logdir, device)
    return {k: run[k] for k in THROUGHPUT_KEYS}


def main(argv=None) -> int:
    """The JAX package's throughput CLI; with ``--profile``, the step's
    profile on the card."""
    argv = list(sys.argv[1:] if argv is None else argv)
    if "--profile" in argv:
        argv.remove("--profile")
        return profile_step(argv)
    from .config import EnvConfig

    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--rows", type=int, default=10)
    p.add_argument("--cols", type=int, default=10)
    p.add_argument("--colours", type=int, default=4)
    p.add_argument("--moves", type=int, default=30)
    p.add_argument("--batch", type=int, default=1024)
    p.add_argument("--steps", type=int, default=32)
    p.add_argument("--reps", type=int, default=3)
    p.add_argument("--no-specials", action="store_true")
    p.add_argument("--trace", type=str, default=None, help="profiler logdir")
    p.add_argument("--device", default=None, help="torch device (default: the CUDA card)")
    args = p.parse_args(argv)
    cfg = EnvConfig(
        args.rows,
        args.cols,
        args.colours,
        args.moves,
        cookie=not args.no_specials,
        vertical_laser=not args.no_specials,
        horizontal_laser=not args.no_specials,
        bomb=not args.no_specials,
    )
    out = measure_throughput(
        cfg, args.batch, args.steps, args.reps, logdir=args.trace, device=args.device
    )
    print(json.dumps(out))
    return 0


def profile_step(argv) -> int:
    ap = argparse.ArgumentParser(description="profile the port's step on the card")
    ap.add_argument("--config", type=int, default=3)
    ap.add_argument("--batch", type=int, default=16384)
    ap.add_argument("--steps", type=int, default=10)
    ap.add_argument("--no-bomb", action="store_true", help="drop the bomb from the config")
    ap.add_argument("--dqn", action="store_true",
                    help="profile the DQN train step in place of the env step")
    args = ap.parse_args(argv)

    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    if not torch.cuda.is_available():
        print("profiling: needs a CUDA card", file=sys.stderr)
        return 1
    from . import random as trandom
    from .bench import CONFIGS, card_line
    from .config import EnvConfig
    from .envs.batched import BatchedTileMatchEnv

    dev = torch.device("cuda", 0)
    print(card_line(dev))
    R, C, K, moves, colourless, colour = CONFIGS[args.config]
    if args.no_bomb:
        colour = tuple(n for n in colour if n != "bomb")
    cfg = EnvConfig.create(R, C, K, moves, colourless_specials=colourless,
                           colour_specials=colour)
    if 2 * args.steps + 4 >= moves:
        raise SystemExit(f"--steps must leave the window before the reset at step {moves}")
    parts = []  # (label) of the train step's parts whose launches are counted
    if args.dqn:
        from .models import dqn

        init_fn, train_step, _ = dqn.make_dqn(cfg, batch_size=args.batch, device=dev)
        key, k_init = trandom.split(trandom.PRNGKey(0, dev))
        state = init_fn(k_init)

        def labelled(fn, label):
            def wrapper(*a, **k):
                with record_function(label):
                    return fn(*a, **k)
            return wrapper

        for name, label in (("batched_step", "env step"), ("act_greedy_or_random", "draw")):
            setattr(dqn, name, labelled(getattr(dqn, name), label))
            parts.append(label)

        def one_step():
            nonlocal state, key
            key, k = trandom.split(key)
            state, _ = train_step(state, k)
    else:
        env = BatchedTileMatchEnv(cfg, args.batch, device=dev)
        gen = torch.Generator(device=dev)
        gen.manual_seed(0)
        states, ts = env.reset(trandom.PRNGKey(0, dev))

        def one_step():
            nonlocal states, ts
            mask = ts.info.effective_actions
            actions = torch.where(mask, torch.rand(mask.shape, generator=gen, device=dev),
                                  -1.0).argmax(-1)
            states, ts = env.step(states, actions)

    for _ in range(4):
        one_step()
    torch.cuda.synchronize()
    wrappers = kernel_modules()
    for m in wrappers.values():
        m.launches = 0
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(args.steps):
            one_step()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3

    # the labelled parts' ranges also appear on the device's timeline: not work
    events = [e for e in prof.events()
              if e.device_type == torch.autograd.DeviceType.CUDA and e.name not in parts]
    kernels = [e for e in events if "memcpy" not in e.name.lower() and "memset" not in e.name.lower()]
    busy_ms = _busy_us([(e.time_range.start, e.time_range.end) for e in events]) / 1e3
    launch_events = [e for e in prof.events() if e.name in ("cudaLaunchKernel", "cuLaunchKernel")]
    launches = len(launch_events)
    by_name = {}
    for e in kernels:
        by_name[e.name] = by_name.get(e.name, 0.0) + (e.time_range.end - e.time_range.start)
    port_us = sum(t for n, t in by_name.items() if any(k in n for k in PORT_KERNELS))
    other_us = sum(by_name.values()) - port_us
    n = args.steps
    print(f"config {args.config} B={args.batch}, {n} profiled steps")
    print(f"wall {wall_ms / n:.3f} ms/step with the profiler on")
    print(f"device busy {busy_ms / n:.3f} ms/step, {100 * busy_ms / wall_ms:.1f}% of wall")
    print(f"kernel launches {launches / n:.1f}/step; of the port's kernels: "
          f"{', '.join(f'{k} {m.launches / n:.2f}' for k, m in wrappers.items())}")
    for label in parts:
        spans = [e.time_range for e in prof.events() if e.name == label]
        inside = sum(1 for e in launch_events
                     if any(r.start <= e.time_range.start < r.end for r in spans))
        launches -= inside
        print(f"  in the {label}: {inside / n:.1f}/step")
    if parts:
        print(f"  in the rest of the train step: {launches / n:.1f}/step")
    print(f"device time: port kernels {port_us / 1e3 / n:.3f} ms/step, "
          f"other device work {other_us / 1e3 / n:.3f} ms/step")
    for name, us in sorted(by_name.items(), key=lambda kv: -kv[1])[:10]:
        print(f"  {us / 1e3 / n:9.3f} ms/step  {name[:100]}")

    # host-clock breakdown of the step's parts
    from . import engine

    spent = {}

    def timed(module, name):
        fn = getattr(module, name)

        def wrapper(*a, **k):
            torch.cuda.synchronize()
            t = time.perf_counter()
            out = fn(*a, **k)
            torch.cuda.synchronize()
            spent[name] = spent.get(name, 0.0) + time.perf_counter() - t
            return out

        setattr(module, name, wrapper)

    for module, name in ((engine, "combination_trip"), (engine, "make_playable"),
                         (engine, "fused_specials_cascade"), (engine, "cascade_sp_chunk"),
                         (engine, "specials_trip"), (engine, "settled_mask_sp")):
        timed(module, name)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(args.steps):
        one_step()
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    print(f"host-clock breakdown over {n} more steps: {wall_ms / n:.3f} ms/step in all")
    for name, sec in sorted(spent.items(), key=lambda kv: -kv[1]):
        print(f"  {sec * 1e3 / n:9.3f} ms/step  {name}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
