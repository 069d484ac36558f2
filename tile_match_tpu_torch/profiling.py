"""Tracing and throughput of the PyTorch port (counterpart of
``tile_match_tpu.profiling``, on ``torch.profiler``).

Program spans: ``span(name, **attrs)`` marks a part of the step (the
batched step, the draw, regeneration, the playability loop, the cascade,
each kernel wrapper's call) with host-integer counts as attributes.  A
span records only while a ``torch.profiler`` session runs; otherwise it is
one flag check and a shared no-op object.  Its times are ``time.time_ns()``,
the profiler's own time base, so a reader can cut the profile's device
operations by span.  ``spans()`` returns the log, ``clear_spans()`` empties
it.  Spans are plain Python, never ``record_function`` ranges, so they put
nothing on the device's timeline.

``trace(logdir)`` is a ``torch.profiler`` context that writes a Chrome
trace into ``logdir`` (a no-op for ``None``), the program's spans in it;
``timed_windows`` times the batched step under the random effective
policy, keyed as the JAX package's, and ``measure_throughput`` reports its
best window.  As a CLI, with the JAX package's flags:

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
device time of the port's CUDA kernels against all other device work, the
ten kernels with the most device time, and by program span the ms a step,
the ms with the device idle, the kernels started and the launches made
inside it (``span_table``; nested spans count in their callers too).
With ``--dqn`` the step is ``models.dqn.make_dqn``'s train step (hidden
512, default epsilon schedule) on a batch of ``--batch`` boards, its
epsilon-greedy draw (``act_greedy_or_random``) in a span of its own, and
the launches a step outside the env step and the draw are printed too
(network passes, loss, backward, Adam).  Every number is the card's; the
card's name and power limit head the output.  Imports no JAX.
"""

from __future__ import annotations

import argparse
import bisect
import contextlib
import functools
import json
import os
import socket
import sys
import time

from torch.autograd import _profiler_enabled

class Span:
    """One record of the span log: ``name``, ``start_ns`` and ``end_ns``
    (``time.time_ns()``; ``end_ns`` None while open), ``parent`` (the
    enclosing span's index in the log, -1 for a root), ``step`` (the index
    of the ``batched_step`` span it belongs to; a root ``draw`` takes the
    step it feeds; -1 for none) and ``attrs``, host-integer counts (and
    ``what``, the entry point of a ``line_test`` launch)."""

    __slots__ = ("name", "start_ns", "end_ns", "parent", "step", "attrs")

    def __init__(self, name, start_ns, parent, step, attrs):
        self.name, self.start_ns, self.end_ns = name, start_ns, None
        self.parent, self.step, self.attrs = parent, step, attrs

    def set(self, **attrs) -> None:
        """Add counts known only at the span's end."""
        self.attrs.update(attrs)

    def __enter__(self):
        return self

    def __exit__(self, *exc) -> None:
        self.end_ns = time.time_ns()
        if _open and _log[_open[-1]] is self:
            _open.pop()


class _Off:
    """The span of an untraced call: records nothing."""

    __slots__ = ()

    def set(self, **attrs) -> None:
        pass

    def __enter__(self):
        return self

    def __exit__(self, *exc) -> None:
        pass


_OFF = _Off()
_log: list = []  # every Span recorded, in the order they opened
_open: list = []  # indices of the open spans, innermost last
_draws: list = []  # root draws waiting for the step they feed


def span(name: str, **attrs):
    """A context manager marking a part of the program as span ``name``
    with counts ``attrs``; it records only while a ``torch.profiler``
    session runs (``torch.autograd._profiler_enabled()``), and adds no
    device work or synchronisation either way."""
    if not _profiler_enabled():
        return _OFF
    i = len(_log)
    parent = _open[-1] if _open else -1
    if parent >= 0:
        step = _log[parent].step
    elif name == "batched_step":
        step = i
        for d in _draws:
            d.step = i
        _draws.clear()
    else:
        step = -1
    rec = Span(name, time.time_ns(), parent, step, attrs)
    if parent < 0 and name == "draw":
        _draws.append(rec)
    _log.append(rec)
    _open.append(i)
    return rec


def kernel_span(name: str):
    """Decorator of a kernel wrapper ``fn(cfg, colour, ...)``: each call in
    span ``name`` with ``boards``, the launch's batch (``colour``'s rows)."""

    def wrap(fn):
        @functools.wraps(fn)
        def call(cfg, colour, *args, **kwargs):
            if not _profiler_enabled():
                return fn(cfg, colour, *args, **kwargs)
            with span(name, boards=colour.shape[0]):
                return fn(cfg, colour, *args, **kwargs)

        return call

    return wrap


def spans() -> list:
    """The span log: every ``Span`` recorded since the last ``clear_spans()``."""
    return _log


def clear_spans() -> None:
    _log.clear()
    _open.clear()
    _draws.clear()


def _merged(intervals) -> list:
    """The union of [start, end) intervals as sorted disjoint [start, end]
    pairs."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


@contextlib.contextmanager
def trace(logdir: str | None):
    """``torch.profiler`` trace context writing a Chrome trace
    (``<host>_<pid>.<ns>.pt.trace.json``) into ``logdir``, the program's
    spans of the session in it as complete events of thread 0 on the
    trace's own time base; a no-op when logdir is None.  Traces the card's
    kernels too where there is a card."""
    if logdir is None:
        yield
        return
    import torch
    from torch.profiler import ProfilerActivity, profile

    first = len(_log)

    def write(prof):
        os.makedirs(logdir, exist_ok=True)
        path = os.path.join(logdir, f"{socket.gethostname()}_{os.getpid()}.{time.time_ns()}.pt.trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            chrome = json.load(f)
        base = chrome.get("baseTimeNanoseconds", 0)
        pid = os.getpid()
        events = chrome["traceEvents"]
        events.append({"ph": "M", "name": "thread_name", "pid": pid, "tid": 0,
                       "args": {"name": "program spans"}})
        for s in _log[first:]:
            if s.end_ns is not None:
                events.append({"ph": "X", "cat": "program_span", "name": s.name, "pid": pid, "tid": 0,
                               "ts": (s.start_ns - base) / 1e3, "dur": (s.end_ns - s.start_ns) / 1e3,
                               "args": dict(s.attrs, step=s.step, parent=s.parent)})
        with open(path, "w") as f:
            json.dump(chrome, f)

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities, on_trace_ready=write):
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
    from .cuda_build import launches, resolve_device
    from .envs.batched import batched_reset, batched_step, random_effective

    device = resolve_device(device)

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
    before = dict(launches)
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
        "launches": {n: c - before[n] for n, c in launches.items()},
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


def _kineto_events(prof) -> list:
    """(name, on the card, start ns, end ns) of every event of a finished
    profile, on the spans' time base (kineto's unix ns)."""
    from torch.autograd import DeviceType

    return [(e.name(), e.device_type() == DeviceType.CUDA, e.start_ns(), e.start_ns() + e.duration_ns())
            for e in prof.profiler.kineto_results.events()]


def _covered(busy, ends, a, b) -> float:
    """Length of [a, b) that ``busy`` (sorted disjoint intervals, ``ends``
    their ends) covers."""
    total = 0
    for s, e in busy[bisect.bisect_right(ends, a):]:
        if s >= b:
            break
        total += min(e, b) - max(s, a)
    return total


def span_table(records, device_ops, launches, steps: int) -> dict:
    """By span name, a step: ``ms`` inside the spans, ``idle_ms`` of it in
    which no device operation of ``device_ops`` [(name, start, end)] runs,
    ``kernels`` (device operations but memcpy and memset) started inside,
    ``launches`` (the host's launch calls, by their start times) made
    inside, and ``calls``.  Times in ns on the spans' base; nested spans
    count in their callers too."""
    busy = _merged((s, e) for _, s, e in device_ops)
    ends = [e for _, e in busy]
    kernels = sorted(s for n, s, _ in device_ops
                     if "memcpy" not in n.lower() and "memset" not in n.lower())
    launches = sorted(launches)

    def inside(starts, ivs):
        return sum(bisect.bisect_left(starts, e) - bisect.bisect_left(starts, s) for s, e in ivs)

    by_name = {}
    for r in records:
        if r.end_ns is not None:
            by_name.setdefault(r.name, []).append((r.start_ns, r.end_ns))
    out = {}
    for name, ivs in by_name.items():
        merged = _merged(ivs)
        ns = sum(e - s for s, e in merged)
        idle = ns - sum(_covered(busy, ends, s, e) for s, e in merged)
        out[name] = {"ms": ns / 1e6 / steps, "idle_ms": idle / 1e6 / steps,
                     "kernels": inside(kernels, merged) / steps,
                     "launches": inside(launches, merged) / steps, "calls": len(ivs) / steps}
    return out


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
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        print("profiling: needs a CUDA card", file=sys.stderr)
        return 1
    from . import cuda_build
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
    if args.steps + 4 >= moves:
        raise SystemExit(f"--steps must leave the window before the reset at step {moves}")
    if args.dqn:
        from .models import dqn

        init_fn, train_step, _ = dqn.make_dqn(cfg, batch_size=args.batch, device=dev)
        key, k_init = trandom.split(trandom.PRNGKey(0, dev))
        state = init_fn(k_init)
        act = dqn.act_greedy_or_random

        def spanned_act(*a, **k):
            with span("act_greedy_or_random"):
                return act(*a, **k)

        dqn.act_greedy_or_random = spanned_act

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
    before = dict(cuda_build.launches)
    first = len(_log)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(args.steps):
            one_step()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3

    events = _kineto_events(prof)
    device_ops = [(name, s, e) for name, on_card, s, e in events if on_card]
    launch_starts = [s for name, on_card, s, _ in events
                     if not on_card and name in ("cudaLaunchKernel", "cuLaunchKernel")]
    busy_ms = sum(e - s for s, e in _merged((s, e) for _, s, e in device_ops)) / 1e6
    by_name = {}
    for name, s, e in device_ops:
        if "memcpy" not in name.lower() and "memset" not in name.lower():
            by_name[name] = by_name.get(name, 0.0) + (e - s) / 1e3
    port = [k.device_name for k in cuda_build.KERNELS.values()]
    port_us = sum(t for n, t in by_name.items() if any(k in n for k in port))
    other_us = sum(by_name.values()) - port_us
    n = args.steps
    table = span_table(_log[first:], device_ops, launch_starts, n)
    print(f"config {args.config} B={args.batch}, {n} profiled steps")
    print(f"wall {wall_ms / n:.3f} ms/step with the profiler on")
    print(f"device busy {busy_ms / n:.3f} ms/step, {100 * busy_ms / wall_ms:.1f}% of wall")
    counts = {k: (c - before[k]) / n for k, c in cuda_build.launches.items()}
    print(f"kernel launches {len(launch_starts) / n:.1f}/step; of the port's kernels: "
          f"{', '.join(f'{k} {c:.2f}' for k, c in counts.items())}")
    if args.dqn:
        parts = sum(table.get(p, {}).get("launches", 0.0)
                    for p in ("batched_step", "act_greedy_or_random"))
        print(f"  in the rest of the train step: {len(launch_starts) / n - parts:.1f}/step")
    print(f"device time: port kernels {port_us / 1e3 / n:.3f} ms/step, "
          f"other device work {other_us / 1e3 / n:.3f} ms/step")
    for name, us in sorted(by_name.items(), key=lambda kv: -kv[1])[:10]:
        print(f"  {us / 1e3 / n:9.3f} ms/step  {name[:100]}")
    print("by program span, a step (nested spans count in their callers too):")
    print(f"  {'span':<22}{'ms':>10}{'idle ms':>10}{'kernels':>10}{'launches':>10}{'calls':>8}")
    for name, row in sorted(table.items(), key=lambda kv: -kv[1]["ms"]):
        print(f"  {name:<22}{row['ms']:10.3f}{row['idle_ms']:10.3f}{row['kernels']:10.1f}"
              f"{row['launches']:10.1f}{row['calls']:8.2f}")
    return 0


if __name__ == "__main__":
    # run as the package's module, so that the CLI reads the span log the
    # program records into (``python -m`` runs a second copy of this file)
    from tile_match_tpu_torch import profiling

    sys.exit(profiling.main())
