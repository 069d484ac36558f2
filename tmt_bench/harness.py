"""One run of one cell: set-up, the measured window, the traced phases and
the check.

The loop is the port's rollout, closed: each step splits the policy key
(``key, ka = split(key)``), draws the actions from the previous step's
mask and steps every board, auto-resetting the finished ones; the next
step waits for this one's mask.  Boards start from ``split(key)[1]`` of
the seed's key, all at timer 0, so every board regenerates in the same
step, every ``num_moves`` steps: a window holds one auto-reset step in
``num_moves``.

Set-up is the process's start to the first timed step: imports, the
kernels' build (found built after a run's first), the reset and
``warmup_episodes`` whole episodes, the auto-reset included, through the
same loop.  The window then runs for ``seconds`` and ends in a device
synchronisation; a CUDA event after each step times the steps.  No
synchronisation is added inside it.

Every step, from the reset on, the outputs of ``check.BOARDS`` boards drawn
from the seed are copied aside on the device (``Recorder``), and each
board's truncated steps are counted on the device over the window; both
are read after it.

``--trace 1`` runs the window with CUDA events around the draw and around
the step, then one whole episode under ``torch.profiler`` (each draw and
step in a ``record_function`` span of the harness), then one more episode
under torch's sync debug mode; the per-layer metrics read these.
"""

from __future__ import annotations

import contextlib
import os
import time
import warnings

import torch

from . import check
from .reference.random import key_of_seed

SPAN = "tmt_bench."  # prefix of the harness's profiler spans
# what a traffic mix may ask of the loop: the port's draw, auto-reset on
LOOP = {"policy": "random_effective", "auto_reset": True}
LAUNCH_CALLS = ("cudaLaunchKernel", "cuLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernelEx")


class Recorder:
    """The outputs of boards ``rows`` at every step, copied aside on the
    device: entry 0 is the reset, entry t the outputs of step t."""

    FIELDS = ("board", "moves_left", "key", "reward", "done", "mask")

    def __init__(self, rows: torch.Tensor):
        self.rows = rows
        self.steps = []
        self.actions = []

    def add(self, outputs: dict, actions=None) -> None:
        self.steps.append({f: outputs[f].index_select(0, self.rows) for f in self.FIELDS})
        if actions is not None:
            self.actions.append(actions.index_select(0, self.rows))

    def stacked(self) -> dict:
        out = {f: torch.stack([s[f] for s in self.steps]) for f in self.FIELDS}
        out["action"] = torch.stack(self.actions)
        return out


class Clock:
    """Marks on the device's timeline (CUDA events) on a card, the host's
    clock elsewhere; ``ms(a, b)`` after a synchronisation."""

    def __init__(self, device):
        self.cuda = device.type == "cuda"

    def mark(self):
        if not self.cuda:
            return time.perf_counter()
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        return ev

    def ms(self, a, b) -> float:
        return a.elapsed_time(b) if self.cuda else (b - a) * 1e3


def sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def process_start() -> float:
    """The wall-clock time at which this process started (Linux), or now."""
    try:
        with open("/proc/self/stat") as f:
            ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return time.time() - uptime + ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError):
        return time.time()


def sample_rows(seed: int, batch: int, n: int) -> torch.Tensor:
    """``n`` boards of ``batch``, drawn from the seed, in order."""
    gen = torch.Generator()
    gen.manual_seed(seed & ((1 << 63) - 1))
    return torch.randperm(batch, generator=gen)[: min(n, batch)].sort().values


class Loop:
    """The closed loop over one program's boards."""

    def __init__(self, program, key, batch: int, rec: Recorder):
        self.program = program
        self.rec = rec
        self.key, k0 = program.split(key)
        self.states, self.ts = program.reset(k0, batch)
        rec.add(program.outputs(self.states, self.ts))
        self.trunc = None  # each board's truncated steps, when counting

    def draw(self):
        self.key, ka = self.program.split(self.key)
        return self.program.draw(ka, self.ts)

    def step(self, actions):
        self.states, self.ts = self.program.step(self.states, self.ts, actions)
        out = self.program.outputs(self.states, self.ts)
        self.rec.add(out, actions)
        if self.trunc is not None:
            self.trunc.add_(out["truncated"])
        return out

    def run(self, n: int) -> None:
        for _ in range(n):
            self.step(self.draw())


def window(loop: Loop, seconds: float, clock: Clock, spans: bool, max_steps=None) -> dict:
    """Steps until ``seconds`` have passed (or ``max_steps`` steps), ending
    in a synchronisation.  Returns the steps, the wall seconds, each
    step's ms and, with ``spans``, each draw's and each step's ms and
    whether episodes ended in the step."""
    device = loop.states.colour.device
    B = loop.states.colour.shape[0]
    loop.trunc = torch.zeros(B, dtype=torch.int32, device=device)
    marks, draws, dones = [], [], []
    n = 0
    t0 = time.perf_counter()
    marks.append(clock.mark())
    while True:
        actions = loop.draw()
        if spans:
            draws.append(clock.mark())
        out = loop.step(actions)
        marks.append(clock.mark())
        if spans:
            dones.append(out["done"].any())
        n += 1
        if (max_steps is not None and n >= max_steps) or (
                max_steps is None and time.perf_counter() - t0 >= seconds):
            break
    sync(device)
    wall = time.perf_counter() - t0
    res = {"steps": n, "wall_s": wall, "step_ms": [clock.ms(a, b) for a, b in zip(marks, marks[1:])],
           "truncated": int(loop.trunc.sum()), "batch": B}
    loop.trunc = None
    if spans:
        res["draw_ms"] = [clock.ms(a, d) for a, d in zip(marks, draws)]
        res["env_step_ms"] = [clock.ms(d, b) for d, b in zip(draws, marks[1:])]
        res["step_done"] = [bool(d) for d in dones]
    return res


def _kineto_events(prof):
    """(name, on the device, start us, end us) of every event a profile
    recorded."""
    from torch.autograd import DeviceType

    try:
        raw = prof.profiler.kineto_results.events()
        out = []
        for e in raw:
            start = e.start_ns() / 1e3 if hasattr(e, "start_ns") else e.start_us()
            dur = e.duration_ns() / 1e3 if hasattr(e, "duration_ns") else e.duration_us()
            out.append((e.name(), e.device_type() == DeviceType.CUDA, start, start + dur))
        return out
    except AttributeError:
        return [(e.name, e.device_type == DeviceType.CUDA, e.time_range.start, e.time_range.end)
                for e in prof.events()]


def profiled_episode(loop: Loop, steps: int) -> dict:
    """``steps`` steps under ``torch.profiler``, each draw and step in a
    span of the harness.  Returns the device's operations (name, start us,
    end us), the kernel launches, the harness's spans (label, step, start
    us, end us), the wall seconds and whether episodes ended in each
    step."""
    from torch.profiler import ProfilerActivity, profile, record_function

    device = loop.states.colour.device
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if device.type == "cuda" else [])
    dones = []
    sync(device)
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for t in range(steps):
            with record_function(f"{SPAN}draw.{t}"):
                actions = loop.draw()
            with record_function(f"{SPAN}step.{t}"):
                out = loop.step(actions)
            dones.append(out["done"].any())
        sync(device)
        wall = time.perf_counter() - t0
    events = _kineto_events(prof)
    ops = [(n, s, e) for n, dev, s, e in events if dev and not n.startswith(SPAN)]
    spans = []
    for n, dev, s, e in events:
        if not dev and n.startswith(SPAN):
            label, t = n[len(SPAN):].rsplit(".", 1)
            spans.append((label, int(t), s, e))
    launches = sum(1 for n, dev, _, _ in events if not dev and n in LAUNCH_CALLS)
    return {"steps": steps, "wall_s": wall, "ops": ops, "launches": launches, "spans": spans,
            "step_done": [bool(d) for d in dones]}


@contextlib.contextmanager
def _count_syncs():
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            yield caught
    finally:
        torch.cuda.set_sync_debug_mode("default")


def sync_episode(loop: Loop, steps: int):
    """The host synchronisations of ``steps`` steps, by torch's sync debug
    mode (it slows the steps, so nothing here is timed); None off a card."""
    if loop.states.colour.device.type != "cuda":
        loop.run(steps)
        return None
    with _count_syncs() as caught:
        loop.run(steps)
    return {"steps": steps, "syncs": sum("synchroniz" in str(w.message) for w in caught)}


def check_loop(traffic: dict) -> None:
    """Raise if the mix asks for a policy or a reset that this loop does not
    run, so that no mix runs other traffic than its file says."""
    for key, value in LOOP.items():
        if traffic.get(key) != value:
            raise ValueError(f"traffic {traffic.get('name')!r}: {key} is {traffic.get(key)!r}; "
                             f"the loop runs {key} {value!r} only")


def run_cell(cell: dict, seed: int, seconds: float, trace: bool, device, program_cls,
             t_start: float, max_steps=None, check_boards: int = check.BOARDS,
             check_chunk: int = check.CHUNK) -> dict:
    """One run of ``cell``; returns the result's parts for ``run.py``.
    ``check_boards`` and ``check_chunk`` are the check's sample and block
    size (smaller in the tests)."""
    config, traffic = cell["config"], cell["traffic"]
    check_loop(traffic)
    B = traffic["batch"]
    moves = config["num_moves"]
    program = program_cls(config, device, seed)
    program.build()
    rows = sample_rows(seed, B, check_boards).to(device)
    rec = Recorder(rows)
    loop = Loop(program, key_of_seed(seed, device), B, rec)
    loop.run(traffic["warmup_episodes"] * moves)
    sync(device)
    counters0 = program.counters()
    clock = Clock(device)
    setup_s = time.time() - t_start
    win = window(loop, seconds, clock, spans=trace, max_steps=max_steps)
    counters = {k: v - counters0[k] for k, v in program.counters().items()}
    prof = syncs = None
    t_trace = time.perf_counter()
    if trace:
        prof = profiled_episode(loop, moves)
        syncs = sync_episode(loop, moves)
    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    del loop
    if device.type == "cuda":
        torch.cuda.empty_cache()
    t_check = time.perf_counter()
    checks, checked = check.compare(config, seed, rec, device, check_chunk)
    checked["trace_s"] = t_check - t_trace
    checked["check_s"] = time.perf_counter() - t_check
    return {"setup_s": setup_s, "window": win, "counters": counters, "profile": prof,
            "syncs": syncs, "memory_peak_bytes": peak, "checks": checks, "checked": checked,
            "config": config, "traffic": traffic}
