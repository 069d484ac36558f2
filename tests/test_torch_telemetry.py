"""The port's program spans (``profiling.span``): nothing recorded and no
``record_function`` with the profiler off; under ``torch.profiler`` the
step's span tree with its counts, on the profiler's own clock; the Chrome
trace and ``span_table`` that carry them; and the benchmark's per-layer
readers of them over traced tiny runs.  All on the CPU."""

import glob
import json
import os
import subprocess
import sys

import pytest
import torch
from torch.profiler import ProfilerActivity, profile, record_function

from tile_match_tpu_torch import engine, profiling
from tile_match_tpu_torch import random as trandom
from tile_match_tpu_torch.config import EnvConfig
from tile_match_tpu_torch.envs.batched import batched_reset, batched_step, random_effective
from tmt_bench import manifest
from tmt_bench.program import PortProgram
from tmt_bench.tests.helpers import tiny_run

torch.set_num_threads(1)

ROOT = manifest.ROOT
CFG3 = EnvConfig.create(10, 10, 4, 30)
KERNEL_SPANS = {"fused_cascade", "cascade_sp_chunk", "settled_mask_sp", "specials_trip",
                "combination_trip"}
NEW_METRICS = ("cascade_ms", "cascade_idle_ms", "cascade_kernels", "regen_ms", "regen_idle_ms",
               "regen_kernels", "regen_loops", "regen_useful_share")
# readers of the cascade's spans and of K2's device time, held on their own
# in test_torch_bench_c4.py: they read nothing with the spans off
ROUND_METRICS = ("cascade_rounds_max", "cascade_tail_share", "k4_boards_per_step", "k2_roofline")


def _cpu_profile():
    return profile(activities=[ProfilerActivity.CPU])


def _one_step(cfg, states, ts, key):
    key, ka = trandom.split(key)
    actions = random_effective(ka, ts)
    states, ts = batched_step(cfg, states, actions, eff_mask=ts.info.effective_actions)
    return states, ts, key


@pytest.fixture
def fresh_log():
    profiling.clear_spans()
    yield profiling.spans()
    profiling.clear_spans()


def test_untraced_step_records_nothing_and_opens_no_record_function(fresh_log, monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("record_function called in the program")

    monkeypatch.setattr(torch.autograd.profiler.record_function, "__init__", refuse)
    states, ts = batched_reset(CFG3, trandom.PRNGKey(3, "cpu"), 8)
    states, ts, _ = _one_step(CFG3, states, ts, trandom.PRNGKey(4, "cpu"))
    assert fresh_log == []
    assert profiling.span("cascade", rounds=1) is profiling.span("draw")  # the shared no-op


def test_traced_step_gives_the_span_tree(fresh_log, monkeypatch):
    taken = []  # the boards each K2 launch took, as the cascade's rounds hand them
    chunk = engine.cascade_sp_chunk

    def counting(cfg, colour, *args, **kwargs):
        taken.append(colour.shape[0])
        return chunk(cfg, colour, *args, **kwargs)

    monkeypatch.setattr(engine, "cascade_sp_chunk", counting)
    states, ts = batched_reset(CFG3, trandom.PRNGKey(5, "cpu"), 8)
    with _cpu_profile() as prof:
        states, ts, _ = _one_step(CFG3, states, ts, trandom.PRNGKey(6, "cpu"))
    log = list(fresh_log)
    names = [s.name for s in log]
    assert names[:2] == ["draw", "batched_step"]
    step = 1
    assert all(s.step == step for s in log)
    assert all(s.end_ns is not None and s.start_ns <= s.end_ns for s in log)
    assert log[0].parent == -1 and log[1].parent == -1
    assert log[1].attrs == {"boards": 8, "regenerated": 0}
    parent = {i: log[s.parent].name for i, s in enumerate(log) if s.parent >= 0}
    for i, s in enumerate(log[2:], 2):
        if s.name in ("cascade_sp_chunk", "specials_trip"):
            want = {"cascade_round"}
        elif s.name == "cascade_round":
            want = {"cascade"}
        elif s.name == "settled_mask_sp":  # after the cascade, or after a shuffle
            want = {"batched_step", "playable"}
        else:
            want = {"batched_step"}
        assert parent[i] in want, (s.name, parent[i])
        if s.name in KERNEL_SPANS:
            assert log[s.parent].start_ns <= s.start_ns and s.end_ns <= log[s.parent].end_ns
    (cascade,) = [s for s in log if s.name == "cascade"]
    assert cascade.attrs["rounds"] == engine.last_cascade["rounds"] == len(taken) >= 1
    assert [s.attrs["boards"] for s in log if s.name == "cascade_sp_chunk"] == taken
    assert taken[0] <= 8
    for name in ("combination_trip", "playable"):
        assert [s.attrs["boards"] for s in log if s.name == name] == [8]
    assert {s.attrs["boards"] for s in log if s.name == "settled_mask_sp"} == {8}
    # spans are not profiler events: nothing of them on the profile's timeline
    assert not {e.name for e in prof.events()} & set(names)


def test_auto_reset_step_counts_the_playability_loop(fresh_log, monkeypatch):
    calls = []
    split_where = engine._split_where

    def counting(go, key):
        calls.append(int(go.sum()))
        return split_where(go, key)

    monkeypatch.setattr(engine, "_split_where", counting)
    cfg = EnvConfig.create(6, 6, 4, 1)  # every step ends every episode
    states, ts = batched_reset(cfg, trandom.PRNGKey(7, "cpu"), 16)
    calls.clear()
    with _cpu_profile():
        states, ts, _ = _one_step(cfg, states, ts, trandom.PRNGKey(8, "cpu"))
    log = list(fresh_log)
    (step,) = [s for s in log if s.name == "batched_step"]
    assert step.attrs == {"boards": 16, "regenerated": 16}
    (regen,) = [i for i, s in enumerate(log) if s.name == "regenerate"]
    assert log[regen].attrs == {"boards": 16}
    inner = [s for s in log if s.name == "playable" and s.parent == regen]
    assert len(inner) == 1 and inner[0].attrs["boards"] == 16
    playable = [s for s in log if s.name == "playable"]
    assert sum(s.attrs["loops"] for s in playable) == len(calls)
    assert sum(s.attrs["live"] for s in playable) == sum(calls)
    for s in playable:
        assert s.attrs["loops"] <= s.attrs["live"] <= s.attrs["loops"] * s.attrs["boards"]
    assert inner[0].attrs["loops"] >= 1


def test_spans_share_the_profilers_clock(fresh_log):
    with _cpu_profile() as prof:
        for _ in range(5):
            with profiling.span("outer") as sp:
                with record_function("inner"):
                    torch.ones(64).cumsum(0)
    inner = [e for e in prof.profiler.kineto_results.events() if e.name() == "inner"]
    outer = [s for s in fresh_log if s.name == "outer"]
    assert len(inner) == len(outer) == 5
    for e, s in zip(inner, outer):
        assert s.start_ns - 100_000 <= e.start_ns()
        assert e.start_ns() + e.duration_ns() <= s.end_ns + 100_000
    assert sp.end_ns is not None


def test_trace_writes_the_spans_into_the_chrome_trace(tmp_path):
    """The CLI's ``--trace DIR``, run as ``python -m`` (a second copy of the
    module), writes the spans the program recorded."""
    logdir = str(tmp_path / "trace")
    out = subprocess.run(
        [sys.executable, "-m", "tile_match_tpu_torch.profiling", "--rows", "10", "--cols", "10",
         "--colours", "4", "--batch", "4", "--steps", "1", "--reps", "1", "--device", "cpu",
         "--trace", logdir],
        cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    (path,) = glob.glob(os.path.join(logdir, "*.pt.trace.json"))
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    ops = [e for e in events if e.get("ph") == "X" and e.get("cat") != "program_span"]
    spans = [e for e in events if e.get("cat") == "program_span"]
    cascade = [e for e in spans if e["name"] == "cascade"]
    assert cascade and "rounds" in cascade[0]["args"]
    # on the trace's own time base: every span lies within the trace's events
    lo = min(e["ts"] for e in ops) - 1e4
    hi = max(e["ts"] + e["dur"] for e in ops) + 1e4
    assert all(lo <= e["ts"] and e["ts"] + e["dur"] <= hi for e in spans)


def test_span_table_cuts_device_time_by_span():
    S = profiling.Span
    records = [S("batched_step", 0, -1, 0, {}), S("cascade", 100, 0, 0, {}),
               S("cascade", 600, 0, 0, {})]
    for r, end in zip(records, (1000, 400, 800)):
        r.end_ns = end
    ops = [("k1", 150, 250), ("Memcpy HtoD", 300, 350), ("k2", 700, 900), ("k3", 950, 990)]
    table = profiling.span_table(records, ops, [120, 650, 900], steps=2)
    assert table["cascade"] == {"ms": 500 / 1e6 / 2, "idle_ms": (500 - 150 - 100) / 1e6 / 2,
                                "kernels": 2 / 2, "launches": 2 / 2, "calls": 1.0}
    assert table["batched_step"]["idle_ms"] == (1000 - 100 - 50 - 200 - 40) / 1e6 / 2
    assert table["batched_step"]["kernels"] == 3 / 2


@pytest.mark.parametrize("workload", ["c3_rollout_b256", "c1_rollout_b256"])
def test_new_metrics_read_in_traced_tiny_runs(workload, fresh_log, monkeypatch):
    cell = manifest.cell(manifest.load(), workload)
    mine = [m for m in cell["per_layer"] if m["name"] in NEW_METRICS]
    old = [m for m in cell["per_layer"] if m["name"] not in NEW_METRICS + ROUND_METRICS]
    assert {m["name"] for m in mine} == (set(NEW_METRICS) if workload.startswith("c3")
                                         else {n for n in NEW_METRICS if n.startswith("regen")})
    res = tiny_run(workload, PortProgram, trace=True, warmup_episodes=0)
    assert res["correct"]
    run = dict(res, device_kind="cpu")
    got = {k: v["value"] for k, v in manifest.read_metrics(mine, run).items()}
    assert set(got) == {m["name"] for m in mine}
    for part in ("cascade", "regen"):
        if f"{part}_ms" in got:
            assert 0 < got[f"{part}_idle_ms"] <= got[f"{part}_ms"]
            assert got[f"{part}_kernels"] == 0  # no device here
    assert 0 < got["regen_useful_share"] <= 100 and got["regen_loops"] >= 1
    with_spans = manifest.read_metrics(old, run)

    profiling.clear_spans()
    monkeypatch.setattr(profiling, "_profiler_enabled", lambda: False)
    res = tiny_run(workload, PortProgram, trace=True, warmup_episodes=0)
    assert profiling.spans() == []
    without = manifest.read_metrics(old, dict(res, device_kind="cpu"))
    assert set(with_spans) == set(without)
    for m in old:  # the counters and device readings repeat exactly; times only exist
        if m["name"] in with_spans and m["source"] != "program_span":
            assert with_spans[m["name"]] == without[m["name"]], m["name"]
