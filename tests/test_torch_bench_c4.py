"""Config 4 in the benchmark (``c4_rollout_b8192``: 20x20 boards, 6 colours,
every special) and what its traced runs read, all on the CPU: a tiny run
of the cell held to the plain reference, and read not correct with a
board altered; the specials cascade's ``cascade_round`` spans against its
``cascade`` span; the per-layer readers of those spans and of K2's device
time on hand-made runs, and K2's byte count against its wrapper's
tensors."""

import time

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from tile_match_tpu_torch import engine, profiling
from tile_match_tpu_torch import random as trandom
from tile_match_tpu_torch.config import EnvConfig
from tile_match_tpu_torch.envs.batched import batched_reset, batched_step, random_effective
from tmt_bench import check, harness, manifest
from tmt_bench.metrics.k2_roofline import k2_bytes
from tmt_bench.program import PortProgram
from tmt_bench.tests.helpers import BOARDS, CHUNK, CPU, tiny_cell
from tmt_bench.tests.test_tmt_bench_faults import Altered

torch.set_num_threads(1)

CELL = "c4_rollout_b8192"
CFG4 = EnvConfig.create(20, 20, 6, 100)
H100 = "NVIDIA H100 80GB HBM3"
ROUND_METRICS = ("cascade_rounds_max", "cascade_tail_share", "k4_boards_per_step", "k2_roofline")


@pytest.fixture
def fresh_log():
    profiling.clear_spans()
    yield profiling.spans()
    profiling.clear_spans()


def test_cell_is_config_4_at_8192_boards():
    cell = manifest.cell(manifest.load(), CELL)
    cfg, traffic = cell["config"], cell["traffic"]
    assert (cfg["num_rows"], cfg["num_cols"], cfg["num_colours"], cfg["num_moves"]) == (20, 20, 6, 100)
    assert cfg["colourless_specials"] == ["cookie"]
    assert cfg["colour_specials"] == ["vertical_laser", "horizontal_laser", "bomb"]
    c3 = manifest.cell(manifest.load(), "c3_rollout_b16384")["config"]
    assert cfg["guarantees"] == c3["guarantees"] and cfg["reference"] == "reference"
    assert traffic["batch"] == 8192 and traffic["warmup_episodes"] == 1
    assert [m["name"] for m in cell["per_layer"]] == list(ROUND_METRICS)
    assert {m["name"] for m in cell["end_to_end"]} == {"board_steps_per_s", "step_ms_p99", "setup_s"}


@pytest.mark.parametrize("program_cls,correct", [(PortProgram, True), (Altered, False)])
def test_tiny_run_of_the_cell_against_the_reference(program_cls, correct):
    """Batch 8 and 3-move episodes, so that auto-resets fall in a window of
    7 steps; the altered run changes one cell of every board once."""
    cell = tiny_cell(CELL)
    cell["config"] = dict(cell["config"], num_moves=3)
    res = harness.run_cell(cell, 2**31 + 29, 0, False, CPU, program_cls, time.time(), max_steps=7,
                           check_boards=BOARDS, check_chunk=CHUNK)
    checks = {c["name"]: c["value"] for c in res["checks"]}
    assert check.passed(res["checks"]) is correct
    assert checks["autoreset_steps_checked"] >= 1
    assert (checks["mismatches"] == 0) is correct


def _steps(n: int, seed: int = 5):
    """``n`` seeded steps of 8 boards at 20x20x6 with every special (seed 5
    runs a cascade of two rounds with a board frozen in its third step)."""
    states, ts = batched_reset(CFG4, trandom.PRNGKey(seed, "cpu"), 8)
    key = trandom.PRNGKey(100 + seed, "cpu")
    for _ in range(n):
        key, ka = trandom.split(key)
        actions = random_effective(ka, ts)
        states, ts = batched_step(CFG4, states, actions, eff_mask=ts.info.effective_actions)


def test_cascade_round_spans(fresh_log):
    _steps(3)
    assert fresh_log == []  # the profiler off: nothing recorded
    with profile(activities=[ProfilerActivity.CPU]):
        _steps(3)
    log = list(fresh_log)
    cascades = [i for i, s in enumerate(log) if s.name == "cascade"]
    rounds = [s for s in log if s.name == "cascade_round"]
    assert len(rounds) == sum(log[i].attrs["rounds"] for i in cascades)
    assert max(log[i].attrs["rounds"] for i in cascades) >= 2
    assert any(s.attrs["frozen"] for s in rounds)
    for i in cascades:
        mine = [s for s in log if s.name == "cascade_round" and s.parent == i]
        assert len(mine) == log[i].attrs["rounds"]
        boards = [s.attrs["boards"] for s in mine]
        assert boards == sorted(boards, reverse=True) and boards[-1] >= 1
        for s in mine:
            assert s.attrs["frozen"] <= s.attrs["boards"]
            assert log[i].start_ns <= s.start_ns <= s.end_ns <= log[i].end_ns
            # K2 takes the round's boards, K4 its frozen ones
            kids = {t.name: t.attrs["boards"] for t in log if t.parent >= 0 and log[t.parent] is s}
            assert kids["cascade_sp_chunk"] == s.attrs["boards"]
            assert kids.get("specials_trip", 0) == s.attrs["frozen"]


def _span(name, start, end, parent, step, **attrs):
    s = profiling.Span(name, start, parent, step, attrs)
    s.end_ns = end
    return s


def _hand_made_log(rounds: bool):
    """Two steps: a cascade of three rounds (1,000, 100 and 3 boards; 10 and
    5 frozen) and one of one round (200 boards).  Without ``rounds``, an
    older program's log: no ``cascade_round`` span, the kernel spans under
    ``cascade``."""
    rows = [  # name, start ns, end ns, parent, attrs
        ("batched_step", 0, 10_000, -1, {}),
        ("cascade", 1_000, 9_000, 0, {"rounds": 3}),
        ("cascade_round", 1_000, 5_000, 1, {"boards": 1000, "frozen": 10}),
        ("cascade_sp_chunk", 1_100, 2_000, 2, {"boards": 1000}),
        ("specials_trip", 3_000, 4_000, 2, {"boards": 10}),
        ("cascade_round", 5_000, 7_000, 1, {"boards": 100, "frozen": 5}),
        ("cascade_sp_chunk", 5_100, 5_500, 5, {"boards": 100}),
        ("specials_trip", 5_600, 6_000, 5, {"boards": 5}),
        ("cascade_round", 7_000, 8_000, 1, {"boards": 3, "frozen": 0}),
        ("cascade_sp_chunk", 7_100, 7_500, 8, {"boards": 3}),
        ("batched_step", 20_000, 30_000, -1, {}),
        ("cascade", 21_000, 23_000, 10, {"rounds": 1}),
        ("cascade_round", 21_000, 23_000, 11, {"boards": 200, "frozen": 0}),
        ("cascade_sp_chunk", 21_100, 22_000, 12, {"boards": 200}),
    ]
    if not rounds:
        keep = [i for i, r in enumerate(rows) if r[0] != "cascade_round"]
        up = {i: rows[i][3] for i, r in enumerate(rows) if r[0] == "cascade_round"}
        rows = [(n, a, b, keep.index(up.get(p, p)) if p >= 0 else -1, at)
                for n, a, b, p, at in (rows[i] for i in keep)]
    steps = [i for i, r in enumerate(rows) if r[0] == "batched_step"]
    return [_span(n, a, b, p, max(t for t in steps if t <= i), **at)
            for i, (n, a, b, p, at) in enumerate(rows)]


def _hand_made_run(monkeypatch, log, profiled=True):
    monkeypatch.setattr(profiling, "spans", lambda: log)
    ops = [("void cascade_sp_kernel<tmt::Lines<20, 20> >(int const*)", 1.0, 3.0),
           ("void cascade_sp_kernel<tmt::Lines<20, 20> >(int const*)", 5.0, 6.0),
           ("void cascade_sp_kernel<tmt::Lines<20, 20> >(int const*)", 7.0, 7.5),
           ("void cascade_sp_kernel<tmt::Lines<20, 20> >(int const*)", 21.0, 22.5),
           ("specials_trip_kernel", 3.0, 4.0), ("cascade_kernel", 8.0, 9.0),
           ("Memcpy DtoD", 9.0, 9.5)]
    prof = {"steps": 2, "wall_s": 3e-5, "ops": ops, "launches": 7, "spans": [],
            "step_done": [False, False]} if profiled else None
    cell = manifest.cell(manifest.load(), CELL)
    return {"profile": prof, "device_kind": H100, "config": cell["config"],
            "traffic": cell["traffic"], "counters": {}, "window": {"steps": 5}}


K2_S = (2.0 + 1.0 + 0.5 + 1.5) / 1e6  # the four K2 launches' device seconds
HAND_MADE = {
    "cascade_rounds_max": 3,
    "cascade_tail_share": 100.0 * (2_000 + 1_000) / (8_000 + 2_000),  # the rounds under 128 boards
    "k4_boards_per_step": (10 + 5) / 2,
    "k2_roofline": 100.0 * sum(k2_bytes(b, 20, 20) for b in (1000, 100, 3, 200)) / 3.35e12 / K2_S,
}


@pytest.mark.parametrize("name", ROUND_METRICS)
def test_readers_on_a_hand_made_run(name, monkeypatch):
    read = manifest.reader(name)
    assert read(_hand_made_run(monkeypatch, _hand_made_log(True))) == pytest.approx(
        HAND_MADE[name], rel=1e-12)
    assert read(_hand_made_run(monkeypatch, _hand_made_log(True), profiled=False)) is None
    assert read(_hand_made_run(monkeypatch, [])) is None  # a profile with no span recorded
    older = read(_hand_made_run(monkeypatch, _hand_made_log(False)))  # no cascade_round span
    if name == "cascade_tail_share":
        assert older is None
    else:
        assert older == pytest.approx(HAND_MADE[name], rel=1e-12)
    if name == "k2_roofline":
        run = _hand_made_run(monkeypatch, _hand_made_log(True))
        assert read(dict(run, device_kind="a card with no published peak")) is None


@pytest.mark.parametrize("shape", [(10, 10), (20, 20)])
def test_k2_bytes_count_the_wrappers_tensors(shape):
    """Every input and output of one ``cascade_sp_chunk`` call, each byte
    once."""
    R, C = shape
    B = 3
    cfg = EnvConfig.create(R, C, 6, 100)
    gen = torch.Generator().manual_seed(7)
    colour = torch.randint(1, 7, (B, R, C), generator=gen, dtype=torch.int32)
    kind = torch.ones(B, R, C, dtype=torch.int32)
    keys = trandom.split(trandom.PRNGKey(3, "cpu"), B)
    zero = torch.zeros(B, dtype=torch.int32)
    inputs = (colour, kind, keys, zero, zero.clone(), zero.clone())
    outputs = engine.cascade_sp_chunk(cfg, *inputs, limit=cfg.max_cascades)
    assert len(outputs) == 9
    hand = sum(t.numel() * t.element_size() for t in inputs + tuple(outputs))
    assert k2_bytes(B, R, C) == hand
