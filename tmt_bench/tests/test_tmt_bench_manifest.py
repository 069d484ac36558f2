"""BENCHMARK.json against the benchmark's contract, and the by-name
discovery of configurations, traffic mixes and metrics."""

from __future__ import annotations

import json
import os
import re
import shutil

import pytest

import torch

from tmt_bench import harness, manifest
from tmt_bench.program import PortProgram

ROOT = manifest.ROOT
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
BENCH = manifest.load()
BENCH_TRAFFIC = [manifest.cell(BENCH, w["name"])["traffic"] for w in BENCH["workloads"]]


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["tmt_bench"]
    assert 1 <= BENCH["run_seconds"] <= 51 and isinstance(BENCH["run_seconds"], int)
    assert len(BENCH["command"]) <= 32
    assert os.path.isfile(os.path.join(ROOT, BENCH["command"][1]))
    assert os.path.getsize(os.path.join(ROOT, "BENCHMARK.json")) <= 64 * 1024


def test_names_units_and_lines():
    names = [x["name"] for k in ("configs", "workloads", "end_to_end", "per_layer") for x in BENCH[k]]
    assert len(names) == len(set(names))
    for n in names:
        assert NAME.match(n), n
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]), m
        assert m["better"] in ("lower", "higher")
    for text in ([w["why"] for w in BENCH["workloads"]] + [c["why"] for c in BENCH["configs"]]
                 + [m["layer"] for m in BENCH["per_layer"]] + [c["source"] for c in BENCH["configs"]]):
        assert 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_end_to_end_bounds():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert {"board_steps_per_s", "step_ms_p99", "setup_s"} <= set(e2e)
    for m in e2e.values():
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")


def test_per_layer_metrics_move_a_reported_metric():
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    cells = {w["name"] for w in BENCH["workloads"]}
    for m in BENCH["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert m["moves"] in e2e and m["moves"] != "setup_s"
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        assert set(m.get("workloads", cells)) <= cells


def test_every_piece_is_found_by_name():
    for w in BENCH["workloads"]:
        cell = manifest.cell(BENCH, w["name"])
        assert w["chips"] == 1
        assert cell["config"]["name"] == w["config"]
        assert cell["traffic"]["name"] == w["traffic"]
        assert cell["per_layer"] and len(cell["end_to_end"]) >= 2
        for m in cell["end_to_end"] + cell["per_layer"]:
            assert callable(manifest.reader(m["name"]))
    for c in BENCH["configs"]:
        assert c["file"].startswith("tmt_bench/")
        with open(os.path.join(ROOT, c["file"])) as f:
            assert json.load(f)["source"] == c["source"]
        assert c["reduced"] == []


def test_a_config_a_mix_and_a_metric_added_as_files_only(tmp_path):
    """A later change adds a configuration, a mix and a metric as new files
    and new entries; the harness finds them and no file changes."""
    shutil.copytree(os.path.join(ROOT, "tmt_bench"), tmp_path / "tmt_bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    before = {p: p.read_bytes() for p in (tmp_path / "tmt_bench").rglob("*") if p.is_file()}
    bench = json.loads(json.dumps(BENCH))
    cfg = json.loads((tmp_path / "tmt_bench/configs/c3_10x10x4_all_specials.json").read_text())
    cfg.update(name="c4_20x20x6_all_specials", num_rows=20, num_cols=20, num_colours=6, num_moves=100)
    (tmp_path / "tmt_bench/configs/c4_20x20x6_all_specials.json").write_text(json.dumps(cfg))
    mix = {"name": "rollout_b8192", "batch": 8192, "policy": "random_effective", "auto_reset": True,
           "warmup_episodes": 1}
    (tmp_path / "tmt_bench/traffic/rollout_b8192.json").write_text(json.dumps(mix))
    (tmp_path / "tmt_bench/metrics/steps_in_window.py").write_text(
        "def read(run):\n    return run['window']['steps']\n")
    bench["configs"].append({"name": cfg["name"], "source": cfg["source"], "reduced": [],
                             "file": "tmt_bench/configs/c4_20x20x6_all_specials.json", "why": "deep"})
    bench["workloads"].append({"name": "c4_rollout_b8192", "config": cfg["name"],
                               "traffic": "rollout_b8192", "chips": 1, "why": "deep cascades"})
    bench["per_layer"].append({"name": "steps_in_window", "unit": "steps", "better": "higher",
                               "source": "host_clock", "layer": "batched env",
                               "moves": "board_steps_per_s", "workloads": ["c4_rollout_b8192"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    root = str(tmp_path)
    cell = manifest.cell(manifest.load(root), "c4_rollout_b8192", root)
    assert cell["config"]["num_rows"] == 20 and cell["traffic"]["batch"] == 8192
    assert [m["name"] for m in cell["per_layer"]][-1] == "steps_in_window"
    run = {"window": {"steps": 12, "batch": 8192, "wall_s": 2.0}}
    got = manifest.read_metrics([m for m in cell["per_layer"] if m["name"] == "steps_in_window"]
                                + [m for m in cell["end_to_end"] if m["name"] == "board_steps_per_s"],
                                run, root)
    assert got == {"steps_in_window": {"value": 12, "unit": "steps"},
                   "board_steps_per_s": {"value": 8192 * 12 / 2.0, "unit": "board-steps/s"}}
    # the existing cells are as they were, and so is every file that was there
    assert manifest.cell(manifest.load(root), "c3_rollout_b16384", root)["traffic"]["batch"] == 16384
    assert all(p.read_bytes() == b for p, b in before.items())


def test_a_metric_that_finds_nothing_is_left_out():
    cell = manifest.cell(BENCH, "c1_rollout_b256")
    run = {"window": {"steps": 3, "batch": 256, "wall_s": 1.0}, "profile": None, "syncs": None,
           "counters": {}, "device_kind": "cpu", "config": cell["config"],
           "traffic": cell["traffic"]}
    assert manifest.read_metrics(cell["per_layer"], run) == {}


@pytest.mark.parametrize("field,value", [("policy", "one_launch"), ("auto_reset", False),
                                         ("policy", None)])
def test_a_mix_the_loop_does_not_run_is_refused(field, value):
    """A mix's policy and auto-reset mean what they say: the harness runs
    the port's draw with auto-reset on, and refuses any other before a step."""
    cell = manifest.cell(BENCH, "c1_rollout_b256")
    for t in BENCH_TRAFFIC:
        harness.check_loop(t)
    traffic = dict(cell["traffic"], **{field: value})
    if value is None:
        del traffic[field]
    with pytest.raises(ValueError, match=field):
        harness.run_cell(dict(cell, traffic=traffic), 1, 0, False, torch.device("cpu"),
                         PortProgram, 0.0, max_steps=1)


@pytest.mark.parametrize("workload", [w["name"] for w in BENCH["workloads"]])
def test_cells_are_unique_pairs(workload):
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(pairs) == len(set(pairs))
    assert workload in {w["name"] for w in BENCH["workloads"]}
