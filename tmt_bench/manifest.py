"""``BENCHMARK.json`` and the files it names, found by name.

A cell (an entry of ``workloads``) names a configuration and a traffic
mix; the configuration's file is the one ``configs`` gives, the mix's is
``traffic/<name>.json``, and each metric, end to end or per layer, is the
reader ``metrics/<name>.py``.  A later cell, mix or metric is new files and
new entries: nothing here changes.
"""

from __future__ import annotations

import importlib.util
import json
import os

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def load(root: str = ROOT) -> dict:
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        return json.load(f)


def cell(bench: dict, workload: str, root: str = ROOT) -> dict:
    """The cell ``workload`` with its configuration, traffic mix and the
    metrics it reports: ``{"workload", "config", "traffic", "end_to_end",
    "per_layer"}``, each metric its entry of ``BENCHMARK.json``."""
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json: {sorted(cells)}")
    w = cells[workload]
    config = next(c for c in bench["configs"] if c["name"] == w["config"])
    with open(os.path.join(root, config["file"])) as f:
        cfg = json.load(f)
    with open(os.path.join(root, "tmt_bench", "traffic", f"{w['traffic']}.json")) as f:
        traffic = json.load(f)

    def mine(metric):
        return workload in metric.get("workloads", [workload])

    return {
        "workload": w,
        "config": cfg,
        "traffic": traffic,
        "end_to_end": [m for m in bench["end_to_end"] if mine(m)],
        "per_layer": [m for m in bench["per_layer"] if mine(m)],
    }


def reader(name: str, root: str = ROOT):
    """The ``read(run)`` function of ``metrics/<name>.py``."""
    path = os.path.join(root, "tmt_bench", "metrics", f"{name}.py")
    spec = importlib.util.spec_from_file_location(f"tmt_bench.metrics.{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def read_metrics(metrics, run, root: str = ROOT) -> dict:
    """``{name: {"value", "unit"}}`` of every metric whose reader finds
    something to read in ``run``; a reader that finds nothing returns
    None, and its metric is left out."""
    out = {}
    for m in metrics:
        value = reader(m["name"], root)(run)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out
