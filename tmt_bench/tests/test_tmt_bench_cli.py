"""The command: without a card it exits non-zero and prints no result;
in a directory holding only the benchmark it does the same; on a card
(marked ``cuda``, skipped here) one short run is correct."""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys

import pytest

from tmt_bench import manifest

ROOT = manifest.ROOT


def run_cmd(cwd, *extra, timeout=600):
    cmd = [sys.executable, "tmt_bench/run.py", "--workload", "c1_rollout_b256", "--seed",
           str(2**31 + 3), "--seconds", "1", "--trace", "0", *extra]
    return subprocess.run(cmd, cwd=cwd, capture_output=True, text=True, timeout=timeout,
                          env=dict(os.environ, BENCH_RUN="1"))


def test_without_a_card_it_fails_and_prints_no_result():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present")
    out = run_cmd(ROOT)
    assert out.returncode != 0
    assert out.stdout.strip() == ""
    assert "CUDA card" in out.stderr


def test_the_benchmark_alone_fails_and_prints_no_result(tmp_path):
    shutil.copytree(os.path.join(ROOT, "tmt_bench"), tmp_path / "tmt_bench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path / "BENCHMARK.json")
    out = run_cmd(tmp_path)
    assert out.returncode != 0
    assert out.stdout.strip() == ""


@pytest.mark.cuda
def test_a_short_run_on_the_card_is_correct():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    out = run_cmd(ROOT, timeout=1200)
    assert out.returncode == 0, out.stderr[-3000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["correct"] and res["device"]["platform"] == "gpu"
    assert list(res)[-1] == "checks"
    assert set(res["metrics"]) == {"board_steps_per_s", "step_ms_p99", "setup_s"}
