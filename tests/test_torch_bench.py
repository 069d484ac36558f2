"""The port's bench (``tile_match_tpu_torch.bench``) against the JAX
package's ``bench.py``: the same config table, batches, metric names and
error messages; its timed loop equal to ``bench.run_chunk``'s scan from
the same keys; its gate's recorded rollouts replayed; a corrupted
recording stops it before any number; it needs a card unless told
``--device cpu``; and it writes neither of ``bench.py``'s record files."""

import importlib.util
import json
import os
import shutil
import sys

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from tile_match_tpu.config import EnvConfig as JaxConfig
from tile_match_tpu.envs.batched import batched_reset as jax_reset
from tile_match_tpu.envs.batched import batched_step as jax_step
from tile_match_tpu_torch import bench, cuda_build, profiling
from tile_match_tpu_torch.tools import parity_check

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BENCH_PY = os.path.join(ROOT, "bench.py")


def _load_bench_py(argv):
    """Import ``bench.py`` afresh as ``bench.py <argv>`` (it reads its
    config from ``sys.argv`` when imported)."""
    spec = importlib.util.spec_from_file_location("jax_bench_under_test", BENCH_PY)
    module = importlib.util.module_from_spec(spec)
    saved = sys.argv
    sys.argv = ["bench.py", *argv]
    try:
        spec.loader.exec_module(module)
    finally:
        sys.argv = saved
    return module


@pytest.mark.parametrize("idx", range(5))
def test_tables_and_metric_equal_bench_py(idx, monkeypatch):
    for name in ("TMT_BENCH_BATCH", "TMT_BENCH_CONFIG"):
        monkeypatch.delenv(name, raising=False)
    ref = _load_bench_py(["--config", str(idx)])
    assert bench.CONFIGS == ref.CONFIGS
    assert bench.CONFIG_BATCH == ref.CONFIG_BATCH
    assert bench.config_index(["--config", str(idx)]) == ref.CFG_IDX == idx
    # bench.py's name: env_steps_per_sec_{R}x{C}x{K}_{_SPEC_LABEL}_{label}, label b{batch}
    want = f"env_steps_per_sec_{ref.R}x{ref.C}x{ref.K}_{ref._SPEC_LABEL}_b{ref.BATCH}"
    assert bench.metric_name(idx, bench.CONFIG_BATCH[idx]) == want


@pytest.mark.parametrize("argv", [["--config"], ["--config", "x"], ["--config", "9"]])
def test_config_errors_are_bench_pys(argv):
    with pytest.raises(SystemExit) as ref:
        _load_bench_py(argv)
    with pytest.raises(SystemExit) as got:
        bench.config_index(argv)
    assert got.value.code == ref.value.code


def _jax_loop(idx, batch, chunk, chunks):
    """``bench.py``'s ``measure_ours`` loop on the CPU: ``run_chunk``'s scan
    body, a warm chunk, then ``chunks`` chunks.  Returns the final state and
    mask, and each timed chunk's reward sum."""
    R, C, K, moves, colourless, colour = bench.CONFIGS[idx]
    cfg = JaxConfig.create(R, C, K, moves, colourless_specials=colourless,
                           colour_specials=colour)

    @jax.jit
    def run_chunk(states, mask, key):
        def body(carry, _):
            states, mask, key = carry
            key, ka = jax.random.split(key)
            logits = jnp.where(mask, 0.0, -jnp.inf)
            acts = jnp.where(
                mask.any(-1), jax.random.categorical(ka, logits, axis=-1), 0
            ).astype(jnp.int32)
            states, ts = jax_step(cfg, states, acts, eff_mask=mask)
            return (states, ts.info.effective_actions, key), ts.reward.sum()

        (states, mask, key), rs = jax.lax.scan(body, (states, mask, key), None, length=chunk)
        return states, mask, rs.sum(), key

    states, ts = jax.jit(lambda k: jax_reset(cfg, k, batch))(jax.random.PRNGKey(0))
    mask, key = ts.info.effective_actions, jax.random.PRNGKey(1)
    states, mask, _, key = run_chunk(states, mask, key)
    sums = []
    for _ in range(chunks):
        states, mask, r, key = run_chunk(states, mask, key)
        sums.append(float(r))
    return states, mask, sums


@pytest.mark.parametrize("idx", [1, 3])
def test_bench_loop_equals_run_chunk(idx):
    """B=130 (no whole tile of boards), chunk 4, two windows of one chunk."""
    batch, chunk, reps = 130, 4, 2
    run = profiling.timed_windows(bench.make_config(idx), batch, chunk, reps, seed=0,
                                  device="cpu", warmup=chunk)
    states, mask, sums = _jax_loop(idx, batch, chunk, reps)
    for name in ("colour", "kind", "timer"):
        assert np.array_equal(getattr(run["states"], name).numpy(),
                              np.asarray(getattr(states, name))), name
    assert np.array_equal(run["states"].key.numpy().astype(np.uint32), np.asarray(states.key))
    assert np.array_equal(run["ts"].info.effective_actions.numpy(), np.asarray(mask))
    rewards = np.asarray(run["rewards"]).reshape(reps, chunk).sum(1)
    assert rewards.tolist() == sums
    assert len(run["step_ms"]) == reps and all(len(w) == chunk for w in run["step_ms"])
    assert run["dones"] == [0, 0] and list(run["launches"]) == list(cuda_build.KERNELS)


def _small_run(monkeypatch):
    for name, value in (("TMT_BENCH_BATCH", "130"), ("TMT_BENCH_CHUNK", "2"),
                        ("TMT_BENCH_STEPS", "1"), ("TMT_BENCH_REPS", "2")):
        monkeypatch.setenv(name, value)
    monkeypatch.delenv("TMT_BENCH_CONFIG", raising=False)


def test_main_prints_the_gate_then_bench_pys_line(monkeypatch, capsys):
    _small_run(monkeypatch)
    assert bench.main(["--config", "1", "--device", "cpu"]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    gate = [i for i, line in enumerate(lines) if line.startswith("gate: config 1:")]
    windows = [i for i, line in enumerate(lines) if line.startswith("bench: window")]
    assert len(gate) == 3 and len(windows) == 2 and max(gate) < min(windows)
    assert "replayed 40 steps of torch_port_fixture_cfg1.npz" in lines[gate[0]]
    # K1 at the bench's own batch: the variant of the kernel that is timed
    assert "cascade parity OK: 10x10x4 B=130" in lines[gate[2]]
    assert any(line.startswith("bench: median step") for line in lines)
    last = json.loads(lines[-1])
    assert list(last) == ["metric", "value", "unit", "vs_baseline"]
    assert last["metric"] == "env_steps_per_sec_10x10x4_no_specials_b130"
    assert last["unit"] == "steps/s" and last["value"] > 0
    with open(os.path.join(ROOT, "bench_baseline.json")) as f:
        base = json.load(f)["1"]["baseline_steps_per_s"]
    assert abs(last["vs_baseline"] - last["value"] / base) < 0.006


def test_bench_writes_no_record(monkeypatch, capsys):
    """``bench_baseline.json`` and ``PARITY_SPOT.json`` are read at most,
    byte for byte the same after a run."""
    paths = [os.path.join(ROOT, n) for n in ("bench_baseline.json", "PARITY_SPOT.json")]
    before = [open(p, "rb").read() for p in paths]
    _small_run(monkeypatch)
    assert bench.main(["--config", "0", "--device", "cpu"]) == 0
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1])["value"] > 0
    assert [open(p, "rb").read() for p in paths] == before


def test_baseline_entry_missing_drops_vs_baseline(tmp_path):
    path = tmp_path / "bench_baseline.json"
    assert bench.baseline(3, str(path)) is None
    path.write_text(json.dumps({"3": {"method": "calibrated-v4", "baseline_steps_per_s": 1.0}}))
    assert bench.baseline(3, str(path)) is None
    assert bench.baseline(3) == json.load(open(bench.BASELINE_FILE))["3"]["baseline_steps_per_s"]


def test_corrupted_fixture_stops_the_bench(tmp_path, monkeypatch, capsys):
    """One cell of the recorded rollout changed: the gate raises, and no
    metric line is printed."""
    d = dict(np.load(parity_check.FIXTURES[0]))
    d["colour"] = d["colour"].copy()
    d["colour"][5, 3, 2, 2] = d["colour"][5, 3, 2, 2] % 3 + 1
    bad = tmp_path / "torch_port_fixture_cfg0.npz"
    np.savez_compressed(bad, **d)
    monkeypatch.setitem(parity_check.FIXTURES, 0, str(bad))
    _small_run(monkeypatch)
    with pytest.raises(RuntimeError, match="fixture step 5: field colour differs"):
        bench.main(["--config", "0", "--device", "cpu"])
    out = capsys.readouterr().out
    assert "metric" not in out and "bench: window" not in out


def test_bench_needs_a_card_unless_told_cpu(monkeypatch):
    if torch.cuda.is_available():
        pytest.skip("this machine has a card: the bench runs there")
    _small_run(monkeypatch)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        bench.main(["--config", "0"])


@pytest.mark.parametrize("idx", [0, 2, 4])
def test_gate_fixture_replays_exactly(idx, tmp_path):
    """The recorded JAX rollouts of configs 0, 2 and 4 (a copy: the file's
    name is the config's) replay through the port bit for bit."""
    d = np.load(parity_check.FIXTURES[idx])
    R, C, K, moves, colourless, colour = bench.CONFIGS[idx]
    assert list(d["config"]) == [R, C, K, moves]
    flags = [n in colourless + colour
             for n in ("cookie", "vertical_laser", "horizontal_laser", "bomb")]
    assert list(d["specials"] if "specials" in d.files else [0, 0, 0, 0]) == flags
    steps = {0: 12, 2: 12, 4: 8}[idx]
    assert d["colour"].shape[:2] == (steps + 1, {0: 64, 2: 32, 4: 16}[idx])
    if idx == 0:
        assert d["done"].any()  # the reset at step 10
    else:
        assert d["num_new_specials"].any()
    copy = shutil.copy(parity_check.FIXTURES[idx], tmp_path)
    assert parity_check.replay_fixture("cpu", copy) == steps
