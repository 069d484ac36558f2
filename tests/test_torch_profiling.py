"""The port's ``profiling``: ``measure_throughput`` returns the JAX
package's keys (on the CPU here, where its device is named ``cpu``),
``trace`` writes a Chrome trace, and the CLI prints the JSON."""

import glob
import json
import os

import torch

from tile_match_tpu.profiling import measure_throughput as jax_measure
from tile_match_tpu.config import EnvConfig as JaxConfig
from tile_match_tpu_torch import profiling
from tile_match_tpu_torch.config import EnvConfig

torch.set_num_threads(1)

CFG = (5, 5, 3, 6)


def test_measure_throughput_has_the_reference_keys():
    out = profiling.measure_throughput(EnvConfig(*CFG), batch_size=8, num_steps=3, reps=2,
                                       device="cpu")
    want = jax_measure(JaxConfig(*CFG), batch_size=8, num_steps=3, reps=1)
    assert set(out) == set(want)
    assert out["steps_per_sec"] > 0
    assert (out["batch_size"], out["num_steps"]) == (8, 3)
    assert len(out["times"]) == 2 and all(t > 0 for t in out["times"])
    assert out["device"] == "cpu"


def test_trace_writes_a_chrome_trace(tmp_path):
    logdir = str(tmp_path / "trace")
    profiling.measure_throughput(EnvConfig(*CFG), batch_size=4, num_steps=2, reps=1,
                                 logdir=logdir, device="cpu")
    files = glob.glob(os.path.join(logdir, "*.pt.trace.json"))
    assert len(files) == 1
    with open(files[0]) as f:
        events = json.load(f)["traceEvents"]
    assert any("aten::" in e.get("name", "") for e in events)
    with profiling.trace(None):  # a no-op
        pass


def test_cli_prints_the_json(capsys):
    rc = profiling.main(["--rows", "5", "--cols", "5", "--colours", "3", "--batch", "4",
                         "--steps", "2", "--reps", "1", "--no-specials", "--device", "cpu"])
    assert rc == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["batch_size"] == 4 and out["num_steps"] == 2 and out["device"] == "cpu"


def test_profile_needs_a_card(capsys):
    """``--profile`` (the step's profile) runs on the card only."""
    if torch.cuda.is_available():
        return
    assert profiling.main(["--profile", "--config", "0", "--steps", "2"]) == 1
    assert "needs a CUDA card" in capsys.readouterr().err
