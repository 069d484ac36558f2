"""The port's random-policy baseline against the JAX package's on the CPU:
both modes draw from the same keys (``randint`` over every action, or
``categorical`` over the effective ones), so returns and effective-action
counts are equal, episode for episode."""

import json

import numpy as np
import pytest

from tile_match_tpu.config import EnvConfig as JaxConfig
from tile_match_tpu.models import random_agent as jra
from tile_match_tpu_torch.config import EnvConfig
from tile_match_tpu_torch.models import random_agent as tra

import torch

torch.set_num_threads(1)

# tests/test_utils_models.py's baseline config: 4x4, 3 colours, 5 moves,
# the vertical laser
SIZE = (4, 4, 3, 5)
SPECIALS = dict(colourless_specials=[], colour_specials=["vertical_laser"])


@pytest.mark.parametrize("effective", [False, True])
def test_run_random_equals_jax(effective):
    jcfg, tcfg = JaxConfig.create(*SIZE, **SPECIALS), EnvConfig.create(*SIZE, **SPECIALS)
    want = jra.run_random(jcfg, seed=3, num_episodes=40, use_effective_actions=effective,
                          batch_size=16)
    got = tra.run_random(tcfg, seed=3, num_episodes=40, use_effective_actions=effective,
                         batch_size=16, device="cpu")
    for g, w in zip(got, want):
        assert g.shape == w.shape == (40,)
        assert g.dtype == w.dtype and np.array_equal(g, w)
    if effective:
        assert (got[0] > 0).all()


def test_save_results_layout(tmp_path):
    tcfg = EnvConfig.create(*SIZE, **SPECIALS)
    r, eff = tra.run_random(tcfg, seed=0, num_episodes=5, batch_size=8, device="cpu")
    tra.save_results((r, eff), tmp_path / "out")
    with open(tmp_path / "out" / "results.json") as f:
        saved = json.load(f)
    assert set(saved) == {"r", "env_num_effective_actions"}
    assert np.allclose(saved["r"], r) and saved["env_num_effective_actions"] == eff.tolist()


def test_run_random_baseline_writes_the_reference_directory(tmp_path, monkeypatch):
    calls = []
    real = tra.run_random
    monkeypatch.setattr(tra, "run_random", lambda *a, **k: calls.append(a) or real(*a, **k))
    tra.run_random_baseline(4, *SIZE, use_effective_actions=True, output_root=str(tmp_path),
                            device="cpu")
    assert (tmp_path / "4_4_3_5_specials_effective_actions" / "results.json").exists()
    cfg = calls[0][0]
    assert cfg.vertical_laser and not (cfg.cookie or cfg.horizontal_laser or cfg.bomb)
