"""Each of the port's examples (``tile_match_tpu_torch.examples``) runs its
``main`` at its smallest flags on the CPU and returns what it printed."""

import json
import os

import pytest
import torch

from tile_match_tpu_torch.examples import dqn_train, play, q_learning_sweep, random_baseline, scaling

torch.set_num_threads(1)


def test_random_baseline(tmp_path):
    rows = random_baseline.main(["--quick", "--episodes", "4", "--batch", "4",
                                 "--out", str(tmp_path), "--device", "cpu"])
    assert len(rows) == 8
    assert all(r["epi_rewards_mean"] >= 0 for r in rows)
    # effective actions score at least as well as uniform ones on every config
    for plain, eff in zip(rows[::2], rows[1::2]):
        assert eff["use_effective_actions"] and eff["epi_rewards_mean"] >= plain["epi_rewards_mean"]
    assert os.path.exists(tmp_path / "3_3_2_5_specials_effective_actions" / "results.json")


def test_play(capsys):
    total = play.main(["--rows", "5", "--cols", "5", "--colours", "3", "--moves", "3",
                       "--device", "cpu"])
    out = capsys.readouterr().out
    assert out.count("action=") == 3 and f"episode return: {total}" in out


@pytest.mark.parametrize("mode", ["host", "device_table"])
def test_q_learning_sweep(mode, tmp_path):
    flags = ["--quick", "--episodes", "3", "--out", str(tmp_path), "--torch-device", "cpu"]
    if mode == "device_table":
        flags.append("--device")
    rows = q_learning_sweep.main(flags)
    assert len(rows) == 2
    if mode == "host":
        assert {r["lr"] for r in rows} == {0.1, 0.25}
        assert len(os.listdir(tmp_path)) == 2
    else:
        assert all(r["final_reward_mean"] >= 0 for r in rows)


@pytest.mark.parametrize("sharded", [False, True], ids=["plain", "sharded"])
def test_dqn_train(sharded, capsys):
    flags = ["--rows", "4", "--cols", "4", "--moves", "5", "--steps", "2", "--batch", "8",
             "--hidden", "32", "--eval-episodes", "4", "--device", "cpu"]
    if sharded:
        flags += ["--sharded", "--ranks", "2", "--tp", "2"]
    out = dqn_train.main(flags)
    assert out[0]["step"] == 2 and out[0]["epsilon"] > 0
    if not sharded:
        assert "eval_return_mean" in json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def test_scaling():
    rows = scaling.main(["--rows", "5", "--cols", "5", "--colours", "3", "--per-device-batch", "4",
                         "--steps", "2", "--max-ranks", "2", "--device", "cpu"])
    assert [r["dp"] for r in rows] == [1, 2]
    assert [len(r["per_rank_steps_per_sec"]) for r in rows] == [1, 2]
    assert all(r["backend"] == "gloo" and r["total_reward"] > 0 for r in rows)
    assert len(rows[1]["shard_max_trips_per_step"]) == 2
