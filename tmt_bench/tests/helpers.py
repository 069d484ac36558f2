"""Tiny runs of the harness on the CPU for the tests: the cell's
configuration and mix at a batch of 8, four boards checked."""

from __future__ import annotations

import time

import torch

from tmt_bench import check, harness, manifest

CPU = torch.device("cpu")


BOARDS = 4  # boards the tiny runs check
CHUNK = 256  # board-steps of a block of the reference in the tiny runs


def tiny_cell(workload: str, batch: int = 8) -> dict:
    cell = manifest.cell(manifest.load(), workload)
    cell["traffic"] = dict(cell["traffic"], batch=batch)
    return cell


def tiny_run(workload: str, program_cls, seed: int = 2**31 + 17, steps: int = 2,
             trace: bool = False, warmup_episodes=None) -> dict:
    """One run on the CPU with ``steps`` steps in the window."""
    cell = tiny_cell(workload)
    if warmup_episodes is not None:
        cell["traffic"]["warmup_episodes"] = warmup_episodes
    res = harness.run_cell(cell, seed, 0, trace, CPU, program_cls, time.time(),
                           max_steps=steps, check_boards=BOARDS, check_chunk=CHUNK)
    res["correct"] = check.passed(res["checks"])
    return res
