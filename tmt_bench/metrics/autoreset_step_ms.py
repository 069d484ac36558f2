"""Median ms of ``batched_step`` on steps in which episodes end and their
boards regenerate (``engine.generate_board``), between CUDA events around
it, over the traced window."""

import statistics


def read(run):
    win = run["window"]
    if "env_step_ms" not in win:
        return None
    ms = [m for m, done in zip(win["env_step_ms"], win["step_done"]) if done]
    return statistics.median(ms) if ms else None
