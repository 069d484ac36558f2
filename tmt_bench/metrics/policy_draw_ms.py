"""Median ms of the policy draw a step (the key split and
``random_effective``), between CUDA events around it, over the traced
window."""

import statistics


def read(run):
    draws = run["window"].get("draw_ms")
    return statistics.median(draws) if draws else None
