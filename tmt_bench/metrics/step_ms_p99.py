"""The 99th percentile of the window's step times, every step counted: a
step is one loop iteration (split, draw, step), timed between CUDA events
recorded after consecutive steps."""

from tmt_bench.stats import percentile


def read(run):
    return percentile(run["window"]["step_ms"], 99)
