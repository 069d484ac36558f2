"""Kernel launches a step (the profiler's ``cudaLaunchKernel`` and
``cuLaunchKernel`` calls) over the profiled episode, the harness's own
copies of the checked boards' outputs included (seven a step)."""


def read(run):
    prof = run["profile"]
    if not prof or not prof["launches"]:
        return None
    return prof["launches"] / prof["steps"]
