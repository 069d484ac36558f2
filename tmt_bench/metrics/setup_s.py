"""Seconds from the process's start to the first timed step: imports, the
kernels' build or its cache check, the reset and the warm-up episodes."""


def read(run):
    return run["setup_s"]
