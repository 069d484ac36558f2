"""Share of the profiled episode's wall time in which the device ran no
operation: 100 * (1 - busy / wall), busy the union of the device's
operation intervals."""

from tmt_bench.trace import busy_s


def read(run):
    prof = run["profile"]
    if not prof or not prof["ops"]:
        return None
    return 100.0 * (1.0 - busy_s(prof) / prof["wall_s"])
