"""How many of the hand-written kernels K1-K5 that ``port_kernels.json``
lists ran on the device in the profiled episode.  A listed kernel that a
cell ran before and no longer shows, renamed, merged into another or taken
off the path, lowers it: its time then counts in ``plain_ops_device_ms``,
and this number says so."""

from tmt_bench.trace import port_kernels


def read(run):
    prof = run["profile"]
    if not prof or not prof["ops"]:
        return None
    names = {n for n, _, _ in prof["ops"]}
    return sum(any(k in n for n in names) for k in port_kernels())
