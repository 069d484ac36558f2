"""Boards a step that K4 (``specials_trip``, the full trip: one warp a
board, its scratch in shared memory) takes: the ``boards`` of the
program's ``specials_trip`` spans, one a wrapper call, summed over the
profiled episode, over its steps."""

from tmt_bench.spans import named


def read(run):
    spans = named(run, "specials_trip")
    return None if spans is None else sum(s.attrs["boards"] for s in spans) / run["profile"]["steps"]
