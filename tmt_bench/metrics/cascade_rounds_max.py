"""The most rounds of the specials cascade's loop in one step: the largest
``rounds`` of the program's ``cascade`` spans (one a step, in
``engine.engine_move``) over the profiled episode.  In a cell whose
episodes are 100 moves the p99 step is in effect the slowest ordinary
step, the one whose cascade ran the most rounds."""

from tmt_bench.spans import named


def read(run):
    spans = named(run, "cascade")
    return None if spans is None else max(s.attrs["rounds"] for s in spans)
