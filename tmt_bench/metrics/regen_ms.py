"""ms of a regeneration: the program's ``regenerate`` spans
(``engine.generate_board`` on the boards whose episode ended, in the
auto-reset step) over their number, in the profiled episode."""

from tmt_bench.spans import named, span_ms


def read(run):
    spans = named(run, "regenerate")
    return None if spans is None else span_ms(spans) / len(spans)
