"""ms a step of the program's ``cascade`` spans (the call of
``fused_specials_cascade``, or of K1 ``fused_cascade``, in
``engine.engine_move``), over the profiled episode."""

from tmt_bench.spans import named, span_ms


def read(run):
    spans = named(run, "cascade")
    return None if spans is None else span_ms(spans) / run["profile"]["steps"]
