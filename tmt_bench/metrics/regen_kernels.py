"""Kernels (device operations but memcpy and memset) that started on the
device inside a regeneration (the program's ``regenerate`` spans, over
their number), in the profiled episode."""

from tmt_bench.spans import Device, named


def read(run):
    spans = named(run, "regenerate")
    if spans is None:
        return None
    return Device(run["profile"]).kernels(spans) / len(spans)
