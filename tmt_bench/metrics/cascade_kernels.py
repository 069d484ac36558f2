"""Kernels a step (device operations but memcpy and memset) that started on
the device inside the program's ``cascade`` spans, over the profiled
episode."""

from tmt_bench.spans import Device, named


def read(run):
    spans = named(run, "cascade")
    if spans is None:
        return None
    return Device(run["profile"]).kernels(spans) / run["profile"]["steps"]
