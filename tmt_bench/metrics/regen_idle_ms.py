"""ms of a regeneration (the program's ``regenerate`` spans, over their
number) in which the device ran no operation, in the profiled episode: the
host's share of the playability loop's iterations."""

from tmt_bench.spans import Device, named


def read(run):
    spans = named(run, "regenerate")
    if spans is None:
        return None
    return Device(run["profile"]).idle_ms(spans) / len(spans)
