"""ms a step inside the program's ``cascade`` spans in which the device ran
no operation, over the profiled episode: the cascade's host loop (rounds'
compaction, host reads, launches) that the device waits on."""

from tmt_bench.spans import Device, named


def read(run):
    spans = named(run, "cascade")
    if spans is None:
        return None
    return Device(run["profile"]).idle_ms(spans) / run["profile"]["steps"]
