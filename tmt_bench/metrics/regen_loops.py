"""Iterations of the playability loop a regeneration: the ``loops``
counts of the program's ``playable`` spans whose parent is a
``regenerate`` span (``make_playable`` inside ``generate_board``; both of
its loops, one key split each), over the ``regenerate`` spans' number, in
the profiled episode."""

from tmt_bench.spans import named, playable_in_regeneration


def read(run):
    loops, regens = playable_in_regeneration(run), named(run, "regenerate")
    if loops is None or regens is None:
        return None
    return sum(s.attrs["loops"] for s in loops) / len(regens)
