"""Share of the board-iterations of regeneration's playability loop that a
board still needed: 100 * sum of ``live`` / sum of ``loops * boards`` over
the program's ``playable`` spans whose parent is a ``regenerate`` span, in
the profiled episode.  Each iteration steps every board of the batch;
``live`` counts those still going."""

from tmt_bench.spans import playable_in_regeneration


def read(run):
    spans = playable_in_regeneration(run)
    if spans is None:
        return None
    tried = sum(s.attrs["loops"] * s.attrs["boards"] for s in spans)
    return 100.0 * sum(s.attrs["live"] for s in spans) / tried if tried else None
