"""Share of the specials cascade's time, in %, spent in rounds that carry
fewer than ``FEW`` boards: the program's ``cascade_round`` spans (one a
round of ``engine.fused_specials_cascade``'s loop, ``boards`` the boards
its K2 launch takes) with ``boards`` < ``FEW``, over its ``cascade``
spans, over the profiled episode.

``FEW`` is 128, under the H100's 132 SMs: K2 and K4 run a board a warp,
so such a round's launches hold less than one board an SM and pay their
launch and host sync whole for little work.  Nothing where the program
has no ``cascade_round`` span (an older one)."""

from tmt_bench.spans import named, span_ms

FEW = 128


def read(run):
    rounds = named(run, "cascade_round")
    cascades = named(run, "cascade")
    if rounds is None or cascades is None:
        return None
    few = [s for s in rounds if s.attrs["boards"] < FEW]
    return 100.0 * span_ms(few) / span_ms(cascades)
