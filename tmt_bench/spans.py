"""The program's own spans over a traced run's profiled episode, for the
per-layer readers that read them (``metrics/cascade_*.py``,
``metrics/regen_*.py``).

The program (``tile_match_tpu_torch.profiling``) records a span log only
while a ``torch.profiler`` session runs; in a run the only such session is
the harness's profiled episode (``harness.profiled_episode``).  Its spans
carry ``time.time_ns()`` times, the profile's own time base, so the
device's operations of ``run["profile"]["ops"]`` (unix us) can be cut by
span: the stretches of a span with the device idle (``stats.idle_gaps``),
and the kernels (``trace.is_kernel``) whose device start lies inside it.

The program is imported when a reader reads, never at import time.  A
program without a span log (an older one) or a run without a profile gives
None, and the metric is left out.
"""

from __future__ import annotations

import bisect

from .stats import idle_gaps
from .trace import is_kernel


def episode(run):
    """The span log and the episode's spans (those of its last
    ``profile["steps"]`` batched steps and of the draws that feed them), or
    None where the program records no spans or the run has no profile."""
    prof = run.get("profile")
    if not prof:
        return None
    try:
        from tile_match_tpu_torch import profiling
    except ImportError:
        return None
    read = getattr(profiling, "spans", None)
    if read is None:
        return None
    log = read()
    steps = [i for i, s in enumerate(log) if s.name == "batched_step" and s.parent == -1]
    if not steps:
        return None
    first = steps[-min(len(steps), prof["steps"])]
    return log, [s for s in log if s.step >= first and s.end_ns is not None]


def named(run, name: str):
    """The episode's closed spans called ``name``, or None where it has
    none (or no spans at all)."""
    got = episode(run)
    if got is None:
        return None
    found = [s for s in got[1] if s.name == name]
    return found or None


def playable_in_regeneration(run):
    """The episode's ``playable`` spans whose parent is a ``regenerate``
    span, or None where it has none."""
    got = episode(run)
    if got is None:
        return None
    log, mine = got
    found = [s for s in mine if s.name == "playable" and s.parent >= 0
             and log[s.parent].name == "regenerate"]
    return found or None


def span_ms(spans) -> float:
    return sum(s.end_ns - s.start_ns for s in spans) / 1e6


class Device:
    """The profiled episode's device operations, for cutting by span:
    their union as sorted disjoint intervals and the kernels' start times,
    in us."""

    def __init__(self, profile: dict):
        busy = []
        for s, e in sorted((s, e) for _, s, e in profile["ops"]):
            if busy and s <= busy[-1][1]:
                busy[-1][1] = max(busy[-1][1], e)
            else:
                busy.append([s, e])
        self.busy = [tuple(b) for b in busy]
        self.starts = [s for s, _ in self.busy]
        self.ends = [e for _, e in self.busy]
        self.kernel_starts = sorted(s for n, s, _ in profile["ops"] if is_kernel(n))

    def idle_ms(self, spans) -> float:
        """ms of the spans in which the device ran no operation: each span's
        length (integer ns, as ``span_ms`` sums it) less the part the
        device's operations cover, so that it never reads above
        ``span_ms`` of the same spans."""
        total = 0.0
        for sp in spans:
            a, b = sp.start_ns / 1e3, sp.end_ns / 1e3
            near = self.busy[bisect.bisect_right(self.ends, a):bisect.bisect_left(self.starts, b)]
            covered_us = max(0.0, (b - a) - sum(e - s for s, e in idle_gaps(near, a, b)))
            total += (sp.end_ns - sp.start_ns) - covered_us * 1e3
        return total / 1e6

    def kernels(self, spans) -> int:
        """Kernels whose device start lies inside the spans."""
        ks = self.kernel_starts
        return sum(bisect.bisect_left(ks, sp.end_ns / 1e3) - bisect.bisect_left(ks, sp.start_ns / 1e3)
                   for sp in spans)
