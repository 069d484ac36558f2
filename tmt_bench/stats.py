"""The benchmark's arithmetic: percentiles, spreads, interval unions and
the device's idle gaps.  Plain Python, no device."""

from __future__ import annotations

import statistics


def percentile(values, q: float) -> float:
    """The ``q``-th percentile of ``values``, linear between the two
    nearest ranks (numpy's default): over n sorted values, position
    (n - 1) * q / 100."""
    xs = sorted(values)
    if not xs:
        raise ValueError("percentile of no values")
    pos = (len(xs) - 1) * q / 100.0
    lo = int(pos)
    hi = min(lo + 1, len(xs) - 1)
    return xs[lo] + (xs[hi] - xs[lo]) * (pos - lo)


def spread(values) -> float:
    """The distance between the first and the third quartile as a share of
    the median, quartiles as ``statistics.quantiles(values, n=4)`` gives
    them."""
    q1, med, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / med


def union_length(intervals) -> float:
    """Length of the union of [start, end) intervals."""
    total, cur_s, cur_e = 0.0, None, None
    for s, e in sorted(intervals):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total


def idle_gaps(intervals, start: float, end: float):
    """The stretches of [start, end) that no interval covers, as (start,
    end) pairs in time order."""
    gaps, cur = [], start
    for s, e in sorted(intervals):
        if s > cur:
            gaps.append((cur, min(s, end)))
        cur = max(cur, e)
        if cur >= end:
            break
    if cur < end:
        gaps.append((cur, end))
    return [(s, e) for s, e in gaps if e > s]
