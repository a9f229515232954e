"""The benchmark's arithmetic: percentiles, rates, spreads, busy time.

Patterns: ``bench.py``'s percentile and rate arithmetic and
``chip_smoke.py:profile_chunk``'s idle share, as of commit
5df33979f11fc4d3c609bdae8857b52774b11979, restated on plain lists.
"""

from __future__ import annotations

import math
import statistics


def percentile(values, q: float) -> float:
    """The nearest-rank q-th percentile: the smallest value with at least
    q % of the values at or below it (a value that was measured)."""
    if not values:
        raise ValueError("percentile of no values")
    ordered = sorted(values)
    rank = max(1, math.ceil(q / 100 * len(ordered)))
    return ordered[rank - 1]


def rate(count: float, seconds: float) -> float:
    """Work per second over a span; the span must be positive."""
    if seconds <= 0:
        raise ValueError(f"rate over a span of {seconds} s")
    return count / seconds


def spread(values) -> float:
    """Interquartile distance over the median: ``statistics.quantiles(n=4)``'s
    first and third quartiles, as a share of the median."""
    q1, q2, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / q2


def union_length(intervals, lo: float, hi: float) -> float:
    """Length of the union of (start, end) intervals clipped to [lo, hi]."""
    total = 0.0
    cur_s = cur_e = None
    for s, e in sorted((max(s, lo), min(e, hi)) for s, e in intervals):
        if e <= s:
            continue
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total


def gaps(intervals, lo: float, hi: float):
    """The idle (start, end) spans of [lo, hi] that no interval covers."""
    out = []
    cursor = lo
    for s, e in sorted(intervals):
        s, e = max(s, lo), min(e, hi)
        if e <= s:
            continue
        if s > cursor:
            out.append((cursor, s))
        cursor = max(cursor, e)
    if hi > cursor:
        out.append((cursor, hi))
    return out
