"""What a per-layer metric reads: the window's ticks and the traced ticks.

A metric is a file ``benchmark/metrics/<name>.py`` whose ``read(r)`` takes
a ``Readings`` and returns a number, or None where it finds nothing to
read (the harness then leaves the metric out of the line).
"""

from __future__ import annotations

import re

import numpy as np

from benchmark.reference.planes import Block, Clusters, Memo
from benchmark.yardstick import roofline, stats

BOUND_BLOCK_ROWS = 512


class Readings:
    """``ticks``: one dict a window tick (``wall_s``, ``objects``,
    ``timings`` (the engine's stage seconds), ``counters`` (every number
    the engine and the phase-1 launcher keep after the tick, by the names
    of ``harness.counters``) and ``deltas`` (each one's change over the
    tick)); ``trace``: a ``devtrace.DeviceTrace`` of the traced ticks, or
    None; ``traced_worlds``: each traced tick's (object records, cluster
    records)."""

    def __init__(self, ticks, trace=None, traced_worlds=()):
        self.ticks = ticks
        self.trace = trace
        self.traced_worlds = list(traced_worlds)
        self._bounds: dict = {}

    def per_tick(self, key: str):
        """Mean of a tick's own field (``wall_s``, ``objects``) over the
        window's ticks."""
        return float(np.mean([t[key] for t in self.ticks])) if self.ticks else None

    def counter(self, name: str):
        """Mean change a tick of a counter the program keeps (``fetch_bytes_total``,
        ``phase1.launches``, ``cache_stats.patch``); None if the program
        has no such counter."""
        vals = [t["deltas"][name] for t in self.ticks if name in t["deltas"]]
        return float(np.mean(vals)) if vals else None

    def gauge(self, name: str):
        """Mean over the window's ticks of a number the program keeps, as
        it stands after each tick; None if the program has no such number."""
        vals = [t["counters"][name] for t in self.ticks if name in t["counters"]]
        return float(np.mean(vals)) if vals else None

    def tick_p95_ms(self):
        """The window's 95th-percentile tick wall (host clock)."""
        return 1e3 * stats.percentile([t["wall_s"] for t in self.ticks], 95) if self.ticks else None

    def stage_ms(self, stage: str):
        """Mean ms a tick of an engine stage's timer; None if it never ran."""
        vals = [t["timings"].get(stage, 0.0) for t in self.ticks]
        if not any(vals):
            return None
        return float(np.mean(vals)) * 1e3

    def traced_device_ms(self, kernels: str, matching: bool = True):
        """Device ms per traced tick of the operations whose name the
        regular expression ``kernels`` finds (``matching``), or of every
        other one; None without a trace that saw such an operation."""
        if self.trace is None or not self.trace.device:
            return None
        pattern = re.compile(kernels)
        secs = self.trace.device_s(lambda n: bool(pattern.search(n)) == matching)
        if secs <= 0:
            return None
        return secs * 1e3 / self.trace.ticks

    def idle_pct(self):
        if self.trace is None or not self.trace.device:
            return None
        return 100.0 * (1.0 - self.trace.busy_s / self.trace.window_s)

    def phase1_bound_ms(self):
        """Phase 1's least time per traced tick (``yardstick/roofline.py``)
        over the reference's own planes of every row of the tick's world."""
        if not self.traced_worlds:
            return None
        total = 0.0
        for units, clusters in self.traced_worlds:
            key = (id(units), id(clusters))
            if key not in self._bounds:
                cl = Clusters(clusters)
                memo = Memo(cl)
                works = [roofline.block_work(Block(units[i:i + BOUND_BLOCK_ROWS], cl, memo))
                         for i in range(0, len(units), BOUND_BLOCK_ROWS)]
                self._bounds[key] = roofline.bound(roofline.add(works))["bound_ms"]
            total += self._bounds[key]
        return total / len(self.traced_worlds)
