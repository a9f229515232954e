"""Device time from a ``torch.profiler`` trace of a few whole ticks.

Only the device is traced (CUDA activity: kernels, copies, sets and the
runtime calls that issued them), so the host runs the ticks at nearly its
untraced pace; recording every torch op as well tripled a c5 drift tick.
The trace is written to a temporary directory, read back and deleted.
The ticks' wall comes from the host clock; the device's idle gaps are
labelled by the runtime call the host was in, if any (a gap between two
ticks holds the harness's work too).  Pattern:
``chip_smoke.py:profile_chunk`` (device events only, busy against the
wall) as of commit 5df33979f11fc4d3c609bdae8857b52774b11979, over a span
of ticks instead of one chunk.
"""

from __future__ import annotations

import json
import os
import re
import tempfile

from benchmark.yardstick import stats

DEVICE_CATS = {"kernel", "gpu_memcpy", "gpu_memset"}
RUNTIME_CATS = {"cuda_runtime", "cuda_driver"}
NO_CALL = "host, in no CUDA call"
# Namespaces and boilerplate dropped from kernel names, so what tells two
# kernels apart fits in NAME_CHARS.
NOISE = re.compile(r"^void |at::native::|at_cuda_detail::|at::cuda::detail::|"
                   r"\(anonymous namespace\)::|std::array<char\*, \d+ul> ?")
NAME_CHARS = 200
TOP = 10


def short(name: str) -> str:
    return NOISE.sub("", name)[:NAME_CHARS]


class DeviceTrace:
    """Device and runtime intervals in microseconds on the profiler's
    clock, with the traced ticks' count and host-clock wall."""

    def __init__(self, events: list, ticks: int, window_s: float):
        self.ticks = ticks
        self.window_s = window_s
        self.device = []   # (name, start, end)
        self.runtime = []  # (name, start, end)
        for e in events:
            if e.get("ph") != "X" or "dur" not in e:
                continue
            cat = str(e.get("cat", "")).lower()
            start = float(e["ts"])
            item = (str(e.get("name", "")), start, start + float(e["dur"]))
            if cat in DEVICE_CATS:
                self.device.append(item)
            elif cat in RUNTIME_CATS:
                self.runtime.append(item)

    @property
    def busy_s(self) -> float:
        """Seconds in which some operation ran on the device."""
        return stats.union_length([(s, e) for _, s, e in self.device], float("-inf"), float("inf")) / 1e6

    def device_s(self, keep) -> float:
        """Summed device seconds of the events whose name ``keep`` takes."""
        return sum(e - s for n, s, e in self.device if keep(n)) / 1e6

    def breakdown(self) -> dict:
        """The device operations that took most time, and the longest idle
        gaps between the trace's first and last event, each labelled by the
        innermost runtime call running at its middle."""
        by_name: dict[str, float] = {}
        for n, s, e in self.device:
            key = short(n)
            by_name[key] = by_name.get(key, 0.0) + (e - s) / 1e6
        ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:TOP]
        every = self.device + self.runtime
        if not every:
            return {"device_ops": [], "idle_gaps": []}
        lo, hi = min(s for _, s, _ in every), max(e for _, _, e in every)
        idle = sorted(stats.gaps([(s, e) for _, s, e in self.device], lo, hi),
                      key=lambda g: g[0] - g[1])[:TOP]
        labelled = []
        for s, e in idle:
            mid = (s + e) / 2
            covering = [(re_ - rs, n) for n, rs, re_ in self.runtime if rs <= mid <= re_]
            labelled.append([min(covering)[1] if covering else NO_CALL, (e - s) / 1e6])
        return {"device_ops": [[n, secs] for n, secs in ops], "idle_gaps": labelled}


def capture(run_ticks, cuda: bool) -> DeviceTrace:
    """Profile ``run_ticks()``, which returns the traced ticks' host-clock
    (start, end) pairs, and read the trace back.  The window is the ticks'
    summed wall: the harness's work between ticks (the next tick's fresh
    objects, the sample) is the load's, and no device work runs in it."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA if cuda else ProfilerActivity.CPU]) as prof:
        spans = run_ticks()
    with tempfile.TemporaryDirectory(prefix="bench-trace-") as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    return DeviceTrace(events, len(spans), sum(end - start for start, end in spans))
