"""The 95th-percentile tick of c5-churn's window (host clock), read in the
traced run: some 45 ticks a window put only two or three past it, too few
for an end-to-end bound (``tick_ms`` holds the cell's latency)."""

LAYER = "SchedulerEngine.schedule"
UNIT = "ms"
SOURCE = "host_clock"
MOVES = "tick_ms"


def read(r):
    return r.tick_p95_ms()
