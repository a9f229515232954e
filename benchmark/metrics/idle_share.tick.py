"""Share of the traced ticks' wall in which no operation ran on the
device: 100 x (1 - busy / wall), the wall summed over the traced ticks
(torch.profiler device events)."""

LAYER = "device"
UNIT = "%"
SOURCE = "device_trace"
MOVES = "tick_ms"


def read(r):
    return r.idle_pct()
