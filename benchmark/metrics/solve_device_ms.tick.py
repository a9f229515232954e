"""Device time per traced tick of every operation but the phase-1 kernels
(the expand, narrow solve, planner, select, pack and copies of
``ops/pipeline.py``, ``ops/planner.py``, ``ops/select.py``), from the
profiler's trace."""

LAYER = "device programs"
UNIT = "ms"
SOURCE = "device_trace"
MOVES = "tick_ms"

# Phase 1's kernels, left out (``phase1_roofline.revalidate`` reads them).
PHASE1_KERNELS = r"\b(columns_kernel|phase1_kernel)\b"


def read(r):
    return r.traced_device_ms(PHASE1_KERNELS, matching=False)
