"""Host decode per tick: the mean of ``SchedulerEngine.timings["decode"]``
over the window (``_decode_packed_mixed``, ``_build_results``)."""

LAYER = "decode"
UNIT = "ms"
SOURCE = "program_span"
MOVES = "tick_ms"


def read(r):
    return r.stage_ms("decode")
