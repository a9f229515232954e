"""Result bytes the engine fetched from the card per tick: the per-tick
delta of ``SchedulerEngine.fetch_bytes_total`` over the window (chunk
cache, sub-batch and fetch paths, ``scheduler/engine.py``)."""

LAYER = "engine chunk cache, sub-batch and fetch"
UNIT = "B"
SOURCE = "program_counter"
MOVES = "tick_ms"


def read(r):
    return r.counter("fetch_bytes_total")
