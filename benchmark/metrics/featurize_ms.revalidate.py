"""Host featurization per tick: the mean of ``SchedulerEngine.timings["featurize"]``
over the window (``scheduler/featurize.py``, ``compact.py``, cache checks)."""

LAYER = "featurization"
UNIT = "ms"
SOURCE = "program_span"
MOVES = "objects_per_s"


def read(r):
    return r.stage_ms("featurize")
