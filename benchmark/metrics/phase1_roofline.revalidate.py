"""Phase 1's share of its roofline in a full-revalidation tick, in %.

Bound: ``yardstick/roofline.py`` over the reference's own planes of every
object against every cluster, once a tick (no padding, no re-dispatch).
Time: the profiler's device time per traced tick of the kernels the
port launches for phase 1 (``csrc/phase1.cu`` through ``ops/phase1.py``:
``columns_kernel``, then ``phase1_kernel``); a phase 1 run by other kernels
reads nothing here."""

LAYER = "phase-1 kernel"
UNIT = "%"
SOURCE = "device_trace"
MOVES = "objects_per_s"

KERNELS = r"\b(columns_kernel|phase1_kernel)\b"


def read(r):
    spent = r.traced_device_ms(KERNELS)
    if spent is None:
        return None
    return 100.0 * r.phase1_bound_ms() / spent
