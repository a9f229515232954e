"""Phase-1 kernel launches per tick: the per-tick delta of
``kubeadmiral_tpu_torch.ops.phase1.phase1.launches`` over the window
(one a ``kt_phase1`` call of ``columns_kernel`` then ``phase1_kernel``)."""

LAYER = "phase-1 kernel"
UNIT = "launches"
SOURCE = "program_counter"
MOVES = "tick_ms"


def read(r):
    return r.counter("phase1.launches")
