"""Seeded random tick problems: every plane the dense tick reads, at any
(B, C), for holding the phase-1 kernel and the tick on the card against
their plain versions.

The per-cell score planes are int32, as every featurizer emits them and
as the kernel takes them.
"""

from __future__ import annotations

import numpy as np

from kubeadmiral_tpu_torch.ops.pipeline import TickInputs

INF = 2**31 - 1


def random_tick_inputs(b, c, r=4, webhook=False, invalid=0, scale=False, seed=0):
    """A random numpy TickInputs: ``webhook`` draws webhook filter and
    score planes, ``invalid`` pads that many trailing cluster columns,
    ``scale`` spreads resource quantities over 2**0..2**39 (the balanced
    score's range shift)."""
    rng = np.random.default_rng(seed * 7919 + b * 1000 + c)
    mask = lambda p, shape=(b, c): rng.random(shape) < p  # noqa: E731
    mult = (np.int64(1) << rng.integers(0, 40, r)) if scale else np.ones(r, np.int64)
    valid = np.ones(c, bool)
    valid[c - invalid:] = False
    current_mask = mask(0.2)
    current_replicas = np.where(
        current_mask & mask(0.7), rng.integers(0, 10, (b, c)), -1
    ).astype(np.int32)
    max_replicas = np.where(mask(0.2), rng.integers(0, 10, (b, c)), INF).astype(np.int32)
    roll = rng.random(b)
    return TickInputs(
        filter_enabled=mask(0.8, (b, 5)),
        api_ok=mask(0.9),
        taint_ok_new=mask(0.85),
        taint_ok_cur=mask(0.95),
        selector_ok=mask(0.9),
        placement_has=mask(0.4, (b,)),
        placement_ok=mask(0.7),
        request=rng.integers(0, 8, (b, r)) * mult,
        alloc=rng.integers(5, 50, (c, r)) * mult,
        used=rng.integers(0, 40, (c, r)) * mult,
        score_enabled=mask(0.8, (b, 5)),
        taint_counts=rng.integers(0, 4, (b, c)).astype(np.int32),
        affinity_scores=rng.integers(0, 60, (b, c)).astype(np.int32),
        webhook_ok=mask(0.85) if webhook else np.ones((b, c), bool),
        webhook_scores=(rng.integers(-50, 200, (b, c)) if webhook
                        else np.zeros((b, c), np.int64)).astype(np.int32),
        max_clusters=np.where(
            roll < 0.25, rng.integers(0, c + 2, b), np.where(roll < 0.3, -1, INF)
        ).astype(np.int32),
        mode_divide=mask(0.7, (b,)),
        sticky=mask(0.15, (b,)),
        current_mask=current_mask,
        current_replicas=current_replicas,
        total=rng.integers(0, 30, b).astype(np.int32),
        weights_given=mask(0.5, (b,)),
        weights=np.where(mask(0.8), rng.integers(0, 20, (b, c)), 0).astype(np.int32),
        min_replicas=np.where(mask(0.2), rng.integers(0, 4, (b, c)), 0).astype(np.int32),
        max_replicas=max_replicas,
        scale_max=max_replicas.copy(),
        capacity=np.where(mask(0.2), rng.integers(0, 8, (b, c)), INF).astype(np.int32),
        keep_unschedulable=mask(0.5, (b,)),
        avoid_disruption=mask(0.5, (b,)),
        tiebreak=rng.integers(-(2**31), 2**31 - 1, (b, c)).astype(np.int32),
        cpu_alloc=rng.integers(0, 30, c).astype(np.int64),
        cpu_avail=rng.integers(-3, 25, c).astype(np.int64),
        cluster_valid=valid,
    )


TAINT_WRAP = 21_474_836  # past it, 100 * count wraps in int32

# (b, c, r, share of invalid interior columns, seed) for edge_tick_inputs:
# C off the phase-1 kernel's four-cell quads and 16-byte accesses (33,
# 200, 1300, 7001, 14003, 1), B off its rows per block (13, 333, 5, 3, 7),
# C wide enough for its one-row (7001) and no-shared-state (14003)
# layouts, and the main path's C = 5120.  The CPU tests hold the plain
# version against JAX on the first five; the card holds the kernel
# against the plain version on all.
EDGE_SHAPES = (
    (13, 33, 3, 0.0, 0),
    (13, 200, 2, 0.05, 1),
    (6, 1300, 4, 0.05, 2),
    (333, 33, 3, 0.05, 3),
    (24, 200, 3, 0.0, 4),
    (64, 5120, 3, 0.05, 5),
    (5, 7001, 3, 0.0, 6),
    (3, 14003, 4, 0.05, 7),
    (7, 1, 2, 0.0, 8),
)


def edge_tick_inputs(b, c, r=3, invalid=0.05, seed=0):
    """``random_tick_inputs`` with the phase-1 kernel's edges drawn in:

    * byte-scale resources (the balanced score's range shift);
    * rows whose taint counts reach 2**31 - 1, past TAINT_WRAP, where
      normalisation's 100 * count wraps in int32;
    * rows with negative, and some with int32-wide, webhook and affinity
      scores;
    * rows whose only feasible column is the last one;
    * rows that every column passes (with ``invalid`` = 0 their
      affinity maximum can be negative);
    * a ``invalid`` share of interior columns marked invalid (never the
      last one).
    """
    inp = random_tick_inputs(b, c, r, webhook=True, scale=True, seed=seed)
    rng = np.random.default_rng(seed * 104729 + b * 1000 + c + 1)
    rows = np.arange(b)
    valid = rng.random(c) >= invalid
    valid[-1] = True
    taint = inp.taint_counts.copy()
    big = rows % 3 == 0
    taint[big] = rng.integers(0, 2**31 - 1, (int(big.sum()), c), dtype=np.int64)
    taint[big, 0] = 2**31 - 1
    affinity = inp.affinity_scores.copy()
    webhook = inp.webhook_scores.copy()
    neg = rows % 3 == 1
    affinity[neg] = rng.integers(-60, 0, (int(neg.sum()), c))
    webhook[neg] = rng.integers(-500, 0, (int(neg.sum()), c))
    wide = rows % 6 == 2
    affinity[wide] = rng.integers(-(2**31), 2**31 - 1, (int(wide.sum()), c), dtype=np.int64)
    webhook[wide] = rng.integers(-(2**31), 2**31 - 1, (int(wide.sum()), c), dtype=np.int64)
    filter_enabled = inp.filter_enabled.copy()
    webhook_ok = inp.webhook_ok.copy()
    request = inp.request.copy()
    planes = {
        k: getattr(inp, k).copy()
        for k in ("api_ok", "taint_ok_new", "taint_ok_cur", "selector_ok", "placement_ok")
    }
    last = rows % 5 == 4  # only the last column passes
    webhook_ok[last] = False
    webhook_ok[last, -1] = True
    for plane in planes.values():
        plane[last, -1] = True
    request[last] = 0
    every = rows % 7 == 5  # every column passes
    filter_enabled[every] = False
    webhook_ok[every] = True
    affinity[every] = rng.integers(-60, 0, (int(every.sum()), c))
    return inp._replace(
        filter_enabled=filter_enabled,
        request=request,
        taint_counts=taint.astype(np.int32),
        affinity_scores=affinity.astype(np.int32),
        webhook_ok=webhook_ok,
        webhook_scores=webhook.astype(np.int32),
        cluster_valid=valid,
        **planes,
    )
