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
