"""Select and Replicas: one row's selected clusters and replica counts.

The plain reference's second half, one object at a time over numpy
vectors of its feasible clusters.  Patterns, as of commit
5df33979f11fc4d3c609bdae8857b52774b11979:
``kubeadmiral_tpu/ops/pipeline_oracle.py`` (``_select``,
``_dynamic_weights``, ``schedule_one``), ``kubeadmiral_tpu/ops/planner_oracle.py``
(``plan``, ``_distribute``, ``_scale_up``, ``_scale_down``; upstream
``pkg/controllers/util/planner/planner.go``) and
``kubeadmiral_tpu/native/seqsched.cpp`` (cluster index as the last sort key).
Imports nothing of the program.
"""

from __future__ import annotations

import numpy as np

SUM_WEIGHT = 1000
SUPPLY_LIMIT = 1400  # rsp.go's supply limit ratio 1.4, times SUM_WEIGHT
INF = np.iinfo(np.int64).max // 4  # no capacity given


def round_half(num, den):
    """Round half away from zero of num / den, non-negative integers."""
    return (2 * num + den) // (2 * den)


def select(scores: np.ndarray, feasible: np.ndarray, max_clusters) -> np.ndarray:
    """Indices of the selected clusters: the feasible ones by (score
    desc, index asc), the first maxClusters of them."""
    idx = np.flatnonzero(feasible)
    order = np.lexsort((idx, -scores[idx]))
    ranked = idx[order]
    if max_clusters is not None:
        if max_clusters < 0:
            return ranked[:0]
        ranked = ranked[:max_clusters]
    return ranked


def dynamic_weights(sel: np.ndarray, cpu_alloc: np.ndarray, cpu_avail: np.ndarray) -> np.ndarray:
    """rsp.go's CalcWeightLimit and AvailableToPercentage over the
    selected clusters (``sel``, ascending), in exact integers; the
    rounding residual goes to the first heaviest cluster by index."""
    n = len(sel)
    alloc = cpu_alloc[sel].astype(np.int64)
    avail = np.maximum(cpu_avail[sel].astype(np.int64), 0)
    alloc_sum, avail_sum = int(alloc.sum()), int(avail.sum())
    equal = round_half(SUM_WEIGHT, n)
    limit = np.full(n, equal, np.int64) if alloc_sum == 0 else round_half(alloc * SUPPLY_LIMIT, alloc_sum)
    if avail_sum == 0:
        tmp = np.full(n, equal, np.int64)
    else:
        tmp = np.minimum(round_half(avail * SUM_WEIGHT, avail_sum), limit)
    tmp_sum = int(tmp.sum())
    if tmp_sum <= 0:
        return np.zeros(n, np.int64)
    w = round_half(tmp * SUM_WEIGHT, tmp_sum)
    top = int(w.max())
    if top > 0:
        first = int(np.argmax(w == top))
        w[first] = max(int(w[first]) + SUM_WEIGHT - int(w.sum()), 0)
    return w


def order(weights: np.ndarray, hashes: np.ndarray, index: np.ndarray) -> np.ndarray:
    """The planner's order: weight desc (non-positive as zero), the
    per-object FNV hash asc, cluster index asc."""
    return np.lexsort((index, hashes, -np.maximum(weights, 0)))


def distribute(weights, cap, total: int, keep: bool):
    """planner.go's distribution over clusters already in the planner's
    order, for records that set no minimum or maximum replicas: weighted
    rounds of ceil(D * w / sum) shares, D the remainder at the round's
    start, each capped by the running remainder and by capacity (the
    excess recorded as overflow), until nothing moves.  Without ``keep``
    the overflow is cut to what stayed unplaced.  Returns (plan,
    overflow)."""
    n = len(weights)
    out = np.zeros(n, np.int64)
    overflow = np.zeros(n, np.int64)
    remaining = int(total)
    w = np.maximum(weights, 0).astype(np.int64)
    active = np.ones(n, bool)
    moved = True
    while moved and remaining > 0:
        weight_sum = int(w[active].sum())
        if weight_sum <= 0:
            break
        idx = np.flatnonzero(active)
        start = out[idx]
        quota = (remaining * w[idx] + weight_sum - 1) // weight_sum
        # Every room is non-negative (a total never passes its cap), so
        # the running remainder before the k-th cluster is what the
        # earlier ones' capped quotas leave of D, never below zero.
        a = np.minimum(quota, cap[idx] - start)
        rem = np.maximum(remaining - (np.cumsum(a) - a), 0)
        tot = start + np.minimum(quota, rem)
        full = tot > cap[idx]
        overflow[idx] += np.maximum(tot - cap[idx], 0)
        delta = np.minimum(tot, cap[idx]) - start
        out[idx] = start + delta
        remaining -= int(delta.sum())
        moved = bool((delta > 0).any())
        active[idx[full]] = False
    if not keep:
        overflow = np.maximum(np.minimum(overflow, remaining), 0)
    return out, overflow


def plan(weights, hashes, index, cap, total: int, avoid_disruption: bool, keep_unschedulable: bool):
    """planner.go's Plan for an object with no current placement: the
    replicas per cluster (in the given clusters' order) with the
    unschedulable overflow added back.  ``hashes`` are FNV-1 of each
    cluster's name and the object's key.  With avoidDisruption the plan
    is re-derived from the current replicas, all zero here: the scale-up
    by the shortfall weights each cluster by its desired count and hands
    each exactly that; only the overflow's trim differs."""
    perm = order(weights, hashes, index)
    keep = keep_unschedulable or not avoid_disruption
    desired, overflow = distribute(weights[perm], cap[perm], total, keep)
    merged = np.zeros(len(weights), np.int64)
    merged[perm] = desired + overflow
    return merged
