"""Reason-code vocabulary for scheduling decisions.

Every (object, cluster) pair a tick rejects carries a bitmask saying
WHY — one bit per filter plugin (matching the ``ops.filters`` plugin
indices: bit i is filter plugin i), plus the host-side webhook filter,
the padded-cluster sentinel, and the select/replica-stage cuts.  A
selected pair carries mask 0.  The mask is computed on device inside
``ops.pipeline.schedule_tick`` (TickOutputs.reasons); the filter bits
come out of ``ops.phase1``.  A copy of ``kubeadmiral_tpu/ops/reasons.py``
(same bits, same operator-facing slugs).
"""

from __future__ import annotations

from kubeadmiral_tpu_torch.ops import filters as F

# -- filter-stage bits (bit i == ops.filters plugin index i) -------------
REASON_API_RESOURCES = 1 << F.F_API_RESOURCES      # 1
REASON_TAINT_TOLERATION = 1 << F.F_TAINT_TOLERATION  # 2
REASON_RESOURCES_FIT = 1 << F.F_RESOURCES_FIT      # 4
REASON_PLACEMENT = 1 << F.F_PLACEMENT              # 8
REASON_CLUSTER_AFFINITY = 1 << F.F_CLUSTER_AFFINITY  # 16
# Host-side (out-of-process) webhook filter plugins, AND-ed into the
# feasibility mask by the tick.
REASON_WEBHOOK_FILTER = 1 << 5
# Padded / invalid cluster slot (cluster_valid == False).  Engine
# consumers never see it (they slice to the real cluster count); it
# keeps the invariant "not selected => nonzero mask" on padded slots.
REASON_CLUSTER_INVALID = 1 << 6

# -- select / replica-stage bits -----------------------------------------
# Feasible but cut by the MaxCluster top-K (score rank >= K, including
# K == 0 for a negative maxClusters).
REASON_MAX_CLUSTERS = 1 << 7
# Selected by top-K but the replica planner assigned 0 replicas, so the
# Divide-mode merge dropped the placement (rsp.go drops zero entries).
REASON_ZERO_REPLICAS = 1 << 8
# Dropped by the sticky-cluster short-circuit: the object is stickily
# placed, so plugins never ran for real and only the current clusters
# survive (generic_scheduler.go:103-107).
REASON_STICKY = 1 << 9

# Bits that make a pair infeasible (filter stage, before select).
FILTER_REASON_MASK = (
    REASON_API_RESOURCES
    | REASON_TAINT_TOLERATION
    | REASON_RESOURCES_FIT
    | REASON_PLACEMENT
    | REASON_CLUSTER_AFFINITY
    | REASON_WEBHOOK_FILTER
    | REASON_CLUSTER_INVALID
)
SELECT_REASON_MASK = REASON_MAX_CLUSTERS | REASON_ZERO_REPLICAS | REASON_STICKY
ALL_REASON_MASK = FILTER_REASON_MASK | SELECT_REASON_MASK

# Canonical bit order (ascending bit value) — the column order of the
# packed export's per-row reason-summary counts (ops/pipeline.pack_rows)
# and of DecisionRecord.reason_counts in the flight recorder.
REASON_BITS: tuple[int, ...] = (
    REASON_API_RESOURCES,
    REASON_TAINT_TOLERATION,
    REASON_RESOURCES_FIT,
    REASON_PLACEMENT,
    REASON_CLUSTER_AFFINITY,
    REASON_WEBHOOK_FILTER,
    REASON_CLUSTER_INVALID,
    REASON_MAX_CLUSTERS,
    REASON_ZERO_REPLICAS,
    REASON_STICKY,
)
NUM_REASON_BITS = len(REASON_BITS)

# bit value -> operator-facing slug (the decision vocabulary).
REASON_NAMES: dict[int, str] = {
    REASON_API_RESOURCES: "api_resources",
    REASON_TAINT_TOLERATION: "taint_toleration",
    REASON_RESOURCES_FIT: "resources_fit",
    REASON_PLACEMENT: "placement",
    REASON_CLUSTER_AFFINITY: "cluster_affinity",
    REASON_WEBHOOK_FILTER: "webhook_filter",
    REASON_CLUSTER_INVALID: "cluster_invalid",
    REASON_MAX_CLUSTERS: "max_clusters",
    REASON_ZERO_REPLICAS: "zero_replicas",
    REASON_STICKY: "sticky_cluster",
}

# The packed column order must cover exactly the named bits, ascending.
assert REASON_BITS == tuple(sorted(REASON_NAMES))


def describe(mask: int) -> list[str]:
    """Bitmask -> list of reason slugs, lowest bit first."""
    return [name for bit, name in REASON_NAMES.items() if mask & bit]


def is_feasible(mask: int) -> bool:
    """A pair is feasible iff no filter-stage bit is set (it may still
    be unselected via a select-stage cut)."""
    return not (mask & FILTER_REASON_MASK)
