"""Core scheduling-facing data model.

Python equivalents of the reference API types the scheduler consumes
(reference: pkg/apis/core/v1alpha1, pkg/controllers/scheduler/framework/
types.go).  Kept deliberately lean: federated objects themselves travel as
unstructured dicts through the control plane; these typed structs cover
the scheduling contract where exact matching semantics matter.

Canonical resource units (dict key -> int):
  "cpu" -> millicores (Quantity.MilliValue), everything else ->
  Quantity.Value (bytes for memory/storage), matching the reference's
  framework.Resource extraction (framework/util.go NewResource).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Mapping, Optional, Sequence

from kubeadmiral_tpu_torch.utils.quantity import cpu_to_millis, to_int_value

# Taint effects / scheduling modes / operators mirror the k8s constants.
NO_SCHEDULE = "NoSchedule"
PREFER_NO_SCHEDULE = "PreferNoSchedule"
NO_EXECUTE = "NoExecute"

MODE_DUPLICATE = "Duplicate"
MODE_DIVIDE = "Divide"


@dataclass(frozen=True)
class Taint:
    key: str
    value: str = ""
    effect: str = NO_SCHEDULE


@dataclass(frozen=True)
class Toleration:
    """Pod/workload toleration with k8s ToleratesTaint semantics."""

    key: str = ""
    operator: str = "Equal"  # "Equal" | "Exists" ("" behaves as Equal)
    value: str = ""
    effect: str = ""  # "" tolerates every effect

    def tolerates(self, taint: Taint) -> bool:
        if self.effect and self.effect != taint.effect:
            return False
        if self.key and self.key != taint.key:
            return False
        # Empty key with Exists tolerates all taints.
        if self.operator == "Exists":
            return self.value == ""
        return self.value == taint.value  # Equal / unset operator


@dataclass(frozen=True)
class SelectorRequirement:
    key: str
    operator: str  # In | NotIn | Exists | DoesNotExist | Gt | Lt
    values: tuple[str, ...] = ()


@dataclass(frozen=True)
class SelectorTerm:
    """ANDed requirements over labels plus fields (metadata.name)."""

    match_expressions: tuple[SelectorRequirement, ...] = ()
    match_fields: tuple[SelectorRequirement, ...] = ()


@dataclass(frozen=True)
class PreferredSchedulingTerm:
    weight: int
    preference: SelectorTerm


@dataclass(frozen=True)
class ClusterAffinity:
    """required=None means "matches everything" (no constraint); an empty
    tuple matches nothing (reference: cluster_affinity.go:69-93)."""

    required: Optional[tuple[SelectorTerm, ...]] = None
    preferred: tuple[PreferredSchedulingTerm, ...] = ()


def parse_resources(raw: Mapping[str, "str | int | float"]) -> dict[str, int]:
    """Quantity strings -> canonical ints (cpu in millis, rest in units)."""
    out: dict[str, int] = {}
    for name, q in raw.items():
        out[name] = cpu_to_millis(q) if name == "cpu" else to_int_value(q)
    return out


@dataclass
class ClusterState:
    """Scheduling-relevant view of a member cluster
    (reference: types_federatedcluster.go FederatedCluster + status)."""

    name: str
    labels: dict[str, str] = field(default_factory=dict)
    taints: tuple[Taint, ...] = ()
    allocatable: dict[str, int] = field(default_factory=dict)  # canonical units
    available: dict[str, int] = field(default_factory=dict)
    api_resources: frozenset[str] = frozenset()  # "group/version/Kind"


@dataclass
class AutoMigrationSpec:
    keep_unschedulable_replicas: bool = False
    estimated_capacity: dict[str, int] = field(default_factory=dict)


@dataclass(frozen=True)
class SchedulingUnit:
    """The per-object scheduling request
    (reference: framework/types.go:34-73).

    Frozen: the engine's cross-tick caches use object identity as a
    fast-path for "unchanged since last tick", so a unit must never be
    modified after construction — including its nested dicts.  Derive
    changed units with ``dataclasses.replace`` and fresh dict values
    (which is what the controllers do: each reconcile builds new units
    from the API objects)."""

    gvk: str  # "group/version/Kind"
    namespace: str
    name: str
    labels: dict[str, str] = field(default_factory=dict)
    annotations: dict[str, str] = field(default_factory=dict)

    desired_replicas: Optional[int] = None
    resource_request: dict[str, int] = field(default_factory=dict)

    current_clusters: dict[str, Optional[int]] = field(default_factory=dict)
    auto_migration: Optional[AutoMigrationSpec] = None

    scheduling_mode: str = MODE_DUPLICATE
    sticky_cluster: bool = False
    avoid_disruption: bool = True

    cluster_selector: dict[str, str] = field(default_factory=dict)
    cluster_names: frozenset[str] = frozenset()  # explicit placement list
    affinity: Optional[ClusterAffinity] = None
    tolerations: tuple[Toleration, ...] = ()
    max_clusters: Optional[int] = None
    min_replicas: dict[str, int] = field(default_factory=dict)
    max_replicas: dict[str, int] = field(default_factory=dict)
    weights: dict[str, int] = field(default_factory=dict)

    # Enabled plugin names per extension point (None = defaults).  Names
    # that aren't in-tree refer to registered webhook plugins.
    enabled_filters: Optional[tuple[str, ...]] = None
    enabled_scores: Optional[tuple[str, ...]] = None
    enabled_selects: Optional[tuple[str, ...]] = None

    @property
    def key(self) -> str:
        return f"{self.namespace}/{self.name}" if self.namespace else self.name


# In-tree plugin names (reference: framework/plugins/names/names.go).
APIRESOURCES = "APIResources"
TAINT_TOLERATION = "TaintToleration"
CLUSTER_RESOURCES_FIT = "ClusterResourcesFit"
PLACEMENT_FILTER = "PlacementFilter"
CLUSTER_AFFINITY = "ClusterAffinity"
CLUSTER_RESOURCES_BALANCED = "ClusterResourcesBalancedAllocation"
CLUSTER_RESOURCES_LEAST = "ClusterResourcesLeastAllocated"
CLUSTER_RESOURCES_MOST = "ClusterResourcesMostAllocated"
MAX_CLUSTER = "MaxCluster"
CLUSTER_CAPACITY_WEIGHT = "ClusterCapacityWeight"

# Default enabled plugins (reference: extensions_schedulingprofile.go:24-49).
DEFAULT_FILTERS: tuple[str, ...] = (
    APIRESOURCES,
    TAINT_TOLERATION,
    CLUSTER_RESOURCES_FIT,
    PLACEMENT_FILTER,
    CLUSTER_AFFINITY,
)
DEFAULT_SCORES: tuple[str, ...] = (
    TAINT_TOLERATION,
    CLUSTER_RESOURCES_BALANCED,
    CLUSTER_RESOURCES_LEAST,
    CLUSTER_AFFINITY,
)
