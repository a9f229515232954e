"""PropagationPolicy / ClusterPropagationPolicy parsing.

A copy of ``kubeadmiral_tpu/models/policy.py`` for the port's control
plane.

Unstructured policy dicts -> typed scheduling directives
(reference: pkg/apis/core/v1alpha1/types_propagationpolicy.go:62-189),
plus the policy->SchedulingUnit projection used by the scheduler
controller (reference: pkg/controllers/scheduler/schedulingunit.go).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

from kubeadmiral_tpu_torch.models.types import (
    ClusterAffinity,
    MODE_DUPLICATE,
    PreferredSchedulingTerm,
    SelectorRequirement,
    SelectorTerm,
    Toleration,
)

PROPAGATION_POLICY_LABEL = "kubeadmiral.io/propagation-policy-name"
CLUSTER_PROPAGATION_POLICY_LABEL = "kubeadmiral.io/cluster-propagation-policy-name"

PROPAGATION_POLICIES = "core.kubeadmiral.io/v1alpha1/propagationpolicies"
CLUSTER_PROPAGATION_POLICIES = "core.kubeadmiral.io/v1alpha1/clusterpropagationpolicies"
OVERRIDE_POLICIES = "core.kubeadmiral.io/v1alpha1/overridepolicies"
CLUSTER_OVERRIDE_POLICIES = "core.kubeadmiral.io/v1alpha1/clusteroverridepolicies"
SCHEDULING_PROFILES = "core.kubeadmiral.io/v1alpha1/schedulingprofiles"


def parse_selector_requirement(raw: dict) -> SelectorRequirement:
    return SelectorRequirement(
        key=raw.get("key", ""),
        operator=raw.get("operator", "In"),
        values=tuple(raw.get("values", ())),
    )


def parse_selector_term(raw: dict) -> SelectorTerm:
    return SelectorTerm(
        match_expressions=tuple(
            parse_selector_requirement(r) for r in raw.get("matchExpressions", ())
        ),
        match_fields=tuple(
            parse_selector_requirement(r) for r in raw.get("matchFields", ())
        ),
    )


def parse_toleration(raw: dict) -> Toleration:
    return Toleration(
        key=raw.get("key", ""),
        operator=raw.get("operator", "Equal"),
        value=raw.get("value", ""),
        effect=raw.get("effect", ""),
    )


@dataclass
class PolicySpec:
    name: str
    namespace: str = ""
    generation: int = 1
    scheduling_profile: str = ""
    scheduling_mode: str = MODE_DUPLICATE
    sticky_cluster: bool = False
    cluster_selector: dict[str, str] = field(default_factory=dict)
    cluster_affinity: tuple[SelectorTerm, ...] = ()
    tolerations: tuple[Toleration, ...] = ()
    max_clusters: Optional[int] = None
    placements: list[dict] = field(default_factory=list)
    disable_follower_scheduling: bool = False
    auto_migration_enabled: bool = False
    keep_unschedulable_replicas: bool = False
    pod_unschedulable_seconds: Optional[float] = None
    avoid_disruption: bool = True

    @property
    def cluster_names(self) -> frozenset[str]:
        return frozenset(p["cluster"] for p in self.placements)

    def min_replicas(self) -> dict[str, int]:
        out = {}
        for p in self.placements:
            v = p.get("preferences", {}).get("minReplicas")
            if v is not None:
                out[p["cluster"]] = int(v)
        return out

    def max_replicas(self) -> dict[str, int]:
        out = {}
        for p in self.placements:
            v = p.get("preferences", {}).get("maxReplicas")
            if v is not None:
                out[p["cluster"]] = int(v)
        return out

    def weights(self) -> dict[str, int]:
        out = {}
        for p in self.placements:
            v = p.get("preferences", {}).get("weight")
            if v is not None:
                out[p["cluster"]] = int(v)
        return out

    def affinity(self) -> Optional[ClusterAffinity]:
        """The scheduler treats policy clusterAffinity terms as the
        required affinity (schedulingunit.go getAffinityFromPolicy)."""
        if not self.cluster_affinity:
            return None
        return ClusterAffinity(required=self.cluster_affinity)


def _parse_duration(raw: Optional[str]) -> Optional[float]:
    if not raw:
        return None
    units = {"ms": 0.001, "s": 1.0, "m": 60.0, "h": 3600.0}
    total, num = 0.0, ""
    i = 0
    while i < len(raw):
        ch = raw[i]
        if ch.isdigit() or ch == ".":
            num += ch
            i += 1
            continue
        for u in ("ms", "s", "m", "h"):
            if raw.startswith(u, i) and (u != "m" or not raw.startswith("ms", i)):
                total += float(num) * units[u]
                num = ""
                i += len(u)
                break
        else:
            raise ValueError(f"invalid duration {raw!r}")
    if num:
        total += float(num)
    return total


def parse_policy(obj: dict) -> PolicySpec:
    meta_ = obj.get("metadata", {})
    spec = obj.get("spec", {})
    auto = spec.get("autoMigration")
    resched = spec.get("replicaRescheduling")
    return PolicySpec(
        name=meta_.get("name", ""),
        namespace=meta_.get("namespace", ""),
        generation=meta_.get("generation", 1),
        scheduling_profile=spec.get("schedulingProfile", ""),
        scheduling_mode=spec.get("schedulingMode", MODE_DUPLICATE),
        sticky_cluster=spec.get("stickyCluster", False),
        cluster_selector=dict(spec.get("clusterSelector", {})),
        cluster_affinity=tuple(
            parse_selector_term(t) for t in spec.get("clusterAffinity", ())
        ),
        tolerations=tuple(parse_toleration(t) for t in spec.get("tolerations", ())),
        max_clusters=spec.get("maxClusters"),
        placements=list(spec.get("placement", ())),
        disable_follower_scheduling=spec.get("disableFollowerScheduling", False),
        auto_migration_enabled=auto is not None,
        keep_unschedulable_replicas=bool(auto and auto.get("keepUnschedulableReplicas")),
        pod_unschedulable_seconds=_parse_duration(
            (auto or {}).get("when", {}).get("podUnschedulableFor")
        ),
        avoid_disruption=resched.get("avoidDisruption", True)
        if resched is not None
        else True,
    )


def matched_policy_key(fed_obj: dict) -> Optional[tuple[str, str]]:
    """(namespace, name) of the matched policy; namespace "" means a
    ClusterPropagationPolicy (reference: scheduler/util.go:37-50)."""
    labels = fed_obj.get("metadata", {}).get("labels", {})
    ns = fed_obj.get("metadata", {}).get("namespace", "")
    if PROPAGATION_POLICY_LABEL in labels and ns:
        return (ns, labels[PROPAGATION_POLICY_LABEL])
    if CLUSTER_PROPAGATION_POLICY_LABEL in labels:
        return ("", labels[CLUSTER_PROPAGATION_POLICY_LABEL])
    return None
