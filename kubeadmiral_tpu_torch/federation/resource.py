"""FederatedResource: the sync controller's view of one federated object.

A copy of ``kubeadmiral_tpu/federation/resource.py`` for the port's control
plane.

Wraps the unstructured federated object + its FTC into the operations
propagation needs: compute placement, derive the per-cluster desired
object from the template, apply overrides, and produce the template/
override hashes that key the version map (reference:
pkg/controllers/sync/resource.go:55-473, accessor.go:40-236).
"""

from __future__ import annotations

import json
from typing import Optional

from kubeadmiral_tpu_torch.federation import common as C
from kubeadmiral_tpu_torch.federation.retain import CURRENT_REVISION_ANNOTATION
from kubeadmiral_tpu_torch.models.ftc import FederatedTypeConfig
from kubeadmiral_tpu_torch.utils.hashing import stable_json_hash
from kubeadmiral_tpu_torch.utils.jsonpatch import apply_patch
from kubeadmiral_tpu_torch.utils.unstructured import copy_json, delete_path, get_path

# Finalizer protecting terminating Jobs/Pods from premature GC
# (reference: dispatch/retain_terminating.go RetainTerminatingObjectFinalizer).
RETAIN_TERMINATING_FINALIZER = C.PREFIX + "retain-terminating-object"


class FederatedResource:
    """One federated object + type config (resource.go:55-90)."""

    def __init__(self, fed_obj: dict, ftc: FederatedTypeConfig):
        self.obj = fed_obj
        self.ftc = ftc
        self._overrides_by_cluster: Optional[dict[str, list]] = None
        # Version-hash memos: one reconcile computes each hash at plan
        # time AND at finish time, and spec.template/spec.overrides are
        # immutable for this wrapper's lifetime (reconcile mutates only
        # metadata/status).
        self._template_version: Optional[str] = None
        self._override_version: Optional[str] = None

    # -- identity --------------------------------------------------------
    @property
    def name(self) -> str:
        return self.obj["metadata"]["name"]

    @property
    def namespace(self) -> str:
        return self.obj["metadata"].get("namespace", "")

    @property
    def key(self) -> str:
        return f"{self.namespace}/{self.name}" if self.namespace else self.name

    @property
    def target_kind(self) -> str:
        return self.ftc.source.kind

    # -- placement -------------------------------------------------------
    def compute_placement(self, joined_clusters) -> set[str]:
        """Union of placements across controllers ∩ joined clusters
        (resource.go ComputePlacement + placement.go union).  Accepts a
        prebuilt set to keep per-object work off the O(fleet) path."""
        placed = C.all_placement_clusters(self.obj)
        if not isinstance(joined_clusters, (set, frozenset)):
            joined_clusters = set(joined_clusters)
        return placed & joined_clusters

    # -- per-cluster desired object --------------------------------------
    def object_for_cluster(self, cluster: str) -> dict:
        """Template -> member-cluster object (resource.go:182-262):
        name/namespace/kind stamped from the federated object, finalizers
        stripped (member controllers own them), source-generation
        annotation added, kind-specific field drops applied."""
        obj = copy_json(C.template(self.obj)) or {}
        meta = obj.setdefault("metadata", {})
        meta.pop("finalizers", None)
        meta["name"] = self.name
        if self.namespace:
            meta["namespace"] = self.namespace
        obj["kind"] = self.target_kind
        obj.setdefault("apiVersion", self.ftc.source.api_version)

        ann = meta.setdefault("annotations", {})
        ann[C.SOURCE_GENERATION] = str(
            self.obj["metadata"].get("generation", 1)
        )
        meta.pop("generation", None)
        meta.pop("resourceVersion", None)

        revision = self.obj["metadata"].get("annotations", {}).get(
            CURRENT_REVISION_ANNOTATION
        )
        if revision is not None:
            ann[CURRENT_REVISION_ANNOTATION] = revision

        kind = self.target_kind
        if kind == "Job":
            self._drop_job_fields(obj)
            self._add_retain_finalizer(obj)
        elif kind == "Service":
            self._drop_service_fields(obj)
        elif kind == "Pod":
            delete_path(obj, "spec.ephemeralContainers")
            self._add_retain_finalizer(obj)
        return obj

    @staticmethod
    def _drop_job_fields(obj: dict) -> None:
        """Drop the generated controller-uid selector unless manualSelector
        (resource.go:272-284)."""
        if get_path(obj, "spec.manualSelector") is True:
            return
        labels = get_path(obj, "spec.template.metadata.labels")
        if isinstance(labels, dict):
            labels.pop("controller-uid", None)
        match = get_path(obj, "spec.selector.matchLabels")
        if isinstance(match, dict):
            match.pop("controller-uid", None)

    @staticmethod
    def _drop_service_fields(obj: dict) -> None:
        """Drop host-allocated clusterIP unless headless (resource.go:286-296)."""
        cluster_ip = get_path(obj, "spec.clusterIP")
        if cluster_ip is not None and cluster_ip != "None":
            delete_path(obj, "spec.clusterIP")
            delete_path(obj, "spec.clusterIPs")

    @staticmethod
    def _add_retain_finalizer(obj: dict) -> None:
        meta = obj.setdefault("metadata", {})
        fins = meta.setdefault("finalizers", [])
        if RETAIN_TERMINATING_FINALIZER not in fins:
            fins.append(RETAIN_TERMINATING_FINALIZER)

    # -- overrides -------------------------------------------------------
    def _ordered_overrides(self) -> dict[str, list]:
        """cluster -> concatenated patches ordered by the FTC's controller
        pipeline, unknown controllers last in spec order
        (resource.go:336-390 overridesForCluster)."""
        if self._overrides_by_cluster is not None:
            return self._overrides_by_cluster
        order: dict[str, int] = {}
        for group in self.ftc.controllers:
            for controller in group:
                order[controller] = len(order)
        entries = list(self.obj.get("spec", {}).get("overrides", []))
        entries.sort(
            key=lambda e: (
                order.get(e.get("controller"), len(order)),
                e.get("controller", ""),
            )
        )
        out: dict[str, list] = {}
        for entry in entries:
            for clause in entry.get("clusters", []):
                out.setdefault(clause.get("cluster"), []).extend(
                    clause.get("patches", [])
                )
        self._overrides_by_cluster = out
        return out

    def apply_overrides(
        self, obj: dict, cluster: str, extra_patches: Optional[list] = None
    ) -> dict:
        """JSONPatch overrides + managed label (resource.go:305-334); the
        managed label lands even when no override matched."""
        patches = self._ordered_overrides().get(cluster)
        if patches:
            obj = apply_patch(obj, patches)
        if extra_patches:
            obj = apply_patch(obj, extra_patches)
        obj.setdefault("metadata", {}).setdefault("labels", {})[
            C.MANAGED_LABEL
        ] = C.MANAGED_TRUE
        return obj

    def replicas_override_for_cluster(self, cluster: str) -> int:
        """The replicas this cluster is scheduled for: the last
        /spec/replicas override patch, else the template's replicas
        (resource.go:392-416 ReplicasOverrideForCluster)."""
        replicas_path = "/" + self.ftc.path.replicas_spec.replace(".", "/") if (
            self.ftc.path.replicas_spec
        ) else "/spec/replicas"
        value = None
        for patch in self._ordered_overrides().get(cluster, ()):
            if patch.get("path") == replicas_path and patch.get("value") is not None:
                value = patch["value"]
        if value is not None:
            return int(value)
        template = self.obj.get("spec", {}).get("template", {})
        return int(get_path(template, self.ftc.path.replicas_spec, 0) or 0)

    def total_replicas(self, clusters) -> int:
        """(resource.go:417-427 TotalReplicas)"""
        return sum(self.replicas_override_for_cluster(c) for c in clusters)

    # -- version hashes --------------------------------------------------
    def template_version(self) -> str:
        """Hash of the template (resource.go TemplateVersion via
        GetTemplateHash)."""
        if self._template_version is None:
            self._template_version = f"{stable_json_hash(C.template(self.obj)):08x}"
        return self._template_version

    def override_version(self) -> str:
        if self._override_version is None:
            self._override_version = (
                f"{stable_json_hash(self.obj.get('spec', {}).get('overrides', [])):08x}"
            )
        return self._override_version


def should_adopt_preexisting(fed_obj: dict) -> bool:
    """conflict-resolution annotation == adopt, internal variant winning
    (util.ShouldAdoptPreexistingResources)."""
    ann = fed_obj.get("metadata", {}).get("annotations", {})
    value = ann.get(C.CONFLICT_RESOLUTION_INTERNAL, ann.get(C.CONFLICT_RESOLUTION, ""))
    return value == "adopt"


def orphaning_behavior(fed_obj: dict) -> str:
    """'' | 'all' | 'adopted', internal variant winning
    (util.GetOrphaningBehavior)."""
    ann = fed_obj.get("metadata", {}).get("annotations", {})
    value = ann.get(C.ORPHAN_MODE_INTERNAL, ann.get(C.ORPHAN_MODE, ""))
    return value if value in ("all", "adopted") else ""


def object_version(cluster_obj: dict) -> str:
    """Generation-preferring version stamp of a member object
    (reference: util/propagatedversion.go:43-49)."""
    gen = cluster_obj.get("metadata", {}).get("generation", 0)
    if gen:
        return f"gen:{gen}"
    return f"rv:{cluster_obj.get('metadata', {}).get('resourceVersion', '')}"


def object_needs_update(
    desired: dict, cluster_obj: dict, recorded_version: str, replicas_path: str
) -> bool:
    """Skip-update check (util/propagatedversion.go:54-110): the recorded
    version must match the observed object AND the fields this controller
    rewrites out-of-band (replicas, rollout maxSurge/maxUnavailable) must
    already agree."""
    if recorded_version != object_version(cluster_obj):
        return True
    if replicas_path:
        if get_path(desired, replicas_path) != get_path(cluster_obj, replicas_path):
            return True
    for p in (
        "spec.strategy.rollingUpdate.maxSurge",
        "spec.strategy.rollingUpdate.maxUnavailable",
    ):
        if get_path(desired, p) != get_path(cluster_obj, p):
            return True
    # Generation-sourced versions don't change on metadata-only edits, so
    # label/annotation drift (e.g. a new current-revision annotation during
    # a rollout) needs an explicit equivalence check
    # (propagatedversion.go:115-119 + meta.go ObjectMetaObjEquivalent).
    if recorded_version.startswith("gen:"):
        for field_ in ("labels", "annotations"):
            a = desired.get("metadata", {}).get(field_) or {}
            b = cluster_obj.get("metadata", {}).get(field_) or {}
            if a != b and (a or b):
                return True
    return False


def is_explicitly_unmanaged(cluster_obj: dict) -> bool:
    """managed=false opts a member object out (managedlabel.IsExplicitlyUnmanaged)."""
    return (
        cluster_obj.get("metadata", {}).get("labels", {}).get(C.MANAGED_LABEL)
        == "false"
    )


def has_managed_label(cluster_obj: dict) -> bool:
    return (
        cluster_obj.get("metadata", {}).get("labels", {}).get(C.MANAGED_LABEL)
        == C.MANAGED_TRUE
    )
