"""FederatedTypeConfig: the CRD-driven type registry.

A copy of ``kubeadmiral_tpu/models/ftc.py`` for the port's control
plane.

The FTC tells the control plane which source types are federated, what
the federated companion type is called, where replicas/status live in the
object, and which controller pipeline processes it (reference:
pkg/apis/core/v1alpha1/types_federatedtypeconfig.go:63-182).

Resource addressing convention: "<group>/<version>/<plural>" (core group
has an empty group segment collapsed, e.g. "v1/configmaps").
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional


def resource_key(group: str, version: str, plural: str) -> str:
    return f"{group}/{version}/{plural}" if group else f"{version}/{plural}"


def gvk_key(group: str, version: str, kind: str) -> str:
    return f"{group}/{version}/{kind}" if group else f"{version}/{kind}"


@dataclass(frozen=True)
class TypeRef:
    group: str
    version: str
    kind: str
    plural: str

    @property
    def resource(self) -> str:
        return resource_key(self.group, self.version, self.plural)

    @property
    def gvk(self) -> str:
        return gvk_key(self.group, self.version, self.kind)

    @property
    def api_version(self) -> str:
        return f"{self.group}/{self.version}" if self.group else self.version


@dataclass(frozen=True)
class PathDefinition:
    """Dotted paths into the source/target object
    (types_federatedtypeconfig.go:146-182)."""

    replicas_spec: str = ""
    replicas_status: str = ""
    available_replicas_status: str = ""
    ready_replicas_status: str = ""
    label_selector: str = ""


# Default controller pipeline when an FTC doesn't specify one.
DEFAULT_PIPELINE: tuple[tuple[str, ...], ...] = (
    ("kubeadmiral.io/global-scheduler",),
    ("kubeadmiral.io/overridepolicy-controller",),
)


@dataclass(frozen=True)
class FederatedTypeConfig:
    name: str
    source: TypeRef
    federated: TypeRef
    status: Optional[TypeRef] = None
    path: PathDefinition = PathDefinition()
    # Ordered controller pipeline groups (spec.controllers).
    controllers: tuple[tuple[str, ...], ...] = DEFAULT_PIPELINE
    status_collection: bool = False
    # Dotted paths collected from member objects into the status CR
    # (types_federatedtypeconfig.go StatusCollection.Fields).
    status_collection_fields: tuple[str, ...] = ("status",)
    status_aggregation: bool = False
    revision_history: bool = False
    rollout_plan: bool = False
    auto_migration: bool = False
    namespaced: bool = True  # target scope (drives PropagatedVersion kind)

    @property
    def controller_groups(self) -> list[list[str]]:
        return [list(g) for g in self.controllers]


FEDERATED_TYPE_CONFIGS = "core.kubeadmiral.io/v1alpha1/federatedtypeconfigs"


def _parse_type_ref(raw: dict) -> TypeRef:
    return TypeRef(
        group=raw.get("group", ""),
        version=raw.get("version", ""),
        kind=raw.get("kind", ""),
        plural=raw.get("pluralName", raw.get("plural", "")),
    )


def _type_ref_to_raw(ref: TypeRef) -> dict:
    raw = {"version": ref.version, "kind": ref.kind, "pluralName": ref.plural}
    if ref.group:
        raw["group"] = ref.group
    return raw


def parse_ftc(obj: dict) -> FederatedTypeConfig:
    """Unstructured FederatedTypeConfig -> typed registry entry
    (types_federatedtypeconfig.go:63-182).  This is what makes the type
    registry CRD-driven: the manager watches these objects and starts the
    per-type controllers from them."""
    spec = obj.get("spec", {})
    source_raw = spec.get("sourceType") or {}
    source = _parse_type_ref(source_raw)
    federated = (
        _parse_type_ref(spec["federatedType"])
        if spec.get("federatedType")
        else federated_ref(source)
    )
    status = _parse_type_ref(spec["statusType"]) if spec.get("statusType") else None
    path_raw = spec.get("pathDefinition") or {}

    # Absent controllers -> default pipeline; an explicit [] stays empty
    # ("no pipeline controllers" is expressible, e.g. sync-only types).
    if "controllers" in spec and spec["controllers"] is not None:
        controllers = tuple(
            tuple(group) for group in spec["controllers"] if group
        )
    else:
        controllers = DEFAULT_PIPELINE

    def feature(raw) -> tuple[bool, dict]:
        """Normalize a toggle that may be bool, "Enabled", null or an
        object with an ``enabled`` field."""
        if isinstance(raw, dict):
            return bool(raw.get("enabled", False)), raw
        return raw in ("Enabled", True), {}

    status_collection, sc_raw = feature(spec.get("statusCollection"))
    auto_migration, _ = feature(spec.get("autoMigration"))

    return FederatedTypeConfig(
        name=obj["metadata"]["name"],
        source=source,
        federated=federated,
        status=status,
        path=PathDefinition(
            replicas_spec=path_raw.get("replicasSpec", ""),
            replicas_status=path_raw.get("replicasStatus", ""),
            available_replicas_status=path_raw.get("availableReplicasStatus", ""),
            ready_replicas_status=path_raw.get("readyReplicasStatus", ""),
            label_selector=path_raw.get("labelSelector", ""),
        ),
        controllers=controllers,
        status_collection=status_collection,
        status_collection_fields=tuple(sc_raw.get("fields") or ("status",)),
        status_aggregation=spec.get("statusAggregation", "") in ("Enabled", True),
        revision_history=spec.get("revisionHistory", "") in ("Enabled", True),
        rollout_plan=spec.get("rolloutPlan", "") in ("Enabled", True),
        auto_migration=auto_migration,
        namespaced=source_raw.get("scope", "Namespaced") != "Cluster",
    )


def ftc_to_object(ftc: FederatedTypeConfig) -> dict:
    """Typed registry entry -> unstructured FederatedTypeConfig object."""
    spec: dict = {
        "sourceType": {
            **_type_ref_to_raw(ftc.source),
            "scope": "Namespaced" if ftc.namespaced else "Cluster",
        },
        "federatedType": _type_ref_to_raw(ftc.federated),
        "controllers": [list(g) for g in ftc.controllers],
    }
    if ftc.status is not None:
        spec["statusType"] = _type_ref_to_raw(ftc.status)
    path = {
        k: v
        for k, v in (
            ("replicasSpec", ftc.path.replicas_spec),
            ("replicasStatus", ftc.path.replicas_status),
            ("availableReplicasStatus", ftc.path.available_replicas_status),
            ("readyReplicasStatus", ftc.path.ready_replicas_status),
            ("labelSelector", ftc.path.label_selector),
        )
        if v
    }
    if path:
        spec["pathDefinition"] = path
    if ftc.status_collection:
        spec["statusCollection"] = {
            "enabled": True,
            "fields": list(ftc.status_collection_fields),
        }
    if ftc.status_aggregation:
        spec["statusAggregation"] = "Enabled"
    if ftc.revision_history:
        spec["revisionHistory"] = "Enabled"
    if ftc.rollout_plan:
        spec["rolloutPlan"] = "Enabled"
    if ftc.auto_migration:
        spec["autoMigration"] = {"enabled": True}
    return {
        "apiVersion": "core.kubeadmiral.io/v1alpha1",
        "kind": "FederatedTypeConfig",
        "metadata": {"name": ftc.name},
        "spec": spec,
    }


def federated_ref(source: TypeRef) -> TypeRef:
    """Default federated companion naming: FederatedX in the kubeadmiral
    types group."""
    return TypeRef(
        group="types.kubeadmiral.io",
        version="v1alpha1",
        kind=f"Federated{source.kind}",
        plural=f"federated{source.plural}",
    )


def status_ref(source: TypeRef) -> TypeRef:
    """Default status-CR naming: FederatedXStatus in the kubeadmiral types
    group (types_federatedtypeconfig.go StatusType)."""
    return TypeRef(
        group="types.kubeadmiral.io",
        version="v1alpha1",
        kind=f"Federated{source.kind}Status",
        plural=f"federated{source.plural}statuses",
    )


def make_ftc(
    name: str,
    group: str,
    version: str,
    kind: str,
    plural: str,
    **kw,
) -> FederatedTypeConfig:
    src = TypeRef(group, version, kind, plural)
    if kw.get("status_collection") and "status" not in kw:
        kw["status"] = status_ref(src)
    return FederatedTypeConfig(
        name=name, source=src, federated=federated_ref(src), **kw
    )


WORKLOAD_PATH = PathDefinition(
    replicas_spec="spec.replicas",
    replicas_status="status.replicas",
    available_replicas_status="status.availableReplicas",
    ready_replicas_status="status.readyReplicas",
    label_selector="spec.selector.matchLabels",
)


WORKLOAD_PIPELINE = (
    ("kubeadmiral.io/global-scheduler",),
    ("kubeadmiral.io/overridepolicy-controller",),
    ("kubeadmiral.io/follower-controller",),
)


def default_ftcs() -> list[FederatedTypeConfig]:
    """The full default set the reference ships — all 21 types of
    config/sample/host/01-ftc.yaml (namespaces, workloads, config/rbac/
    quota/storage types, CRDs); more are added by simply registering
    additional FTC objects.  Workload leader types run the follower
    controller after scheduling (01-ftc.yaml:94-97)."""
    return [
        make_ftc(
            "deployments.apps",
            "apps",
            "v1",
            "Deployment",
            "deployments",
            controllers=WORKLOAD_PIPELINE,
            path=WORKLOAD_PATH,
            status_collection=True,
            status_aggregation=True,
            revision_history=True,
            auto_migration=True,
        ),
        make_ftc(
            "statefulsets.apps",
            "apps",
            "v1",
            "StatefulSet",
            "statefulsets",
            controllers=WORKLOAD_PIPELINE,
            path=WORKLOAD_PATH,
            status_collection=True,
        ),
        make_ftc(
            "daemonsets.apps", "apps", "v1", "DaemonSet", "daemonsets",
            controllers=WORKLOAD_PIPELINE,
            status_collection=True,
        ),
        make_ftc("configmaps", "", "v1", "ConfigMap", "configmaps"),
        make_ftc("secrets", "", "v1", "Secret", "secrets"),
        make_ftc("services", "", "v1", "Service", "services"),
        make_ftc("serviceaccounts", "", "v1", "ServiceAccount", "serviceaccounts"),
        # Namespaces are placed by nsautoprop, not the scheduler
        # (01-ftc.yaml:23-25; running both would fight over placements).
        make_ftc(
            "namespaces", "", "v1", "Namespace", "namespaces", namespaced=False,
            controllers=(
                ("kubeadmiral.io/nsautoprop-controller",),
                ("kubeadmiral.io/overridepolicy-controller",),
            ),
        ),
        make_ftc(
            "jobs.batch", "batch", "v1", "Job", "jobs",
            controllers=WORKLOAD_PIPELINE,
            path=PathDefinition(replicas_spec="spec.parallelism"),
            status_collection=True,
        ),
        make_ftc("cronjobs.batch", "batch", "v1", "CronJob", "cronjobs",
            controllers=WORKLOAD_PIPELINE),
        make_ftc(
            "ingresses.networking.k8s.io",
            "networking.k8s.io",
            "v1",
            "Ingress",
            "ingresses",
        ),
        make_ftc(
            "persistentvolumeclaims",
            "",
            "v1",
            "PersistentVolumeClaim",
            "persistentvolumeclaims",
        ),
        make_ftc(
            "persistentvolumes", "", "v1", "PersistentVolume",
            "persistentvolumes", namespaced=False,
        ),
        make_ftc(
            "storageclasses.storage.k8s.io", "storage.k8s.io", "v1",
            "StorageClass", "storageclasses", namespaced=False,
        ),
        make_ftc(
            "roles.rbac.authorization.k8s.io",
            "rbac.authorization.k8s.io", "v1", "Role", "roles",
        ),
        make_ftc(
            "rolebindings.rbac.authorization.k8s.io",
            "rbac.authorization.k8s.io", "v1", "RoleBinding", "rolebindings",
        ),
        make_ftc(
            "clusterroles.rbac.authorization.k8s.io",
            "rbac.authorization.k8s.io", "v1", "ClusterRole", "clusterroles",
            namespaced=False,
        ),
        make_ftc(
            "clusterrolebindings.rbac.authorization.k8s.io",
            "rbac.authorization.k8s.io", "v1", "ClusterRoleBinding",
            "clusterrolebindings", namespaced=False,
        ),
        make_ftc("limitranges", "", "v1", "LimitRange", "limitranges"),
        make_ftc("resourcequotas", "", "v1", "ResourceQuota", "resourcequotas"),
        make_ftc(
            "customresourcedefinitions.apiextensions.k8s.io",
            "apiextensions.k8s.io", "v1", "CustomResourceDefinition",
            "customresourcedefinitions", namespaced=False,
        ),
    ]
