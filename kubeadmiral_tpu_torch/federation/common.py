"""Shared constants and federated-object accessors.

A copy of ``kubeadmiral_tpu/federation/common.py`` for the port's control
plane.

Federated objects are unstructured dicts:

    apiVersion: types.kubeadmiral.io/v1alpha1
    kind: FederatedDeployment
    metadata: {name, namespace, labels, annotations, finalizers}
    spec:
      template: <full source object, pruned>
      placements: [{controller, placement: [{cluster}]}]
      overrides:  [{controller, clusters: [{cluster, patches: [RFC6902]}]}]
      follows:    [{group, kind, namespace, name}]
    status:
      clusters: [{cluster, status}]
      conditions: [...]

mirroring the reference's federated types (reference:
pkg/apis/types/v1alpha1/types_federateddeployment.go:28-63,
types_placements.go, types_overrides.go, types_status.go).
"""

from __future__ import annotations

import contextlib
import threading
from typing import Optional

PREFIX = "kubeadmiral.io/"

MANAGED_LABEL = PREFIX + "managed"
MANAGED_TRUE = "true"

# Annotations.
FEDERATED_OBJECT = PREFIX + "federated-object"  # marks federate-created objects
SCHEDULING_TRIGGER_HASH = PREFIX + "scheduling-trigger-hash"
PROPAGATION_POLICY_NAME = PREFIX + "propagation-policy-name"
CLUSTER_PROPAGATION_POLICY_NAME = PREFIX + "cluster-propagation-policy-name"
FOLLOWS_OBJECT = PREFIX + "follows-object"
DISABLE_FOLLOWING = PREFIX + "disable-following"
AUTO_MIGRATION_INFO = PREFIX + "auto-migration-info"
UNSCHEDULABLE_THRESHOLD = PREFIX + "auto-migration-unschedulable-threshold"
SOURCE_GENERATION = PREFIX + "source-generation"
CONFLICT_RESOLUTION = PREFIX + "conflict-resolution"  # adopt | abort
ORPHAN_MODE = PREFIX + "orphan"  # all | adopted
# Internal variants set by controllers (not copied from the source object;
# they win over the user-facing annotation — reference:
# util/conflictresolutionannotation.go, util/orphaningannotation.go).
CONFLICT_RESOLUTION_INTERNAL = CONFLICT_RESOLUTION + ".internal"
ORPHAN_MODE_INTERNAL = ORPHAN_MODE + ".internal"
NO_AUTO_PROPAGATION = PREFIX + "no-auto-propagation"
RETAIN_REPLICAS = PREFIX + "retain-replicas"
TEMPLATE_HASH = PREFIX + "template-hash"
OVERRIDE_HASH = PREFIX + "override-hash"
LATEST_REPLICASET_DIGESTS = PREFIX + "latest-replicaset-digests"
SOURCE_FEEDBACK_SCHEDULING = PREFIX + "scheduling"
SOURCE_FEEDBACK_SYNCING = PREFIX + "syncing"
SOURCE_FEEDBACK_STATUS = PREFIX + "status"

# Controller names (pipeline members).
SCHEDULER = PREFIX + "global-scheduler"
OVERRIDE_CONTROLLER = PREFIX + "overridepolicy-controller"
FOLLOWER_CONTROLLER = PREFIX + "follower-controller"

# Finalizers.
SYNC_FINALIZER = PREFIX + "sync-controller"
CLUSTER_FINALIZER = PREFIX + "cluster-controller"

# Host-apiserver resource keys for the core CRDs.
FEDERATED_CLUSTERS = "core.kubeadmiral.io/v1alpha1/federatedclusters"


def compact_json(value) -> str:
    import json

    return json.dumps(value, separators=(",", ":"), sort_keys=True)


def meta(obj: dict) -> dict:
    return obj.setdefault("metadata", {})


def annotations(obj: dict) -> dict:
    return meta(obj).setdefault("annotations", {})


def labels(obj: dict) -> dict:
    return meta(obj).setdefault("labels", {})


def name_of(obj: dict) -> str:
    return obj["metadata"]["name"]


def namespace_of(obj: dict) -> str:
    return obj["metadata"].get("namespace", "")


def template(fed_obj: dict) -> dict:
    return fed_obj.get("spec", {}).get("template", {})


# -- placements (extensions_placements.go semantics) --------------------

def get_placement(fed_obj: dict, controller: str) -> Optional[set[str]]:
    for entry in fed_obj.get("spec", {}).get("placements", []):
        if entry.get("controller") == controller:
            return {p["cluster"] for p in entry.get("placement", [])}
    return None


def set_placement(fed_obj: dict, controller: str, clusters: set[str]) -> bool:
    """Idempotent write; returns True when the spec changed."""
    spec = fed_obj.setdefault("spec", {})
    placements = spec.setdefault("placements", [])
    desired = [{"cluster": c} for c in sorted(clusters)]
    for entry in placements:
        if entry.get("controller") == controller:
            if entry.get("placement") == desired:
                return False
            entry["placement"] = desired
            return True
    placements.append({"controller": controller, "placement": desired})
    return True


def all_placement_clusters(fed_obj: dict) -> set[str]:
    """Union over controllers (reference: placement.go union semantics)."""
    out: set[str] = set()
    for entry in fed_obj.get("spec", {}).get("placements", []):
        out.update(p["cluster"] for p in entry.get("placement", []))
    return out


# -- overrides (util/overrides.go semantics) ----------------------------

def get_overrides(fed_obj: dict, controller: str) -> dict[str, list]:
    """cluster -> RFC6902 patch list for one controller."""
    for entry in fed_obj.get("spec", {}).get("overrides", []):
        if entry.get("controller") == controller:
            return {
                c["cluster"]: c.get("patches", [])
                for c in entry.get("clusters", [])
            }
    return {}


def set_overrides(fed_obj: dict, controller: str, per_cluster: dict[str, list]) -> bool:
    spec = fed_obj.setdefault("spec", {})
    overrides = spec.setdefault("overrides", [])
    desired = [
        {"cluster": c, "patches": patches}
        for c, patches in sorted(per_cluster.items())
        if patches
    ]
    for i, entry in enumerate(overrides):
        if entry.get("controller") == controller:
            if not desired:
                overrides.pop(i)
                return True
            if entry.get("clusters") == desired:
                return False
            entry["clusters"] = desired
            return True
    if desired:
        overrides.append({"controller": controller, "clusters": desired})
        return True
    return False


def overrides_for_cluster(fed_obj: dict, cluster: str) -> list:
    """All controllers' patches for one cluster, in spec order."""
    patches: list = []
    for entry in fed_obj.get("spec", {}).get("overrides", []):
        for c in entry.get("clusters", []):
            if c.get("cluster") == cluster:
                patches.extend(c.get("patches", []))
    return patches


def cluster_lifecycle_sig(cluster_obj: dict) -> tuple:
    """What about a FederatedCluster justifies re-reconciling the world:
    join/ready/terminating transitions (the reference's
    ClusterLifecycleHandlers, controller.go:244-260) — NOT heartbeat
    bumps.  Controllers keep a name->sig map and fan out only on
    change."""
    conds = {
        c.get("type"): c.get("status")
        for c in cluster_obj.get("status", {}).get("conditions", [])
    }
    return (
        conds.get("Joined") == "True",
        conds.get("Ready") == "True",
        bool(cluster_obj["metadata"].get("deletionTimestamp")),
    )


# Per-delivery signature memo: the store installs a scope around its
# watch fan-out so that when several controllers compute the trigger
# signature of the SAME delivered snapshot (one shared dict per event),
# the sorted-items hash runs once per object, not once per watcher.
# Thread-local because fan-out is synchronous on the writing thread and
# id()-keyed entries are only valid while the delivery pins the object.
_sig_tls = threading.local()


@contextlib.contextmanager
def sig_memo_scope():
    """Install a fresh metadata_change_sig memo for one store delivery
    (nested deliveries — a handler writing mid-fan-out — get their own
    scope; the outer memo is restored on exit)."""
    prev = getattr(_sig_tls, "memo", None)
    _sig_tls.memo = {}
    try:
        yield
    finally:
        _sig_tls.memo = prev


def metadata_change_sig(obj: dict, ignore_annotations: tuple = ()) -> int:
    """Trigger signature of the fields a fed-object watch handler cares
    about: generation (spec changes bump it), labels (policy binding),
    annotations minus declared noise keys.  Status-subresource writes —
    the bulk of a converged control plane's event volume — leave it
    unchanged, so controllers keeping a key->sig map skip the requeue
    entirely (the reference's schedulingtriggers.go idea applied at the
    watch boundary)."""
    memo = getattr(_sig_tls, "memo", None)
    if memo is not None:
        memo_key = (id(obj), ignore_annotations)
        sig = memo.get(memo_key)
        if sig is None:
            sig = _metadata_change_sig(obj, ignore_annotations)
            memo[memo_key] = sig
        return sig
    return _metadata_change_sig(obj, ignore_annotations)


def _metadata_change_sig(obj: dict, ignore_annotations: tuple = ()) -> int:
    md = obj.get("metadata", {})
    ann = md.get("annotations") or {}
    if ignore_annotations:
        ann_items = tuple(
            sorted(kv for kv in ann.items() if kv[0] not in ignore_annotations)
        )
    else:
        ann_items = tuple(sorted(ann.items()))
    return hash((
        md.get("generation"),
        bool(md.get("deletionTimestamp")),
        tuple(sorted((md.get("labels") or {}).items())),
        ann_items,
    ))
