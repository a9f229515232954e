"""Field retention: merge cluster-owned fields into the desired object.

A copy of ``kubeadmiral_tpu/federation/retain.py`` for the port's control
plane.

Before updating a member-cluster object, the dispatcher grafts the fields
that member-cluster controllers own (allocated IPs, generated secrets,
admission-injected volumes, ...) from the observed cluster object onto
the freshly-computed desired object, so updates don't fight in-cluster
controllers (reference: pkg/controllers/sync/dispatch/retain.go:49-636).

All objects are unstructured dicts.  Tombstone semantics for labels and
annotations: the keys last propagated from the template are recorded on
the cluster object under the ``propagated-*-keys`` annotations; a key
present in the cluster object but absent from both the template and the
tombstone list is cluster-owned and retained, while a key in the
tombstone list was deliberately removed from the template and is dropped
(retain.go:99-156).
"""

from __future__ import annotations

from typing import Optional

from kubeadmiral_tpu_torch.federation import common as C
from kubeadmiral_tpu_torch.utils.unstructured import get_path, set_path

PROPAGATED_LABEL_KEYS = C.PREFIX + "last-propagated-label-keys"
PROPAGATED_ANNOTATION_KEYS = C.PREFIX + "last-propagated-annotation-keys"

# serviceaccount admission plugin conventions (retain.go:41-45).
SA_VOLUME_PREFIX = "kube-api-access-"
SA_TOKEN_MOUNT_PATH = "/var/run/secrets/kubernetes.io/serviceaccount"

CURRENT_REVISION_ANNOTATION = C.PREFIX + "current-revision"
LAST_REPLICASET_NAME = C.PREFIX + "last-replicaset-name"
LATEST_REPLICASET_NAME = C.PREFIX + "latest-replicaset-name"


def record_propagated_keys(obj: dict) -> None:
    """Stamp the propagated label/annotation key lists so the next
    retention pass can compute template deletions (retain.go:99-111).

    The annotation-keys list is computed *after* adding the label-keys
    annotation, matching the reference's ordering."""
    ann = obj.setdefault("metadata", {}).setdefault("annotations", {})
    labels = obj.get("metadata", {}).get("labels", {}) or {}
    ann[PROPAGATED_LABEL_KEYS] = ",".join(sorted(labels))
    ann[PROPAGATED_ANNOTATION_KEYS] = ",".join(sorted(ann))


def _merge_string_maps(
    template_map: Optional[dict],
    observed_map: Optional[dict],
    last_template_keys: set[str],
) -> dict:
    """Template wins on conflicts; cluster-only keys survive unless they
    appear in the tombstone set (retain.go:134-156)."""
    out = dict(template_map or {})
    deleted = last_template_keys - set(out)
    for k, v in (observed_map or {}).items():
        if k in deleted:
            continue
        out.setdefault(k, v)
    return out


def merge_labels_and_annotations(desired: dict, cluster_obj: dict) -> None:
    cluster_meta = cluster_obj.get("metadata", {})
    cluster_ann = cluster_meta.get("annotations", {}) or {}
    last_labels = set(
        k for k in cluster_ann.get(PROPAGATED_LABEL_KEYS, "").split(",") if k
    )
    last_ann = set(
        k for k in cluster_ann.get(PROPAGATED_ANNOTATION_KEYS, "").split(",") if k
    )
    meta = desired.setdefault("metadata", {})
    merged_ann = _merge_string_maps(meta.get("annotations"), cluster_ann, last_ann)
    if merged_ann:
        meta["annotations"] = merged_ann
    merged_labels = _merge_string_maps(
        meta.get("labels"), cluster_meta.get("labels"), last_labels
    )
    if merged_labels:
        meta["labels"] = merged_labels


# -- per-kind retention --------------------------------------------------

def _retain_service(desired: dict, cluster_obj: dict) -> None:
    """clusterIP and nodePorts are cluster-allocated (retain.go:158-209)."""
    cluster_ip = get_path(cluster_obj, "spec.clusterIP")
    if cluster_ip:
        set_path(desired, "spec.clusterIP", cluster_ip)
    cluster_ports = get_path(cluster_obj, "spec.ports")
    if not isinstance(cluster_ports, list):
        return
    desired_ports = get_path(desired, "spec.ports")
    if not isinstance(desired_ports, list):
        desired_ports = []
    for dport in desired_ports:
        for cport in cluster_ports:
            if (
                dport.get("name") == cport.get("name")
                and dport.get("protocol") == cport.get("protocol")
                and dport.get("port") == cport.get("port")
                and "nodePort" in cport
            ):
                dport["nodePort"] = cport["nodePort"]
    set_path(desired, "spec.ports", desired_ports)


def _retain_serviceaccount(desired: dict, cluster_obj: dict) -> None:
    """Keep generated token secrets to avoid regeneration churn
    (retain.go:219-241)."""
    if desired.get("secrets"):
        return
    secrets = cluster_obj.get("secrets")
    if secrets:
        desired["secrets"] = secrets


def _retain_job(desired: dict, cluster_obj: dict) -> None:
    """controller-uid selector/labels are immutable and cluster-generated
    unless manualSelector (retain.go:247-273)."""
    if get_path(desired, "spec.manualSelector") is True:
        return
    selector = get_path(cluster_obj, "spec.selector")
    if selector is not None:
        set_path(desired, "spec.selector", selector)
    labels = get_path(cluster_obj, "spec.template.metadata.labels")
    if labels is not None:
        set_path(desired, "spec.template.metadata.labels", labels)


def _retain_persistentvolume(desired: dict, cluster_obj: dict) -> None:
    claim_ref = get_path(cluster_obj, "spec.claimRef")
    if claim_ref is not None:
        set_path(desired, "spec.claimRef", claim_ref)


def _retain_persistentvolumeclaim(desired: dict, cluster_obj: dict) -> None:
    volume_name = get_path(cluster_obj, "spec.volumeName")
    if volume_name is not None:
        set_path(desired, "spec.volumeName", volume_name)


def _find_sa_volume(pod: dict) -> tuple[Optional[dict], int]:
    volumes = get_path(pod, "spec.volumes")
    if not isinstance(volumes, list):
        return None, 0
    for i, v in enumerate(volumes):
        if isinstance(v, dict) and str(v.get("name", "")).startswith(SA_VOLUME_PREFIX):
            return v, i
    return None, 0


def _find_sa_volume_mount(container: dict) -> tuple[Optional[dict], int]:
    mounts = container.get("volumeMounts")
    if not isinstance(mounts, list):
        return None, 0
    for i, m in enumerate(mounts):
        if isinstance(m, dict) and m.get("mountPath") == SA_TOKEN_MOUNT_PATH:
            return m, i
    return None, 0


def _retain_container(desired_c: dict, cluster_c: dict) -> None:
    found, _ = _find_sa_volume_mount(desired_c)
    if found is None:
        mnt, idx = _find_sa_volume_mount(cluster_c)
        if mnt is not None:
            mounts = list(desired_c.get("volumeMounts") or [])
            mounts.insert(min(idx, len(mounts)), mnt)
            desired_c["volumeMounts"] = mounts


def _retain_pod(desired: dict, cluster_obj: dict) -> None:
    """Control-plane-managed pod fields (retain.go:302-393): always copy
    ephemeralContainers; copy admission/scheduler defaults only when the
    user left them unset; re-inject the serviceaccount admission volume
    and its per-container mounts at their original indices."""
    eph = get_path(cluster_obj, "spec.ephemeralContainers")
    if eph is not None:
        set_path(desired, "spec.ephemeralContainers", eph)
    for field in ("serviceAccountName", "serviceAccount", "nodeName", "priority"):
        if get_path(desired, f"spec.{field}") is None:
            val = get_path(cluster_obj, f"spec.{field}")
            if val is not None:
                set_path(desired, f"spec.{field}", val)
    found, _ = _find_sa_volume(desired)
    if found is None:
        volume, idx = _find_sa_volume(cluster_obj)
        if volume is not None:
            volumes = list(get_path(desired, "spec.volumes") or [])
            volumes.insert(min(idx, len(volumes)), volume)
            set_path(desired, "spec.volumes", volumes)
    for field in ("containers", "initContainers"):
        desired_cs = get_path(desired, f"spec.{field}") or []
        cluster_cs = {
            c.get("name"): c
            for c in get_path(cluster_obj, f"spec.{field}") or []
            if isinstance(c, dict)
        }
        for dc in desired_cs:
            if isinstance(dc, dict) and dc.get("name") in cluster_cs:
                _retain_container(dc, cluster_cs[dc["name"]])


_KIND_RETAINERS = {
    "Service": _retain_service,
    "ServiceAccount": _retain_serviceaccount,
    "Job": _retain_job,
    "PersistentVolume": _retain_persistentvolume,
    "PersistentVolumeClaim": _retain_persistentvolumeclaim,
    "Pod": _retain_pod,
}


def _retain_whole_status(desired: dict, cluster_obj: dict) -> None:
    """Keep the member-written ``status`` in the desired object.  For
    kinds whose status is NOT a subresource an update would wipe it;
    the member (e.g. the Argo workflow-controller) owns it
    (retain.go:624-636 retainArgoWorkflow)."""
    if "status" in cluster_obj:
        desired["status"] = cluster_obj["status"]
    else:
        desired.pop("status", None)


# Per-GVK retention registry — the "extensible framework to support
# CRDs" the reference leaves as a TODO (retain.go:89-91): CRDs register
# an apiVersion/Kind-keyed retainer; the Argo Workflow rule ships as the
# built-in precedent.
_GVK_RETAINERS: dict[str, callable] = {
    "argoproj.io/v1alpha1/Workflow": _retain_whole_status,
}


def register_gvk_retainer(gvk: str, retainer) -> None:
    """Register a CRD retention rule keyed by "group/version/Kind";
    called as retainer(desired, cluster_obj) after the generic pass."""
    _GVK_RETAINERS[gvk] = retainer


def retain_cluster_fields(
    kind: str, desired: dict, cluster_obj: dict, gvk: str = ""
) -> None:
    """The dispatcher's pre-update pass (retain.go:49-97): resourceVersion
    + finalizers from the cluster object, tombstoned label/annotation
    merge, then kind-specific rules, then any registered per-GVK CRD rule
    (retain.go:88-94; Workflow built in)."""
    meta = desired.setdefault("metadata", {})
    meta["resourceVersion"] = cluster_obj.get("metadata", {}).get("resourceVersion")
    finalizers = cluster_obj.get("metadata", {}).get("finalizers")
    if finalizers:
        meta["finalizers"] = list(finalizers)
    elif "finalizers" in meta:
        del meta["finalizers"]
    merge_labels_and_annotations(desired, cluster_obj)
    retainer = _KIND_RETAINERS.get(kind)
    if retainer is not None:
        retainer(desired, cluster_obj)
    gvk_retainer = _GVK_RETAINERS.get(gvk or desired.get("apiVersion", "") + "/" + kind)
    if gvk_retainer is not None:
        gvk_retainer(desired, cluster_obj)


def retain_replicas(
    desired: dict, cluster_obj: dict, fed_obj: dict, replicas_path: str
) -> None:
    """HPA compatibility: when spec.retainReplicas is set on the federated
    object, the member cluster owns the replica count
    (retain.go:527-557)."""
    if not replicas_path:
        return
    if not fed_obj.get("spec", {}).get("retainReplicas"):
        return
    replicas = get_path(cluster_obj, replicas_path)
    if replicas is not None:
        set_path(desired, replicas_path, replicas)
