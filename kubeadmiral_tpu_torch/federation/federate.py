"""The federate controller: source object → federated companion object.

A copy of ``kubeadmiral_tpu/federation/federate.py`` for the port's control
plane.

For every source object (e.g. a Deployment) this controller maintains the
federated wrapper (FederatedDeployment) whose ``spec.template`` is the
pruned source, classifying source labels/annotations into ones that ride
on the federated object itself versus ones that stay in the template, and
recording bookkeeping annotations (observed key sets, a JSON merge patch
reconstructing the template generator).  Source deletion is propagated by
deleting the federated object first, gated by a finalizer on the source
(reference: pkg/controllers/federate/controller.go:95-567, util.go).
"""

from __future__ import annotations

from typing import Optional

from kubeadmiral_tpu_torch.federation import common as C
from kubeadmiral_tpu_torch.models.ftc import FederatedTypeConfig
from kubeadmiral_tpu_torch.runtime import pending, slo
from kubeadmiral_tpu_torch.runtime.metrics import Metrics
from kubeadmiral_tpu_torch.runtime.worker import Result, Worker
from kubeadmiral_tpu_torch.testing.fakekube import Conflict, FakeKube, NotFound, obj_key
from kubeadmiral_tpu_torch.utils.jsonpatch import create_merge_patch
from kubeadmiral_tpu_torch.utils.unstructured import copy_json, get_path, set_path

FEDERATE_FINALIZER = C.PREFIX + "federate-controller"
NO_FEDERATED_RESOURCE = C.PREFIX + "no-federated-resource"

# Bookkeeping annotations on the federated object
# (reference: pkg/controllers/common/constants.go).
FEDERATED_OBJECT = C.FEDERATED_OBJECT
OBSERVED_ANNOTATION_KEYS = C.PREFIX + "observed-annotation-keys"
OBSERVED_LABEL_KEYS = C.PREFIX + "observed-label-keys"
TEMPLATE_GENERATOR_MERGE_PATCH = C.PREFIX + "template-generator-merge-patch"
NO_SCHEDULING = C.PREFIX + "no-scheduling"
REVISION_HISTORY_LIMIT = C.PREFIX + "revision-history-limit"

# Annotations copied onto the federated object rather than the template
# (reference: federate/util.go federatedAnnotationSet).
FEDERATED_ANNOTATIONS = frozenset(
    {
        C.PREFIX + "scheduling-mode",
        C.PREFIX + "sticky-cluster",
        C.CONFLICT_RESOLUTION,
        C.NO_AUTO_PROPAGATION,
        C.ORPHAN_MODE,
        C.PREFIX + "tolerations",
        C.PREFIX + "placements",
        C.PREFIX + "cluster-selector",
        C.PREFIX + "affinity",
        C.PREFIX + "max-clusters",
        NO_SCHEDULING,
        C.FOLLOWS_OBJECT,
        C.PREFIX + "followers",
    }
)

# Source annotations never copied anywhere (internal / feedback keys;
# reference: federate/util.go ignoredAnnotationSet).
IGNORED_ANNOTATIONS = frozenset(
    {
        C.RETAIN_REPLICAS,
        C.LATEST_REPLICASET_DIGESTS,
        C.SOURCE_FEEDBACK_SCHEDULING,
        C.SOURCE_FEEDBACK_SYNCING,
        C.SOURCE_FEEDBACK_STATUS,
        C.CONFLICT_RESOLUTION_INTERNAL,
        C.ORPHAN_MODE_INTERNAL,
        C.PREFIX + "enable-follower-scheduling",
    }
)

# Labels that ride on the federated object (policy bindings; reference:
# federate/util.go federatedLabelSet).
FEDERATED_LABELS = frozenset(
    {
        "kubeadmiral.io/propagation-policy-name",
        "kubeadmiral.io/cluster-propagation-policy-name",
        "kubeadmiral.io/override-policy-name",
        "kubeadmiral.io/cluster-override-policy-name",
    }
)

# metadata fields pruned from the template (reference:
# federate/util.go templateForSourceObject).
_PRUNED_META = (
    "selfLink",
    "uid",
    "resourceVersion",
    "generation",
    "creationTimestamp",
    "deletionTimestamp",
    "ownerReferences",
    "finalizers",
    "managedFields",
)


def classify_annotations(src: dict) -> tuple[dict, dict]:
    """Split source annotations into (federated, template) maps."""
    federated, template = {}, {}
    for key, value in (src or {}).items():
        if key in IGNORED_ANNOTATIONS:
            continue
        (federated if key in FEDERATED_ANNOTATIONS else template)[key] = value
    federated[FEDERATED_OBJECT] = "1"
    return federated, template


def classify_labels(src: dict) -> tuple[dict, dict]:
    federated, template = {}, {}
    for key, value in (src or {}).items():
        (federated if key in FEDERATED_LABELS else template)[key] = value
    return federated, template


# Annotations this control plane writes back onto SOURCE objects.
_FEEDBACK_ANNOTATIONS = frozenset(
    {
        C.SOURCE_FEEDBACK_SCHEDULING,
        C.SOURCE_FEEDBACK_SYNCING,
        C.SOURCE_FEEDBACK_STATUS,
    }
)


def source_for_bookkeeping(source: dict) -> dict:
    """Source with the feedback annotations stripped: observed-keys and
    the template-generator merge patch must not react to keys this
    control plane writes back onto the source, or every feedback write
    would restart the whole pipeline.  Other ignored annotations (e.g.
    retain-replicas) stay — they are user-written inputs the federated
    spec derives from.  Only the metadata/annotations layers are rebuilt
    (no deep copy of large pod templates on this hot path)."""
    ann = source.get("metadata", {}).get("annotations")
    if not ann or not (_FEEDBACK_ANNOTATIONS & ann.keys()):
        return source
    pruned = {k: v for k, v in ann.items() if k not in _FEEDBACK_ANNOTATIONS}
    meta = {**source["metadata"]}
    if pruned:
        meta["annotations"] = pruned
    else:
        meta.pop("annotations", None)
    return {**source, "metadata": meta}


def observed_keys(source_map: dict, federated_map: dict) -> str:
    """``fedKeys|otherKeys`` bookkeeping so later syncs know which source
    keys were observed (federate/util.go generateObservedKeys)."""
    if not source_map:
        return ""
    fed = sorted(k for k in source_map if k in federated_map)
    non = sorted(k for k in source_map if k not in federated_map)
    return ",".join(fed) + "|" + ",".join(non)


def template_for_source(source: dict, annotations: dict, labels: dict) -> dict:
    template = copy_json(source)
    meta = template.setdefault("metadata", {})
    for field in _PRUNED_META:
        meta.pop(field, None)
    if annotations:
        meta["annotations"] = dict(annotations)
    else:
        meta.pop("annotations", None)
    if labels:
        meta["labels"] = dict(labels)
    else:
        meta.pop("labels", None)
    template.pop("status", None)
    return template


def _is_deployment(ftc: FederatedTypeConfig) -> bool:
    return ftc.source.group == "apps" and ftc.source.kind == "Deployment"


def _ensure_deployment_fields(source: dict, fed_obj: dict) -> bool:
    """spec.retainReplicas + spec.revisionHistoryLimit from source
    annotations (federate/controller.go ensureDeploymentFields)."""
    anno = source.get("metadata", {}).get("annotations", {}) or {}
    changed = False

    retain = anno.get(C.RETAIN_REPLICAS) == "true"
    if get_path(fed_obj, "spec.retainReplicas") != retain:
        set_path(fed_obj, "spec.retainReplicas", retain)
        changed = True

    limit = int(anno.get(REVISION_HISTORY_LIMIT, "1") or 1)
    if get_path(fed_obj, "spec.revisionHistoryLimit") != limit:
        set_path(fed_obj, "spec.revisionHistoryLimit", limit)
        changed = True
    return changed


def new_federated_object(ftc: FederatedTypeConfig, source: dict) -> dict:
    source = source_for_bookkeeping(source)
    src_meta = source.get("metadata", {})
    fed_labels, tmpl_labels = classify_labels(src_meta.get("labels", {}))
    fed_anno, tmpl_anno = classify_annotations(src_meta.get("annotations", {}))
    template = template_for_source(source, tmpl_anno, tmpl_labels)

    fed_anno[OBSERVED_ANNOTATION_KEYS] = observed_keys(
        src_meta.get("annotations", {}) or {}, fed_anno
    )
    fed_anno[OBSERVED_LABEL_KEYS] = observed_keys(
        src_meta.get("labels", {}) or {}, fed_labels
    )
    fed_anno[TEMPLATE_GENERATOR_MERGE_PATCH] = C.compact_json(
        create_merge_patch(source, template)
    )

    fed_obj = {
        "apiVersion": ftc.federated.api_version,
        "kind": ftc.federated.kind,
        "metadata": {
            "name": src_meta.get("name"),
            "annotations": fed_anno,
        },
        "spec": {"template": template},
    }
    if src_meta.get("namespace"):
        fed_obj["metadata"]["namespace"] = src_meta["namespace"]
    if fed_labels:
        fed_obj["metadata"]["labels"] = fed_labels
    if _is_deployment(ftc):
        _ensure_deployment_fields(source, fed_obj)
    pending.set_pending(fed_obj, ftc.controller_groups)
    return fed_obj


def update_federated_object(
    fed_obj: dict, ftc: FederatedTypeConfig, source: dict
) -> bool:
    """Reconcile an existing federated object against the source; returns
    True when it changed (federate/util.go
    updateFederatedObjectForSourceObject)."""
    changed = False
    source = source_for_bookkeeping(source)
    src_meta = source.get("metadata", {})
    fed_meta = fed_obj.setdefault("metadata", {})

    fed_labels, tmpl_labels = classify_labels(src_meta.get("labels", {}))
    fed_anno, tmpl_anno = classify_annotations(src_meta.get("annotations", {}))

    if (fed_meta.get("labels") or {}) != fed_labels:
        if fed_labels:
            fed_meta["labels"] = fed_labels
        else:
            fed_meta.pop("labels", None)
        changed = True

    template = template_for_source(source, tmpl_anno, tmpl_labels)
    if get_path(fed_obj, "spec.template") != template:
        set_path(fed_obj, "spec.template", template)
        changed = True

    # Merge federated annotations into the existing set: other
    # controllers annotate the federated object too, so only keys this
    # controller owns are overwritten/removed.
    existing = dict(fed_meta.get("annotations", {}) or {})
    merged = dict(existing)
    for key in list(merged):
        if key in FEDERATED_ANNOTATIONS and key not in fed_anno:
            del merged[key]
    merged.update(fed_anno)
    merged[OBSERVED_ANNOTATION_KEYS] = observed_keys(
        src_meta.get("annotations", {}) or {}, fed_anno
    )
    merged[OBSERVED_LABEL_KEYS] = observed_keys(
        src_meta.get("labels", {}) or {}, fed_labels
    )
    merged[TEMPLATE_GENERATOR_MERGE_PATCH] = C.compact_json(
        create_merge_patch(source, template)
    )
    if merged != existing:
        fed_meta["annotations"] = merged
        changed = True

    if _is_deployment(ftc):
        changed = _ensure_deployment_fields(source, fed_obj) or changed

    if changed:
        # A template change restarts the controller pipeline
        # (federate/util.go:208-213).
        pending.set_pending(fed_obj, ftc.controller_groups)
    return changed


class FederateController:
    """Per-FTC controller keeping FederatedX in step with X."""

    name = "federate-controller"

    def __init__(
        self,
        host: FakeKube,
        ftc: FederatedTypeConfig,
        metrics: Optional[Metrics] = None,
        clock=None,
    ):
        self.host = host
        self.ftc = ftc
        self.metrics = metrics or Metrics()
        self._source_resource = ftc.source.resource
        self._fed_resource = ftc.federated.resource
        self.worker = Worker(
            f"federate-{ftc.name}", self.reconcile, metrics=self.metrics, clock=clock
        )
        # The source resource is the pipeline's ingress: its watch
        # events mint the SLO provenance tokens the whole
        # event→placement-written decomposition hangs off
        # (runtime/slo.py).
        slo.track(host, self._source_resource)
        # Watch-boundary trigger filter for FED events: federate reads a
        # fed object's template (generation), labels and annotations
        # (the feedback annotations it mirrors to the source included),
        # never its status — sync's per-round status-subresource write
        # must not re-reconcile every object (common.metadata_change_sig).
        self._fed_event_sigs: dict[str, int] = {}
        host.watch(self._source_resource, self._on_event, replay=True)
        host.watch(self._fed_resource, self._on_fed_event, replay=True)

    def _on_event(self, event: str, obj: dict) -> None:
        if self.worker.is_own_thread():
            return  # echo of this controller's own source/fed write
        self.worker.enqueue(obj_key(obj))

    def _on_fed_event(self, event: str, obj: dict) -> None:
        key = obj_key(obj)
        if event == "DELETED":
            self._fed_event_sigs.pop(key, None)
            if not self.worker.is_own_thread():
                self.worker.enqueue(key)
            return
        sig = C.metadata_change_sig(obj)
        if self._fed_event_sigs.get(key) == sig:
            return  # status-only fed write: nothing federate consumes
        self._fed_event_sigs[key] = sig
        if self.worker.is_own_thread():
            return  # echo of this controller's own fed write
        self.worker.enqueue(key)

    def run_until_idle(self) -> None:
        while self.worker.step():
            pass

    # -- reconcile (federate/controller.go:194-341) ----------------------
    def reconcile(self, key: str) -> Result:
        self.metrics.counter("federate.throughput")
        source = self.host.try_get(self._source_resource, key)
        fed_obj = self.host.try_get(self._fed_resource, key)

        if source is None:
            return Result.ok()

        if source["metadata"].get("deletionTimestamp"):
            return self._handle_terminating_source(source, fed_obj)

        if source["metadata"].get("annotations", {}).get(NO_FEDERATED_RESOURCE):
            return Result.ok()

        source = self._ensure_finalizer(source)
        if source is None:
            return Result.retry()

        if fed_obj is None:
            return self._create(source)
        return self._update(source, fed_obj)

    def _ensure_finalizer(self, source: dict) -> Optional[dict]:
        fins = source["metadata"].setdefault("finalizers", [])
        if FEDERATE_FINALIZER in fins:
            return source
        fins.append(FEDERATE_FINALIZER)
        try:
            # rv-only consumption: skip the result deep copy.
            updated = self.host.update(
                self._source_resource, source, _copy_result=False
            )
        except (Conflict, NotFound):
            return None
        source["metadata"]["resourceVersion"] = updated["metadata"]["resourceVersion"]
        return source

    def _handle_terminating_source(
        self, source: dict, fed_obj: Optional[dict]
    ) -> Result:
        if fed_obj is None:
            # Federated object gone: release the source
            # (federate/controller.go handleTerminatingSourceObject).
            fins = source["metadata"].get("finalizers", [])
            if FEDERATE_FINALIZER in fins:
                source["metadata"]["finalizers"] = [
                    f for f in fins if f != FEDERATE_FINALIZER
                ]
                try:
                    # Result discarded: skip the deep copy.
                    self.host.update(
                        self._source_resource, source, _copy_result=False
                    )
                except (Conflict, NotFound):
                    return Result.retry()
            return Result.ok()
        if not fed_obj["metadata"].get("deletionTimestamp"):
            try:
                self.host.delete(self._fed_resource, obj_key(fed_obj))
            except NotFound:
                pass
            # A finalizer-free federated object is gone right away (its
            # DELETED event is our own echo, suppressed): release the
            # source NOW instead of waiting for a requeue that nothing
            # would trigger.
            if self.host.try_get(self._fed_resource, obj_key(fed_obj)) is None:
                return self._handle_terminating_source(source, None)
        # Requeue until the federated object finishes terminating
        # (sync's finalizer removal fires a foreign DELETED event too).
        return Result.after(1.0)

    def _create(self, source: dict) -> Result:
        fed_obj = new_federated_object(self.ftc, source)
        try:
            # _sync_feedback only reads the created object: no copy needed.
            created = self.host.create(
                self._fed_resource, fed_obj, _copy_result=False
            )
        except Conflict:
            return Result.retry()
        except Exception:
            return Result.retry()
        # The ADDED echo is suppressed (own thread): stamp the initial
        # scheduling feedback on the source now, as the echo-driven
        # second reconcile used to.
        return self._sync_feedback(source, created)

    def _update(self, source: dict, fed_obj: dict) -> Result:
        if not update_federated_object(fed_obj, self.ftc, source):
            return self._sync_feedback(source, fed_obj)
        try:
            # rv/generation-only consumption: skip the result deep copy.
            updated = self.host.update(
                self._fed_resource, fed_obj, _copy_result=False
            )
        except (Conflict, NotFound):
            return Result.retry()
        # Server-set fields (rv AND generation — the fedGeneration the
        # feedback annotation records) must come from the stored object.
        fed_obj["metadata"]["resourceVersion"] = updated["metadata"][
            "resourceVersion"
        ]
        if "generation" in updated.get("metadata", {}):
            fed_obj["metadata"]["generation"] = updated["metadata"]["generation"]
        # Continue straight to the feedback pass: the write's own echo
        # is suppressed (is_own_thread), so nothing else would requeue
        # this key to mirror feedback onto the source.
        return self._sync_feedback(source, fed_obj)

    def _sync_feedback(self, source: dict, fed_obj: dict) -> Result:
        """Write scheduling feedback (computed from the federated object's
        placements) and copy syncing feedback onto the source object
        (federate/controller.go:485-494;
        sourcefeedback/scheduling.go PopulateSchedulingAnnotation)."""
        fed_anno = fed_obj["metadata"].get("annotations", {}) or {}
        changed = False
        src_anno = source["metadata"].setdefault("annotations", {})

        scheduling: dict = {
            # Generation of the source as observed in the template (the
            # template prunes it, as the reference's does, so this stays
            # null unless another controller kept it).
            "generation": get_path(fed_obj, "spec.template.metadata.generation"),
            "fedGeneration": fed_obj["metadata"].get("generation", 1),
        }
        placement = sorted(C.all_placement_clusters(fed_obj))
        if placement:
            scheduling["placement"] = placement
        scheduling_value = C.compact_json(scheduling)
        if src_anno.get(C.SOURCE_FEEDBACK_SCHEDULING) != scheduling_value:
            src_anno[C.SOURCE_FEEDBACK_SCHEDULING] = scheduling_value
            changed = True

        syncing = fed_anno.get(C.SOURCE_FEEDBACK_SYNCING)
        if syncing is not None and src_anno.get(C.SOURCE_FEEDBACK_SYNCING) != syncing:
            src_anno[C.SOURCE_FEEDBACK_SYNCING] = syncing
            changed = True
        if not changed:
            return Result.ok()
        try:
            self.host.update(self._source_resource, source)
        except (Conflict, NotFound):
            return Result.retry()
        return Result.ok()
