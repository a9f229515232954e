"""Status collection and aggregation.

A copy of ``kubeadmiral_tpu/federation/statusctl.py`` for the port's
control plane.

Two per-FTC controllers close the feedback loop from member clusters back
to the user:

* :class:`StatusController` — collects the FTC's ``statusCollection``
  dotted fields from each placed member object into a companion status CR
  (``FederatedXStatus`` with ``clusterStatus: [{clusterName, ...fields}]``),
  owned by the federated object (reference:
  pkg/controllers/status/controller.go:126-686).
* :class:`StatusAggregator` — folds member statuses back onto the
  **source** object via per-kind plugins: Deployments get summed
  replica counts on the status subresource; other kinds get the
  sourcefeedback annotation (reference:
  pkg/controllers/statusaggregator/controller.go:110-399, plugins/).
"""

from __future__ import annotations

from typing import Callable, Optional

from kubeadmiral_tpu_torch.federation import common as C
from kubeadmiral_tpu_torch.federation.dispatch import bulk_get
from kubeadmiral_tpu_torch.models.ftc import FederatedTypeConfig
from kubeadmiral_tpu_torch.runtime.hostbatch import HostBatch
from kubeadmiral_tpu_torch.runtime.informer import MemberStore
from kubeadmiral_tpu_torch.runtime.metrics import Metrics
from kubeadmiral_tpu_torch.runtime.worker import BatchWorker, Result
from kubeadmiral_tpu_torch.testing.fakekube import ClusterFleet, FakeKube, obj_key
from kubeadmiral_tpu_torch.transport import breaker as B
from kubeadmiral_tpu_torch.utils.unstructured import copy_json, get_path, set_path

# Bulk host point reads (the JAX module's KT_BULK_READS default, on).
BULK_READS = True


def _host_bulk_reads(host) -> bool:
    """Bulk host point reads (BULK_READS): only worth a round trip on
    network hosts — an in-process store's view reads are free."""
    return not isinstance(host, FakeKube) and BULK_READS


def _retry_pending_attach(store: MemberStore, worker, host, fed_resource) -> None:
    """Heartbeat-path retry for transiently failed member-watch attaches
    (mirrors sync's check).  On success, replay streams the cluster's
    EXISTING member objects through the store handler (enqueuing their
    keys), but fed objects with nothing propagated to the newly attached
    cluster still hold stale 'cluster unavailable' entries — whenever
    the pending set SHRANK (not only when it drained), fan everything
    out."""
    before = store.pending
    if not before:
        return
    store.reattach()
    if before - store.pending:
        worker.enqueue_all(host.keys(fed_resource))


def _view_read(client, resource: str, key: str) -> Optional[dict]:
    """No-copy read when the client offers one; consumers must not
    mutate the result."""
    view = getattr(client, "try_get_view", None)
    return view(resource, key) if view is not None else client.try_get(resource, key)


class StatusController:
    """Collects member-object fields into the status CR.

    Batch-tick shape: member objects come from a :class:`MemberStore`
    (cached informer stores — zero member round trips per reconcile,
    reference: status/controller.go:291-450 reading FederatedInformer
    caches), and one tick's status-CR writes ride a single
    ``host.batch()`` round trip through :class:`HostBatch`."""

    name = "status-controller"

    def __init__(
        self,
        fleet: ClusterFleet,
        ftc: FederatedTypeConfig,
        metrics: Optional[Metrics] = None,
        clock=None,
    ):
        if ftc.status is None:
            raise ValueError(f"FTC {ftc.name} has no status type")
        self.fleet = fleet
        self.host = fleet.host
        self.ftc = ftc
        self.metrics = metrics or Metrics()
        self._fed_resource = ftc.federated.resource
        self._target_resource = ftc.source.resource
        self._status_resource = ftc.status.resource
        self.worker = BatchWorker(
            f"status-{ftc.name}",
            self.reconcile_batch,
            metrics=self.metrics,
            clock=clock,
        )
        self._cluster_sigs: dict[str, tuple] = {}
        # Skip cache: fingerprint of the clusterStatus+labels this
        # controller last wrote (or verified) per key — an unchanged
        # world costs zero host reads (this controller is the status
        # CR's only writer).
        self._last_written: dict[str, tuple] = {}
        # resourceVersions of this controller's own status-CR writes —
        # echo suppression for the drift-repair watch below.
        self._own_status_rv: dict[str, str] = {}
        self.store = MemberStore(
            fleet, self._target_resource, on_event=self._on_member_event
        )
        # A member coming back from a breaker-open window may have
        # changed out from under its stalled watch stream: refresh every
        # status CR (and retry any pending member-watch attach) when the
        # fleet's shared breaker closes.
        B.for_fleet(fleet, metrics=self.metrics).on_transition(
            self._on_breaker_transition
        )
        self.host.watch(self._fed_resource, self._on_fed_event, replay=True)
        self.host.watch(C.FEDERATED_CLUSTERS, self._on_cluster_event, replay=False)
        # Drift repair: a status CR deleted or modified out-of-band must
        # invalidate the skip cache, or the fingerprint check would
        # never rewrite it while the member world stays quiescent.
        self.host.watch(self._status_resource, self._on_status_event, replay=False)

    def _on_fed_event(self, event: str, obj: dict) -> None:
        self.worker.enqueue(obj_key(obj))

    def _on_member_event(self, cluster: str, event: str, obj: dict) -> None:
        self.worker.enqueue(obj_key(obj))

    def _on_breaker_transition(self, name: str, old: str, new: str) -> None:
        if new == B.CLOSED:
            _retry_pending_attach(
                self.store, self.worker, self.host, self._fed_resource
            )
            self.worker.enqueue_all(self.host.keys(self._fed_resource))

    def _on_status_event(self, event: str, obj: dict) -> None:
        key = obj_key(obj)
        if event == "DELETED":
            self._own_status_rv.pop(key, None)
            if self.worker.is_own_thread():
                return  # echo of this controller's own delete
        elif self.worker.is_own_thread() or self._own_status_rv.get(key) == str(
            obj.get("metadata", {}).get("resourceVersion", "")
        ):
            return  # echo of this controller's own write
        self._last_written.pop(key, None)
        self.worker.enqueue(key)

    def _on_cluster_event(self, event: str, obj: dict) -> None:
        sig = C.cluster_lifecycle_sig(obj)
        name = obj["metadata"]["name"]
        if event == "DELETED":
            self._cluster_sigs.pop(name, None)  # re-creation must fan out
            # Tear down the removed cluster's store: it must report
            # 'cluster unavailable', not serve frozen last-known state.
            # No reattach here — it would re-add the evicted cluster.
            self.store.evict(name)
            self.worker.enqueue_all(self.host.keys(self._fed_resource))
            return
        elif self._cluster_sigs.get(name) == sig:
            # Heartbeat bump: nothing placement-relevant changed, but a
            # transiently failed member-watch attach still needs its
            # retry channel.
            _retry_pending_attach(
                self.store, self.worker, self.host, self._fed_resource
            )
            return
        else:
            self._cluster_sigs[name] = sig
        self.store.readmit(name)  # a re-created cluster lifts its eviction
        self.store.reattach()
        self.worker.enqueue_all(self.host.keys(self._fed_resource))

    def run_until_idle(self) -> None:
        while self.worker.step():
            pass

    # -- reconcile (status/controller.go:291-450) ------------------------
    def reconcile_batch(self, keys: list[str]) -> dict[str, Result]:
        """One tick: every due key's status CR recomputed against the
        member store, all host writes staged into ONE batch.  Network
        hosts prefetch the tick's federated objects (and the status CRs
        of keys outside the skip cache) in bulk reads instead of two
        GETs per key."""
        results: dict[str, Result] = {}
        fed_cache = status_cache = None
        if _host_bulk_reads(self.host) and keys:
            fed_cache = bulk_get(self.host, self._fed_resource, keys)
            cold = [k for k in keys if k not in self._last_written]
            if cold:
                status_cache = bulk_get(self.host, self._status_resource, cold)
        hb = HostBatch(self.host)
        for key in keys:
            try:
                self._plan_one(key, hb, results, fed_cache, status_cache)
            except Exception:
                self.metrics.counter("status.plan_panic")
                results[key] = Result.retry()
        hb.flush()
        return results

    def _plan_one(
        self,
        key: str,
        hb: HostBatch,
        results: dict,
        fed_cache: Optional[dict] = None,
        status_cache: Optional[dict] = None,
    ) -> None:
        self.metrics.counter("status.throughput")
        if fed_cache is not None and key in fed_cache:
            fed_obj = fed_cache[key]
        else:
            fed_obj = _view_read(self.host, self._fed_resource, key)

        def on_panic(_key=key) -> None:
            self._last_written.pop(_key, None)
            results[_key] = Result.retry()

        if fed_obj is None or fed_obj["metadata"].get("deletionTimestamp"):
            # Federated object gone: drop the status CR.
            self._last_written.pop(key, None)

            def on_delete(result, _key=key) -> None:
                if result.get("code") not in (200, 404):
                    results[_key] = Result.retry()

            hb.stage(
                {"verb": "delete", "resource": self._status_resource, "key": key},
                on_delete,
                on_panic,
            )
            return

        cluster_status = self._cluster_statuses(fed_obj, key)
        labels = dict(fed_obj["metadata"].get("labels", {}) or {})
        fp = (C.compact_json(cluster_status), C.compact_json(labels))
        if self._last_written.get(key) == fp:
            return  # nothing changed since our last verified write

        if status_cache is not None and key in status_cache:
            existing = status_cache[key]
        else:
            existing = _view_read(self.host, self._status_resource, key)
        if existing is None:
            desired = {
                "apiVersion": self.ftc.status.api_version,
                "kind": self.ftc.status.kind,
                "metadata": {"name": fed_obj["metadata"]["name"], "labels": labels},
                "clusterStatus": cluster_status,
            }
            if fed_obj["metadata"].get("namespace"):
                desired["metadata"]["namespace"] = fed_obj["metadata"]["namespace"]

            def on_create(result, _key=key, _fp=fp) -> None:
                if result.get("code") == 201:
                    self._last_written[_key] = _fp
                    self._record_own(_key, result.get("object"))
                else:
                    results[_key] = Result.retry()

            hb.stage(
                {
                    "verb": "create",
                    "resource": self._status_resource,
                    "object": desired,
                },
                on_create,
                on_panic,
            )
            return

        if (
            existing.get("clusterStatus") == cluster_status
            and (existing["metadata"].get("labels") or {}) == labels
        ):
            self._last_written[key] = fp
            return

        # ``existing`` is a view: rebuild the changed layers, share the
        # rest (every store write deep-copies on entry).
        updated = dict(existing)
        meta = dict(existing["metadata"])
        meta["labels"] = labels
        updated["metadata"] = meta
        updated["clusterStatus"] = cluster_status

        def on_update(result, _key=key, _fp=fp) -> None:
            if result.get("code") == 200:
                self._last_written[_key] = _fp
                self._record_own(_key, result.get("object"))
            else:  # conflict / gone / transport: re-read next pass
                self._last_written.pop(_key, None)
                results[_key] = Result.retry()

        hb.stage(
            {"verb": "update", "resource": self._status_resource, "object": updated},
            on_update,
            on_panic,
        )

    def _record_own(self, key: str, obj) -> None:
        if isinstance(obj, dict):
            rv = obj.get("metadata", {}).get("resourceVersion")
            if rv is not None:
                self._own_status_rv[key] = str(rv)

    def _cluster_statuses(self, fed_obj: dict, key: str) -> list[dict]:
        """Per placed cluster, the collected dotted fields
        (status/controller.go:491-560 clusterStatuses) — read from the
        member store, not the member apiservers."""
        placed = sorted(C.all_placement_clusters(fed_obj))
        out = []
        for cname in placed:
            entry: dict = {"clusterName": cname}
            obj = self.store.get(cname, key)
            if obj is None:
                if not self.store.attached(cname):
                    entry["error"] = "cluster unavailable"
                    out.append(entry)
                continue  # attached but not propagated yet: skip silently
            collected: dict = {}
            for field in self.ftc.status_collection_fields:
                value = get_path(obj, field)
                if value is None:
                    continue
                # Values alias the store view; every downstream write
                # path (fp serialization, host.batch) copies on entry.
                set_path(collected, field, value)
            entry["collectedFields"] = collected
            out.append(entry)
        return out


# -- aggregation plugins (statusaggregator/plugins/) ---------------------

_SUMMED_DEPLOYMENT_FIELDS = (
    "replicas",
    "updatedReplicas",
    "readyReplicas",
    "availableReplicas",
    "unavailableReplicas",
)


def aggregate_workload_status(
    source: dict, cluster_objs: dict[str, dict], up_to_date: bool
) -> Optional[dict]:
    """Deployment-family aggregation: sum the replica counters across
    clusters; bump observedGeneration to the source's generation only
    when every member status reflects the latest sync
    (plugins/deployment.go:42-160)."""
    agg = {f: 0 for f in _SUMMED_DEPLOYMENT_FIELDS}
    if not cluster_objs:
        up_to_date = False
    for obj in cluster_objs.values():
        status = obj.get("status")
        if not status:
            up_to_date = False
            continue
        for f in _SUMMED_DEPLOYMENT_FIELDS:
            agg[f] += int(status.get(f, 0) or 0)
    new_status = {f: v for f, v in agg.items() if v}
    if up_to_date:
        new_status["observedGeneration"] = source["metadata"].get("generation", 1)
    else:
        old = (source.get("status") or {}).get("observedGeneration")
        if old is not None:
            new_status["observedGeneration"] = old
    return new_status


def aggregate_single_cluster(
    source: dict, cluster_objs: dict[str, dict], up_to_date: bool
) -> Optional[dict]:
    """Adopt the lone member's status verbatim; ambiguous with more than
    one placement (plugins/single_cluster_plugin.go)."""
    if len(cluster_objs) != 1:
        return None
    (obj,) = cluster_objs.values()
    return obj.get("status")


def _job_finished_failed(status: dict) -> bool:
    return any(
        c.get("type") == "Failed" and c.get("status") == "True"
        for c in status.get("conditions", []) or []
    )


def aggregate_job_status(
    source: dict, cluster_objs: dict[str, dict], up_to_date: bool
) -> Optional[dict]:
    """Jobs: sum active/succeeded/failed, min startTime; once every
    cluster's job finished, a federation-level Complete/Failed condition
    summarizes where it completed vs failed (plugins/job.go:43-140).
    Timestamps are RFC3339 strings, so lexicographic min/max is
    chronological."""
    agg: dict = {"active": 0, "succeeded": 0, "failed": 0}
    start_time: Optional[str] = None
    completion_time: Optional[str] = None
    finished = 0
    completed_in: list[str] = []
    failed_in: list[str] = []
    for cname, obj in sorted(cluster_objs.items()):
        status = obj.get("status")
        if not status:
            continue
        st = status.get("startTime")
        if st and (start_time is None or st < start_time):
            start_time = st
        ct = status.get("completionTime")
        if ct:
            finished += 1
            completed_in.append(cname)
            if completion_time is None or ct > completion_time:
                completion_time = ct
        elif _job_finished_failed(status):
            finished += 1
            failed_in.append(cname)
        for f in ("active", "succeeded", "failed"):
            agg[f] += int(status.get(f, 0) or 0)

    new_status = {f: v for f, v in agg.items() if v}
    if start_time is not None:
        new_status["startTime"] = start_time
    if finished > 0 and finished == len(cluster_objs):
        if completed_in and failed_in:
            cond = {
                "type": "Failed",
                "status": "True",
                "reason": "Mixed",
                "message": (
                    f"Job completed in clusters {completed_in} "
                    f"and failed in clusters {failed_in}"
                ),
            }
        elif completed_in:
            cond = {
                "type": "Complete",
                "status": "True",
                "reason": "Completed",
                "message": f"Job completed in clusters {completed_in}",
            }
            if completion_time is not None:
                new_status["completionTime"] = completion_time
        else:
            cond = {
                "type": "Failed",
                "status": "True",
                "reason": "Failed",
                "message": f"Job failed in clusters {failed_in}",
            }
        new_status["conditions"] = [cond]
    return new_status


# Phase precedence: any failure dominates, then pending, running, and only
# all-succeeded reads Succeeded (plugins/pod.go:101-130).
_POD_PHASE_ORDER = ("Failed", "Pending", "Running", "Succeeded")


def aggregate_pod_status(
    source: dict, cluster_objs: dict[str, dict], up_to_date: bool
) -> Optional[dict]:
    """Pods: federation-level phase by precedence, min startTime, member
    container statuses concatenated with the cluster name suffixed
    (plugins/pod.go:41-130)."""
    phases: dict[str, list[str]] = {p: [] for p in _POD_PHASE_ORDER}
    new_status: dict = {}
    start_time: Optional[str] = None
    containers: list[dict] = []
    init_containers: list[dict] = []
    for cname, obj in sorted(cluster_objs.items()):
        status = obj.get("status") or {}
        phase = status.get("phase") or "Pending"
        if phase in phases:
            phases[phase].append(cname)
        st = status.get("startTime")
        if st and (start_time is None or st < start_time):
            start_time = st
        for cs in status.get("initContainerStatuses", []) or []:
            cs = dict(cs)
            cs["name"] = f"{cs.get('name')} ({cname})"
            init_containers.append(cs)
        for cs in status.get("containerStatuses", []) or []:
            cs = dict(cs)
            cs["name"] = f"{cs.get('name')} ({cname})"
            containers.append(cs)

    messages = []
    for phase in _POD_PHASE_ORDER:
        if not phases[phase]:
            continue
        new_status.setdefault("phase", phase)
        messages.append(f"pod is {phase} in clusters {sorted(phases[phase])}")
    if messages:
        new_status["message"] = "; ".join(messages)
    if start_time is not None:
        new_status["startTime"] = start_time
    if init_containers:
        new_status["initContainerStatuses"] = init_containers
    if containers:
        new_status["containerStatuses"] = containers
    return new_status


# GVK -> plugin, mirroring the reference registry (plugins/plugin.go:42-47:
# Deployment summed, StatefulSet single-cluster, Job merged, Pod phased).
AGGREGATION_PLUGINS: dict[str, Callable] = {
    "apps/v1/Deployment": aggregate_workload_status,
    "apps/v1/StatefulSet": aggregate_single_cluster,
    "batch/v1/Job": aggregate_job_status,
    "v1/Pod": aggregate_pod_status,
}


class StatusAggregator:
    """Folds member statuses back onto the source object.

    Batch-tick shape mirrors :class:`StatusController`: member objects
    come from the cached :class:`MemberStore` (reference: the aggregator
    reads FederatedInformer caches, statusaggregator/controller.go:291-399)
    and one tick's source writes share one ``host.batch()`` round trip."""

    name = "status-aggregator"

    def __init__(
        self,
        fleet: ClusterFleet,
        ftc: FederatedTypeConfig,
        metrics: Optional[Metrics] = None,
        clock=None,
    ):
        self.fleet = fleet
        self.host = fleet.host
        self.ftc = ftc
        self.metrics = metrics or Metrics()
        self._fed_resource = ftc.federated.resource
        self._target_resource = ftc.source.resource
        self.plugin = AGGREGATION_PLUGINS.get(ftc.source.gvk)
        self.worker = BatchWorker(
            f"statusagg-{ftc.name}",
            self.reconcile_batch,
            metrics=self.metrics,
            clock=clock,
        )
        self._cluster_sigs: dict[str, tuple] = {}
        self.store = MemberStore(
            fleet, self._target_resource, on_event=self._on_member_event
        )
        self.host.watch(self._fed_resource, self._on_event, replay=True)
        self.host.watch(C.FEDERATED_CLUSTERS, self._on_cluster_event, replay=False)

    def _on_event(self, event: str, obj: dict) -> None:
        self.worker.enqueue(obj_key(obj))

    def _on_member_event(self, cluster: str, event: str, obj: dict) -> None:
        self.worker.enqueue(obj_key(obj))

    def _on_cluster_event(self, event: str, obj: dict) -> None:
        sig = C.cluster_lifecycle_sig(obj)
        name = obj["metadata"]["name"]
        if event == "DELETED":
            self._cluster_sigs.pop(name, None)
            self.store.evict(name)
            self.worker.enqueue_all(self.host.keys(self._fed_resource))
            return
        elif self._cluster_sigs.get(name) == sig:
            _retry_pending_attach(
                self.store, self.worker, self.host, self._fed_resource
            )
            return
        else:
            self._cluster_sigs[name] = sig
        self.store.readmit(name)  # a re-created cluster lifts its eviction
        self.store.reattach()
        self.worker.enqueue_all(self.host.keys(self._fed_resource))

    def run_until_idle(self) -> None:
        while self.worker.step():
            pass

    # -- reconcile (statusaggregator/controller.go:291-399) --------------
    def reconcile_batch(self, keys: list[str]) -> dict[str, Result]:
        results: dict[str, Result] = {}
        source_cache = fed_cache = None
        if _host_bulk_reads(self.host) and keys:
            # Aggregation reads two host objects per key; batch both.
            source_cache = bulk_get(self.host, self._target_resource, keys)
            fed_cache = bulk_get(self.host, self._fed_resource, keys)
        hb = HostBatch(self.host)
        for key in keys:
            try:
                self._plan_one(key, hb, results, source_cache, fed_cache)
            except Exception:
                self.metrics.counter("statusagg.plan_panic")
                results[key] = Result.retry()
        hb.flush()
        return results

    def _plan_one(
        self,
        key: str,
        hb: HostBatch,
        results: dict,
        source_cache: Optional[dict] = None,
        fed_cache: Optional[dict] = None,
    ) -> None:
        self.metrics.counter("statusagg.throughput")
        if source_cache is not None and key in source_cache:
            source = source_cache[key]
        else:
            source = _view_read(self.host, self._target_resource, key)
        if fed_cache is not None and key in fed_cache:
            fed_obj = fed_cache[key]
        else:
            fed_obj = _view_read(self.host, self._fed_resource, key)
        if source is None or fed_obj is None:
            return
        if source["metadata"].get("deletionTimestamp"):
            return

        cluster_objs: dict[str, dict] = {}
        up_to_date = True
        synced = {
            c.get("cluster"): c.get("status")
            for c in (fed_obj.get("status", {}) or {}).get("clusters", [])
        }
        for cname in sorted(C.all_placement_clusters(fed_obj)):
            obj = self.store.get(cname, key)
            if obj is None:
                up_to_date = False
                continue
            if synced.get(cname) != "OK":
                up_to_date = False
            cluster_objs[cname] = obj

        def on_panic(_key=key) -> None:
            results[_key] = Result.retry()

        def on_write(result, _key=key) -> None:
            if result.get("code") not in (200, 404):
                results[_key] = Result.retry()

        plugin = self.plugin
        if plugin is not None:
            new_status = plugin(source, cluster_objs, up_to_date)
            if new_status is not None and new_status != source.get("status"):
                # Status subresource write: only .status is applied, so a
                # minimal object (key + optimistic resourceVersion) rides
                # the batch instead of a deep copy of the source.
                patch = {
                    "apiVersion": source.get("apiVersion"),
                    "kind": source.get("kind"),
                    "metadata": {
                        "name": source["metadata"]["name"],
                        "resourceVersion": source["metadata"].get("resourceVersion"),
                    },
                    "status": new_status,
                }
                if source["metadata"].get("namespace"):
                    patch["metadata"]["namespace"] = source["metadata"]["namespace"]
                hb.stage(
                    {
                        "verb": "update_status",
                        "resource": self._target_resource,
                        "object": patch,
                    },
                    on_write,
                    on_panic,
                )
            return

        # No plugin: record statuses in the sourcefeedback annotation
        # (sourcefeedback/status.go).
        feedback = C.compact_json(
            {
                "clusters": [
                    {"name": c, "status": o.get("status")}
                    for c, o in sorted(cluster_objs.items())
                    if o.get("status") is not None
                ]
            }
        )
        if (source["metadata"].get("annotations") or {}).get(
            C.SOURCE_FEEDBACK_STATUS
        ) == feedback:
            return
        updated = copy_json(source)
        updated["metadata"].setdefault("annotations", {})[
            C.SOURCE_FEEDBACK_STATUS
        ] = feedback
        hb.stage(
            {"verb": "update", "resource": self._target_resource, "object": updated},
            on_write,
            on_panic,
        )
