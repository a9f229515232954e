"""The auto-migration controller: unschedulable-pod capacity feedback.

A copy of ``kubeadmiral_tpu/federation/automigration.py`` for the port's
control plane.

Closes the elastic-recovery loop (reference:
pkg/controllers/automigration/controller.go:88-441, util.go:29-70): the
scheduler stamps a pod-unschedulable-threshold annotation from the
policy; this controller lists each placed cluster's workload pods, counts
the ones stuck Unschedulable beyond the threshold, derives per-cluster
``estimatedCapacity``, and writes it into the auto-migration-info
annotation — whose change re-triggers the scheduler, which caps those
clusters in the planner and shifts replicas elsewhere.
"""

from __future__ import annotations

import json
import time
from typing import Optional

from kubeadmiral_tpu_torch.federation import common as C
from kubeadmiral_tpu_torch.federation.schedulerctl import POD_UNSCHEDULABLE_THRESHOLD
from kubeadmiral_tpu_torch.models.ftc import FederatedTypeConfig
from kubeadmiral_tpu_torch.models.policy import _parse_duration
from kubeadmiral_tpu_torch.runtime.metrics import Metrics
from kubeadmiral_tpu_torch.runtime.worker import Result, Worker
from kubeadmiral_tpu_torch.testing.fakekube import (
    ClusterFleet,
    Conflict,
    NotFound,
    obj_key,
)
from kubeadmiral_tpu_torch.utils.unstructured import get_path

PODS = "v1/pods"


def _pod_scheduled_condition(pod: dict) -> Optional[dict]:
    for cond in pod.get("status", {}).get("conditions", []) or []:
        if cond.get("type") == "PodScheduled":
            return cond
    return None


def _transition_time(value) -> Optional[float]:
    """Condition timestamps as seconds: accepts the monotonic floats the
    in-process tests use AND the RFC3339 strings real pods carry
    (metav1.Time in automigration/util.go).  Malformed timestamps yield
    None — the caller skips the condition rather than treating the pod
    as unschedulable-since-epoch (which would silently migrate on
    garbage input).  A MISSING timestamp still maps to 0.0 — Go's
    metav1.Time zero value — matching the reference's time.Since(zero)
    behavior."""
    if not value:
        return 0.0
    try:
        return float(value)
    except (TypeError, ValueError):
        pass
    import datetime

    try:
        return datetime.datetime.fromisoformat(
            str(value).replace("Z", "+00:00")
        ).timestamp()
    except ValueError:
        return None


def count_unschedulable_pods(
    pods: list[dict], now: float, threshold: float
) -> tuple[int, Optional[float]]:
    """(count past threshold, seconds until the next pod crosses)
    (automigration/util.go:29-70)."""
    count = 0
    next_cross: Optional[float] = None
    for pod in pods:
        if pod["metadata"].get("deletionTimestamp"):
            continue
        cond = _pod_scheduled_condition(pod)
        if (
            cond is None
            or cond.get("status") != "False"
            or cond.get("reason") != "Unschedulable"
        ):
            continue
        since = _transition_time(cond.get("lastTransitionTime", 0))
        if since is None:  # malformed timestamp: not yet crossed
            continue
        crossing_in = since + threshold - now
        if crossing_in <= 0:
            count += 1
        elif next_cross is None or crossing_in < next_cross:
            next_cross = crossing_in
    return count, next_cross


def pods_for_workload(member, workload: dict) -> list[dict]:
    """Pods matching the workload's selector in its namespace
    (automigration/plugins pod listing)."""
    selector = get_path(workload, "spec.selector.matchLabels") or {}
    namespace = workload["metadata"].get("namespace", "")
    out = []

    def check(pod: dict) -> None:
        if pod["metadata"].get("namespace", "") != namespace:
            return
        labels = pod["metadata"].get("labels", {}) or {}
        if all(labels.get(k) == v for k, v in selector.items()):
            out.append(pod)

    member.scan(PODS, check)
    return out


class AutoMigrationController:
    """Per-FTC controller feeding estimatedCapacity to the scheduler."""

    name = "auto-migration-controller"

    def __init__(
        self,
        fleet: ClusterFleet,
        ftc: FederatedTypeConfig,
        metrics: Optional[Metrics] = None,
        clock=None,
        pod_informer=None,
    ):
        self.fleet = fleet
        self.host = fleet.host
        self.ftc = ftc
        # Optional shared PodInformer (runtime/podinformer.py): pruned
        # per-cluster pod caches instead of scanning full pod objects
        # (the 50k-pod memory discipline, federatedclient/podinformer.go).
        self.pod_informer = pod_informer
        self.metrics = metrics or Metrics()
        self._clock = clock or time.time
        self._fed_resource = ftc.federated.resource
        self._target_resource = ftc.source.resource
        self.worker = Worker(
            f"automigration-{ftc.name}",
            self.reconcile,
            metrics=self.metrics,
            clock=clock,
        )
        self.host.watch(self._fed_resource, self._on_event, replay=True)
        self._reattach = fleet.watch_members(PODS, self._on_member_pod_event)
        # ktlint: ignore[shard-intake-coverage] broadcast: cluster topology changes reattach member pod watches on every replica; per-key work still routes through the shard-filtered worker
        self.host.watch(C.FEDERATED_CLUSTERS, self._on_cluster_event, replay=False)
        if self.pod_informer is not None:
            self.pod_informer.attach()

    def _on_event(self, event: str, obj: dict) -> None:
        self.worker.enqueue(obj_key(obj))

    def _on_member_pod_event(self, event: str, pod: dict) -> None:
        # A pod event re-reconciles the workloads in its namespace; the
        # reference scopes this precisely via per-workload pod informers
        # (automigration pod handler); matching by namespace over the
        # object cache is the lean equivalent.
        ns = pod["metadata"].get("namespace", "")
        matched: list[str] = []

        def check(fed: dict) -> None:
            if fed["metadata"].get("namespace", "") == ns:
                matched.append(obj_key(fed))

        self.host.scan(self._fed_resource, check)
        self.worker.enqueue_all(matched)

    def _on_cluster_event(self, event: str, obj: dict) -> None:
        self._reattach()
        if self.pod_informer is not None:
            self.pod_informer.attach()

    def run_until_idle(self) -> None:
        while self.worker.step():
            pass

    # -- reconcile (controller.go:178-290) -------------------------------
    def reconcile(self, key: str) -> Result:
        self.metrics.counter("auto-migration.throughput")
        fed_obj = self.host.try_get(self._fed_resource, key)
        if fed_obj is None or fed_obj["metadata"].get("deletionTimestamp"):
            return Result.ok()

        ann = fed_obj["metadata"].setdefault("annotations", {})
        threshold = _parse_duration(ann.get(POD_UNSCHEDULABLE_THRESHOLD))

        needs_update = False
        requeue_after: Optional[float] = None
        if threshold is None:
            # Auto migration disabled: clean up.
            if C.AUTO_MIGRATION_INFO in ann:
                del ann[C.AUTO_MIGRATION_INFO]
                needs_update = True
        else:
            estimated, requeue_after = self._estimate_capacity(
                fed_obj, key, threshold
            )
            desired_info = {"estimatedCapacity": estimated} if estimated else {}
            try:
                existing_info = json.loads(ann.get(C.AUTO_MIGRATION_INFO, "{}"))
            except ValueError:
                existing_info = {}
            if existing_info != desired_info:
                if desired_info:
                    ann[C.AUTO_MIGRATION_INFO] = C.compact_json(desired_info)
                else:
                    ann.pop(C.AUTO_MIGRATION_INFO, None)
                needs_update = True

        if needs_update:
            try:
                self.host.update(self._fed_resource, fed_obj)
            except Conflict:
                return Result.retry()
            except NotFound:
                return Result.ok()
        if requeue_after is not None:
            return Result.after(requeue_after)
        return Result.ok()

    def _estimate_capacity(
        self, fed_obj: dict, key: str, threshold: float
    ) -> tuple[dict[str, int], Optional[float]]:
        """(controller.go:292-380 estimateCapacity)."""
        now = self._clock()
        estimated: dict[str, int] = {}
        retry_after: Optional[float] = None
        replicas_path = self.ftc.path.replicas_spec or "spec.replicas"

        for cname in sorted(C.all_placement_clusters(fed_obj)):
            try:
                member = self.fleet.member(cname)
            except NotFound:
                continue
            workload = member.try_get_view(self._target_resource, key)  # read-only
            if workload is None:
                continue

            # Skip pod listing when everything is ready (the reference's
            # total==ready optimization).
            total = get_path(workload, "status.replicas")
            ready = get_path(workload, "status.readyReplicas")
            if total is not None and total == ready:
                continue

            desired = int(get_path(workload, replicas_path) or 0)
            pods = None
            if self.pod_informer is not None:
                pods = self.pod_informer.pods_for(
                    cname,
                    workload["metadata"].get("namespace", ""),
                    get_path(workload, "spec.selector.matchLabels") or {},
                )
            if pods is None:
                # Informer not (yet) watching this cluster (cold attach /
                # rejoin window): scan the member directly rather than
                # trusting an empty snapshot.
                pods = pods_for_workload(member, workload)
            unschedulable, next_cross = count_unschedulable_pods(
                pods, now, threshold
            )
            if next_cross is not None and (
                retry_after is None or next_cross < retry_after
            ):
                retry_after = next_cross

            if len(pods) >= desired:
                capacity = len(pods) - unschedulable
            else:
                # Uncreated pods count as schedulable so they aren't
                # migrated before they exist (controller.go:349-355).
                capacity = desired - unschedulable

            if capacity >= desired:
                continue  # nothing to migrate; omit to avoid rescheduling
            estimated[cname] = max(0, capacity)
        return estimated, retry_after
