"""The global scheduler controller — batch edition.

A copy of ``kubeadmiral_tpu/federation/schedulerctl.py`` for the port's control
plane.

Mirrors the reference scheduler's control surface (reference:
pkg/controllers/scheduler/scheduler.go): watch federated objects,
policies, clusters and profiles; dedupe with a scheduling-trigger hash;
respect the pending-controllers pipeline; persist placements + replica
overrides + auxiliary annotations; hand off downstream.

The difference is the hot path: instead of one object per worker
goroutine through sequential plugin loops, every due object in a tick is
featurized into one batch and pushed through the port's engine
(kubeadmiral_tpu_torch.scheduler.engine), on the card unless the caller
hands it a ``SchedulerEngine(device="cpu")``.
"""

from __future__ import annotations

import dataclasses
import json as _json

from concurrent.futures import ThreadPoolExecutor
from typing import Optional

import numpy as np

from kubeadmiral_tpu_torch.federation import common as C
from kubeadmiral_tpu_torch.models import policy as P
from kubeadmiral_tpu_torch.runtime import trace
from kubeadmiral_tpu_torch.models import profile as PR
from kubeadmiral_tpu_torch.models import types as T
from kubeadmiral_tpu_torch.models.ftc import FederatedTypeConfig
from kubeadmiral_tpu_torch.models.types import parse_resources
from kubeadmiral_tpu_torch.runtime import pending, slo, tenancy
from kubeadmiral_tpu_torch.runtime.eventsink import DefederatingRecorderMux
from kubeadmiral_tpu_torch.runtime.metrics import Metrics
from kubeadmiral_tpu_torch.runtime.hostbatch import HostBatch
from kubeadmiral_tpu_torch.runtime.worker import BatchWorker, Result
from kubeadmiral_tpu_torch.scheduler.engine import ScheduleResult, SchedulerEngine
from kubeadmiral_tpu_torch.scheduler import webhook as W
from kubeadmiral_tpu_torch.testing.fakekube import (
    Conflict, FakeKube, NotFound, ShardIntake, obj_key,
)
from kubeadmiral_tpu_torch.utils.hashing import stable_json_hash
from kubeadmiral_tpu_torch.utils.unstructured import get_path

FEDERATED_CLUSTERS = C.FEDERATED_CLUSTERS

# Annotations the scheduler owns (reference: common constants +
# scheduler.go applySchedulingResult).
ENABLE_FOLLOWER_SCHEDULING = C.PREFIX + "enable-follower-scheduling"
POD_UNSCHEDULABLE_THRESHOLD = C.PREFIX + "pod-unschedulable-threshold"

# Per-object annotation overrides of policy fields
# (schedulingunit.go getters).
A_SCHEDULING_MODE = C.PREFIX + "scheduling-mode"
A_STICKY_CLUSTER = C.PREFIX + "sticky-cluster"
A_CLUSTER_SELECTOR = C.PREFIX + "cluster-selector"
A_PLACEMENTS = C.PREFIX + "placements"
A_MAX_CLUSTERS = C.PREFIX + "max-clusters"


def cluster_state_from_object(obj: dict) -> Optional[T.ClusterState]:
    """FederatedCluster dict -> scheduler view; None unless joined."""
    status = obj.get("status", {})
    conditions = {c.get("type"): c.get("status") for c in status.get("conditions", [])}
    if conditions.get("Joined") != "True":
        return None
    resources = status.get("resources", {})
    return T.ClusterState(
        name=obj["metadata"]["name"],
        labels=dict(obj["metadata"].get("labels", {})),
        taints=tuple(
            T.Taint(
                key=t.get("key", ""),
                value=t.get("value", ""),
                effect=t.get("effect", ""),
            )
            for t in obj.get("spec", {}).get("taints", ())
        ),
        allocatable=parse_resources(resources.get("allocatable", {})),
        available=parse_resources(resources.get("available", {})),
        api_resources=frozenset(status.get("apiResourceTypes", ())),
    )


def extract_pod_resource_request(template: dict) -> dict[str, int]:
    """Sum of container requests in the workload's pod template.

    The reference stubs this out (schedulingtriggers.go:188-191 returns an
    empty Resource); implemented here so ClusterResourcesFit/score plugins
    see real requests when present."""
    pod_spec = get_path(template, "spec.template.spec", {})
    total: dict[str, int] = {}
    for container in pod_spec.get("containers", ()) if isinstance(pod_spec, dict) else ():
        requests = get_path(container, "resources.requests", {}) or {}
        for name, q in parse_resources(requests).items():
            total[name] = total.get(name, 0) + q
    return total


class SchedulerController:
    name = C.SCHEDULER

    def __init__(
        self,
        host: FakeKube,
        ftc: FederatedTypeConfig,
        engine: Optional[SchedulerEngine] = None,
        metrics: Optional[Metrics] = None,
        webhook_client: Optional[W.HTTPClient] = None,
    ):
        self.host = host
        self.ftc = ftc
        self.engine = engine or SchedulerEngine()
        self.metrics = metrics or Metrics()
        # Scheduling events land on the federated object AND its
        # de-federated source, so `kubectl describe deployment` shows the
        # federation decision (scheduler.go eventRecorder; the message
        # strings share the flight recorder's reason vocabulary).
        self.recorder = DefederatingRecorderMux(host, C.SCHEDULER)
        self.worker = BatchWorker(f"scheduler-{ftc.name}", self.reconcile_batch, metrics=self.metrics)
        self._resource = ftc.federated.resource
        self._webhook_client = webhook_client
        self._webhook_pool: Optional[ThreadPoolExecutor] = None
        # name -> WebhookPlugin, maintained from config watch events
        # (scheduler.go s.webhookPlugins sync.Map).
        self.webhook_plugins: dict[str, W.WebhookPlugin] = {}
        # (namespace, name) -> parsed PolicySpec, invalidated by policy
        # watch events (see _policy_for / _on_policy_event).  The epoch
        # counter closes the read-then-cache race: an event landing
        # between a tick's try_get and its cache store bumps the epoch,
        # and the store is skipped (caching the pre-event spec would
        # pin it forever, since the trigger hash would keep matching).
        self._policy_cache: dict[tuple[str, str], P.PolicySpec] = {}
        self._policy_epoch: dict[tuple[str, str], int] = {}
        # Watch-boundary trigger filter: last metadata_change_sig per
        # key.  Status-subresource writes (sync's per-round status +
        # every member ack echo) leave the sig unchanged and never
        # re-enqueue — the trigger-hash skip in reconcile_batch would
        # no-op them anyway, but only after paying a per-key replan
        # check; at e2e scale that recheck WAS a whole extra tick.
        self._event_sigs: dict[str, int] = {}
        # Per-cluster scheduling-relevant signature (the _clusters_hash
        # fields + joined-ness): heartbeats and capacity-only status
        # bumps leave it unchanged and must NOT sweep-enqueue every
        # object — at 10000x500 such a sweep is a ~300k-enqueue storm
        # (one full-keyspace enqueue_all per cluster event, all of them
        # trigger-hash no-ops downstream).
        self._cluster_sweep_sigs: dict[str, str] = {}
        # The replica's shard filter, resolved once like the worker's:
        # non-owned object events are dropped pre-delivery (kt_predicate
        # runs batch-wise in the store), before they cost a handler
        # call, a metadata sig, or an enqueue.
        self._shard = self.worker._shard

        host.watch(
            self._resource,
            ShardIntake(self._on_object_event, predicate=self._owns_event),
            replay=True,
        )
        host.watch(P.PROPAGATION_POLICIES, self._on_policy_event, replay=False)
        host.watch(P.CLUSTER_PROPAGATION_POLICIES, self._on_policy_event, replay=False)
        host.watch(
            FEDERATED_CLUSTERS,
            ShardIntake(self._on_cluster_event, batch=self._on_cluster_events),
            replay=False,
        )
        host.watch(PR.SCHEDULING_PROFILES, self._on_profile_event, replay=False)
        host.watch(W.SCHEDULER_WEBHOOK_CONFIGS, self._on_webhook_config_event, replay=True)

    def _owns_event(self, event: str, obj: dict) -> bool:
        return self._shard.owns(obj_key(obj))

    # -- event handlers (fan-in to the dirty queue) ----------------------
    def _on_object_event(self, event: str, obj: dict) -> None:
        key = obj_key(obj)
        if event == "DELETED":
            self._event_sigs.pop(key, None)
            self.worker.enqueue(key)
            return
        # The syncing feedback annotation churns once per sync round and
        # never feeds a scheduling decision; everything else in
        # generation/labels/annotations does (policy binding labels,
        # pending-controllers, placements via generation).
        sig = C.metadata_change_sig(
            obj, ignore_annotations=(C.SOURCE_FEEDBACK_SYNCING,)
        )
        if self._event_sigs.get(key) == sig:
            return  # status-only write / feedback noise: no requeue
        self._event_sigs[key] = sig
        if self.worker.is_own_thread():
            # Echo of this controller's own persist (placements +
            # trigger-hash annotation): the sig is recorded so the next
            # foreign event diffs against the post-persist state, but
            # the persist itself needs no replan.
            return
        # The reconcile path's root span: the watch event that made the
        # object dirty (its tick shows up as a later worker.tick span;
        # the gap between the two is the queue wait, gauged by
        # worker_queue_wait_seconds).  Sampled — per-event spans at e2e
        # scale only evict each other from the ring (trace.hot_span).
        with trace.hot_span(
            "informer.event", resource=self._resource, event=event, key=key
        ):
            self.worker.enqueue(key)

    def _enqueue_objects_for_policies(self, policies: set[tuple[str, str]]) -> None:
        """Re-enqueue every federated object bound to one of the given
        (namespace, name) policy keys.  Scan without deep-copying: at
        100k objects a full copying LIST per event would stall the store."""
        if not policies:
            return
        matched: list[str] = []

        def check(fed: dict) -> None:
            if P.matched_policy_key(fed) in policies:
                matched.append(obj_key(fed))

        self.host.scan(self._resource, check)
        self.worker.enqueue_all(matched)

    def _on_policy_event(self, event: str, obj: dict) -> None:
        # (schedulingtriggers.go enqueueFederatedObjectsForPolicy).
        pname = obj["metadata"]["name"]
        pns = obj["metadata"].get("namespace", "")
        # Event-invalidated parse cache: the next tick re-reads + re-
        # parses this policy once instead of once per bound object.
        key = (pns, pname)
        self._policy_epoch[key] = self._policy_epoch.get(key, 0) + 1
        self._policy_cache.pop(key, None)
        self._enqueue_objects_for_policies({(pns, pname)})

    def _on_profile_event(self, event: str, obj: dict) -> None:
        # A profile change reschedules every object bound to a policy
        # naming that profile (scheduler.go enqueueFederatedObjectsForProfile
        # analogue).  The profile's generation is part of the trigger hash,
        # so hash-gated objects re-enter the engine.
        pname = obj["metadata"]["name"]
        policies: set[tuple[str, str]] = set()

        def collect(pol: dict) -> None:
            if pol.get("spec", {}).get("schedulingProfile", "") == pname:
                policies.add(
                    (pol["metadata"].get("namespace", ""), pol["metadata"]["name"])
                )

        self.host.scan(P.PROPAGATION_POLICIES, collect)
        self.host.scan(P.CLUSTER_PROPAGATION_POLICIES, collect)
        self._enqueue_objects_for_policies(policies)

    def _cluster_sweep_sig(self, obj: dict) -> str:
        """The scheduling-relevant signature of one cluster: exactly the
        fields _clusters_hash feeds the trigger hash, plus joined-ness.
        Anything that leaves it unchanged (heartbeats, capacity status
        bumps, sync's finalizer writes) cannot change a trigger hash,
        so sweeping the keyspace for it is pure enqueue-storm."""
        state = cluster_state_from_object(obj)
        if state is None:
            return "unjoined"
        return self._clusters_hash([state])

    def _on_cluster_events(self, events: list) -> None:
        """Coalesced cluster intake: flush-level dedup BEFORE the
        router — one committed flush of K cluster events triggers at
        most ONE full-keyspace sweep, and none at all when no event
        changed a scheduling-relevant field
        (schedulingtriggers.go enqueueFederatedObjectsForCluster, minus
        the per-heartbeat replay storm)."""
        sweep = False
        for event, obj in events:
            name = obj["metadata"]["name"]
            if event == "DELETED":
                self._cluster_sweep_sigs.pop(name, None)
                sweep = True
                continue
            sig = self._cluster_sweep_sig(obj)
            if self._cluster_sweep_sigs.get(name) != sig:
                self._cluster_sweep_sigs[name] = sig
                sweep = True
        if sweep:
            self.worker.enqueue_all(self.host.keys(self._resource))

    def _on_cluster_event(self, event: str, obj: dict) -> None:
        # Per-event (non-coalesced store) path of the same dedup.
        self._on_cluster_events([(event, obj)])

    def _on_webhook_config_event(self, event: str, obj: dict) -> None:
        """Register/refresh/remove the webhook plugin and reschedule
        everything (scheduler.go cacheWebhookPlugin + event fan-out).
        A malformed config must not escape the watch handler — it would
        break delivery to every later-registered watcher."""
        name = obj["metadata"]["name"]
        if event == "DELETED":
            self.webhook_plugins.pop(name, None)
        else:
            try:
                config = W.parse_webhook_config(obj)
            except Exception:
                self.metrics.counter(
                    f"scheduler-{self.ftc.name}.webhook_config_errors"
                )
                return
            if not any(
                v in W.SUPPORTED_PAYLOAD_VERSIONS for v in config.payload_versions
            ):
                self.metrics.counter(
                    f"scheduler-{self.ftc.name}.webhook_unsupported_payload"
                )
                self.webhook_plugins.pop(name, None)
            else:
                self.webhook_plugins[name] = W.WebhookPlugin(
                    config, client=self._webhook_client
                )
        self.worker.enqueue_all(self.host.keys(self._resource))

    # -- reconcile -------------------------------------------------------
    def _clusters(self) -> list[T.ClusterState]:
        out = []
        # list_view: cluster_state_from_object copies what it keeps.
        for obj in self.host.list_view(FEDERATED_CLUSTERS):
            state = cluster_state_from_object(obj)
            if state is not None:
                out.append(state)
        out.sort(key=lambda c: c.name)
        return out

    def _policy_for(self, fed_obj: dict) -> Optional[P.PolicySpec]:
        key = P.matched_policy_key(fed_obj)
        if key is None:
            return None
        ns, name = key
        # Watch-invalidated cache (_on_policy_event): thousands of
        # objects bind the same few policies, and per-object
        # try_get+parse was a top host cost of the scheduling tick.
        hit = self._policy_cache.get((ns, name))
        if hit is not None:
            return hit
        epoch = self._policy_epoch.get((ns, name), 0)
        resource = P.PROPAGATION_POLICIES if ns else P.CLUSTER_PROPAGATION_POLICIES
        obj = self.host.try_get(resource, f"{ns}/{name}" if ns else name)
        if obj is None:
            return None
        spec = P.parse_policy(obj)
        if self._policy_epoch.get((ns, name), 0) == epoch:
            self._policy_cache[(ns, name)] = spec
        return spec

    def _profile_for(self, policy: P.PolicySpec) -> Optional[PR.ProfileSpec]:
        """Cluster-scoped SchedulingProfile named by the policy
        (scheduler.go:371-376; missing profile schedules with defaults)."""
        if not policy.scheduling_profile:
            return None
        obj = self.host.try_get(PR.SCHEDULING_PROFILES, policy.scheduling_profile)
        return PR.parse_profile(obj) if obj else None

    @staticmethod
    def _clusters_hash(clusters) -> str:
        """One hash of the scheduling-relevant cluster state, shared by
        every object in a batch: hashing the full cluster list per object
        would be O(objects x clusters) JSON work per tick."""
        return str(
            stable_json_hash(
                [
                    [c.name, sorted(c.labels.items()),
                     [[t.key, t.value, t.effect] for t in c.taints],
                     sorted(c.api_resources)]
                    for c in clusters
                ]
            )
        )

    def _trigger_hash(
        self,
        fed_obj: dict,
        policy: P.PolicySpec,
        clusters_hash: str,
        profile: Optional[PR.ProfileSpec] = None,
        request: Optional[dict[str, int]] = None,
    ) -> str:
        ann = fed_obj["metadata"].get("annotations", {})
        scheduling_annotations = {
            k: v
            for k, v in sorted(ann.items())
            if k in (A_SCHEDULING_MODE, A_STICKY_CLUSTER, A_CLUSTER_SELECTOR,
                     A_PLACEMENTS, A_MAX_CLUSTERS)
        }
        replicas = get_path(C.template(fed_obj), self.ftc.path.replicas_spec, 0)
        trigger = {
            "annotations": scheduling_annotations,
            "replicas": replicas,
            "request": request
            if request is not None
            else extract_pod_resource_request(C.template(fed_obj)),
            "policy": [policy.namespace, policy.name, policy.generation],
            # Unlike the reference (schedulingtriggers.go hashes only the
            # policy), the profile and webhook-config generations are
            # hashed too so their edits reschedule bound objects instead
            # of being swallowed by the dedupe gate.
            "profile": [profile.name, profile.generation] if profile else None,
            # dict(...) snapshots against concurrent watch-thread mutation.
            "webhooks": sorted(
                (name, p.config.generation)
                for name, p in dict(self.webhook_plugins).items()
            ),
            "autoMigration": ann.get(C.AUTO_MIGRATION_INFO)
            if policy.auto_migration_enabled
            else None,
            "clusters": clusters_hash,
        }
        return str(stable_json_hash(trigger))

    def _scheduling_unit(
        self,
        fed_obj: dict,
        policy: P.PolicySpec,
        profile: Optional[PR.ProfileSpec] = None,
        request: Optional[dict[str, int]] = None,
    ) -> T.SchedulingUnit:
        template = C.template(fed_obj)
        meta = fed_obj["metadata"]
        ann = meta.get("annotations", {})

        mode = ann.get(A_SCHEDULING_MODE, policy.scheduling_mode)
        if mode == T.MODE_DIVIDE and not self.ftc.path.replicas_spec:
            mode = T.MODE_DUPLICATE
        desired = None
        if mode == T.MODE_DIVIDE:
            desired = get_path(template, self.ftc.path.replicas_spec)
            if desired is None:
                desired = 0

        # Current placements + this controller's replicas overrides
        # (schedulingunit.go:181-221).
        current: dict[str, Optional[int]] = {}
        placement = C.get_placement(fed_obj, self.name)
        if placement:
            own_overrides = C.get_overrides(fed_obj, self.name)
            replicas_path = "/" + self.ftc.path.replicas_spec.replace(".", "/")
            for cluster in placement:
                current[cluster] = None
                for patch in own_overrides.get(cluster, ()):
                    if patch.get("path") == replicas_path and patch.get("op", "replace") == "replace":
                        current[cluster] = int(patch["value"])
                        break

        auto = None
        if policy.auto_migration_enabled:
            info_raw = ann.get(C.AUTO_MIGRATION_INFO)
            estimated = {}
            if info_raw:
                estimated = _json.loads(info_raw).get("estimatedCapacity", {}) or {}
            auto = T.AutoMigrationSpec(
                keep_unschedulable_replicas=policy.keep_unschedulable_replicas,
                estimated_capacity={k: int(v) for k, v in estimated.items()},
            )

        sticky = ann.get(A_STICKY_CLUSTER, "").lower() == "true" or (
            A_STICKY_CLUSTER not in ann and policy.sticky_cluster
        )

        # Per-object annotation overrides of the policy's cluster set and
        # preferences (schedulingunit.go getters: placements annotation is
        # a JSON Placement list, cluster-selector a JSON object).
        cluster_selector = policy.cluster_selector
        if A_CLUSTER_SELECTOR in ann:
            cluster_selector = dict(_json.loads(ann[A_CLUSTER_SELECTOR]))
        cluster_names = policy.cluster_names
        min_replicas = policy.min_replicas()
        max_replicas = policy.max_replicas()
        weights = policy.weights()
        if A_PLACEMENTS in ann:
            placements = _json.loads(ann[A_PLACEMENTS])
            cluster_names = frozenset(p["cluster"] for p in placements)
            min_replicas, max_replicas, weights = {}, {}, {}
            for p in placements:
                prefs = p.get("preferences", {})
                if "minReplicas" in prefs:
                    min_replicas[p["cluster"]] = int(prefs["minReplicas"])
                if prefs.get("maxReplicas") is not None:
                    max_replicas[p["cluster"]] = int(prefs["maxReplicas"])
                if prefs.get("weight") is not None:
                    weights[p["cluster"]] = int(prefs["weight"])
        max_clusters = policy.max_clusters
        if A_MAX_CLUSTERS in ann:
            max_clusters = int(ann[A_MAX_CLUSTERS])

        # Profile-resolved plugin enablement (profile.go createFramework).
        # Disabling MaxCluster at the select point removes the top-K cap.
        enabled_filters, enabled_scores, enabled_selects = PR.resolve_plugins(profile)
        if T.MAX_CLUSTER not in enabled_selects:
            max_clusters = None

        return T.SchedulingUnit(
            gvk=self.ftc.source.gvk,
            namespace=meta.get("namespace", ""),
            name=meta["name"],
            labels=dict(template.get("metadata", {}).get("labels", {})),
            annotations=dict(template.get("metadata", {}).get("annotations", {})),
            desired_replicas=desired,
            resource_request=request
            if request is not None
            else extract_pod_resource_request(template),
            current_clusters=current,
            auto_migration=auto,
            scheduling_mode=mode,
            sticky_cluster=sticky,
            avoid_disruption=policy.avoid_disruption,
            cluster_selector=cluster_selector,
            cluster_names=cluster_names,
            affinity=policy.affinity(),
            tolerations=policy.tolerations,
            max_clusters=max_clusters,
            min_replicas=min_replicas,
            max_replicas=max_replicas,
            weights=weights,
            enabled_filters=enabled_filters,
            enabled_scores=enabled_scores,
            enabled_selects=enabled_selects,
        )

    def reconcile_batch(self, keys: list[str]) -> dict[str, Result]:
        results: dict[str, Result] = {}
        # SLO provenance: the batch pickup closes the ingress→scheduler
        # "queued" stage for every due key carrying a token
        # (runtime/slo.py; non-pending keys are one dict probe each).
        slo.mark_many(keys, "queued")
        clusters = self._clusters()
        clusters_hash = self._clusters_hash(clusters)
        # One profile lookup per distinct name per batch, not per object.
        profile_memo: dict[str, Optional[PR.ProfileSpec]] = {}

        def profile_for(policy: P.PolicySpec) -> Optional[PR.ProfileSpec]:
            name = policy.scheduling_profile
            if name not in profile_memo:
                profile_memo[name] = self._profile_for(policy)
            return profile_memo[name]

        to_schedule: list[tuple[str, dict, P.PolicySpec, str]] = []
        units = []
        for key in keys:
            # Per-object isolation: one malformed object (bad annotation
            # JSON, bad override value) must not poison the whole batch —
            # it alone backs off, matching the reference's per-object
            # worker semantics.
            try:
                fed_obj = self.host.try_get(self._resource, key)
                if fed_obj is None or fed_obj["metadata"].get("deletionTimestamp"):
                    results[key] = Result.ok()
                    continue
                try:
                    if not pending.dependencies_fulfilled(fed_obj, self.name):
                        results[key] = Result.ok()
                        continue
                except KeyError:
                    results[key] = Result.ok()  # not yet initialized by federate
                    continue
                if P.matched_policy_key(fed_obj) is None:
                    # No policy bound: deschedule (empty own placement)
                    # but still advance the pipeline so downstream
                    # controllers — override, follower, sync — process
                    # the object (scheduler.go:454-466 + persist).
                    results[key] = self._deschedule(fed_obj)
                    continue
                policy = self._policy_for(fed_obj)
                if policy is None:
                    # Bound policy not created yet: wait for its event
                    # (scheduler.go:356-367).
                    results[key] = Result.ok()
                    continue
                profile = profile_for(policy)
                # One template walk feeds both the trigger hash and the
                # scheduling unit (it was the tick's top repeated cost).
                request = extract_pod_resource_request(C.template(fed_obj))
                trigger = self._trigger_hash(
                    fed_obj, policy, clusters_hash, profile, request=request
                )
                if fed_obj["metadata"].get("annotations", {}).get(C.SCHEDULING_TRIGGER_HASH) == trigger:
                    # Skip scheduling, but still advance the pipeline:
                    # template-only changes re-arm pending-controllers
                    # without changing the trigger hash, and downstream
                    # controllers (override, sync) must still run
                    # (scheduler.go:423-434).
                    results[key] = self._advance_pipeline(fed_obj, modified=False)
                    continue
                units.append(
                    self._scheduling_unit(fed_obj, policy, profile, request=request)
                )
            except Exception:
                self.metrics.counter(f"scheduler-{self.ftc.name}.unit_errors")
                results[key] = Result.retry()
                continue
            to_schedule.append((key, fed_obj, policy, trigger))

        if not to_schedule:
            return results
        # Unit assembly done: the "slab" stage (trigger hashing +
        # featurization prep) closes; "engine" closes when the solve
        # returns, "fetch" when the placements are persisted below.
        slo_keys = [k for k, _, _, _ in to_schedule] if slo.active() else ()
        slo.mark_many(slo_keys, "slab")
        with trace.span(
            "scheduler.engine_tick", ftc=self.ftc.name, units=len(units)
        ) as tick_span, self.metrics.timer(
            f"scheduler-{self.ftc.name}.engine_latency"
        ):
            # ONE watch-thread-safe snapshot for the whole tick: the
            # score-decode decision and the select pass must agree on
            # the plugin set, or a select plugin registered mid-tick
            # would narrow on fabricated zero scores.
            plugins = dict(self.webhook_plugins)
            webhook_eval = self._webhook_eval(plugins, units, clusters)
            # Score decoding only matters when a select webhook might
            # consume it (the decode is the engine's main host cost).
            want_scores = any(p.has_select for p in plugins.values())
            outcomes = self.engine.schedule(
                units, clusters, webhook_eval=webhook_eval, want_scores=want_scores
            )
            outcomes = self._apply_webhook_selects(
                units, clusters, outcomes, plugins, webhook_eval
            )
            tick_span.set(tick=getattr(self.engine, "last_tick_id", 0))
        slo.mark_many(slo_keys, "engine")
        self.metrics.counter(f"scheduler-{self.ftc.name}.scheduled", len(units))
        self.metrics.counter(
            "scheduler_scheduled_total", len(units), ftc=self.ftc.name
        )
        # Per-tenant demand attribution (runtime/tenancy.py; no-op
        # unless a ledger is installed): which tenants are driving the
        # scheduler — the denominator the fair-admission arbitration
        # will weigh deferrals and sheds against.
        if tenancy.active():
            by_tenant: dict[str, int] = {}
            for key, _, _, _ in to_schedule:
                t = tenancy.tenant_of_key(key)
                by_tenant[t] = by_tenant.get(t, 0) + 1
            for t, n_objs in by_tenant.items():
                tenancy.note_scheduled(t, n_objs)

        hb = HostBatch(self.host)
        # The engine tick id rides the persist span too, so the event ->
        # engine -> member-write timeline joins on one id in
        # /debug/trace (and against /debug/waterfall).
        with trace.span(
            "scheduler.persist", ftc=self.ftc.name, units=len(to_schedule),
            tick=getattr(self.engine, "last_tick_id", 0),
        ):
            try:
                for (key, fed_obj, policy, trigger), outcome in zip(
                    to_schedule, outcomes
                ):
                    # Per-key isolation: one poison object backs off
                    # alone; every already-staged placement still
                    # flushes.
                    try:
                        results[key] = self._persist(
                            key, fed_obj, policy, trigger, outcome, hb, results
                        )
                    except Exception:
                        self.metrics.counter(
                            f"scheduler-{self.ftc.name}.persist_panic"
                        )
                        results[key] = Result.retry()
            finally:
                # ONE bulk host round trip persists every placement.
                hb.flush()
        slo.mark_many(slo_keys, "fetch")
        return results

    # -- webhook (out-of-process) plugins --------------------------------
    @staticmethod
    def _sticky_skip(su: T.SchedulingUnit) -> bool:
        """Plugins never run for a stickily placed object
        (generic_scheduler.go:103-107)."""
        return su.sticky_cluster and bool(su.current_clusters)

    def _webhook_eval(
        self, plugins: dict[str, W.WebhookPlugin], units=(), clusters=()
    ):
        """Host-side evaluator handed to the engine: AND of the unit's
        enabled webhook filters, sum of its webhook scores, per cluster.
        Any failing webhook call marks the cluster infeasible for this
        tick (the batch-mode analogue of the reference failing the whole
        per-object schedule and backing off).

        Batch-capable plugins are evaluated upfront: ONE POST per plugin
        per tick ships the whole (units x clusters) grid (vs the
        reference's O(B x C) HTTP calls, webhook/v1alpha1/plugin.go:77-251).
        Per-pair servers fall back to thread-pooled calls, memoized by
        object key so the select-narrowing rerun repeats nothing.
        ``plugins`` is the tick's plugin snapshot."""
        if not plugins:
            return None
        if self._webhook_pool is None:
            self._webhook_pool = ThreadPoolExecutor(
                max_workers=16, thread_name_prefix="webhook-eval"
            )
        pool = self._webhook_pool
        cache: dict[str, Optional[tuple]] = {}
        clusters = list(clusters)

        # -- upfront batched calls ---------------------------------------
        # plugin name -> key -> bool row / int row; a None row marks a
        # batch call that failed with a protocol error (all clusters
        # infeasible for those units this tick).
        prefilter: dict[str, dict[str, Optional[np.ndarray]]] = {}
        prescore: dict[str, dict[str, Optional[np.ndarray]]] = {}
        for name, plugin in plugins.items():
            if plugin.has_filter:
                subset = [
                    su
                    for su in units
                    if not self._sticky_skip(su)
                    and name in (su.enabled_filters or ())
                ]
                if subset:
                    try:
                        rows = plugin.filter_batch(subset, clusters)
                    except Exception:
                        self.metrics.counter(
                            f"scheduler-{self.ftc.name}.webhook_errors"
                        )
                        rows = [None] * len(subset)
                    if rows is not None:
                        prefilter[name] = {
                            su.key: np.asarray(row, bool)
                            if row is not None
                            else None
                            for su, row in zip(subset, rows)
                        }
            if plugin.has_score:
                subset = [
                    su
                    for su in units
                    if not self._sticky_skip(su)
                    and name in (su.enabled_scores or ())
                ]
                if subset:
                    try:
                        rows = plugin.score_batch(subset, clusters)
                    except Exception:
                        self.metrics.counter(
                            f"scheduler-{self.ftc.name}.webhook_errors"
                        )
                        rows = [None] * len(subset)
                    if rows is not None:
                        prescore[name] = {
                            su.key: np.asarray(row, np.int64)
                            if row is not None
                            else None
                            for su, row in zip(subset, rows)
                        }

        def eval_cluster(su, cluster, filters, scorers):
            score = np.int64(0)
            try:
                for plugin in filters:
                    if not plugin.filter(su, cluster):
                        return False, score
                for plugin in scorers:
                    score += plugin.score(su, cluster)
            except Exception:
                self.metrics.counter(f"scheduler-{self.ftc.name}.webhook_errors")
                return False, np.int64(0)
            return True, score

        def evaluate(su: T.SchedulingUnit, eval_clusters):
            if su.key in cache:
                return cache[su.key]
            if self._sticky_skip(su):
                cache[su.key] = None
                return None
            filters = [
                p
                for name in (su.enabled_filters or ())
                if (p := plugins.get(name)) is not None and p.has_filter
            ]
            scorers = [
                p
                for name in (su.enabled_scores or ())
                if (p := plugins.get(name)) is not None and p.has_score
            ]
            if not filters and not scorers:
                cache[su.key] = None
                return None
            c = len(eval_clusters)
            ok = np.ones(c, bool)
            score = np.zeros(c, np.int64)
            failed = False
            pair_filters, pair_scorers = [], []
            for plugin in filters:
                pre = prefilter.get(plugin.name)
                if pre is None:
                    pair_filters.append(plugin)
                    continue
                row = pre.get(su.key)
                if row is None:  # batch protocol error: infeasible tick
                    failed = True
                    break
                ok &= row
            if not failed:
                for plugin in scorers:
                    pre = prescore.get(plugin.name)
                    if pre is None:
                        pair_scorers.append(plugin)
                        continue
                    row = pre.get(su.key)
                    if row is None:
                        failed = True
                        break
                    score = score + row
            if failed:
                result = (np.zeros(c, bool), np.zeros(c, np.int64))
                cache[su.key] = result
                return result
            if pair_filters or pair_scorers:
                rows = list(
                    pool.map(
                        lambda cluster: eval_cluster(
                            su, cluster, pair_filters, pair_scorers
                        ),
                        eval_clusters,
                    )
                )
                ok &= np.array([r[0] for r in rows], bool)
                score = score + np.array([r[1] for r in rows], np.int64)
            cache[su.key] = (ok, score)
            return ok, score

        return evaluate

    def _apply_webhook_selects(
        self,
        units,
        clusters,
        outcomes: list[ScheduleResult],
        plugins: dict[str, W.WebhookPlugin],
        webhook_eval=None,
    ) -> list[ScheduleResult]:
        """Webhook select plugins narrow the tick's selected set; affected
        Divide-mode units are re-planned over the narrowed set in one
        follow-up batch (the sequential RunSelectClustersPlugin chain,
        framework.go:183-209, with the planner re-run batched).  The
        first pass's memoizing evaluator is reused so the rerun repeats
        no webhook filter/score calls; ``plugins`` is the same snapshot
        the scores were decoded for."""
        if not plugins:
            return outcomes
        by_name = {c.name: c for c in clusters}
        rerun_units, rerun_slots = [], []
        for i, (su, outcome) in enumerate(zip(units, outcomes)):
            if su.sticky_cluster and su.current_clusters:
                # Plugins never run for a stickily placed object
                # (generic_scheduler.go:103-107).
                continue
            selects = [
                p
                for name in (su.enabled_selects or ())
                if (p := plugins.get(name)) is not None and p.has_select
            ]
            if not selects or not outcome.clusters:
                continue
            narrowed = set(outcome.clusters)
            try:
                for plugin in selects:
                    cluster_scores = [
                        (by_name[c], outcome.scores.get(c, 0))
                        for c in sorted(narrowed)
                        if c in by_name
                    ]
                    narrowed &= set(plugin.select(su, cluster_scores))
            except Exception:
                self.metrics.counter(f"scheduler-{self.ftc.name}.webhook_errors")
                continue  # keep the un-narrowed outcome this tick
            if narrowed == set(outcome.clusters):
                continue
            if not narrowed:
                # An empty cluster_names means "no explicit placement" to
                # the featurizer, so short-circuit instead of re-running.
                outcomes = list(outcomes)
                outcomes[i] = ScheduleResult(clusters={})
                continue
            rerun_units.append(
                dataclasses.replace(
                    su,
                    cluster_names=frozenset(narrowed),
                    enabled_filters=tuple(
                        dict.fromkeys(
                            (su.enabled_filters or ()) + (T.PLACEMENT_FILTER,)
                        )
                    ),
                    enabled_selects=None,
                    max_clusters=None,
                )
            )
            rerun_slots.append(i)
        if not rerun_units:
            return outcomes
        rerun_outcomes = self.engine.schedule(
            rerun_units, clusters, webhook_eval=webhook_eval
        )
        outcomes = list(outcomes)
        for slot, new_outcome in zip(rerun_slots, rerun_outcomes):
            outcomes[slot] = new_outcome
        return outcomes

    def _record_schedule_event(
        self, key: str, fed_obj: dict, outcome: ScheduleResult, modified: bool
    ) -> None:
        """Scheduled / ScheduleFailed events with the flight recorder's
        explanation strings (scheduler.go's schedulingUnit events).
        Emitted when the decision changed (or failed), so steady-state
        re-persists don't churn event objects; identical repeats bump
        the event count instead of piling up."""
        try:
            if outcome.clusters:
                if not modified:
                    return
                placements = ", ".join(
                    name if reps is None else f"{name}({int(reps)})"
                    for name, reps in sorted(outcome.clusters.items())
                )
                self.recorder.event(
                    fed_obj, "Normal", "Scheduled",
                    f"scheduled to {len(outcome.clusters)} cluster(s): "
                    f"{placements}",
                )
                return
            detail = "no cluster selected"
            rec = getattr(self.engine, "flightrec", None)
            record = rec.lookup(key) if rec is not None else None
            if record is not None:
                from kubeadmiral_tpu_torch.runtime import flightrec as FR

                summary = FR.summarize_reasons(record)
                if summary:
                    detail = f"no cluster selected: {summary}"
            self.recorder.event(fed_obj, "Warning", "ScheduleFailed", detail)
        except Exception:
            pass  # event loss must never fail a persist

    # -- persistence -----------------------------------------------------
    def _advance_pipeline(self, fed_obj: dict, modified: bool) -> Result:
        """Remove self from pending-controllers (re-arming downstream when
        ``modified``) and persist, sharing the Conflict/NotFound policy of
        every scheduler write."""
        if not pending.update_pending(
            fed_obj, self.name, modified, self.ftc.controller_groups
        ):
            return Result.ok()
        try:
            self.host.update(self._resource, fed_obj)
        except Conflict:
            return Result.retry()
        except NotFound:
            pass
        return Result.ok()

    def _deschedule(self, fed_obj: dict) -> Result:
        """No policy bound: clear own placement/overrides and hand off
        downstream (scheduler.go schedule() with nil policy)."""
        assert self._shard.owns(obj_key(fed_obj)), (
            f"shard violation: replica {self._shard.shard_index}/"
            f"{self._shard.shard_count} descheduling non-owned key "
            f"{obj_key(fed_obj)}"
        )
        modified = C.set_placement(fed_obj, self.name, set())
        if C.get_overrides(fed_obj, self.name):
            C.set_overrides(fed_obj, self.name, {})
            modified = True
        pend = pending.update_pending(
            fed_obj, self.name, modified, self.ftc.controller_groups
        )
        if not (modified or pend):
            return Result.ok()
        try:
            self.host.update(self._resource, fed_obj)
        except Conflict:
            return Result.retry()
        except NotFound:
            pass
        return Result.ok()

    def _persist(
        self,
        key: str,
        fed_obj: dict,
        policy: P.PolicySpec,
        trigger: str,
        outcome: ScheduleResult,
        hb: HostBatch,
        results: dict,
    ) -> Result:
        # Disjoint-by-construction guard: a replica persists placements
        # ONLY for keys its shard owns.  The intake boundary already
        # filters, so tripping this means a key bypassed the router
        # (double-scheduling across replicas) — fail loudly.
        assert self._shard.owns(key), (
            f"shard violation: replica {self._shard.shard_index}/"
            f"{self._shard.shard_count} persisting non-owned key {key}"
        )
        modified = C.set_placement(fed_obj, self.name, outcome.cluster_set)

        # Replicas overrides for Divide-mode results (scheduler/util.go:71-110).
        desired = {
            cl: reps for cl, reps in outcome.clusters.items() if reps is not None
        }
        replicas_path = "/" + self.ftc.path.replicas_spec.replace(".", "/") if self.ftc.path.replicas_spec else None
        own = C.get_overrides(fed_obj, self.name)
        new_overrides: dict[str, list] = {}
        if replicas_path:
            for cl, reps in desired.items():
                new_overrides[cl] = [
                    {"op": "replace", "path": replicas_path, "value": int(reps)}
                ]
        if new_overrides != own:
            C.set_overrides(fed_obj, self.name, new_overrides)
            modified = True

        ann = fed_obj["metadata"].setdefault("annotations", {})
        follower_value = "false" if policy.disable_follower_scheduling else "true"
        if ann.get(ENABLE_FOLLOWER_SCHEDULING) != follower_value:
            ann[ENABLE_FOLLOWER_SCHEDULING] = follower_value
            modified = True
        if policy.auto_migration_enabled and policy.pod_unschedulable_seconds is not None:
            threshold = f"{policy.pod_unschedulable_seconds:g}s"
            if ann.get(POD_UNSCHEDULABLE_THRESHOLD) != threshold:
                ann[POD_UNSCHEDULABLE_THRESHOLD] = threshold
                modified = True
        elif POD_UNSCHEDULABLE_THRESHOLD in ann:
            del ann[POD_UNSCHEDULABLE_THRESHOLD]
            modified = True

        ann[C.SCHEDULING_TRIGGER_HASH] = trigger
        pending.update_pending(fed_obj, self.name, modified, self.ftc.controller_groups)
        self._record_schedule_event(key, fed_obj, outcome, modified)

        def on_persist(result: dict) -> None:
            code = result.get("code")
            if code in (200, 404):
                return  # persisted, or object gone
            # Conflict (or transport): requeue with backoff; the next
            # tick re-reads the object, recomputes the trigger hash and
            # reschedules — the batch analogue of the reference's
            # per-object retry loop.
            results[key] = Result.retry()

        def on_panic() -> None:
            results[key] = Result.retry()

        hb.stage(
            {"verb": "update", "resource": self._resource, "object": fed_obj},
            on_persist,
            on_panic,
        )
        return Result.ok()
