"""The sync controller: propagate federated objects to member clusters.

A copy of ``kubeadmiral_tpu/federation/sync.py`` for the port's control
plane.

The propagation engine (reference: pkg/controllers/sync/controller.go):
for each federated object, compute placement ∩ joined clusters, dispatch
parallel create/update/delete against member apiservers, record per-
cluster propagation status and object versions, and handle deletion with
finalizers, orphaning annotations and cluster cascading-delete.

Batching: where the reference runs one goroutine per federated object
(worker.go:37-174) and one goroutine per member write
(dispatch/operation.go:102-123), this controller is tick-native — a
BatchWorker drains every due object, the whole tick shares one
cluster-list scan and one cross-object :class:`dispatch.BatchSink`, and
the flush issues ONE bulk write per member cluster.  Echoes of the
controller's own writes (member events, fed status events) are
suppressed at the watch boundary so a converged tick stays converged
instead of re-reconciling itself forever.
"""

from __future__ import annotations

import threading
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Optional, Union

from kubeadmiral_tpu_torch.federation import common as C
from kubeadmiral_tpu_torch.federation import dispatch as D
from kubeadmiral_tpu_torch.federation import rollout as R
from kubeadmiral_tpu_torch.federation.resource import (
    FederatedResource,
    orphaning_behavior,
    should_adopt_preexisting,
)
from kubeadmiral_tpu_torch.federation.history import (
    LAST_REVISION_ANNOTATION,
    RevisionManager,
    RevisionSyncError,
)
from kubeadmiral_tpu_torch.federation.retain import CURRENT_REVISION_ANNOTATION
from kubeadmiral_tpu_torch.federation.version import VersionManager
from kubeadmiral_tpu_torch.models.ftc import FederatedTypeConfig
from kubeadmiral_tpu_torch.runtime.eventsink import DefederatingRecorderMux
from kubeadmiral_tpu_torch.runtime import pending, slo
from kubeadmiral_tpu_torch.runtime.hostbatch import HostBatch
from kubeadmiral_tpu_torch.runtime.metrics import Metrics
from kubeadmiral_tpu_torch.runtime.worker import BatchWorker, Result
from kubeadmiral_tpu_torch.transport import breaker as B
from kubeadmiral_tpu_torch.testing.fakekube import (
    DELETED,
    ClusterFleet,
    Conflict,
    FakeKube,
    NotFound,
    ShardIntake,
    obj_key,
)

FEDERATED_CLUSTERS = C.FEDERATED_CLUSTERS

# Bulk point reads over network fleets (the JAX module's KT_BULK_READS
# default, on).  The in-process FakeKube fleet never takes them.
BULK_READS = True

# Cascading-delete opt-in annotation on FederatedCluster
# (reference: util/cascadingdeleteannotation.go:24-37).
CASCADING_DELETE = C.PREFIX + "cascading-delete"

ORPHAN_ALL = "all"
ORPHAN_ADOPTED = "adopted"

# Worker-queue namespace for FederatedCluster reconciles (the reference
# runs a second ReconcileWorker, clusterWorker; one queue with a key
# prefix keeps ordering here).
_CLUSTER_KEY_PREFIX = "cluster::"

# AggregateReason values surfaced in the Propagation condition
# (reference: pkg/apis/types/v1alpha1/types_status.go AggregateReason).
AGGREGATE_SUCCESS = "AggregateSuccess"
CHECK_CLUSTERS = "CheckClusters"


def is_cluster_joined(cluster_obj: dict) -> bool:
    conds = {
        c.get("type"): c.get("status")
        for c in cluster_obj.get("status", {}).get("conditions", [])
    }
    return conds.get("Joined") == "True"


def is_cluster_ready(cluster_obj: dict) -> bool:
    conds = {
        c.get("type"): c.get("status")
        for c in cluster_obj.get("status", {}).get("conditions", [])
    }
    return conds.get("Ready") == "True"


def is_cascading_delete_enabled(cluster_obj: dict) -> bool:
    return CASCADING_DELETE in cluster_obj.get("metadata", {}).get("annotations", {})


def _apply_desired_status(
    obj: dict,
    reason: str,
    status_map: dict[str, str],
    collision_count: Optional[int],
) -> bool:
    """Write the desired propagation status shape into ``obj`` in place;
    True when anything changed (controller.go:637-721's diff) — ONE
    definition shared by the optimistic batched write and the
    synchronous conflict-retry fallback."""
    desired_clusters = [
        {"cluster": c, "status": s} for c, s in sorted(status_map.items())
    ]
    status = obj.setdefault("status", {})
    old_conditions = {c.get("type"): c for c in status.get("conditions", [])}
    prop = old_conditions.get("Propagation", {})
    new_status = "True" if reason == AGGREGATE_SUCCESS else "False"
    changed = (
        status.get("clusters") != desired_clusters
        or prop.get("reason") != reason
        or prop.get("status") != new_status
    )
    if collision_count is not None and status.get("collisionCount") != collision_count:
        status["collisionCount"] = collision_count
        changed = True
    if not changed:
        return False
    status["clusters"] = desired_clusters
    status["conditions"] = [
        c for t, c in sorted(old_conditions.items()) if t != "Propagation"
    ] + [{"type": "Propagation", "status": new_status, "reason": reason}]
    return True


def _syncing_value(status_map: dict[str, str], generation: int) -> str:
    """The sourcefeedback syncing annotation payload
    (sourcefeedback/syncing.go PopulateSyncingAnnotation)."""
    return C.compact_json(
        {
            "generation": None,
            "fedGeneration": generation,
            "clusters": [
                {"name": c, "status": s} for c, s in sorted(status_map.items())
            ],
        }
    )


def _cluster_lifecycle_sig(cluster_obj: dict) -> tuple:
    """What about a FederatedCluster makes sync re-reconcile the world:
    join/ready/terminating/cascading transitions (controller.go:244-260
    ClusterLifecycleHandlers) — NOT heartbeat timestamp bumps."""
    return (
        is_cluster_joined(cluster_obj),
        is_cluster_ready(cluster_obj),
        bool(cluster_obj["metadata"].get("deletionTimestamp")),
        is_cascading_delete_enabled(cluster_obj),
    )


class _TickClusters:
    """One tick's shared view of the member fleet: the cluster list is
    scanned ONCE per BatchWorker tick instead of once per object, and
    per-object work is O(candidate clusters), not O(all clusters)."""

    __slots__ = ("flags", "joined_set")

    def __init__(self, joined: list[dict]):
        # name -> (ready, terminating, cascading) per joined cluster.
        self.flags = {
            c["metadata"]["name"]: (
                is_cluster_ready(c),
                bool(c["metadata"].get("deletionTimestamp")),
                bool(c["metadata"].get("deletionTimestamp"))
                and is_cascading_delete_enabled(c),
            )
            for c in joined
        }
        self.joined_set = frozenset(self.flags)


class SyncController:
    """Per-FTC propagation controller (sync/controller.go:90-135)."""

    name = "sync-controller"

    def __init__(
        self,
        fleet: ClusterFleet,
        ftc: FederatedTypeConfig,
        metrics: Optional[Metrics] = None,
        max_dispatch_workers: int = 16,
        clock=None,
    ):
        self.fleet = fleet
        self.host = fleet.host
        self.ftc = ftc
        self.metrics = metrics or Metrics()
        self._fed_resource = ftc.federated.resource
        self._target_resource = ftc.source.resource
        self.versions = VersionManager(self.host, ftc.source.kind, ftc.namespaced)
        self.revisions = RevisionManager(self.host) if ftc.revision_history else None
        # Events recorded on the federated object are re-targeted to the
        # source object too (util/eventsink DefederatingRecorderMux).
        self.recorder = DefederatingRecorderMux(self.host, f"sync-{ftc.name}")
        # Local (in-process store) fleets dispatch member writes inline:
        # the per-op thread fan-out costs more than the in-memory ops it
        # parallelizes.  Network fleets keep the per-cluster parallel
        # dispatch (operation.go:102-123).
        self._inline = isinstance(fleet.host, FakeKube)
        self.pool = (
            None
            if self._inline
            else ThreadPoolExecutor(max_workers=max_dispatch_workers)
        )
        # Bulk point reads (BULK_READS, network fleets only): one
        # tick's federated objects and candidate member objects are
        # prefetched through the /batch protocol — MEMBER_BATCH keys
        # per round trip — instead of one GET per (object, member) pair.
        # In-process stores serve free view reads, so the in-memory
        # fleet keeps the direct path.
        self._bulk_reads = not self._inline and BULK_READS
        # (cluster, key) -> ("ok", obj|None) | ("err", message), valid
        # for the duration of one reconcile_batch tick.
        self._tick_reads: dict[tuple[str, str], tuple[str, object]] = {}
        # Per-member circuit breakers, SHARED across this fleet's
        # controllers (transport/breaker.py): a member that stalled one
        # flush short-circuits the next tick's reads and writes to
        # ClusterNotReady immediately instead of re-parking threads.
        self.breakers = B.for_fleet(fleet, metrics=self.metrics)
        self.breakers.on_transition(self._on_breaker_transition)
        self.worker = BatchWorker(
            f"sync-{ftc.name}", self.reconcile_batch, metrics=self.metrics, clock=clock
        )
        # Echo suppression: the thread currently inside reconcile_batch
        # (in-process stores deliver watch events synchronously on the
        # writer's thread — any event arriving on it mid-tick was caused
        # by this controller's own write), plus resourceVersion maps of
        # this controller's last writes for async transports.
        self._flush_threads: set[int] = set()
        self._own_member_rv: dict[tuple[str, str], str] = {}
        self._own_fed_rv: dict[str, str] = {}
        # Live index of which member clusters hold each object (fed by
        # the member watches + this controller's own writes) — the
        # informer-cache analogue that lets a reconcile visit only
        # candidate clusters instead of scanning the whole fleet.  It is
        # an accelerator, not the source of truth: restart-safe deletion
        # candidates come from the fed object's persisted status.clusters.
        self._member_index: dict[str, set[str]] = {}
        self._index_lock = threading.Lock()
        # Last seen lifecycle signature per cluster, so heartbeat-only
        # cluster updates don't re-enqueue every federated object.
        self._cluster_sigs: dict[str, tuple] = {}
        # Per-FTC cascading-delete finalizer held on FederatedCluster
        # objects (controller.go:216 cascadingDeleteFinalizer).
        self.cluster_finalizer = C.PREFIX + "cascading-delete-" + ftc.name
        # Member-object events re-enqueue the owning federated object
        # (the FederatedInformer path, SURVEY §3.3) — rollout planning in
        # particular must observe member progress between dispatches.
        # Attached before the cluster watch: its replay fires
        # _on_cluster_event, which re-attaches members, synchronously.
        # replay=True: existing member objects stream through the handler
        # at attach, populating the member index — the informer's initial
        # LIST, without which pre-existing managed objects in clusters
        # outside the current placement would never be visited for
        # cleanup (federatedinformer.go:151-250).
        # The replica's shard filter (resolved once, like the worker's):
        # non-owned member/fed events are dropped batch-wise BEFORE
        # delivery — at 500 members a flush fans out to every replica,
        # and the filter keeps each replica's share of the handler work
        # at ~1/N instead of N copies of everything.
        self._shard = self.worker._shard
        self._reattach_members = fleet.watch_members(
            self._target_resource, self._on_member_event, named=True, replay=True,
            batch=self._on_member_events, predicate=self._owns_event,
        )
        self.host.watch(
            self._fed_resource,
            ShardIntake(self._on_fed_event, predicate=self._owns_event),
            replay=True,
        )
        self.host.watch(FEDERATED_CLUSTERS, self._on_cluster_event, replay=True)

    def _owns_event(self, event: str, obj: dict) -> bool:
        return self._shard.owns(obj_key(obj))

    def watch_owners(self) -> list[object]:
        """Everything holding watch registrations on this controller's
        behalf (consumed by the manager's dynamic teardown)."""
        owners: list[object] = [self]
        if self.revisions is not None:
            owners.append(self.revisions)
        return owners

    # -- event fan-in ----------------------------------------------------
    def _is_own_echo(self) -> bool:
        # Worker-tracked reconcile threads + the BatchSink's pool-flush
        # threads: in-process stores deliver watch events synchronously
        # on the writing thread, so an event on any of these is an echo
        # of this controller's own write.
        return (
            self.worker.is_own_thread()
            or threading.get_ident() in self._flush_threads
        )

    def _on_fed_event(self, event: str, obj: dict) -> None:
        key = obj_key(obj)
        if event == DELETED:
            # Cleanup before the echo check: inline deletions deliver
            # their DELETED event on the tick thread, and the rv entry
            # must not outlive the object.
            self._own_fed_rv.pop(key, None)
            if self._is_own_echo():
                return
        elif self._is_own_echo() or self._own_fed_rv.get(key) == str(
            obj.get("metadata", {}).get("resourceVersion", "")
        ):
            return  # our own status/annotation write coming back around
        self.worker.enqueue(key)

    def _on_member_event(self, cluster: str, event: str, obj: dict) -> None:
        key = obj_key(obj)
        # Index maintenance runs for EVERY event, echoes included.
        if event == DELETED:
            with self._index_lock:
                held = self._member_index.get(key)
                if held is not None:
                    held.discard(cluster)
                    if not held:
                        self._member_index.pop(key, None)
            self._own_member_rv.pop((cluster, key), None)
            if self._is_own_echo():
                return
        else:
            with self._index_lock:
                self._member_index.setdefault(key, set()).add(cluster)
            if self._is_own_echo() or self._own_member_rv.get((cluster, key)) == str(
                obj.get("metadata", {}).get("resourceVersion", "")
            ):
                return  # echo of our own member write
        self.worker.enqueue(key)

    def _on_member_events(self, cluster: str, events: list) -> None:
        """Coalesced member-watch intake: one committed store flush
        ``[(event, obj), ...]`` in commit order.  Same decisions as
        :meth:`_on_member_event` per event, batched where per-event cost
        was pure overhead: the thread-identity echo check runs once
        (delivery is synchronous on the writing thread, so it cannot
        change mid-flush), index maintenance runs under ONE lock hold,
        and enqueues dedupe into one :meth:`~runtime.worker._WorkerBase.
        enqueue_many` call."""
        self.metrics.counter("member_watch_flushes_total", controller=self.worker.name)
        self.metrics.counter(
            "member_watch_flush_events_total", len(events), controller=self.worker.name
        )
        own_echo = self._is_own_echo()
        enqueue: dict[str, None] = {}
        with self._index_lock:
            for event, obj in events:
                key = obj_key(obj)
                if event == DELETED:
                    held = self._member_index.get(key)
                    if held is not None:
                        held.discard(cluster)
                        if not held:
                            self._member_index.pop(key, None)
                    self._own_member_rv.pop((cluster, key), None)
                    if own_echo:
                        continue
                else:
                    self._member_index.setdefault(key, set()).add(cluster)
                    if own_echo or self._own_member_rv.get((cluster, key)) == str(
                        obj.get("metadata", {}).get("resourceVersion", "")
                    ):
                        continue
                enqueue[key] = None
        if enqueue:
            self.worker.enqueue_many(enqueue)

    def _on_cluster_event(self, event: str, obj: dict) -> None:
        # Cluster lifecycle re-enqueues everything (controller.go:244-260)
        # and reconciles the per-cluster cascading-delete finalizer —
        # but only on join/ready/terminating transitions, not heartbeats,
        # and never for this controller's own finalizer writes.
        if self._is_own_echo():
            return
        name = obj["metadata"]["name"]
        if event == DELETED:
            self._cluster_sigs.pop(name, None)
            self.worker.enqueue_all(self.host.keys(self._fed_resource))
            return
        sig = _cluster_lifecycle_sig(obj)
        if self._cluster_sigs.get(name) == sig:
            # Heartbeat / unrelated metadata bump: no object re-enqueue,
            # but give the member-watch attach loop its retry channel —
            # a network fleet may have failed a cluster's attach (join
            # secret not yet readable) after the signature stabilized.
            if getattr(self._reattach_members, "pending", None):
                self._reattach_members()
            return
        self._cluster_sigs[name] = sig
        self._reattach_members()
        self.worker.enqueue(_CLUSTER_KEY_PREFIX + name)
        self.worker.enqueue_all(self.host.keys(self._fed_resource))

    def _on_breaker_transition(self, name: str, old: str, new: str) -> None:
        # A member's breaker closing means its shed writes can land now:
        # re-drive every federated object instead of waiting out each
        # key's exponential backoff (the recovery-latency half of the
        # "shed to a background requeue" contract).
        if new == B.CLOSED:
            self.worker.enqueue_all(self.host.keys(self._fed_resource))

    def _member_client(self, cluster: str) -> FakeKube:
        return self.fleet.member(cluster)

    def _guarded_member_read(
        self, dispatcher: D.ManagedDispatcher, cname: str, key: str
    ):
        """Member read feeding the breaker: transport failures (a hung
        or erroring member) record breaker evidence and settle the
        cluster at ClusterNotReady — they must not escape and poison the
        whole object's plan.  Returns (ok, cluster_obj)."""
        cached = self._tick_reads.get((cname, key))
        if cached is not None:
            kind, value = cached
            if kind == "err":
                # Breaker evidence was recorded once at prefetch time.
                dispatcher.record_error(
                    cname, D.CLUSTER_NOT_READY, f"member read failed: {value}"
                )
                return False, None
            return True, value
        breaker = self.breakers.for_member(cname)
        start = time.monotonic()
        try:
            obj = self._member_read(
                self._member_client(cname), self._target_resource, key
            )
        except NotFound:
            dispatcher.record_error(
                cname, D.CACHED_RETRIEVAL_FAILED, "cluster unavailable"
            )
            return False, None
        except Exception as e:  # transport-level: the member is sick
            breaker.record_failure(latency_s=time.monotonic() - start)
            dispatcher.record_error(
                cname, D.CLUSTER_NOT_READY, f"member read failed: {e}"
            )
            return False, None
        breaker.note_ok(time.monotonic() - start)
        return True, obj

    @staticmethod
    def _member_read(client, resource: str, key: str):
        """Read-only member lookup: the no-copy view when the client
        offers one (FakeKube) — the sync hot path reads one member
        object per (object, cluster) pair, and per-read deep copies
        dominated its profile.  Consumers must NOT mutate the result
        (the dispatcher's mutating paths copy first)."""
        view = getattr(client, "try_get_view", None)
        return view(resource, key) if view is not None else client.try_get(resource, key)

    # -- reconcile -------------------------------------------------------
    def reconcile(self, key: str) -> Result:
        """Single-key compatibility entry: one tick over one key."""
        return self.reconcile_batch([key])[key]

    def reconcile_batch(self, keys: list[str]) -> dict[str, Result]:
        """One tick: every due key planned against ONE cluster-list scan,
        member writes staged into ONE BatchSink, flushed as one bulk
        write per member, then per-object status finalized."""
        results: dict[str, Result] = {}
        # Mark this thread for echo suppression even when called
        # directly (tests, the reconcile() compat wrapper) rather than
        # through BatchWorker.step.
        ident = self.worker._enter()
        try:
            fed_keys: list[str] = []
            for key in keys:
                if key.startswith(_CLUSTER_KEY_PREFIX):
                    results[key] = self._reconcile_cluster(
                        key[len(_CLUSTER_KEY_PREFIX) :]
                    )
                else:
                    fed_keys.append(key)
            if not fed_keys:
                return results
            # Disjoint-by-construction guard: a replica syncs (and
            # persists placements/status for) only keys its shard owns;
            # a non-owned key here bypassed the router.
            if self._shard.shard_count > 1:
                for key in fed_keys:
                    assert self._shard.owns(key), (
                        f"shard violation: replica "
                        f"{self._shard.shard_index}/{self._shard.shard_count}"
                        f" syncing non-owned key {key}"
                    )
            ctx = _TickClusters(
                [
                    c
                    for c in self.host.list_view(FEDERATED_CLUSTERS)
                    if is_cluster_joined(c)
                ]
            )
            # Bulk prefetch (network fleets): the tick's fed objects in
            # batched host reads, then every candidate (object, member)
            # pair in batched member reads — the per-object GET fan-out
            # becomes ceil(n / MEMBER_BATCH) round trips per member.
            fed_cache: Optional[dict] = None
            if self._bulk_reads and fed_keys:
                fed_cache = D.bulk_get(self.host, self._fed_resource, fed_keys)
                if fed_cache is not None:
                    self._prefetch_member_reads(fed_keys, fed_cache, ctx)
            sink = D.BatchSink(
                self._member_client,
                pool=self.pool,
                thread_registry=self._flush_threads,
                breakers=self.breakers,
            )
            # Tick-level write-ack buffer: on_written callbacks append
            # (fed_key, cluster) here (list.append from the flush pool's
            # threads is atomic) and the SLO token closes + member-index
            # updates settle in ONE batch after the flush, instead of a
            # lock hold and an SLO round per acked op.
            acks: list[tuple[str, str]] = []
            sink.kt_acks = acks
            finishers: list[tuple[str, Callable[..., Result]]] = []
            for key in fed_keys:
                # Per-key isolation: one poison object backs off alone
                # (worker.go:119-131 semantics), the rest of the tick
                # proceeds and still flushes.
                try:
                    out = self._plan_one(key, ctx, sink, fed_cache)
                except Exception:
                    self.metrics.counter(f"sync-{self.ftc.name}.plan_panic")
                    results[key] = Result.retry()
                    continue
                if isinstance(out, Result):
                    results[key] = out
                else:
                    finishers.append((key, out))
            sink.flush()
            # Settle the flush's acks before finishers run: finish()
            # calls slo.settle, which must observe every placement ack
            # of its own tick or tokens would finalize short.
            if acks:
                with self._index_lock:
                    for fed_key, cluster in acks:
                        self._member_index.setdefault(fed_key, set()).add(cluster)
                slo.written_many(acks)
            hb = HostBatch(self.host)
            for key, finish in finishers:
                try:
                    results[key] = finish(hb, results, key)
                except Exception:
                    self.metrics.counter(f"sync-{self.ftc.name}.finish_panic")
                    results[key] = Result.retry()
            # One bulk host round trip (plus follow-ups) finalizes every
            # object's status + syncing annotation.
            hb.flush()
        finally:
            self._tick_reads.clear()
            self.worker._exit(ident)
        return results

    def _prefetch_member_reads(
        self, fed_keys: list[str], fed_cache: dict, ctx: _TickClusters
    ) -> None:
        """Populate ``self._tick_reads`` with every member object this
        tick's planning will read: the candidate computation mirrors
        :meth:`_sync_to_clusters` (over-fetching a skipped candidate is
        harmless; a miss falls back to the direct read)."""
        wanted: dict[str, list[str]] = {}
        for key in fed_keys:
            fed_obj = fed_cache.get(key)
            if fed_obj is None or fed_obj["metadata"].get("deletionTimestamp"):
                continue
            try:
                if pending.get_pending(fed_obj):
                    continue
            except KeyError:
                continue
            candidates = set(C.all_placement_clusters(fed_obj))
            for entry in fed_obj.get("status", {}).get("clusters", ()):
                cname = entry.get("cluster")
                if cname:
                    candidates.add(cname)
            with self._index_lock:
                candidates.update(self._member_index.get(key, ()))
            for cname in candidates:
                flags = ctx.flags.get(cname)
                if flags is None or not flags[0]:
                    continue  # not joined / not ready: never read
                if not self.breakers.allow(cname, consume_probe=False):
                    continue  # breaker-open: the plan short-circuits too
                wanted.setdefault(cname, []).append(key)
        for cname, keys in wanted.items():
            try:
                client = self._member_client(cname)
            except Exception:
                continue  # resolution failures take the direct path
            got = D.bulk_get(
                client, self._target_resource, keys,
                cluster=cname, breakers=self.breakers,
            )
            if got is None:
                # Transport-level failure: every planned read of this
                # member settles ClusterNotReady without another socket
                # (breaker evidence was recorded once by bulk_get).
                for key in keys:
                    self._tick_reads[(cname, key)] = (
                        "err", "member bulk read failed"
                    )
                continue
            for key in keys:
                if key in got:
                    self._tick_reads[(cname, key)] = ("ok", got[key])

    def _plan_one(
        self,
        key: str,
        ctx: _TickClusters,
        sink: D.BatchSink,
        fed_cache: Optional[dict] = None,
    ) -> Union[Result, Callable[..., Result]]:
        """Everything up to (and including) staging one object's member
        writes; returns a finisher ``finish(hb, results, key)`` to run
        after the sink flushes, or a settled Result for the early-exit
        paths."""
        if fed_cache is not None and key in fed_cache:
            fed_obj = fed_cache[key]
        else:
            fed_obj = self.host.try_get(self._fed_resource, key)
        if fed_obj is None:
            return Result.ok()
        fed = FederatedResource(fed_obj, self.ftc)

        if fed_obj["metadata"].get("deletionTimestamp"):
            return self._ensure_deletion(fed)

        # Wait until upstream pipeline controllers have run
        # (controller.go:380-388: any pending controller defers sync).
        try:
            if pending.get_pending(fed_obj):
                return Result.ok()
        except KeyError:
            return Result.ok()  # not initialized by federate yet

        # Pre-dispatch metadata: the sync finalizer (MUST be persisted
        # before any member write — controller.go:389-397) and the
        # revision annotations land in ONE host update instead of two.
        fins = fed_obj["metadata"].setdefault("finalizers", [])
        dirty = C.SYNC_FINALIZER not in fins
        if dirty:
            fins.append(C.SYNC_FINALIZER)

        collision_count = None
        if self.revisions is not None:
            # Record the template revision + annotate the fed object
            # (controller.go:399-418 syncRevisions/ensureAnnotations).
            try:
                collision_count, last_rev, current_rev = (
                    self.revisions.sync_revisions(fed_obj)
                )
            except RevisionSyncError:
                return Result.retry()
            ann = fed_obj["metadata"].setdefault("annotations", {})
            for key_, value in (
                (LAST_REVISION_ANNOTATION, last_rev),
                (CURRENT_REVISION_ANNOTATION, current_rev),
            ):
                if value and ann.get(key_) != value:
                    ann[key_] = value
                    dirty = True
        if dirty:
            try:
                # rv-only consumption: skip the result deep copy (the
                # in-process store hands back the immutable node).
                updated = self.host.update(
                    self._fed_resource, fed_obj, _copy_result=False
                )
            except Conflict:
                return Result.retry()
            except NotFound:
                return Result.ok()
            fed_obj["metadata"]["resourceVersion"] = updated["metadata"][
                "resourceVersion"
            ]
            self._record_own_fed(updated)

        return self._sync_to_clusters(fed, collision_count, ctx, sink)

    def _record_own_fed(self, obj: dict) -> None:
        self._own_fed_rv[obj_key(obj)] = str(
            obj.get("metadata", {}).get("resourceVersion", "")
        )

    # -- cluster cascading-delete finalizer (controller.go:1050-1196) ----
    def _reconcile_cluster(self, name: str) -> Result:
        cluster = self.host.try_get(FEDERATED_CLUSTERS, name)
        if cluster is None:
            return Result.ok()

        if not cluster["metadata"].get("deletionTimestamp"):
            fins = cluster["metadata"].setdefault("finalizers", [])
            if self.cluster_finalizer in fins:
                return Result.ok()
            fins.append(self.cluster_finalizer)
            try:
                self.host.update(FEDERATED_CLUSTERS, cluster)
            except Conflict:
                return Result.retry()
            except NotFound:
                pass
            return Result.ok()

        if is_cluster_joined(cluster) and is_cascading_delete_enabled(cluster):
            # Wait until no managed target objects remain in the member.
            try:
                member = self._member_client(name)
            except NotFound:
                member = None
            if member is not None:
                held = []

                def check(obj: dict) -> None:
                    if C.MANAGED_LABEL in obj.get("metadata", {}).get("labels", {}):
                        held.append(obj_key(obj))

                member.scan(self._target_resource, check)
                if held:
                    return Result.after(2.0)

        return self._remove_cluster_finalizer(cluster)

    def _remove_cluster_finalizer(self, cluster: dict) -> Result:
        fins = cluster["metadata"].get("finalizers", [])
        if self.cluster_finalizer not in fins:
            return Result.ok()
        cluster["metadata"]["finalizers"] = [
            f for f in fins if f != self.cluster_finalizer
        ]
        try:
            self.host.update(FEDERATED_CLUSTERS, cluster)
        except Conflict:
            return Result.retry()
        except NotFound:
            pass
        return Result.ok()

    # -- the propagation round (controller.go:425-596) -------------------
    def _sync_to_clusters(
        self,
        fed: FederatedResource,
        collision_count: Optional[int],
        ctx: _TickClusters,
        sink: D.BatchSink,
    ) -> Callable[[], Result]:
        selected = fed.compute_placement(ctx.joined_set)

        recorded = self.versions.get(
            fed.namespace, fed.name, fed.template_version(), fed.override_version()
        )
        # Rollout planning is Deployment-only, incompatible with
        # member-owned replicas (managed.go:204-213), and depends on the
        # current-revision annotation that only revision history stamps —
        # without it every plan would fail and nothing would ever be
        # created.
        rollout_enabled = (
            self.ftc.rollout_plan
            and self.revisions is not None
            and self.ftc.source.kind == "Deployment"
            and not fed.obj.get("spec", {}).get("retainReplicas")
        )
        plans_holder: dict[str, R.RolloutPlan] = {}
        fed_key = fed.key

        acks = getattr(sink, "kt_acks", None)

        def on_written(cluster: str, obj: dict) -> None:
            self._own_member_rv[(cluster, fed_key)] = str(
                obj.get("metadata", {}).get("resourceVersion", "")
            )
            if acks is not None:
                # Per-op bookkeeping diet: defer the member-index update
                # and SLO ack to one post-flush batch (reconcile_batch
                # drains kt_acks right after sink.flush()).
                acks.append((fed_key, cluster))
                return
            with self._index_lock:
                self._member_index.setdefault(fed_key, set()).add(cluster)
            # SLO provenance: a member apiserver acked this placement —
            # the token closes (and the e2e latency histogram samples)
            # once every expected placement has acked.
            slo.written(fed_key, cluster)

        dispatcher = D.ManagedDispatcher(
            self._member_client,
            fed,
            self._target_resource,
            replicas_path=self.ftc.path.replicas_spec,
            skip_adopting=not should_adopt_preexisting(fed.obj),
            sink=sink,
            on_written=on_written,
            rollout_overrides=(
                (
                    lambda c: plans_holder[c].to_overrides()
                    if c in plans_holder
                    else []
                )
                if rollout_enabled
                else None
            ),
        )
        # (cluster, cluster_obj, should_be_deleted, cascading) actions
        # deferred until after rollout planning.
        rollout_ops: list[tuple[str, Optional[dict], bool, bool]] = []

        # Candidate clusters — O(selected + previously-placed), not
        # O(fleet): selected placements, clusters named in the object's
        # persisted propagation status (the durable record of where it
        # was last dispatched, surviving restarts and template-version
        # bumps that invalidate the version record), and the live member
        # index (foreign-created managed objects seen by the watches).
        candidates = set(selected)
        for entry in fed.obj.get("status", {}).get("clusters", ()):
            cname = entry.get("cluster")
            if cname:
                candidates.add(cname)
        with self._index_lock:
            candidates.update(self._member_index.get(fed_key, ()))

        for cname in sorted(candidates):
            flags = ctx.flags.get(cname)
            if flags is None:
                continue  # not a joined cluster (or left the federation)
            ready, terminating, cascading = flags
            should_be_deleted = cname not in selected or cascading

            if not ready:
                if not should_be_deleted:
                    dispatcher.record_error(
                        cname, D.CLUSTER_NOT_READY, "cluster not ready"
                    )
                continue
            if not self.breakers.allow(cname, consume_probe=False):
                # Breaker hard-open: the member already stalled or
                # errored past threshold this window — short-circuit to
                # ClusterNotReady without a read, write or thread.
                if not should_be_deleted:
                    self.breakers.count_shed(cname)
                    dispatcher.record_error(
                        cname, D.CLUSTER_NOT_READY, "member circuit breaker open"
                    )
                continue
            ok, cluster_obj = self._guarded_member_read(dispatcher, cname, fed.key)
            if not ok:
                continue
            if cluster_obj is not None and C.MANAGED_LABEL not in cluster_obj[
                "metadata"
            ].get("labels", {}):
                # Unmanaged member objects are invisible to the sync view
                # (federatedinformer.go:678-680): a pre-existing object is
                # "absent", so Create runs and the AlreadyExists fallback
                # decides adoption.
                cluster_obj = None

            if should_be_deleted:
                if cluster_obj is None:
                    continue
                if cluster_obj["metadata"].get("deletionTimestamp"):
                    dispatcher.record_status(cname, D.WAITING_FOR_REMOVAL)
                    continue
                if terminating and not cascading:
                    # Preserve member objects of a non-cascading
                    # terminating cluster (controller.go:498-506).
                    continue
                if rollout_enabled:
                    # Deletions drain through the rollout plan so removing
                    # a cluster counts against maxUnavailable.
                    rollout_ops.append((cname, cluster_obj, True, cascading))
                    continue
                # Orphaning is only respected during cascading deletion,
                # not when migrating between clusters (controller.go:508).
                self._delete_one(dispatcher, cname, fed, cluster_obj, cascading)
                continue

            if terminating:
                dispatcher.record_error(
                    cname, D.CLUSTER_TERMINATING, "cluster terminating"
                )
                continue
            if rollout_enabled:
                rollout_ops.append((cname, cluster_obj, False, False))
            elif cluster_obj is None:
                dispatcher.create(cname)
            else:
                dispatcher.update(cname, cluster_obj, recorded.get(cname, ""))

        if rollout_enabled:
            plans = self._plan_rollout(fed, rollout_ops, selected)
            if plans:
                plans_holder.update(plans)
            # The dispatch decisions of managed.go:214-250: unplanned
            # clusters keep their template (and rollout knobs); planned
            # ones create/update/shrink/delete as the plan dictates.
            for cname, cluster_obj, to_delete, cascading in rollout_ops:
                plan = plans.get(cname) if plans else None
                version = recorded.get(cname, "")
                if plan is None:
                    if cluster_obj is not None:
                        dispatcher.patch_and_keep_template(
                            cname, cluster_obj, True, version
                        )
                    continue
                if to_delete and (plan.replicas is None or plan.replicas == 0):
                    self._delete_one(dispatcher, cname, fed, cluster_obj, cascading)
                    continue
                if cluster_obj is None:
                    dispatcher.create(cname)
                    continue
                if plan.only_patch_replicas and plan.replicas is not None:
                    dispatcher.patch_and_keep_template(
                        cname, cluster_obj, False, version
                    )
                    continue
                dispatcher.update(cname, cluster_obj, version)

        # SLO provenance: member writes are staged — the "dispatch"
        # stage closes here, and the declared placements become the
        # token's ack set (the freshness gauges count what has not
        # landed: a breaker-open or hard-down member keeps its
        # placements pending, which is exactly the staleness signal).
        slo.expect(fed_key, selected)
        slo.mark(fed_key, "dispatch")

        def finish(hb: HostBatch, results: dict, key: str) -> Result:
            """Runs after the tick's sink flushes: status/version
            bookkeeping over the completed dispatch round.  Host writes
            are staged into ``hb``; callbacks downgrade ``results[key]``
            on persistent failure."""
            ok = dispatcher.wait()

            # Record versions (an optimization; failures tolerated —
            # controller.go:568-576).
            self.versions.update(
                fed.namespace,
                fed.name,
                fed.template_version(),
                fed.override_version(),
                sorted(selected),
                dispatcher.version_map,
                batch=hb,
            )

            status_map = dispatcher.status_map
            reason = AGGREGATE_SUCCESS if ok else CHECK_CLUSTERS
            if not ok:
                failed = sorted(
                    c for c, s in status_map.items()
                    if s not in (D.OK, D.WAITING, D.WAITING_FOR_REMOVAL)
                )
                self.recorder.event(
                    fed.obj,
                    "Warning",
                    "PropagationFailed",
                    f"failed clusters: {', '.join(failed)}",
                )
            self._stage_status_writes(
                hb, fed, reason, status_map, collision_count, results, key
            )
            if not ok:
                return Result.retry()
            # Fully-OK round: any still-pending token is a no-op
            # (version-skips) or partially-acked event — settle it so
            # the freshness gauges only count genuinely unwritten work.
            slo.settle(key)
            if D.WAITING_FOR_REMOVAL in status_map.values():
                # A member object is finalizer-gated mid-removal; no host
                # event will fire when it finishes, so revisit on a timer
                # (controller.go recheckAfterDispatchDelay).
                return Result.after(10.0)
            return Result.ok()

        return finish

    def _plan_rollout(
        self,
        fed: FederatedResource,
        ops: list,
        selected: set[str],
    ) -> Optional[dict[str, R.RolloutPlan]]:
        """Build the cross-cluster rollout plan for this tick
        (managed.go:272-323 planRolloutProcess).  None = planning failed;
        existing members then keep their template this round."""
        try:
            replicas = fed.total_replicas(selected)
            planner = R.RolloutPlanner(fed.key, fed.obj, replicas)
            for cname, cluster_obj, to_delete, _ in ops:
                desired = 0 if to_delete else fed.replicas_override_for_cluster(cname)
                planner.register(
                    R.target_from_cluster_object(
                        cname,
                        cluster_obj,
                        desired,
                        planner.revision,
                        self.ftc.path.replicas_spec,
                        self.ftc.path.available_replicas_status,
                    )
                )
            plans = planner.plan()
        except (R.RolloutPlanError, TypeError, ValueError):
            # Malformed member-written state degrades to a no-plan tick
            # (existing members keep their template) rather than wedging
            # the whole reconcile.
            self.metrics.counter(f"sync-{self.ftc.name}.plan_rollout_failed")
            return None
        return plans or None

    def _delete_one(
        self,
        dispatcher: D.ManagedDispatcher,
        cluster: str,
        fed: FederatedResource,
        cluster_obj: dict,
        respect_orphaning: bool,
    ) -> None:
        """(controller.go:821-845 deleteFromCluster)."""
        if respect_orphaning:
            behavior = orphaning_behavior(fed.obj)
            adopted = cluster_obj.get("metadata", {}).get("annotations", {}).get(
                D.ADOPTED_ANNOTATION
            )
            if behavior == ORPHAN_ALL or (behavior == ORPHAN_ADOPTED and adopted):
                dispatcher.remove_managed_label(cluster, cluster_obj)
                return
        dispatcher.delete(cluster)

    # -- status ----------------------------------------------------------
    def _stage_status_writes(
        self,
        hb: HostBatch,
        fed: FederatedResource,
        reason: str,
        status_map: dict[str, str],
        collision_count: Optional[int],
        results: dict,
        key: str,
    ) -> None:
        """Stage the status-subresource write (and, chained on its new
        resourceVersion, the syncing annotation) into the tick's host
        batch.  The in-hand object is the optimistic base; a conflict
        falls back to the synchronous read-retry loops."""
        obj = fed.obj
        if not _apply_desired_status(obj, reason, status_map, collision_count):
            self._stage_annotation(hb, fed, obj, status_map, results, key)
            return

        def on_panic() -> None:
            self.metrics.counter(f"sync-{self.ftc.name}.host_write_panic")
            results[key] = Result.retry()

        def on_status(result: dict) -> None:
            code = result.get("code")
            if code == 200:
                updated = result["object"]
                self._record_own_fed(updated)
                obj["metadata"]["resourceVersion"] = updated["metadata"][
                    "resourceVersion"
                ]
                self._stage_annotation(hb, fed, obj, status_map, results, key)
            elif code == 404:
                pass  # object gone: nothing to finalize
            else:
                # Conflict (or transport trouble): the synchronous
                # read-retry loops own this object's finalization.
                r = self._set_federated_status(
                    fed, reason, status_map, collision_count
                )
                if not r.success:
                    results[key] = Result.retry()
                else:
                    self._set_syncing_annotation(fed, status_map)

        hb.stage(
            {"verb": "update_status", "resource": self._fed_resource, "object": obj},
            on_status,
            on_panic,
        )

    def _stage_annotation(
        self,
        hb: HostBatch,
        fed: FederatedResource,
        obj: dict,
        status_map: dict[str, str],
        results: dict,
        key: str,
    ) -> None:
        """The syncing feedback annotation is a separate (non-status)
        write: UpdateStatus ignores annotations (controller.go:686-718)."""
        syncing = _syncing_value(status_map, obj["metadata"].get("generation", 1))
        ann = obj["metadata"].setdefault("annotations", {})
        prior = ann.get(C.SOURCE_FEEDBACK_SYNCING)
        if prior == syncing:
            return
        ann[C.SOURCE_FEEDBACK_SYNCING] = syncing

        def on_panic() -> None:
            self.metrics.counter(f"sync-{self.ftc.name}.host_write_panic")
            results[key] = Result.retry()

        def on_ann(result: dict) -> None:
            code = result.get("code")
            if code == 200:
                self._record_own_fed(result["object"])
            elif code != 404:
                # Undo the optimistic in-hand mutation FIRST: the
                # fallback's cheap steady-state exit consults this very
                # dict and would otherwise see the desired value as
                # already present and skip the conflict-retry loop.
                if prior is None:
                    ann.pop(C.SOURCE_FEEDBACK_SYNCING, None)
                else:
                    ann[C.SOURCE_FEEDBACK_SYNCING] = prior
                self._set_syncing_annotation(fed, status_map)

        hb.stage(
            {"verb": "update", "resource": self._fed_resource, "object": obj},
            on_ann,
            on_panic,
        )

    def _set_federated_status(
        self,
        fed: FederatedResource,
        reason: str,
        status_map: dict[str, str],
        collision_count: Optional[int] = None,
    ) -> Result:
        """Write status.clusters + the Propagated condition (and the
        revision collisionCount, when history is on) via the status
        subresource, with conflict-retry (controller.go:637-721)."""
        for _ in range(5):
            obj = self.host.try_get(self._fed_resource, fed.key)
            if obj is None:
                return Result.ok()
            if not _apply_desired_status(obj, reason, status_map, collision_count):
                return Result.ok()
            try:
                updated = self.host.update_status(self._fed_resource, obj)
                if isinstance(updated, dict):
                    self._record_own_fed(updated)
                return Result.ok()
            except NotFound:
                return Result.ok()
            except Conflict:
                continue
        return Result.retry()

    def _set_syncing_annotation(
        self, fed: FederatedResource, status_map: dict[str, str]
    ) -> None:
        """Record per-cluster sync progress on the federated object for
        the federate controller to mirror onto the source
        (sourcefeedback/syncing.go PopulateSyncingAnnotation); best-effort
        with conflict-refresh."""

        # Cheap steady-state exit using the in-hand object: no refetch
        # (a full deep copy per tick) when the annotation is current.
        in_hand = fed.obj.get("metadata", {})
        if in_hand.get("annotations", {}).get(
            C.SOURCE_FEEDBACK_SYNCING
        ) == _syncing_value(status_map, in_hand.get("generation", 1)):
            return
        for _ in range(5):
            obj = self.host.try_get(self._fed_resource, fed.key)
            if obj is None:
                return
            syncing = _syncing_value(
                status_map, obj["metadata"].get("generation", 1)
            )
            ann = obj["metadata"].setdefault("annotations", {})
            if ann.get(C.SOURCE_FEEDBACK_SYNCING) == syncing:
                return
            ann[C.SOURCE_FEEDBACK_SYNCING] = syncing
            try:
                updated = self.host.update(self._fed_resource, obj)
                if isinstance(updated, dict):
                    self._record_own_fed(updated)
                return
            except NotFound:
                return
            except Conflict:
                continue

    # -- deletion (controller.go:723-819) --------------------------------
    def _ensure_deletion(self, fed: FederatedResource) -> Result:
        # An object heading for deletion will never be written: its
        # provenance token (if any) must not wedge the freshness gauges.
        slo.forget(fed.key)
        self.versions.delete(fed.namespace, fed.name)
        fins = fed.obj["metadata"].get("finalizers", [])
        if C.SYNC_FINALIZER not in fins:
            return Result.ok()

        if orphaning_behavior(fed.obj) == ORPHAN_ALL:
            # Orphan everywhere: strip managed labels, drop finalizer.
            if not self._remove_managed_labels_everywhere(fed):
                return Result.retry()
            return self._remove_finalizer(fed)

        remaining = self._delete_from_clusters(fed)
        if remaining is None:
            return Result.retry()
        if remaining:
            return Result(success=True, requeue_after=2.0)
        return self._remove_finalizer(fed)

    def _joined_members(self) -> list[dict]:
        return [
            c
            for c in self.host.list_view(FEDERATED_CLUSTERS)
            if is_cluster_joined(c)
        ]

    def _delete_from_clusters(self, fed: FederatedResource) -> Optional[list[str]]:
        """Returns clusters still holding the object, or None on failure
        (controller.go:846-887)."""
        dispatcher = D.ManagedDispatcher(
            self._member_client,
            fed,
            self._target_resource,
            replicas_path=self.ftc.path.replicas_spec,
            pool=self.pool,
            inline=self._inline,
            breakers=self.breakers,
        )
        remaining: list[str] = []
        unreachable: list[str] = []
        for cluster in self._joined_members():
            cname = cluster["metadata"]["name"]
            if not is_cluster_ready(cluster) or not self.breakers.allow(
                cname, consume_probe=False
            ):
                # Cannot confirm removal from an unready (or breaker-
                # open) cluster; block finalizer removal until it is
                # reachable again (controller.go:846-887 errs when a
                # cluster store is unavailable, keeping the finalizer in
                # place).
                unreachable.append(cname)
                continue
            try:
                cluster_obj = self._member_read(
                    self._member_client(cname), self._target_resource, fed.key
                )
            except NotFound:
                continue  # cluster client gone mid-leave; nothing to delete
            except Exception:
                # Transport failure mid-read: same contract as unready —
                # removal unconfirmed, finalizer held.
                self.breakers.for_member(cname).record_failure()
                unreachable.append(cname)
                continue
            if cluster_obj is None:
                continue
            if C.MANAGED_LABEL not in cluster_obj["metadata"].get("labels", {}):
                # Never delete objects this control plane doesn't manage
                # (pre-existing, non-adopted — federatedinformer.go:678).
                continue
            remaining.append(cname)
            if cluster_obj["metadata"].get("deletionTimestamp"):
                dispatcher.record_status(cname, D.WAITING_FOR_REMOVAL)
                continue
            self._delete_one(dispatcher, cname, fed, cluster_obj, True)
        if not dispatcher.wait():
            return None
        # Re-check what actually remains after the dispatch round; an
        # orphaned (label-stripped) object no longer counts as managed.
        still = []
        for c in remaining:
            try:
                obj = self._member_read(
                    self._member_client(c), self._target_resource, fed.key
                )
            except NotFound:
                continue
            except Exception:
                still.append(c)  # unconfirmed: keep the finalizer held
                continue
            if obj is None:
                continue
            if C.MANAGED_LABEL not in obj.get("metadata", {}).get("labels", {}):
                continue
            still.append(c)
        return still + unreachable

    def _remove_managed_labels_everywhere(self, fed: FederatedResource) -> bool:
        dispatcher = D.ManagedDispatcher(
            self._member_client, fed, self._target_resource, pool=self.pool,
            inline=self._inline, breakers=self.breakers,
        )
        all_reachable = True
        for cluster in self._joined_members():
            cname = cluster["metadata"]["name"]
            if not is_cluster_ready(cluster) or not self.breakers.allow(
                cname, consume_probe=False
            ):
                all_reachable = False  # cannot strip labels there yet
                continue
            try:
                cluster_obj = self._member_read(
                    self._member_client(cname), self._target_resource, fed.key
                )
            except NotFound:
                continue
            except Exception:
                self.breakers.for_member(cname).record_failure()
                all_reachable = False
                continue
            if cluster_obj is None or cluster_obj["metadata"].get("deletionTimestamp"):
                continue
            if C.MANAGED_LABEL not in cluster_obj["metadata"].get("labels", {}):
                continue
            dispatcher.remove_managed_label(cname, cluster_obj)
        return dispatcher.wait() and all_reachable

    def _remove_finalizer(self, fed: FederatedResource) -> Result:
        obj = self.host.try_get(self._fed_resource, fed.key)
        if obj is None:
            return Result.ok()
        fins = obj["metadata"].get("finalizers", [])
        if C.SYNC_FINALIZER in fins:
            fins.remove(C.SYNC_FINALIZER)
            try:
                self.host.update(self._fed_resource, obj)
            except Conflict:
                return Result.retry()
            except NotFound:
                pass
        return Result.ok()
