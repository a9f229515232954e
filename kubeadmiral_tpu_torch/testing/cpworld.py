"""The control plane at benchmark scale: the manager's controllers.

A port-owned copy of the world of ``bench_e2e.py:521-690``, the run that
BASELINE.md lists as "bench_e2e.py at config-#3 scale": member clusters
``m-0000…`` each with one node of ``32 + j % 64`` cpu and 256Gi and a
``tier`` label of ``j % 3``; the PropagationPolicy ``pp`` in ``Divide``
mode; the OverridePolicy ``op``, which adds the annotation
``tier: one`` to the member objects on ``tier: "1"`` members;
Deployments ``web-00000…`` with ``(i % 20) + 1`` replicas of 50m cpu,
labelled with both policies.

:class:`ControlPlane` runs the controller set of the JAX manager
(``runtime/manager.py:_start_ftc``), not the bench's five-controller
subset: it is what a deployment runs, and it puts every controller of
the control plane to work at scale.  Three FederatedTypeConfigs with
their default pipelines: ``deployments.apps`` (scheduler → override →
follower; federate, scheduler, override, sync, policyrc, status, status
aggregator and auto-migration), ``configmaps`` (scheduler → override;
federate, scheduler, override, sync, policyrc: no policy binds the
ConfigMaps, so the scheduler leaves their placement empty and the
follower places them) and ``namespaces`` (nsautoprop → override;
federate, nsautoprop, override, sync, policyrc); one engine shared by
the schedulers, as the manager shares it; the always-on follower
controller over all three; and a monitor per FTC (off by default in the
manager, on here as a round check).  The ``deployments.apps`` monitor
has the fleet, for placement drift; the others run host-only, as the
manager builds them: drift is measured against the scheduler's
placement, and every member object of an FTC the scheduler does not
place would read as an orphan.  Auto-migration reads a
:class:`PodInformer` and a fixed clock (``ControlPlane.now``), so two
planes fed the same rounds decide alike.  The sync controllers write
each placed object to its member clusters inline (an in-process fleet),
in submission order.  The plane settles as the bench's ``StageTimer``
does, timing each controller kind.

:func:`run_rounds` drives seven rounds and checks each:

1. ``join`` — the cluster controller settles the members' joins; every
   FederatedCluster is Joined and Ready with allocatable and available;
   no member holds a Deployment;
2. ``cold`` — the Deployments are created and the controllers settle;
   every FederatedObject is placed and its replica overrides sum to its
   ``spec.replicas``; every placed (object, cluster) pair has one member
   Deployment with that cluster's replicas and an ``OK`` propagation
   status, and the members hold nothing else (:func:`check_members`);
3. ``churn`` — ``spec.replicas`` of every hundredth Deployment changes;
   only those objects' placements and member objects change;
4. ``noop`` — every object is re-enqueued to the scheduler with nothing
   changed; the trigger-hash skip holds all of them back from the
   engine (no tick, no launch), and no member is written;
5. ``topology`` — one more member joins, which changes the scheduler's
   cluster signature; every object is rescheduled and still sums, and
   only the objects whose placement moved change on the members;
6. ``follow`` — the Namespace ``team-a``, its PropagationPolicy
   ``pp-am`` (Divide, at most 4 clusters, auto-migration after 30 s of
   unschedulable pods), ConfigMaps ``cfg-000…`` and Deployments
   ``mig-000…`` (``40 + i % 20`` replicas, each mounting ``cfg-i``):
   nsautoprop places ``team-a`` in every member, the scheduler places
   the ``mig-*`` objects on at most 4 clusters, the follower places each
   ``cfg-i`` on ``mig-i``'s clusters, and no ``web-*`` object moves;
7. ``migrate`` — at 1,000 s on the clock, the member holding the largest
   share *s* of each of the first 20 ``mig-*`` objects reports the
   Deployment ``{replicas: s, readyReplicas: 2}`` and holds *s* − 2
   Pods unschedulable since 0 s and 2 running: auto-migration writes
   ``estimatedCapacity {member: 2}`` on exactly those objects, once
   each, the scheduler re-plans them with that cap, their ConfigMaps
   follow, and nothing else changes on the members.  Once the capped
   member's desired replicas (2) no longer exceed its capacity,
   auto-migration clears the annotation, and the scheduler's tick over
   the cleared objects keeps their placement.

After every round each member Deployment on a tier-1 member carries
the override annotation and no other does, each FederatedDeployment has
one status object listing exactly its placed clusters, the policies'
``status.refCount`` counts their objects, and the monitors read no
placement drift (:func:`check_controllers`).

Each round reports its walls by controller kind, the engine ticks with
their phase-1 launches, fetch bytes and fetch paths, the objects
placed, the store's object count, the member objects, writes and
dispatch accounting (:meth:`ControlPlane.member_counts`), the monitors'
gauges, and the store's per-object digests (:func:`store_digests`;
wall-clock fields masked), which let two runs — the card's engine and
the CPU engine — be held equal object for object.
"""

from __future__ import annotations

import hashlib
import json
import time
from typing import Callable, Optional

from kubeadmiral_tpu_torch.federation import common as C
from kubeadmiral_tpu_torch.federation.automigration import PODS, AutoMigrationController
from kubeadmiral_tpu_torch.federation.clusterctl import (
    FEDERATED_CLUSTERS,
    JOINED,
    NODES,
    READY,
    FederatedClusterController,
    get_condition,
)
from kubeadmiral_tpu_torch.federation.federate import FederateController
from kubeadmiral_tpu_torch.federation.follower import FollowerController
from kubeadmiral_tpu_torch.federation.monitor import (
    DEFAULT_INTERVAL_SECONDS,
    DRIFT_KINDS,
    MonitorController,
)
from kubeadmiral_tpu_torch.federation.nsautoprop import NamespaceAutoPropagationController
from kubeadmiral_tpu_torch.federation.overridectl import (
    OVERRIDE_POLICIES,
    OVERRIDE_POLICY_NAME_LABEL,
    OverrideController,
)
from kubeadmiral_tpu_torch.federation.policyrc import PolicyRCController
from kubeadmiral_tpu_torch.federation.schedulerctl import SchedulerController
from kubeadmiral_tpu_torch.federation.statusctl import StatusAggregator, StatusController
from kubeadmiral_tpu_torch.federation.sync import SyncController
from kubeadmiral_tpu_torch.models.ftc import default_ftcs
from kubeadmiral_tpu_torch.models.policy import PROPAGATION_POLICIES, PROPAGATION_POLICY_LABEL
from kubeadmiral_tpu_torch.ops import phase1 as phase1_mod
from kubeadmiral_tpu_torch.runtime.metrics import Metrics, series_key
from kubeadmiral_tpu_torch.runtime.podinformer import PodInformer
from kubeadmiral_tpu_torch.scheduler.engine import SchedulerEngine
from kubeadmiral_tpu_torch.testing.fakekube import ClusterFleet

GVK = "apps/v1/Deployment"
# The manager's FTCs in this world, in ``default_ftcs`` order.
FTC_NAMES = ("deployments.apps", "configmaps", "namespaces")
CONFIGMAPS = "v1/configmaps"
NAMESPACES = "v1/namespaces"
CHURN_EVERY = 100
ROUNDS = ("join", "cold", "churn", "noop", "topology", "follow", "migrate")
# Round 6-7: the namespace, the objects that follow and migrate.
TEAM = "team-a"
FOLLOWERS = 100
MIGRANTS = 20
MIGRATE_AT = 1000.0
MIGRATE_READY = 2
OVERRIDE_ANNOTATION = ("tier", "one")

# Fields that carry wall-clock times, masked before two stores are held
# equal: the event recorder stamps ``time.time()`` on each event
# (``runtime/eventsink.py:EventRecorder._record``).  The controllers
# this world adds stamp none: the status objects, policy statuses,
# ConfigMaps, Namespaces and auto-migration's annotations compare
# unmasked (the Pods' transition times come from the round).
WALL_CLOCK_FIELDS = {"v1/events": ("firstTimestamp", "lastTimestamp")}


def world_ftcs() -> dict:
    """The three FTCs with their default pipelines, by name."""
    return {f.name: f for f in default_ftcs() if f.name in FTC_NAMES}


def deployment_ftc():
    return world_ftcs()["deployments.apps"]


def cluster_name(j: int) -> str:
    return f"m-{j:04d}"


def member_node(j: int) -> dict:
    return {
        "apiVersion": "v1",
        "kind": "Node",
        "metadata": {"name": "n1"},
        "spec": {},
        "status": {
            "allocatable": {"cpu": str(32 + j % 64), "memory": "256Gi"},
            "conditions": [{"type": "Ready", "status": "True"}],
        },
    }


def federated_cluster(j: int) -> dict:
    return {
        "apiVersion": "core.kubeadmiral.io/v1alpha1",
        "kind": "FederatedCluster",
        "metadata": {"name": cluster_name(j), "labels": {"tier": str(j % 3)}},
        "spec": {},
    }


def propagation_policy(name: str = "pp", namespace: str = "default", **spec) -> dict:
    return {
        "apiVersion": "core.kubeadmiral.io/v1alpha1",
        "kind": "PropagationPolicy",
        "metadata": {"name": name, "namespace": namespace},
        "spec": {"schedulingMode": "Divide", **spec},
    }


def override_policy() -> dict:
    """``bench_e2e.py``'s OverridePolicy: tier-1 members' objects gain
    the annotation ``tier: one``."""
    key, value = OVERRIDE_ANNOTATION
    return {
        "apiVersion": "core.kubeadmiral.io/v1alpha1",
        "kind": "OverridePolicy",
        "metadata": {"name": "op", "namespace": "default"},
        "spec": {
            "overrideRules": [
                {
                    "targetClusters": {"clusterSelector": {"tier": "1"}},
                    "overriders": {
                        "jsonpatch": [
                            {"operator": "add", "path": f"/metadata/annotations/{key}",
                             "value": value}
                        ]
                    },
                }
            ]
        },
    }


def migration_policy() -> dict:
    return propagation_policy(
        "pp-am", TEAM, maxClusters=4,
        autoMigration={"when": {"podUnschedulableFor": "30s"}},
    )


def replicas_of(i: int) -> int:
    return (i % 20) + 1


def mig_replicas_of(i: int) -> int:
    return 40 + (i % 20)


def _deployment(name: str, namespace: str, labels: dict, replicas: int,
                volumes: Optional[list] = None) -> dict:
    pod_spec: dict = {
        "containers": [
            {"name": "c", "image": "nginx", "resources": {"requests": {"cpu": "50m"}}}
        ]
    }
    if volumes:
        pod_spec["volumes"] = volumes
    return {
        "apiVersion": "apps/v1",
        "kind": "Deployment",
        "metadata": {"name": name, "namespace": namespace, "labels": labels},
        "spec": {
            "replicas": replicas,
            "selector": {"matchLabels": {"app": name}},
            "template": {"metadata": {"labels": {"app": name}}, "spec": pod_spec},
        },
    }


def web_key(i: int) -> str:
    return f"default/web-{i:05d}"


def mig_key(i: int) -> str:
    return f"{TEAM}/mig-{i:03d}"


def cfg_key(i: int) -> str:
    return f"{TEAM}/cfg-{i:03d}"


def make_deployment(i: int) -> dict:
    return _deployment(
        f"web-{i:05d}", "default",
        {PROPAGATION_POLICY_LABEL: "pp", OVERRIDE_POLICY_NAME_LABEL: "op"},
        replicas_of(i),
    )


def make_mig_deployment(i: int) -> dict:
    return _deployment(
        f"mig-{i:03d}", TEAM, {PROPAGATION_POLICY_LABEL: "pp-am"}, mig_replicas_of(i),
        volumes=[{"name": "cfg", "configMap": {"name": f"cfg-{i:03d}"}}],
    )


def make_configmap(i: int) -> dict:
    return {
        "apiVersion": "v1",
        "kind": "ConfigMap",
        "metadata": {"name": f"cfg-{i:03d}", "namespace": TEAM},
        "data": {"index": str(i)},
    }


def make_namespace(name: str) -> dict:
    return {"apiVersion": "v1", "kind": "Namespace", "metadata": {"name": name}}


def make_pod(name: str, app: str, running: bool) -> dict:
    """A Pod of ``app`` in TEAM: running, or pending and unschedulable
    since 0 s (``tests/test_automigration.py``'s pattern)."""
    status: dict = {"phase": "Running", "conditions": [
        {"type": "PodScheduled", "status": "True"}]}
    if not running:
        status = {"phase": "Pending", "conditions": [
            {"type": "PodScheduled", "status": "False", "reason": "Unschedulable",
             "lastTransitionTime": 0.0}]}
    return {
        "apiVersion": "v1",
        "kind": "Pod",
        "metadata": {"name": name, "namespace": TEAM, "labels": {"app": app}},
        "spec": {"containers": [
            {"name": "c", "resources": {"requests": {"cpu": "50m"}}}]},
        "status": status,
    }


def masked(resource: str, obj: dict) -> dict:
    fields = WALL_CLOCK_FIELDS.get(resource)
    if not fields:
        return obj
    return {k: v for k, v in obj.items() if k not in fields}


def _digest(resource: str, obj: dict) -> str:
    return hashlib.blake2b(
        json.dumps(masked(resource, obj), sort_keys=True).encode(), digest_size=12
    ).hexdigest()


def store_digests(fleet: ClusterFleet, cache: Optional[dict] = None) -> dict:
    """``{"host"|member: {"rv": n, "objects": {resource: {key: digest}}}}``
    over the whole fleet, each object's canonical JSON digested with
    its wall-clock fields masked.  The stores' version nodes are read in
    place (they are immutable); with ``cache`` (a dict kept across calls
    on one fleet) an object whose resourceVersion is unchanged since an
    earlier call keeps its digest: every write bumps it."""

    def one(name: str, kube) -> dict:
        with kube._lock:
            rv = kube._rv
            nodes = {resource: dict(objs) for resource, objs in kube._objects.items()}
        out = {}
        for resource, objs in nodes.items():
            digests = out[resource] = {}
            for key, obj in objs.items():
                version = obj.get("metadata", {}).get("resourceVersion")
                tag = (name, resource, key, version)
                digest = None if cache is None or version is None else cache.get(tag)
                if digest is None:
                    digest = _digest(resource, obj)
                    if cache is not None and version is not None:
                        cache[tag] = digest
                digests[key] = digest
        return {"rv": rv, "objects": out}

    out = {"host": one("host", fleet.host)}
    for name, member in fleet.members.items():
        out[name] = one(name, member)
    return out


def digest_diff(a: dict, b: dict, limit: int = 8) -> list[str]:
    """The first ``limit`` differences between two :func:`store_digests`."""
    diffs = []
    for kube in sorted(set(a) | set(b)):
        if kube not in a or kube not in b:
            diffs.append(f"{kube}: only in {'first' if kube in a else 'second'}")
            continue
        if a[kube]["rv"] != b[kube]["rv"]:
            diffs.append(f"{kube}: rv {a[kube]['rv']} != {b[kube]['rv']}")
        oa, ob = a[kube]["objects"], b[kube]["objects"]
        for resource in sorted(set(oa) | set(ob)):
            ka, kb = oa.get(resource, {}), ob.get(resource, {})
            for key in sorted(set(ka) | set(kb)):
                if ka.get(key) != kb.get(key):
                    diffs.append(f"{kube} {resource} {key}")
                    if len(diffs) >= limit:
                        return diffs
    return diffs




def workers_of(ctl) -> list:
    """A controller's workers (policyrc has three), as the manager's
    ``_workers_of`` lists them."""
    out = []
    for attr in ("worker", "count_worker", "pp_persist_worker", "op_persist_worker"):
        worker = getattr(ctl, attr, None)
        if worker is not None and worker not in out:
            out.append(worker)
    return out


class StageTimer:
    """Each controller's workers stepped with cumulative timing: the
    in-process settle of ``bench_e2e.py:StageTimer``; controllers that
    share a name share its timer."""

    def __init__(self, named_controllers):
        self.stages = {name: 0.0 for name, _ in named_controllers}
        self.controllers = named_controllers

    def settle(self, max_rounds: int = 10_000) -> None:
        for _ in range(max_rounds):
            progressed = False
            for name, ctl in self.controllers:
                t0 = time.perf_counter()
                for worker in workers_of(ctl):
                    stepped = True
                    # Drain this worker fully before moving on: batch
                    # controllers amortize best over a full queue.
                    while stepped:
                        stepped = worker.step()
                        progressed |= stepped
                self.stages[name] += time.perf_counter() - t0
            if not progressed:
                # Keys pending but not yet due within a short fuse
                # (admission delays) are waited out; long-fuse requeues
                # (heartbeats, auto-migration's threshold) read as idle.
                dues = [
                    d
                    for _, ctl in self.controllers
                    for worker in workers_of(ctl)
                    for d in (worker.queue.next_due_in(),)
                    if d is not None and d <= 0.25
                ]
                if not dues:
                    return
                time.sleep(min(dues) + 0.002)
        raise RuntimeError(f"controllers did not settle in {max_rounds} rounds")


class ControlPlane:
    """A fleet and the JAX manager's controllers for three FTCs over
    ``engine`` (``None``: the scheduler's default engine, on the card)."""

    def __init__(self, engine=None):
        self.fleet = ClusterFleet()
        self.host = self.fleet.host
        self.ftcs = world_ftcs()
        self.ftc = self.ftcs["deployments.apps"]
        self.metrics = Metrics()
        # Auto-migration's clock and the monitors' clock: fixed, moved
        # only by the rounds, so two planes decide alike.
        self.now = [0.0]
        self.monitor_now = [0.0]
        self.pod_informer = PodInformer(self.fleet)
        m = self.metrics
        # The cluster controller's clock is frozen, as the package
        # tests' are: its 10 s heartbeat is a timer, and one falling due
        # mid-round would make the round's writes depend on the wall
        # clock (round 7's running Pods change their members' available
        # cpu).  Joins are event-driven and need no tick.
        named = [("cluster", FederatedClusterController(
            self.fleet, metrics=m, api_resource_probe=[GVK], clock=lambda: 0.0))]
        # One engine for every FTC's scheduler, as the manager shares it.
        self.engine = engine if engine is not None else SchedulerEngine(metrics=m)
        self.controllers: dict[str, dict[str, object]] = {}
        self.monitors: list[MonitorController] = []
        for ftc in self.ftcs.values():
            # runtime/manager.py:_start_ftc, in its order.
            pipeline = {c for group in ftc.controllers for c in group}
            ctls: dict[str, object] = {"federate": FederateController(self.host, ftc, metrics=m)}
            if C.SCHEDULER in pipeline:
                ctls["schedule"] = SchedulerController(
                    self.host, ftc, engine=self.engine, metrics=m
                )
            if C.OVERRIDE_CONTROLLER in pipeline:
                ctls["override"] = OverrideController(self.host, ftc, metrics=m)
            if NamespaceAutoPropagationController.name in pipeline:
                ctls["nsautoprop"] = NamespaceAutoPropagationController(self.host, ftc, metrics=m)
            ctls["sync"] = SyncController(self.fleet, ftc, metrics=m)
            ctls["policyrc"] = PolicyRCController(self.host, ftc, metrics=m)
            if ftc.status_collection and ftc.status is not None:
                ctls["status"] = StatusController(self.fleet, ftc, metrics=m)
            if ftc.status_aggregation:
                ctls["statusagg"] = StatusAggregator(self.fleet, ftc, metrics=m)
            if ftc.auto_migration:
                ctls["automigration"] = AutoMigrationController(
                    self.fleet, ftc, metrics=m, clock=lambda: self.now[0],
                    pod_informer=self.pod_informer,
                )
            self.controllers[ftc.name] = ctls
            named += list(ctls.items())
        self.follower = FollowerController(self.host, list(self.ftcs.values()), metrics=m)
        named.append(("follower", self.follower))
        self.scheduler = self.controllers[self.ftc.name]["schedule"]
        for ftc in self.ftcs.values():
            # Drift is measured against the scheduler's placement, which
            # only the Deployments have: the other FTCs get the
            # manager's host-only monitor.
            self.monitors.append(MonitorController(
                self.host, ftc, metrics=m, clock=lambda: self.monitor_now[0],
                fleet=self.fleet if ftc is self.ftc else None,
                flight_recorder=self.engine.flightrec,
            ))
        self.sync = self.controllers[self.ftc.name]["sync"]
        self.timer = StageTimer(named)
        self.timer.stages["monitor"] = 0.0
        # Member ops by verb, through the members' bulk write path.
        self.member_ops: dict[str, int] = {}
        # Store digests by (store, resource, key, resourceVersion).
        self.digest_cache: dict = {}
        self.ticks: list[dict] = []
        # Every change of a FederatedDeployment's auto-migration info:
        # (key, annotation or None), in store order.
        self.capacity_log: list[tuple[str, Optional[str]]] = []
        self._capacity: dict[str, Optional[str]] = {}
        self.host.watch(self.ftc.federated.resource, self._on_federated, replay=False)
        self._schedule = self.engine.schedule
        self.engine.schedule = self._recorded_schedule

    def _on_federated(self, event: str, obj: dict) -> None:
        key = C.meta(obj).get("namespace", "") + "/" + obj["metadata"]["name"]
        info = None
        if event != "DELETED":
            info = (obj["metadata"].get("annotations") or {}).get(C.AUTO_MIGRATION_INFO)
        if self._capacity.get(key) != info:
            self._capacity[key] = info
            self.capacity_log.append((key, info))

    def _recorded_schedule(self, units, clusters, **kw):
        """The engine's tick, with its launches, bytes and fetch paths."""
        engine = self.engine
        launches0 = phase1_mod.phase1.launches
        bytes0 = engine.fetch_bytes_total
        paths0 = dict(engine.fetch_stats)
        t0 = time.perf_counter()
        out = self._schedule(units, clusters, **kw)
        self.ticks.append({
            "units": len(units),
            "clusters": len(clusters),
            "wall_ms": (time.perf_counter() - t0) * 1e3,
            "phase1_launches": phase1_mod.phase1.launches - launches0,
            "fetch_bytes": engine.fetch_bytes_total - bytes0,
            "fetch_paths": {
                k: v - paths0.get(k, 0)
                for k, v in engine.fetch_stats.items()
                if v - paths0.get(k, 0)
            },
            "stages_ms": {k: v * 1e3 for k, v in engine.timings.items()},
        })
        return out

    def workers(self) -> list:
        """Every controller's workers, the monitors' included."""
        return [w for _, ctl in self.timer.controllers for w in workers_of(ctl)] + [
            mon.worker for mon in self.monitors
        ]

    # -- the world ---------------------------------------------------------
    def add_cluster(self, j: int) -> None:
        member = self.fleet.add_member(cluster_name(j))
        member.create(NODES, member_node(j))
        batch = member.batch

        def counted_batch(ops):
            for op in ops:
                verb = op.get("verb", "?")
                self.member_ops[verb] = self.member_ops.get(verb, 0) + 1
            return batch(ops)

        member.batch = counted_batch
        self.host.create(FEDERATED_CLUSTERS, federated_cluster(j))

    def create_objects(self, ids) -> None:
        for i in ids:
            self.host.create(self.ftc.source.resource, make_deployment(i))

    def scale(self, replicas: dict[int, int]) -> None:
        for i, n in replicas.items():
            obj = self.host.get(self.ftc.source.resource, web_key(i))
            obj["spec"]["replicas"] = n
            self.host.update(self.ftc.source.resource, obj)

    def resync(self) -> None:
        """Re-enqueue every federated object to the scheduler."""
        self.scheduler.worker.enqueue_all(self.host.keys(self.ftc.federated.resource))

    def create_team(self, followers: int) -> None:
        """Round 6: the namespace, its policy, the ConfigMaps and the
        Deployments that mount them."""
        self.host.create(NAMESPACES, make_namespace(TEAM))
        self.host.create(PROPAGATION_POLICIES, migration_policy())
        for i in range(followers):
            self.host.create(CONFIGMAPS, make_configmap(i))
        for i in range(followers):
            self.host.create(self.ftc.source.resource, make_mig_deployment(i))

    def stick(self, migrants: int) -> dict[str, str]:
        """Round 7: the clock at MIGRATE_AT; in the member holding the
        largest share of each of the first ``migrants`` ``mig-*``
        objects (the lowest name on a tie), that share's Pods stick
        unschedulable but MIGRATE_READY.  Returns key -> member."""
        self.now[0] = MIGRATE_AT
        resource = self.ftc.source.resource
        placed = self.placements()
        stuck = {}
        for i in range(migrants):
            key = mig_key(i)
            reps = placed[key]
            share = max(reps.values())
            name = min(c for c, n in reps.items() if n == share)
            member = self.fleet.member(name)
            dep = member.get(resource, key)
            dep["status"] = {"replicas": share, "readyReplicas": MIGRATE_READY}
            member.update_status(resource, dep)
            app = key.split("/", 1)[1]
            for p in range(share):
                running = p >= share - MIGRATE_READY
                member.create(PODS, make_pod(
                    f"{app}-{'run' if running else 'pend'}-{p:03d}", app, running))
            stuck[key] = name
        return stuck

    def settle(self) -> dict[str, float]:
        """Settle the controllers, then one monitor pass (its clock moved
        by one interval); seconds per controller kind."""
        before = dict(self.timer.stages)
        self.timer.settle()
        t0 = time.perf_counter()
        self.monitor_now[0] += DEFAULT_INTERVAL_SECONDS
        for mon in self.monitors:
            while mon.worker.step():
                pass
        self.timer.stages["monitor"] += time.perf_counter() - t0
        return {k: v - before.get(k, 0.0) for k, v in self.timer.stages.items()}

    # -- reads -------------------------------------------------------------
    def placements(self) -> dict[str, dict[str, Optional[int]]]:
        """Federated object key -> {cluster: replicas} of the scheduler."""
        out = {}
        for fed in self.host.list_view(self.ftc.federated.resource):
            clusters = C.get_placement(fed, C.SCHEDULER) or ()
            overrides = C.get_overrides(fed, C.SCHEDULER)
            reps = {}
            for cl in sorted(clusters):
                patches = overrides.get(cl, ())
                reps[cl] = int(patches[0]["value"]) if patches else None
            out[C.meta(fed).get("namespace", "") + "/" + fed["metadata"]["name"]] = reps
        return out

    def member_objects(self, resource: Optional[str] = None) -> dict[str, dict[str, dict]]:
        """Member -> {key: object} of one resource (the Deployments by
        default) as the members hold them."""
        resource = resource or self.ftc.source.resource
        return {
            name: {
                C.meta(obj).get("namespace", "") + "/" + obj["metadata"]["name"]: obj
                for obj in member.list_view(resource)
            }
            for name, member in self.fleet.members.items()
        }

    def member_counts(self) -> dict:
        """Cumulative member-side counts: Deployments, ConfigMaps and
        Namespaces held, store writes (resourceVersion steps), ops by
        verb, bulk requests, and the breakers' sheds and retries."""
        members = self.fleet.members.values()
        snap = self.sync.breakers.snapshot()
        return {
            "member_objects": sum(len(m.keys(self.ftc.source.resource)) for m in members),
            "member_configmaps": sum(len(m.keys(CONFIGMAPS)) for m in members),
            "member_namespaces": sum(len(m.keys(NAMESPACES)) for m in members),
            "member_rv": sum(m._rv for m in members),
            "member_ops": dict(sorted(self.member_ops.items())),
            "dispatch_batches": sum(
                sum(e.get("batch", {}).get("requests", {}).values()) for e in snap.values()
            ),
            "sheds": self.sync.breakers.shed_total(),
            "retries": sum(e["dispatch_retries"] for e in snap.values()),
        }

    def gauges(self) -> dict:
        """The monitors' gauges: per FTC its totals and, where the
        monitor has the fleet, its placement drift by kind."""
        out = {}
        for mon in self.monitors:
            name = mon.ftc.name
            prefix = f"monitor.{name}"
            stores = self.metrics.stores
            row = {k: stores.get(series_key(f"{prefix}.{k}", {}))
                   for k in ("total", "propagated", "unpropagated")}
            if mon.fleet is not None:
                row["drift"] = {
                    kind: stores.get(series_key("placement_drift_objects",
                                                {"ftc": name, "kind": kind}))
                    for kind in DRIFT_KINDS
                }
            out[name] = row
        return out

    def ref_counts(self) -> dict[str, Optional[int]]:
        """``status.refCount`` of every policy, by resource and key."""
        out = {}
        for resource in (PROPAGATION_POLICIES, OVERRIDE_POLICIES):
            for obj in self.host.list_view(resource):
                key = C.meta(obj).get("namespace", "") + "/" + obj["metadata"]["name"]
                out[key] = (obj.get("status") or {}).get("refCount")
        return out

    def panics(self) -> dict[str, float]:
        """The controllers' panic and error counters (all must stay 0)."""
        keys = ["cluster-controller.panic"]
        for name in self.ftcs:
            keys += [f"federate-{name}.panic", f"sync-{name}.panic",
                     f"sync-{name}.plan_panic", f"sync-{name}.finish_panic",
                     f"sync-{name}.host_write_panic"]
        name = self.ftc.name
        keys += [f"scheduler-{name}.persist_panic", f"scheduler-{name}.panic",
                 f"scheduler-{name}.unit_errors", "status.plan_panic",
                 "statusagg.plan_panic"]
        out = {key: self.metrics.get_counter(key) for key in keys}
        for worker in self.workers():
            out[f"{worker.name}.exceptions"] = self.metrics.get_counter(
                "worker_exceptions_total", controller=worker.name
            )
        return out


def check_sums(plane: ControlPlane, expected: dict[str, int]) -> int:
    """Every object placed, its replica overrides summing to its
    ``spec.replicas`` (Divide); returns the objects placed."""
    placed = plane.placements()
    missing = sorted(set(expected) - set(placed))
    if missing:
        raise AssertionError(f"{len(missing)} objects not federated, first {missing[:3]}")
    for key, want in expected.items():
        reps = placed[key]
        if not reps:
            raise AssertionError(f"{key}: no placement")
        if None in reps.values() or sum(reps.values()) != want:
            raise AssertionError(f"{key}: replicas {reps} do not sum to {want}")
    return sum(1 for reps in placed.values() if reps)


def check_members(plane: ControlPlane) -> int:
    """Every placed (object, cluster) pair has one member Deployment with
    that cluster's replicas and an ``OK`` propagation status, and the
    members hold no other Deployment; returns the pairs.  Reads the
    ``deployments.apps`` member resource only: the members' Namespaces
    and ConfigMaps are held by :func:`check_followers`."""
    placed = plane.placements()
    held = plane.member_objects(plane.ftc.source.resource)
    statuses = {
        C.meta(fed).get("namespace", "") + "/" + fed["metadata"]["name"]: {
            c["cluster"]: c["status"] for c in (fed.get("status") or {}).get("clusters", ())
        }
        for fed in plane.host.list_view(plane.ftc.federated.resource)
    }
    pairs = 0
    for key, reps in placed.items():
        status = statuses.get(key, {})
        if set(status) != set(reps) or any(v != "OK" for v in status.values()):
            raise AssertionError(f"{key}: propagation status {status} for placement {reps}")
        for cluster, n in reps.items():
            obj = held.get(cluster, {}).get(key)
            if obj is None:
                raise AssertionError(f"{key}: no member object in {cluster}")
            if obj["spec"]["replicas"] != n:
                raise AssertionError(
                    f"{key}: {obj['spec']['replicas']} replicas in {cluster}, {n} placed"
                )
        pairs += len(reps)
    total = sum(len(objs) for objs in held.values())
    if total != pairs:
        raise AssertionError(f"{total} member objects for {pairs} placed pairs")
    return pairs


def check_controllers(plane: ControlPlane, refs: dict[str, int]) -> dict:
    """The round checks of the override, status, policyrc and monitor
    controllers: the override annotation on every member Deployment of a
    tier-1 member and on no other; one status object per
    FederatedDeployment listing exactly its placed clusters; each
    policy's ``status.refCount`` as ``refs`` says; no placement drift of
    any kind in any FTC.  Returns the counts checked."""
    key_, value = OVERRIDE_ANNOTATION
    tiers = {
        obj["metadata"]["name"]: (obj["metadata"].get("labels") or {}).get("tier")
        for obj in plane.host.list_view(FEDERATED_CLUSTERS)
    }
    annotated = 0
    for cluster, objs in plane.member_objects(plane.ftc.source.resource).items():
        tier_one = value if tiers.get(cluster) == "1" else None
        for key, obj in objs.items():
            # Only the ``web-*`` objects in ``default`` bind ``op``.
            want = tier_one if key.startswith("default/") else None
            got = (obj["metadata"].get("annotations") or {}).get(key_)
            if got != want:
                raise AssertionError(f"{key} in {cluster} (tier {tiers.get(cluster)}): "
                                     f"annotation {key_}={got!r}")
            annotated += got is not None
    placed = plane.placements()
    status_objs = {
        C.meta(obj).get("namespace", "") + "/" + obj["metadata"]["name"]: obj
        for obj in plane.host.list_view(plane.ftc.status.resource)
    }
    if set(status_objs) != set(placed):
        raise AssertionError(
            f"{len(status_objs)} status objects for {len(placed)} FederatedDeployments: "
            f"{sorted(set(status_objs) ^ set(placed))[:3]}"
        )
    for key, reps in placed.items():
        listed = [c["clusterName"] for c in status_objs[key].get("clusterStatus", ())]
        if listed != sorted(reps):
            raise AssertionError(f"{key}: clusterStatus {listed}, placed {sorted(reps)}")
    counts = plane.ref_counts()
    for key, want in refs.items():
        if counts.get(key) != want:
            raise AssertionError(f"{key}: refCount {counts.get(key)}, {want} expected")
    gauges = plane.gauges()
    for name, row in gauges.items():
        if any(v != 0 for v in row.get("drift", {}).values()):
            raise AssertionError(f"monitor {name}: placement drift {row['drift']}")
    return {"annotated": annotated, "status_objects": len(status_objs),
            "ref_counts": {k: counts.get(k) for k in refs}, "gauges": gauges}


def check_followers(plane: ControlPlane, followers: int) -> dict:
    """``team-a`` in every member; each ``cfg-i`` placed by the follower
    on exactly ``mig-i``'s clusters, and the members hold exactly those
    ConfigMaps."""
    members = set(plane.fleet.members)
    for name, member in plane.fleet.members.items():
        if member.try_get_view(NAMESPACES, TEAM) is None:
            raise AssertionError(f"{name}: no Namespace {TEAM}")
    cm_ftc = plane.ftcs["configmaps"]
    placed = plane.placements()
    want: dict[str, set] = {name: set() for name in members}
    for i in range(followers):
        clusters = set(placed[mig_key(i)])
        fed = plane.host.get(cm_ftc.federated.resource, cfg_key(i))
        got = C.get_placement(fed, C.FOLLOWER_CONTROLLER) or set()
        if got != clusters:
            raise AssertionError(f"{cfg_key(i)}: follower placement {sorted(got)}, "
                                 f"mig-{i:03d} on {sorted(clusters)}")
        for cl in clusters:
            want[cl].add(cfg_key(i))
    held = plane.member_objects(CONFIGMAPS)
    for name in members:
        if set(held.get(name, {})) != want[name]:
            raise AssertionError(f"{name}: ConfigMaps {sorted(held.get(name, {}))[:4]}, "
                                 f"want {sorted(want[name])[:4]}")
    return {"namespaces": len(members), "configmaps": sum(len(v) for v in want.values())}


def member_changes(before: dict, after: dict, resource: str) -> set[str]:
    """Object keys whose member objects (of ``resource``) differ between
    two :func:`store_digests`: written, created or deleted anywhere."""
    changed = set()
    for kube in set(before) | set(after):
        if kube == "host":
            continue
        a = before.get(kube, {}).get("objects", {}).get(resource, {})
        b = after.get(kube, {}).get("objects", {}).get(resource, {})
        changed.update(k for k in set(a) | set(b) if a.get(k) != b.get(k))
    return changed


def check_joined(plane: ControlPlane, n: int) -> None:
    for obj in plane.host.list_view(FEDERATED_CLUSTERS):
        name = obj["metadata"]["name"]
        for ctype in (JOINED, READY):
            cond = get_condition(obj, ctype)
            if cond is None or cond.get("status") != "True":
                raise AssertionError(f"{name}: {ctype} is {cond}")
        res = obj.get("status", {}).get("resources", {})
        if not res.get("allocatable") or not res.get("available"):
            raise AssertionError(f"{name}: no allocatable/available in {res}")
    got = len(plane.host.keys(FEDERATED_CLUSTERS))
    if got != n:
        raise AssertionError(f"{got} FederatedClusters, {n} expected")


def run_rounds(
    plane: ControlPlane,
    objects: int,
    clusters: int,
    on_round: Optional[Callable[[str], None]] = None,
    after_round: Optional[Callable[[str, dict], None]] = None,
    followers: int = FOLLOWERS,
    migrants: int = MIGRANTS,
) -> dict[str, dict]:
    """The seven rounds of the module docstring on ``plane``, each
    checked, with ``followers`` ``mig-*`` objects, the first ``migrants``
    of them stuck in round 7; ``on_round(name)`` runs just before each
    round (the caller's counter resets) and ``after_round(name,
    report)`` just after it settles, before its checks."""
    expected = {web_key(i): replicas_of(i) for i in range(objects)}
    reports: dict[str, dict] = {}
    resource = plane.ftc.source.resource
    refs = {"default/pp": 0, "default/op": 0}

    def round_(name: str, act: Callable[[], None]) -> dict:
        if on_round is not None:
            on_round(name)
        ticks0, seq0 = len(plane.ticks), plane.engine.tick_seq
        counts0 = plane.member_counts()
        t0 = time.perf_counter()
        act()
        walls = plane.settle()
        wall = time.perf_counter() - t0
        ticks = plane.ticks[ticks0:]
        digests = store_digests(plane.fleet, plane.digest_cache)
        counts = plane.member_counts()
        reports[name] = report = {
            "wall_s": wall,
            "walls_s": walls,
            "engine_ticks": plane.engine.tick_seq - seq0,
            "ticks": ticks,
            "phase1_launches": sum(t["phase1_launches"] for t in ticks),
            "fetch_bytes": sum(t["fetch_bytes"] for t in ticks),
            "store_objects": sum(len(o) for o in digests["host"]["objects"].values()),
            "status_objects": len(digests["host"]["objects"].get(plane.ftc.status.resource, ())),
            "member_objects": counts["member_objects"],
            "member_configmaps": counts["member_configmaps"],
            "member_namespaces": counts["member_namespaces"],
            "member_writes": counts["member_rv"] - counts0["member_rv"],
            "member_ops": {
                verb: n - counts0["member_ops"].get(verb, 0)
                for verb, n in counts["member_ops"].items()
                if n - counts0["member_ops"].get(verb, 0)
            },
            "dispatch_batches": counts["dispatch_batches"] - counts0["dispatch_batches"],
            "sheds": counts["sheds"],
            "retries": counts["retries"],
            # Enqueues the workers' admission deferred (ADMIT_DEPTH), by
            # worker, since the plane started: a deferral waits on the
            # wall clock.
            "admissions": {
                dict(labels).get("controller", ""): n
                for labels, n in plane.metrics.counter_family("worker_admission_total").items()
            },
            "digests": digests,
        }
        if after_round is not None:
            after_round(name, report)
        if name != "join":
            report["controllers"] = check_controllers(plane, refs)
        return report

    # 1. join
    plane.host.create(PROPAGATION_POLICIES, propagation_policy())
    plane.host.create(OVERRIDE_POLICIES, override_policy())
    report = round_("join", lambda: [plane.add_cluster(j) for j in range(clusters)])
    check_joined(plane, clusters)
    if report["member_objects"]:
        raise AssertionError(f"join: {report['member_objects']} member objects")

    # 2. cold
    refs = {"default/pp": objects, "default/op": objects}
    report = round_("cold", lambda: plane.create_objects(range(objects)))
    report["placed"] = check_sums(plane, expected)
    if report["engine_ticks"] < 1:
        raise AssertionError("cold: the scheduler ran no engine tick")
    report["pairs"] = check_members(plane)
    before = plane.placements()

    # 3. churn: every CHURN_EVERY-th Deployment gets 5 more replicas.
    churned = {i: replicas_of(i) + 5 for i in range(0, objects, CHURN_EVERY)}
    report = round_("churn", lambda: plane.scale(churned))
    for i, n in churned.items():
        expected[web_key(i)] = n
    report["placed"] = check_sums(plane, expected)
    after = plane.placements()
    keys = {web_key(i) for i in churned}
    moved = sorted(k for k in after if after[k] != before.get(k))
    if not set(moved) <= keys:
        raise AssertionError(f"churn moved unchurned objects: {sorted(set(moved) - keys)[:5]}")
    if not moved:
        raise AssertionError("churn moved no object")
    report["churned"], report["moved"] = len(churned), len(moved)
    report["pairs"] = check_members(plane)
    written = member_changes(reports["cold"]["digests"], report["digests"], resource)
    if not written or not written <= keys:
        raise AssertionError(f"churn changed member objects of {sorted(written - keys)[:5]}")
    report["members_changed"] = len(written)
    before = after

    # 4. noop: everything re-enqueued, nothing changed.
    report = round_("noop", plane.resync)
    report["placed"] = check_sums(plane, expected)
    if report["engine_ticks"] or report["phase1_launches"]:
        raise AssertionError(
            f"noop: {report['engine_ticks']} engine ticks, "
            f"{report['phase1_launches']} launches (0 expected)"
        )
    if plane.placements() != before:
        raise AssertionError("noop: placements changed")
    if report["member_writes"] or member_changes(
        reports["churn"]["digests"], report["digests"], resource
    ):
        raise AssertionError(f"noop: {report['member_writes']} member writes")

    # 5. topology: one more member joins.
    report = round_("topology", lambda: plane.add_cluster(clusters))
    check_joined(plane, clusters + 1)
    report["placed"] = check_sums(plane, expected)
    if report["engine_ticks"] < 1:
        raise AssertionError("topology: the scheduler ran no engine tick")
    after = plane.placements()
    moved = {k for k in after if after[k] != before.get(k)}
    report["moved"] = len(moved)
    report["pairs"] = check_members(plane)
    written = member_changes(reports["noop"]["digests"], report["digests"], resource)
    if not written <= moved:
        raise AssertionError(f"topology changed member objects of {sorted(written - moved)[:5]}")
    report["members_changed"] = len(written)
    before = after

    # 6. follow: a namespace, its policy, ConfigMaps and the Deployments
    # that mount them.
    refs["team-a/pp-am"] = followers
    report = round_("follow", lambda: plane.create_team(followers))
    for i in range(followers):
        expected[mig_key(i)] = mig_replicas_of(i)
    report["placed"] = check_sums(plane, expected)
    if report["engine_ticks"] < 1:
        raise AssertionError("follow: the scheduler ran no engine tick")
    after = plane.placements()
    wide = [mig_key(i) for i in range(followers) if len(after[mig_key(i)]) > 4]
    if wide:
        raise AssertionError(f"follow: {wide[:3]} on more than 4 clusters")
    moved = {k for k in before if after[k] != before[k]}
    if moved:
        raise AssertionError(f"follow moved web objects: {sorted(moved)[:5]}")
    report["pairs"] = check_members(plane)
    written = member_changes(reports["topology"]["digests"], report["digests"], resource)
    mig = {mig_key(i) for i in range(followers)}
    if written != mig:
        raise AssertionError(f"follow changed member objects of {sorted(written ^ mig)[:5]}")
    report["followers"] = check_followers(plane, followers)
    before = after

    # 7. migrate: the first ``migrants`` mig-* objects stick in one member.
    stuck: dict[str, str] = {}
    log0 = len(plane.capacity_log)
    report = round_("migrate", lambda: stuck.update(plane.stick(migrants)))
    report["placed"] = check_sums(plane, expected)
    # What auto-migration wrote in the round: each stuck object's
    # capacity, once.  Once the scheduler has capped the member, its
    # desired replicas no longer exceed the capacity and the next pass
    # clears the annotation; the scheduler's tick over the cleared
    # objects keeps their placement.
    written_info = [(k, json.loads(i)["estimatedCapacity"])
                    for k, i in plane.capacity_log[log0:] if i is not None]
    want_capped = sorted((key, {name: MIGRATE_READY}) for key, name in stuck.items())
    if sorted(written_info) != want_capped:
        raise AssertionError(f"migrate: estimatedCapacity written {written_info[:4]}, "
                             f"want {want_capped[:4]}")
    report["estimated_capacity"] = len(written_info)
    report["estimated_capacity_held"] = sum(
        1 for key in stuck if plane._capacity.get(key) is not None
    )
    if report["engine_ticks"] < 1:
        raise AssertionError("migrate: the scheduler ran no engine tick")
    after = plane.placements()
    for key, name in stuck.items():
        if after[key].get(name, 0) > MIGRATE_READY:
            raise AssertionError(f"migrate: {key} holds {after[key][name]} in {name}")
    moved = {k for k in before if after[k] != before[k]}
    if not moved or not moved <= set(stuck):
        raise AssertionError(f"migrate moved {sorted(moved - set(stuck))[:5]} "
                             f"({len(moved)} objects)")
    report["moved"] = len(moved)
    report["pairs"] = check_members(plane)
    written = member_changes(reports["follow"]["digests"], report["digests"], resource)
    if not written <= set(stuck):
        raise AssertionError(f"migrate changed member objects of {sorted(written - set(stuck))[:5]}")
    cfgs = member_changes(reports["follow"]["digests"], report["digests"], CONFIGMAPS)
    want_cfgs = {cfg_key(int(k.rsplit("-", 1)[1])) for k in moved}
    if not cfgs <= want_cfgs:
        raise AssertionError(f"migrate changed ConfigMaps {sorted(cfgs - want_cfgs)[:5]}")
    report["members_changed"] = len(written)
    report["followers"] = check_followers(plane, followers)

    panics = plane.panics()
    if any(panics.values()):
        raise AssertionError(f"controller panics: { {k: v for k, v in panics.items() if v} }")
    last = reports["migrate"]
    if last["sheds"] or last["retries"]:
        raise AssertionError(f"dispatch: {last['sheds']} sheds, {last['retries']} retries")
    return reports
