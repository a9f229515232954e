"""The control plane at benchmark scale: scheduling and member sync.

A port-owned copy of the world of ``bench_e2e.py:521-690``, the run that
BASELINE.md lists as "bench_e2e.py at config-#3 scale": member clusters
``m-0000…`` each with one node of ``32 + j % 64`` cpu and 256Gi and a
``tier`` label of ``j % 3``; the PropagationPolicy ``pp`` in ``Divide``
mode; Deployments ``web-00000…`` with ``(i % 20) + 1`` replicas of 50m
cpu; the ``deployments.apps`` FederatedTypeConfig with the scheduler as
its only pipeline member.  The OverridePolicy, its label on the
Deployments and the override and status stages of the bench are left
out: their controllers are not part of this copy.

:class:`ControlPlane` holds a :class:`ClusterFleet` and four controllers
(cluster, federate, scheduler, sync) over the given engine, and settles
them as the bench's ``StageTimer`` does, timing each controller.  The
sync controller writes each placed object to its member clusters
inline (an in-process fleet), in submission order.
:func:`run_rounds` drives five rounds and checks each:

1. ``join`` — the cluster controller settles the members' joins; every
   FederatedCluster is Joined and Ready with allocatable and available;
   no member holds a Deployment;
2. ``cold`` — the Deployments are created and the federate, scheduler
   and sync controllers settle; every FederatedObject is placed and its
   replica overrides sum to its ``spec.replicas``; every placed
   (object, cluster) pair has one member Deployment with that cluster's
   replicas and an ``OK`` propagation status, and the members hold
   nothing else (:func:`check_members`);
3. ``churn`` — ``spec.replicas`` of every hundredth Deployment changes;
   only those objects' placements and member objects change;
4. ``noop`` — every object is re-enqueued to the scheduler with nothing
   changed; the trigger-hash skip holds all of them back from the
   engine (no tick, no launch), and no member is written;
5. ``topology`` — one more member joins, which changes the scheduler's
   cluster signature; every object is rescheduled and still sums, and
   only the objects whose placement moved change on the members.

Each round reports its walls by controller, the engine ticks with their
phase-1 launches, fetch bytes and fetch paths, the objects placed, the
store's object count, the member objects, writes and dispatch
accounting (:meth:`ControlPlane.member_counts`), and the store's
per-object digests (:func:`store_digests`; wall-clock fields masked),
which let two runs — the card's engine and the CPU engine — be held
equal object for object.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import time
from typing import Callable, Optional

from kubeadmiral_tpu_torch.federation import common as C
from kubeadmiral_tpu_torch.federation.clusterctl import (
    FEDERATED_CLUSTERS,
    JOINED,
    NODES,
    READY,
    FederatedClusterController,
    get_condition,
)
from kubeadmiral_tpu_torch.federation.federate import FederateController
from kubeadmiral_tpu_torch.federation.schedulerctl import SchedulerController
from kubeadmiral_tpu_torch.federation.sync import SyncController
from kubeadmiral_tpu_torch.models.ftc import default_ftcs
from kubeadmiral_tpu_torch.models.policy import PROPAGATION_POLICIES
from kubeadmiral_tpu_torch.ops import phase1 as phase1_mod
from kubeadmiral_tpu_torch.runtime.metrics import Metrics
from kubeadmiral_tpu_torch.testing.fakekube import ClusterFleet

GVK = "apps/v1/Deployment"
PIPELINE = ((C.SCHEDULER,),)
CHURN_EVERY = 100
ROUNDS = ("join", "cold", "churn", "noop", "topology")

# Fields that carry wall-clock times, masked before two stores are held
# equal: the event recorder stamps ``time.time()`` on each event.
WALL_CLOCK_FIELDS = {"v1/events": ("firstTimestamp", "lastTimestamp")}


def deployment_ftc():
    ftc = next(f for f in default_ftcs() if f.name == "deployments.apps")
    return dataclasses.replace(ftc, controllers=PIPELINE)


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


def propagation_policy() -> dict:
    return {
        "apiVersion": "core.kubeadmiral.io/v1alpha1",
        "kind": "PropagationPolicy",
        "metadata": {"name": "pp", "namespace": "default"},
        "spec": {"schedulingMode": "Divide"},
    }


def replicas_of(i: int) -> int:
    return (i % 20) + 1


def make_deployment(i: int) -> dict:
    name = f"web-{i:05d}"
    return {
        "apiVersion": "apps/v1",
        "kind": "Deployment",
        "metadata": {
            "name": name,
            "namespace": "default",
            "labels": {"kubeadmiral.io/propagation-policy-name": "pp"},
        },
        "spec": {
            "replicas": replicas_of(i),
            "selector": {"matchLabels": {"app": name}},
            "template": {
                "metadata": {"labels": {"app": name}},
                "spec": {
                    "containers": [
                        {
                            "name": "c",
                            "image": "nginx",
                            "resources": {"requests": {"cpu": "50m"}},
                        }
                    ]
                },
            },
        },
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


class StageTimer:
    """Each controller's ``worker.step()`` with cumulative timing: the
    in-process settle of ``bench_e2e.py:StageTimer``."""

    def __init__(self, named_controllers):
        self.stages = {name: 0.0 for name, _ in named_controllers}
        self.controllers = named_controllers

    def settle(self, max_rounds: int = 10_000) -> None:
        for _ in range(max_rounds):
            progressed = False
            for name, ctl in self.controllers:
                t0 = time.perf_counter()
                stepped = True
                # Drain this controller fully before moving on: batch
                # controllers amortize best over a full queue.
                while stepped:
                    stepped = ctl.worker.step()
                    progressed |= stepped
                self.stages[name] += time.perf_counter() - t0
            if not progressed:
                # Keys pending but not yet due within a short fuse
                # (admission delays) are waited out; long-fuse requeues
                # (heartbeats) read as idle.
                dues = [
                    d
                    for _, ctl in self.controllers
                    for d in (ctl.worker.queue.next_due_in(),)
                    if d is not None and d <= 0.25
                ]
                if not dues:
                    return
                time.sleep(min(dues) + 0.002)
        raise RuntimeError(f"controllers did not settle in {max_rounds} rounds")


class ControlPlane:
    """A fleet and the cluster, federate, scheduler and sync controllers
    over ``engine`` (``None``: the scheduler's default engine, on the
    card)."""

    def __init__(self, engine=None):
        self.fleet = ClusterFleet()
        self.host = self.fleet.host
        self.ftc = deployment_ftc()
        self.metrics = Metrics()
        self.clusterctl = FederatedClusterController(
            self.fleet, metrics=self.metrics, api_resource_probe=[GVK]
        )
        self.federate = FederateController(self.host, self.ftc, metrics=self.metrics)
        self.scheduler = SchedulerController(
            self.host, self.ftc, engine=engine, metrics=self.metrics
        )
        self.sync = SyncController(self.fleet, self.ftc, metrics=self.metrics)
        self.engine = self.scheduler.engine
        self.timer = StageTimer(
            [("cluster", self.clusterctl), ("federate", self.federate),
             ("schedule", self.scheduler), ("sync", self.sync)]
        )
        # Member ops by verb, through the members' bulk write path.
        self.member_ops: dict[str, int] = {}
        # Store digests by (store, resource, key, resourceVersion).
        self.digest_cache: dict = {}
        self.ticks: list[dict] = []
        self._schedule = self.engine.schedule
        self.engine.schedule = self._recorded_schedule

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
            obj = self.host.get(self.ftc.source.resource, f"default/web-{i:05d}")
            obj["spec"]["replicas"] = n
            self.host.update(self.ftc.source.resource, obj)

    def resync(self) -> None:
        """Re-enqueue every federated object to the scheduler."""
        self.scheduler.worker.enqueue_all(self.host.keys(self.ftc.federated.resource))

    def settle(self) -> dict[str, float]:
        """Settle the controllers; seconds per controller."""
        before = dict(self.timer.stages)
        self.timer.settle()
        return {k: v - before[k] for k, v in self.timer.stages.items()}

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

    def member_objects(self) -> dict[str, dict[str, dict]]:
        """Member -> {key: Deployment} as the members hold them."""
        resource = self.ftc.source.resource
        return {
            name: {
                C.meta(obj).get("namespace", "") + "/" + obj["metadata"]["name"]: obj
                for obj in member.list_view(resource)
            }
            for name, member in self.fleet.members.items()
        }

    def member_counts(self) -> dict:
        """Cumulative member-side counts: Deployments held, store writes
        (resourceVersion steps), ops by verb, bulk requests, and the
        breakers' sheds and retries."""
        resource = self.ftc.source.resource
        members = self.fleet.members.values()
        snap = self.sync.breakers.snapshot()
        return {
            "member_objects": sum(len(m.keys(resource)) for m in members),
            "member_rv": sum(m._rv for m in members),
            "member_ops": dict(sorted(self.member_ops.items())),
            "dispatch_batches": sum(
                sum(e.get("batch", {}).get("requests", {}).values()) for e in snap.values()
            ),
            "sheds": self.sync.breakers.shed_total(),
            "retries": sum(e["dispatch_retries"] for e in snap.values()),
        }

    def panics(self) -> dict[str, float]:
        """The controllers' panic and error counters (all must stay 0)."""
        name = self.ftc.name
        return {
            key: self.metrics.get_counter(key)
            for key in (
                f"scheduler-{name}.persist_panic",
                f"scheduler-{name}.panic",
                f"scheduler-{name}.unit_errors",
                f"federate-{name}.panic",
                "cluster-controller.panic",
                f"sync-{name}.panic",
                f"sync-{name}.plan_panic",
                f"sync-{name}.finish_panic",
                f"sync-{name}.host_write_panic",
            )
        }


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
    members hold no other Deployment; returns the pairs."""
    placed = plane.placements()
    held = plane.member_objects()
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
) -> dict[str, dict]:
    """The five rounds of the module docstring on ``plane``, each checked;
    ``on_round(name)`` runs just before each round (the caller's counter
    resets) and ``after_round(name, report)`` just after it settles,
    before its checks."""
    expected = {f"default/web-{i:05d}": replicas_of(i) for i in range(objects)}
    reports: dict[str, dict] = {}
    resource = plane.ftc.source.resource

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
            "member_objects": counts["member_objects"],
            "member_writes": counts["member_rv"] - counts0["member_rv"],
            "member_ops": {
                verb: n - counts0["member_ops"].get(verb, 0)
                for verb, n in counts["member_ops"].items()
                if n - counts0["member_ops"].get(verb, 0)
            },
            "dispatch_batches": counts["dispatch_batches"] - counts0["dispatch_batches"],
            "sheds": counts["sheds"],
            "retries": counts["retries"],
            "digests": digests,
        }
        if after_round is not None:
            after_round(name, report)
        return report

    # 1. join
    plane.host.create(PROPAGATION_POLICIES, propagation_policy())
    report = round_("join", lambda: [plane.add_cluster(j) for j in range(clusters)])
    check_joined(plane, clusters)
    if report["member_objects"]:
        raise AssertionError(f"join: {report['member_objects']} member objects")

    # 2. cold
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
        expected[f"default/web-{i:05d}"] = n
    report["placed"] = check_sums(plane, expected)
    after = plane.placements()
    keys = {f"default/web-{i:05d}" for i in churned}
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

    panics = plane.panics()
    if any(panics.values()):
        raise AssertionError(f"controller panics: {panics}")
    last = reports["topology"]
    if last["sheds"] or last["retries"]:
        raise AssertionError(f"dispatch: {last['sheds']} sheds, {last['retries']} retries")
    return reports
