"""The port's control plane against the JAX package's, store for store.

A ``Pair`` builds the same fleet twice: the JAX package's
``ClusterFleet`` with the JAX manager's controller set for the
``deployments.apps`` FTC (``runtime/manager.py:_start_ftc``: the
cluster, federate, scheduler, override — when the pipeline names it —
sync, policyrc, status, status aggregator, auto-migration over a pod
informer, and follower controllers) over a JAX ``SchedulerEngine``, and
the port's copies of the same modules over the port's
``SchedulerEngine(device="cpu")``.  Every case feeds both the same
objects in the same order; after each settle the two fleets' stores
(host and members) are equal object for object — placements,
overrides, trigger-hash and pending-controllers annotations, status
objects, policy statuses, resourceVersions, events — with only the
fields listed in ``cpworld.WALL_CLOCK_FIELDS`` masked (the event
recorder's ``time.time()`` stamps), and the engines' tick count, cache
and fetch counters are equal.  The controllers take a frozen clock on
both sides, so no heartbeat or backoff falls due mid-case.  The default
SLO recorders hold the same provenance tokens, stage marks and event
counters.

The cases are the cases of ``tests/test_e2e_slice.py`` with the sync
controller writing to the members, whose stores are compared too
(propagation with divided replicas, source feedback, source update,
the deletion cascade, scaling, a policy change, a cluster join, and the
migration off a NoExecute-tainted cluster), ``tests/test_profile.py`` (the taint filter, a disabled
plugin, a profile update rescheduling, the max-cluster cap) and
``tests/test_webhook.py`` (its fake ``HTTPClient``: a filter, the batch
protocol, a select, an unsupported payload version); each runs with
both engines at the pipeline depth 16 (the default of both) and at
depth 1.  ``test_seven_rounds_stores_equal`` drives
``testing/cpworld.py``'s seven rounds (join, cold, churn, no-op,
topology, follow, migrate; three FTCs, the follower and the monitors)
at a small size over each package, at depth 16 and 1: the stores after
every settle (status, policy-status, ConfigMap, Namespace and Pod
objects included), the monitors' gauges, the SLO recorders and every
round's checked counts are equal.
"""

import dataclasses
import importlib
import json
import types

import pytest

from test_e2e_slice import make_deployment, make_node
from test_webhook import FakeClient

from kubeadmiral_tpu.runtime import slo as jax_slo
from kubeadmiral_tpu.runtime.devprof import DispatchLedger as JaxLedger
from kubeadmiral_tpu.runtime.flightrec import FlightRecorder as JaxRecorder
from kubeadmiral_tpu.scheduler.engine import SchedulerEngine as JaxEngine
from kubeadmiral_tpu_torch.runtime import slo as port_slo
from kubeadmiral_tpu_torch.runtime.devprof import DispatchLedger
from kubeadmiral_tpu_torch.runtime.flightrec import FlightRecorder
from kubeadmiral_tpu_torch.scheduler.engine import SchedulerEngine
from kubeadmiral_tpu_torch.testing.cpworld import WALL_CLOCK_FIELDS

GVK = "apps/v1/Deployment"
SCHEDULER_ONLY = (("kubeadmiral.io/global-scheduler",),)
DEPTHS = (16, 1)


def masked_dump(fleet) -> dict:
    """The fleet's dump with the wall-clock fields removed."""
    dump = fleet.dump()
    for kube in [dump["host"], *dump["members"].values()]:
        for resource, fields in WALL_CLOCK_FIELDS.items():
            for obj in kube["objects"].get(resource, {}).values():
                for field in fields:
                    obj.pop(field, None)
    return dump


def first_difference(a, b, path="") -> str:
    if type(a) is not type(b):
        return f"{path}: {a!r} != {b!r}"
    if isinstance(a, dict):
        for k in sorted(set(a) | set(b), key=str):
            if k not in a or k not in b:
                return f"{path}/{k}: only in {'jax' if k in a else 'port'}"
            if a[k] != b[k]:
                return first_difference(a[k], b[k], f"{path}/{k}")
    if isinstance(a, list) and len(a) != len(b):
        return f"{path}: {len(a)} != {len(b)} items"
    if isinstance(a, list):
        for i, (x, y) in enumerate(zip(a, b)):
            if x != y:
                return first_difference(x, y, f"{path}[{i}]")
    return f"{path}: {a!r} != {b!r}"


class Side:
    """One package's fleet and the JAX manager's controllers for the
    ``deployments.apps`` FTC (``runtime/manager.py:_start_ftc``: federate,
    the scheduler once started, the override controller when the
    pipeline names it, sync, policyrc, status, the status aggregator,
    auto-migration over a pod informer, and the follower controller)."""

    def __init__(self, root: str, engine, pipeline=SCHEDULER_ONLY):
        def m(name):
            return importlib.import_module(f"{root}.{name}")

        self.root = root
        self.C = m("federation.common")
        self.ctl = m("federation.clusterctl")
        self.PR = m("models.profile")
        self.P = m("models.policy")
        self.W = m("scheduler.webhook")
        self.schedulerctl = m("federation.schedulerctl")
        ftc = next(f for f in m("models.ftc").default_ftcs() if f.name == "deployments.apps")
        self.ftc = dataclasses.replace(ftc, controllers=pipeline)
        self.fleet = m("testing.fakekube").ClusterFleet()
        self.host = self.fleet.host
        self.engine = engine
        clock = lambda: 0.0  # noqa: E731 - frozen: no heartbeat falls due
        self.clusterctl = self.ctl.FederatedClusterController(
            self.fleet, api_resource_probe=[GVK], clock=clock
        )
        self.federate = m("federation.federate").FederateController(
            self.host, self.ftc, clock=clock
        )
        self.scheduler = None
        self.client = None
        names = {c for group in pipeline for c in group}
        self.override = (
            m("federation.overridectl").OverrideController(self.host, self.ftc, clock=clock)
            if self.C.OVERRIDE_CONTROLLER in names else None
        )
        self.sync = m("federation.sync").SyncController(self.fleet, self.ftc, clock=clock)
        self.policyrc = m("federation.policyrc").PolicyRCController(self.host, self.ftc)
        statusctl = m("federation.statusctl")
        self.status = statusctl.StatusController(self.fleet, self.ftc, clock=clock)
        self.statusagg = statusctl.StatusAggregator(self.fleet, self.ftc, clock=clock)
        self.automigration = m("federation.automigration").AutoMigrationController(
            self.fleet, self.ftc, clock=clock,
            pod_informer=m("runtime.podinformer").PodInformer(self.fleet),
        )
        self.follower = m("federation.follower").FollowerController(
            self.host, [self.ftc], clock=clock
        )

    def start_scheduler(self, client=None) -> None:
        self.client = client
        self.scheduler = self.schedulerctl.SchedulerController(
            self.host, self.ftc, engine=self.engine, webhook_client=client
        )

    def controllers(self):
        return tuple(
            c for c in (
                self.clusterctl, self.federate, self.scheduler, self.override,
                self.sync, self.policyrc, self.status, self.statusagg,
                self.automigration, self.follower,
            ) if c
        )

    def settle(self, rounds=20) -> None:
        for _ in range(rounds):
            progressed = False
            for c in self.controllers():
                step = getattr(c, "step_all", None) or c.worker.step
                progressed |= step()
            if not progressed:
                return
        raise AssertionError(f"{self.root}: not settled in {rounds} rounds")

    def add_cluster(self, name, cpu="64", labels=None, taints=None) -> None:
        member = self.fleet.add_member(name)
        member.create(self.ctl.NODES, make_node("n1", cpu, "128Gi"))
        spec = {"taints": [dict(t) for t in taints]} if taints else {}
        self.host.create(
            self.ctl.FEDERATED_CLUSTERS,
            {
                "apiVersion": "core.kubeadmiral.io/v1alpha1",
                "kind": "FederatedCluster",
                "metadata": {"name": name, "labels": dict(labels or {})},
                "spec": spec,
            },
        )

    def placement(self, name="web"):
        fed = self.host.get(self.ftc.federated.resource, f"default/{name}")
        return self.C.get_placement(fed, self.C.SCHEDULER)

    def member_replicas(self, name="web") -> dict:
        """Cluster -> spec.replicas of the member objects sync wrote."""
        out = {}
        for cluster, member in sorted(self.fleet.members.items()):
            obj = member.try_get(self.ftc.source.resource, f"default/{name}")
            if obj is not None:
                out[cluster] = obj["spec"]["replicas"]
        return out

    def statuses(self, name="web") -> dict:
        fed = self.host.get(self.ftc.federated.resource, f"default/{name}")
        return {c["cluster"]: c["status"] for c in fed["status"]["clusters"]}

    def replicas(self, name="web") -> dict:
        fed = self.host.get(self.ftc.federated.resource, f"default/{name}")
        return {
            cl: patches[0]["value"]
            for cl, patches in self.C.get_overrides(fed, self.C.SCHEDULER).items()
        }


def slo_image(mod):
    """The default SLO recorder's tokens (generation and stage names per
    key), last generations and event counters; the marks' times are
    wall clock."""
    rec = mod.get_default()
    with rec._lock:
        pending = {k: (e.gen, [s for s, _ in e.marks]) for k, e in rec._pending.items()}
        return pending, dict(rec._gen), rec.metrics.counter_family("slo_events_total")


class Pair:
    """The JAX side and the port side, fed the same objects."""

    def __init__(self, monkeypatch, depth: int, **side_kw):
        monkeypatch.setenv("KT_PIPELINE_DEPTH", str(depth))
        jax_slo.reset_default()
        port_slo.reset_default()
        # Each engine its own dispatch ledger: the tick ids the spans
        # carry are then each engine's tick count.
        ref = JaxEngine(
            mesh=None, devprof=JaxLedger(enabled=True),
            flight_recorder=JaxRecorder(max_ticks=8, max_bytes=256 << 20, topk=8, enabled=True),
        )
        port = SchedulerEngine(
            device="cpu", flight_recorder=FlightRecorder(), devprof=DispatchLedger()
        )
        port.pipeline_depth = depth
        self.jax = Side("kubeadmiral_tpu", ref, **side_kw)
        self.port = Side("kubeadmiral_tpu_torch", port, **side_kw)
        self.sides = (self.jax, self.port)

    def each(self, fn):
        """fn(side) on the JAX side, then on the port side."""
        return [fn(s) for s in self.sides]

    def create(self, resource_of, obj) -> None:
        for s in self.sides:
            s.host.create(resource_of(s), json.loads(json.dumps(obj)))

    def update(self, resource_of, key, mutate) -> None:
        for s in self.sides:
            obj = s.host.get(resource_of(s), key)
            mutate(obj)
            s.host.update(resource_of(s), obj)

    def settle(self, rounds=20) -> None:
        for s in self.sides:
            s.settle(rounds)
        self.assert_equal()

    def assert_equal(self) -> None:
        a, b = masked_dump(self.jax.fleet), masked_dump(self.port.fleet)
        assert a == b, first_difference(a, b)
        ref, port = self.jax.engine, self.port.engine
        assert port.tick_seq == ref.tick_seq
        assert port.cache_stats == ref.cache_stats
        assert port.fetch_stats == ref.fetch_stats
        assert slo_image(port_slo) == slo_image(jax_slo)

    def same(self, fn):
        """fn(side) equal on both sides; returns the value."""
        got = self.each(fn)
        assert got[0] == got[1], got
        return got[0]


def source(s):
    return s.ftc.source.resource


def fed_resource(s):
    return s.ftc.federated.resource


def policy(mode="Divide", **spec):
    return {
        "apiVersion": "core.kubeadmiral.io/v1alpha1",
        "kind": "PropagationPolicy",
        "metadata": {"name": "pp", "namespace": "default"},
        "spec": {"schedulingMode": mode, **spec},
    }


def policies(s):
    return s.P.PROPAGATION_POLICIES


def profiles(s):
    return s.PR.SCHEDULING_PROFILES


def clusters_of(s):
    return s.ctl.FEDERATED_CLUSTERS


@pytest.fixture(params=DEPTHS, ids=lambda d: f"depth{d}")
def depth(request):
    return request.param


# -- tests/test_e2e_slice.py's scheduling cases ------------------------------

@pytest.fixture
def slice_pair(monkeypatch, depth):
    pair = Pair(monkeypatch, depth)
    pair.each(lambda s: s.start_scheduler())
    for name, cpu in (("c1", "64"), ("c2", "32"), ("c3", "32")):
        pair.each(lambda s: s.add_cluster(name, cpu))
    pair.create(policies, policy())
    pair.settle()
    return pair


class TestE2ESliceScheduling:
    def test_deployment_divided_replicas(self, slice_pair):
        slice_pair.create(source, make_deployment())
        slice_pair.settle()
        assert slice_pair.same(lambda s: s.placement()) == {"c1", "c2", "c3"}
        assert sum(slice_pair.same(lambda s: s.replicas()).values()) == 9
        assert slice_pair.same(lambda s: s.member_replicas()) == slice_pair.same(
            lambda s: s.replicas()
        )
        assert slice_pair.same(lambda s: s.statuses()) == {c: "OK" for c in ("c1", "c2", "c3")}

    def test_source_feedback_annotation(self, slice_pair):
        slice_pair.create(source, make_deployment())
        slice_pair.settle()

        def feedback(s):
            src = s.host.get(source(s), "default/web")
            return json.loads(src["metadata"]["annotations"][s.C.SOURCE_FEEDBACK_SCHEDULING])

        assert slice_pair.same(feedback)["placement"] == ["c1", "c2", "c3"]

    def test_source_update_rolls_through(self, slice_pair):
        slice_pair.create(source, make_deployment())
        slice_pair.settle()

        def bump(obj):
            obj["spec"]["replicas"] = 15
            obj["spec"]["template"]["spec"]["containers"][0]["image"] = "nginx:2"

        slice_pair.update(source, "default/web", bump)
        slice_pair.settle()
        assert sum(slice_pair.same(lambda s: s.replicas()).values()) == 15
        assert sum(slice_pair.same(lambda s: s.member_replicas()).values()) == 15

    def test_source_delete_removes_federated_object(self, slice_pair):
        slice_pair.create(source, make_deployment())
        slice_pair.settle()
        slice_pair.each(lambda s: s.host.delete(source(s), "default/web"))
        slice_pair.settle(rounds=40)
        assert slice_pair.same(lambda s: s.host.try_get(fed_resource(s), "default/web")) is None
        assert slice_pair.same(lambda s: s.host.try_get(source(s), "default/web")) is None
        assert slice_pair.same(lambda s: s.member_replicas()) == {}

    def test_scaling_up_and_down(self, slice_pair):
        for i in range(4):
            slice_pair.create(source, make_deployment(name=f"web-{i}", replicas=3 + i))
        slice_pair.settle()
        for replicas in (40, 1, 0, 7):
            def scale(obj, n=replicas):
                obj["spec"]["replicas"] = n

            slice_pair.update(source, "default/web-2", scale)
            slice_pair.settle()
            assert sum(slice_pair.same(lambda s: s.replicas("web-2")).values()) == replicas
            assert sum(slice_pair.same(lambda s: s.member_replicas("web-2")).values()) == replicas

    def test_policy_change_reschedules(self, slice_pair):
        for i in range(3):
            slice_pair.create(source, make_deployment(name=f"web-{i}"))
        slice_pair.settle()

        def duplicate(obj):
            obj["spec"] = {"schedulingMode": "Duplicate", "maxClusters": 2}

        slice_pair.update(policies, "default/pp", duplicate)
        slice_pair.settle()
        assert slice_pair.same(lambda s: len(s.placement("web-1"))) == 2
        assert slice_pair.same(lambda s: s.replicas("web-1")) == {}

    def test_cluster_join_reschedules(self, slice_pair):
        for i in range(3):
            slice_pair.create(source, make_deployment(name=f"web-{i}", replicas=30))
        slice_pair.settle()
        ticks = slice_pair.same(lambda s: s.engine.tick_seq)
        slice_pair.each(lambda s: s.add_cluster("c4", "128"))
        slice_pair.settle()
        # The new cluster changes every object's trigger hash: a new tick.
        assert slice_pair.same(lambda s: s.engine.tick_seq) > ticks
        assert sum(slice_pair.same(lambda s: s.replicas("web-0")).values()) == 30

    def test_cluster_taint_reschedules(self, slice_pair):
        for i in range(3):
            slice_pair.create(source, make_deployment(name=f"web-{i}"))
        slice_pair.settle()

        def taint(effect):
            def mutate(obj):
                obj.setdefault("spec", {})["taints"] = [
                    {"key": "dedicated", "value": "infra", "effect": effect}
                ]
            return mutate

        # NoSchedule keeps what is placed and turns new objects away...
        slice_pair.update(clusters_of, "c1", taint("NoSchedule"))
        slice_pair.create(source, make_deployment(name="web-new"))
        slice_pair.settle()
        assert slice_pair.same(lambda s: s.placement("web-0")) == {"c1", "c2", "c3"}
        assert slice_pair.same(lambda s: s.placement("web-new")) == {"c2", "c3"}
        # ... NoExecute evicts.
        slice_pair.update(clusters_of, "c1", taint("NoExecute"))
        slice_pair.settle()
        assert slice_pair.same(lambda s: s.placement("web-0")) == {"c2", "c3"}
        assert sum(slice_pair.same(lambda s: s.replicas("web-0")).values()) == 9
        # The migration off c1: its member object is deleted.
        assert set(slice_pair.same(lambda s: s.member_replicas("web-0"))) == {"c2", "c3"}


# -- tests/test_profile.py's wiring cases ------------------------------------

@pytest.fixture
def profile_pair(monkeypatch, depth):
    """test_profile.py's world: three clusters, c1 tainted."""
    pair = Pair(monkeypatch, depth)
    pair.each(lambda s: s.start_scheduler())
    taints = [{"key": "dedicated", "value": "infra", "effect": "NoSchedule"}]
    for name in ("c1", "c2", "c3"):
        pair.each(lambda s: s.add_cluster(name, taints=taints if name == "c1" else None))
    pair.settle()
    return pair


def no_taints_profile(name):
    return {
        "apiVersion": "core.kubeadmiral.io/v1alpha1",
        "kind": "SchedulingProfile",
        "metadata": {"name": name},
        "spec": {
            "plugins": {
                "filter": {"disabled": [{"name": "TaintToleration"}]},
                "score": {"disabled": [{"name": "TaintToleration"}]},
            }
        },
    }


class TestProfileScheduling:
    def test_default_profile_respects_taints(self, profile_pair):
        profile_pair.create(policies, policy("Duplicate"))
        profile_pair.create(source, make_deployment())
        profile_pair.settle()
        assert profile_pair.same(lambda s: s.placement()) == {"c2", "c3"}

    def test_profile_disabling_taint_filter(self, profile_pair):
        profile_pair.create(profiles, no_taints_profile("no-taints"))
        profile_pair.create(policies, policy("Duplicate", schedulingProfile="no-taints"))
        profile_pair.create(source, make_deployment())
        profile_pair.settle()
        assert profile_pair.same(lambda s: s.placement()) == {"c1", "c2", "c3"}

    def test_profile_update_triggers_reschedule(self, profile_pair):
        profile_pair.create(policies, policy("Duplicate", schedulingProfile="later"))
        profile_pair.create(source, make_deployment())
        profile_pair.settle()
        assert profile_pair.same(lambda s: s.placement()) == {"c2", "c3"}
        profile_pair.create(profiles, no_taints_profile("later"))
        profile_pair.settle()
        assert profile_pair.same(lambda s: s.placement()) == {"c1", "c2", "c3"}

    def test_profile_disabling_maxcluster_lifts_cap(self, profile_pair):
        profile_pair.create(
            profiles,
            {
                "apiVersion": "core.kubeadmiral.io/v1alpha1",
                "kind": "SchedulingProfile",
                "metadata": {"name": "no-topk"},
                "spec": {"plugins": {"select": {"disabled": [{"name": "MaxCluster"}]}}},
            },
        )
        profile_pair.create(
            policies,
            policy(
                "Duplicate", maxClusters=1, schedulingProfile="no-topk",
                tolerations=[{"key": "dedicated", "operator": "Exists"}],
            ),
        )
        profile_pair.create(source, make_deployment())
        profile_pair.settle()
        assert profile_pair.same(lambda s: s.placement()) == {"c1", "c2", "c3"}

    def test_max_clusters_cap_holds_with_default_profile(self, profile_pair):
        profile_pair.create(
            policies,
            policy("Duplicate", maxClusters=1,
                   tolerations=[{"key": "dedicated", "operator": "Exists"}]),
        )
        profile_pair.create(source, make_deployment())
        profile_pair.settle()
        assert len(profile_pair.same(lambda s: s.placement())) == 1


# -- tests/test_webhook.py's scheduling cases (fake HTTPClient) --------------

class RegionFilter(FakeClient):
    """Per-pair filter: regions "eu" pass; select keeps the first name."""

    def post(self, url, body, timeout):
        req = json.loads(body)
        self.requests.append((url, req))
        if url.endswith("/filter"):
            return json.dumps(
                {"selected": req["cluster"]["metadata"]["labels"].get("region") == "eu"}
            ).encode()
        if url.endswith("/select"):
            names = sorted(cs["cluster"]["metadata"]["name"] for cs in req["clusterScores"])
            return json.dumps({"selectedClusterNames": names[:1]}).encode()
        raise AssertionError(f"unexpected url {url}")


class BatchServer(FakeClient):
    """The batch protocol: one POST per plugin per tick."""

    def post(self, url, body, timeout):
        req = json.loads(body)
        self.requests.append((url, req))
        if url.endswith("/filter-batch"):
            rows = [
                [c["metadata"]["labels"].get("region") == "eu" for c in req["clusters"]]
                for _ in req["schedulingUnits"]
            ]
            return json.dumps({"selected": rows}).encode()
        if url.endswith("/score-batch"):
            rows = [
                [50 if c["metadata"]["name"] == "c2" else 1 for c in req["clusters"]]
                for _ in req["schedulingUnits"]
            ]
            return json.dumps({"scores": rows}).encode()
        raise AssertionError(f"per-pair call leaked: {url}")


def webhook_config(name, paths, versions=("v1alpha1",)):
    return {
        "apiVersion": "core.kubeadmiral.io/v1alpha1",
        "kind": "SchedulerPluginWebhookConfiguration",
        "metadata": {"name": name},
        "spec": {"urlPrefix": "http://webhook.example", **paths,
                 "payloadVersions": list(versions)},
    }


def webhook_pair(monkeypatch, depth, client_cls):
    pair = Pair(monkeypatch, depth)
    pair.each(lambda s: s.start_scheduler(client_cls({})))
    for name, region in (("c1", "us"), ("c2", "eu"), ("c3", "eu")):
        pair.each(lambda s: s.add_cluster(name, labels={"region": region}))
    pair.settle()
    return pair


def with_webhook_profile(pair, webhook, points):
    plugins = {p: {"enabled": [{"type": "Webhook", "name": webhook}]} for p in points}
    pair.create(
        profiles,
        {
            "apiVersion": "core.kubeadmiral.io/v1alpha1",
            "kind": "SchedulingProfile",
            "metadata": {"name": "with-webhook"},
            "spec": {"plugins": plugins},
        },
    )
    pair.create(policies, policy("Duplicate", schedulingProfile="with-webhook"))


def webhook_configs(s):
    return s.W.SCHEDULER_WEBHOOK_CONFIGS


class TestWebhookScheduling:
    def test_fake_client_filter_narrows_placement(self, monkeypatch, depth):
        pair = webhook_pair(monkeypatch, depth, RegionFilter)
        pair.create(webhook_configs, webhook_config("eu-only", {"filterPath": "/filter"}))
        with_webhook_profile(pair, "eu-only", ("filter",))
        pair.create(source, make_deployment())
        pair.settle()
        assert pair.same(lambda s: s.placement()) == {"c2", "c3"}
        assert pair.same(lambda s: len(s.client.requests)) > 0

    def test_filter_and_select_narrow_to_one(self, monkeypatch, depth):
        pair = webhook_pair(monkeypatch, depth, RegionFilter)
        pair.create(
            webhook_configs,
            webhook_config("eu-picker", {"filterPath": "/filter", "selectPath": "/select"}),
        )
        with_webhook_profile(pair, "eu-picker", ("filter", "select"))
        pair.create(source, make_deployment())
        pair.settle()
        assert pair.same(lambda s: s.placement()) == {"c2"}

    def test_batch_protocol_one_post_per_plugin_per_tick(self, monkeypatch, depth):
        pair = webhook_pair(monkeypatch, depth, BatchServer)
        pair.create(
            webhook_configs,
            webhook_config("eu-batch", {"filterPath": "/filter", "scorePath": "/score"}),
        )
        with_webhook_profile(pair, "eu-batch", ("filter", "score"))
        for i in range(6):
            pair.create(source, make_deployment(name=f"web-{i}"))
        pair.settle()
        for i in range(6):
            assert pair.same(lambda s: s.placement(f"web-{i}")) == {"c2", "c3"}
        urls = pair.same(lambda s: [u for u, _ in s.client.requests])
        assert urls and all(u.endswith("-batch") for u in urls)
        assert len(urls) <= 6

    def test_unsupported_payload_version_is_not_registered(self, monkeypatch, depth):
        pair = webhook_pair(monkeypatch, depth, RegionFilter)
        pair.create(
            webhook_configs, webhook_config("future", {"filterPath": "/filter"}, ("v99",))
        )
        pair.settle()
        assert pair.same(lambda s: "future" in s.scheduler.webhook_plugins) is False


# -- the engine's tick id on the controller's spans ---------------------------

def test_trace_spans_carry_the_same_tick_ids(monkeypatch):
    """The scheduler reads ``last_tick_id`` through getattr onto its
    engine-tick and persist spans: with a dispatch ledger of its own per
    engine, the port's (its ledger's tick id) equals the JAX engine's on
    every span."""
    from kubeadmiral_tpu.runtime import trace as jax_trace
    from kubeadmiral_tpu_torch.runtime import trace as port_trace

    jax_trace.get_default().clear()
    port_trace.get_default().clear()
    pair = Pair(monkeypatch, 16)
    pair.each(lambda s: s.start_scheduler())
    for name in ("c1", "c2"):
        pair.each(lambda s: s.add_cluster(name))
    pair.create(policies, policy())
    for i in range(3):
        pair.create(source, make_deployment(name=f"web-{i}"))
        pair.settle()

    def ticks(tracer):
        return [
            (sp.name, sp.args.get("tick"), sp.args.get("units"))
            for sp in tracer.get_default().spans()
            if sp.name in ("scheduler.engine_tick", "scheduler.persist")
        ]

    got, want = ticks(port_trace), ticks(jax_trace)
    assert got == want and len(got) == 6
    assert [t for name, t, _ in got if name == "scheduler.persist"] == [1, 2, 3]


def test_store_digests_read_in_place_equal_a_dump():
    """``cpworld.store_digests`` reads the stores' version nodes in place
    and reuses a digest while an object's resourceVersion holds: after
    every round of a small world it equals digests of a full ``dump()``,
    with and without its cache."""
    import hashlib

    from kubeadmiral_tpu_torch.testing import cpworld

    def from_dump(fleet):
        dump = fleet.dump()
        out = {}
        for name, kube in [("host", dump["host"]), *dump["members"].items()]:
            out[name] = {
                "rv": kube["rv"],
                "objects": {
                    resource: {
                        key: hashlib.blake2b(
                            json.dumps(cpworld.masked(resource, obj), sort_keys=True).encode(),
                            digest_size=12,
                        ).hexdigest()
                        for key, obj in objs.items()
                    }
                    for resource, objs in kube["objects"].items()
                },
            }
        return out

    plane = cpworld.ControlPlane(engine=SchedulerEngine(device="cpu"))
    seen = []

    def check(name, report):
        want = from_dump(plane.fleet)
        assert report["digests"] == want, name
        assert cpworld.store_digests(plane.fleet) == want, name
        seen.append(name)

    cpworld.run_rounds(plane, objects=60, clusters=6, after_round=check)
    assert seen == list(cpworld.ROUNDS)
    assert plane.digest_cache


# -- testing/cpworld.py's seven rounds on both packages -----------------------

def point_cpworld_at_jax(mp, cpworld) -> None:
    """cpworld's globals from the port pointed at the JAX package's
    counterparts (the phase-1 launch counter stays the port's: the JAX
    engine launches none of the port's kernels)."""
    port_root, jax_root = "kubeadmiral_tpu_torch.", "kubeadmiral_tpu."
    for name, value in list(vars(cpworld).items()):
        if name == "phase1_mod":
            continue
        if isinstance(value, types.ModuleType):
            if value.__name__.startswith(port_root):
                mp.setattr(cpworld, name, importlib.import_module(
                    jax_root + value.__name__[len(port_root):]))
            continue
        module = getattr(value, "__module__", None)
        if (
            isinstance(module, str) and module.startswith(port_root)
            and module != cpworld.__name__ and hasattr(value, "__name__")
        ):
            jax_module = importlib.import_module(jax_root + module[len(port_root):])
            mp.setattr(cpworld, name, getattr(jax_module, value.__name__))


SMALL_WORLD = {"objects": 30, "clusters": 5, "followers": 12, "migrants": 4}


def seven_rounds(monkeypatch, package: str, depth: int) -> dict:
    """cpworld's rounds on one package at SMALL_WORLD: per round the
    fleet's masked dump, the monitors' gauges, the SLO recorder's image
    and the device-independent counts."""
    from kubeadmiral_tpu_torch.testing import cpworld

    out = {}
    with monkeypatch.context() as mp:
        jax_slo.reset_default()
        port_slo.reset_default()
        if package == "jax":
            point_cpworld_at_jax(mp, cpworld)
            mp.setenv("KT_PIPELINE_DEPTH", str(depth))
            engine = JaxEngine(
                mesh=None, devprof=JaxLedger(enabled=True),
                flight_recorder=JaxRecorder(max_ticks=8, max_bytes=256 << 20, topk=8,
                                            enabled=True),
            )
            slo_mod = jax_slo
        else:
            engine = SchedulerEngine(
                device="cpu", flight_recorder=FlightRecorder(), devprof=DispatchLedger()
            )
            engine.pipeline_depth = depth
            slo_mod = port_slo
        plane = cpworld.ControlPlane(engine=engine)
        assert plane.engine is engine
        assert type(plane.scheduler).__module__.startswith(
            "kubeadmiral_tpu_torch" if package == "port" else "kubeadmiral_tpu.")

        def after(name, report):
            out[name] = {
                "dump": masked_dump(plane.fleet),
                "gauges": plane.gauges(),
                "slo": slo_image(slo_mod),
                "counts": {k: report[k] for k in (
                    "engine_ticks", "store_objects", "status_objects", "member_objects",
                    "member_configmaps", "member_namespaces", "member_writes",
                    "member_ops", "dispatch_batches")},
            }

        reports = cpworld.run_rounds(plane, after_round=after, **SMALL_WORLD)
        for name, report in reports.items():
            out[name]["checked"] = {
                k: report.get(k) for k in (
                    "placed", "pairs", "moved", "members_changed", "followers",
                    "estimated_capacity", "estimated_capacity_held")
            }
            out[name]["controllers"] = report.get("controllers")
    return out


def test_seven_rounds_stores_equal(monkeypatch, depth):
    """The manager's controller set over ``testing/cpworld.py``'s seven
    rounds (join, cold, churn, no-op, topology, follow, migrate), once
    over the JAX package and its engine and once over the port's on the
    CPU: after every settle the host and member stores are equal object
    for object (status objects, policy statuses, ConfigMaps, Namespaces
    and Pods included), and so are the monitors' gauges, the SLO
    recorders and every round's checked counts."""
    want = seven_rounds(monkeypatch, "jax", depth)
    got = seven_rounds(monkeypatch, "port", depth)
    from kubeadmiral_tpu_torch.testing import cpworld

    assert list(got) == list(want) == list(cpworld.ROUNDS)
    for name in cpworld.ROUNDS:
        a, b = want[name], got[name]
        assert a["dump"] == b["dump"], (name, first_difference(a["dump"], b["dump"]))
        for key in ("gauges", "slo", "counts", "checked", "controllers"):
            assert a[key] == b[key], (name, key, a[key], b[key])
    migrate = got["migrate"]["checked"]
    assert migrate["estimated_capacity"] == SMALL_WORLD["migrants"]
    assert migrate["moved"] == SMALL_WORLD["migrants"]
    dump = got["migrate"]["dump"]
    assert any(kube["objects"].get("v1/pods") for kube in dump["members"].values())
    assert dump["host"]["objects"]["v1/namespaces"]
