"""The port's soak harness and shard replica against the JAX package's.

* ``testing/soakharness.py``: the same ``SoakSchedule`` (arrivals,
  churn, capacity drift, a flapping and a hard-down member behind
  ``FaultyKube``) through the JAX harness and the port's on its CPU
  engine gives the same ``fingerprint()``; with faults on, it equals the
  fault-free run's (faults touch only the write path).  The SLO windows
  and the freshness objective are cut as ``tests/test_soak_observatory.py``
  cuts them (JAX: ``KT_SLO_WINDOWS_S``, ``KT_SLO_FRESHNESS_S``; the
  port: ``slo.WINDOWS_S`` and the catalog's threshold).
* ``testing/shardreplica.py``: two replicas (``python -m
  kubeadmiral_tpu_torch.testing.shardreplica --shard-count 2
  --shard-index i --device cpu``) over a port farm's host apiserver,
  the parent joining the members: every object placed and propagated,
  the union of the replicas' placements equal to an unsharded world's
  (the same controllers in process over a ``ClusterFleet``), and each
  replica's reason-count hash equal to the hash of the unsharded
  world's reason counts of the keys it owns.
"""

import dataclasses
import json
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import pytest

from test_e2e_slice import make_node

from kubeadmiral_tpu.runtime import slo as jax_slo
from kubeadmiral_tpu.testing import soakharness as jax_soak
from kubeadmiral_tpu_torch.federation import shardmap
from kubeadmiral_tpu_torch.federation.clusterctl import (
    FEDERATED_CLUSTERS,
    JOINED,
    NODES,
    READY,
    FederatedClusterController,
    get_condition,
)
from kubeadmiral_tpu_torch.models.ftc import default_ftcs
from kubeadmiral_tpu_torch.models.policy import PROPAGATION_POLICIES
from kubeadmiral_tpu_torch.runtime import metric_catalog as port_catalog
from kubeadmiral_tpu_torch.runtime import slo as port_slo
from kubeadmiral_tpu_torch.runtime.flightrec import FlightRecorder
from kubeadmiral_tpu_torch.scheduler.engine import SchedulerEngine
from kubeadmiral_tpu_torch.testing import shardreplica
from kubeadmiral_tpu_torch.testing import soakharness as port_soak
from kubeadmiral_tpu_torch.testing.fakekube import ClusterFleet
from kubeadmiral_tpu_torch.testing.kwoklite import KwokLiteFarm
from kubeadmiral_tpu_torch.utils.hashing import stable_json_hash

ROOT = Path(__file__).resolve().parent.parent


def schedule(mod):
    return mod.SoakSchedule(
        rounds=5, arrivals_per_round=3, churn_per_round=2, members=3,
        drift_every=2, flap_window=(1, 4), down_window=(2, 4),
        flap_member_idx=1, down_member_idx=2,
    )


def soak_run(monkeypatch, package: str, faults: bool) -> dict:
    with monkeypatch.context() as mp:
        if package == "jax":
            mp.setenv("KT_SLO_FRESHNESS_S", "1.0")
            mp.setenv("KT_SLO_WINDOWS_S", "3,10")
            jax_slo.reset_default()
            h = jax_soak.SoakHarness(schedule(jax_soak))
        else:
            mp.setattr(port_slo, "WINDOWS_S", (3.0, 10.0))
            objectives = dict(port_catalog.SLO_OBJECTIVES)
            objectives["freshness"] = objectives["freshness"]._replace(threshold_s=1.0)
            mp.setattr(port_catalog, "SLO_OBJECTIVES", objectives)
            port_slo.reset_default()
            h = port_soak.SoakHarness(
                schedule(port_soak),
                engine=SchedulerEngine(device="cpu", flight_recorder=FlightRecorder()),
            )
        sched = h.schedule
        for r in range(sched.rounds):
            h.run_round(r, faults=faults)
        h.finish()
        out = h.fingerprint()
        out["windows"] = [(w["member"], w["kind"], w["round0"]) for w in h.windows]
        out["members"] = h.member_object_counts()
    jax_slo.reset_default()
    port_slo.reset_default()
    return out


def test_soak_schedule_is_jax_schedule():
    a, b = schedule(jax_soak), schedule(port_soak)
    for r in range(a.rounds):
        assert a.arrivals(r) == b.arrivals(r)
        assert a.churn(r) == b.churn(r)
        assert a.drift(r) == b.drift(r)
        assert a.fault_state(r) == b.fault_state(r)


def test_soak_fingerprint_equals_jax_with_faults(monkeypatch):
    want = soak_run(monkeypatch, "jax", faults=True)
    got = soak_run(monkeypatch, "port", faults=True)
    assert got["hash"] == want["hash"]
    assert got["placements"] == want["placements"]
    assert got["members"] == want["members"]
    assert got["windows"] == want["windows"] and got["windows"]
    assert got["objects"] == 15


def test_soak_fingerprint_fault_free_equals_faulted(monkeypatch):
    faulted = soak_run(monkeypatch, "port", faults=True)
    clean = soak_run(monkeypatch, "port", faults=False)
    assert clean["hash"] == faulted["hash"]
    assert not clean["windows"]


# -- the shard replica ------------------------------------------------------
SHARDS = 2
MEMBERS = 4
OBJECTS = 24


def replica_ftc():
    ftc = next(f for f in default_ftcs() if f.name == "deployments.apps")
    return dataclasses.replace(ftc, controllers=(
        ("kubeadmiral.io/global-scheduler",), ("kubeadmiral.io/overridepolicy-controller",)))


def deployment(i: int) -> dict:
    return {
        "apiVersion": "apps/v1", "kind": "Deployment",
        "metadata": {"name": f"web-{i:03d}", "namespace": "default",
                     "labels": {"kubeadmiral.io/propagation-policy-name": "pp"}},
        "spec": {"replicas": 1 + i % 7, "selector": {"matchLabels": {"app": f"web-{i}"}},
                 "template": {"metadata": {"labels": {"app": f"web-{i}"}}, "spec": {"containers": [
                     {"name": "c", "image": "nginx", "resources": {"requests": {"cpu": "100m"}}}]}}},
    }


def add_clusters(host, add_member, cluster_spec) -> None:
    for j in range(MEMBERS):
        name = f"m{j}"
        add_member(name).create(NODES, make_node("n1", str(8 + 4 * j), "64Gi"))
        host.create(FEDERATED_CLUSTERS, {
            "apiVersion": "core.kubeadmiral.io/v1alpha1", "kind": "FederatedCluster",
            "metadata": {"name": name}, "spec": cluster_spec(name)})


def add_objects(host) -> None:
    host.create(PROPAGATION_POLICIES, {
        "apiVersion": "core.kubeadmiral.io/v1alpha1", "kind": "PropagationPolicy",
        "metadata": {"name": "pp", "namespace": "default"},
        "spec": {"schedulingMode": "Divide"}})
    for i in range(OBJECTS):
        host.create("apps/v1/deployments", deployment(i))


def placements(host, resource) -> dict:
    out = {}
    for obj in host.list(resource):
        key = f"{obj['metadata']['namespace']}/{obj['metadata']['name']}"
        spec = obj.get("spec") or {}
        out[key] = {"placements": spec.get("placements", []), "overrides": spec.get("overrides", [])}
    return out


def unsharded_world() -> tuple[dict, dict]:
    """The replicas' controllers in process over a ClusterFleet: the
    placements and {key: reason counts}."""
    ftc = replica_ftc()
    fleet = ClusterFleet()
    with shardmap.scoped(shardmap.ShardMap(1, 0)):
        clusterctl = FederatedClusterController(fleet, api_resource_probe=["apps/v1/Deployment"])
        engine = SchedulerEngine(device="cpu", flight_recorder=FlightRecorder())
        named = shardreplica._build_controllers(fleet, ftc, engine)
    add_clusters(fleet.host, fleet.add_member, lambda name: {})
    for objects in (False, True):
        if objects:
            add_objects(fleet.host)
        for _ in range(200):
            progressed = False
            for ctl in [clusterctl, *(c for _, c in named)]:
                while ctl.worker.step():
                    progressed = True
            if not progressed:
                break
    reasons = {}
    for key in fleet.host.keys(ftc.federated.resource):
        record = engine.flightrec.lookup(key)
        if record is not None:
            reasons[key] = [int(n) for n in record.reason_counts]
    return placements(fleet.host, ftc.federated.resource), reasons


def read_line(proc, want_type=None, timeout=120.0) -> dict:
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        line = proc.stdout.readline()
        if not line:
            break
        line = line.strip()
        if line.startswith("{"):
            doc = json.loads(line)
            if want_type is None or doc.get("type") == want_type:
                return doc
    raise AssertionError(f"replica {proc.args} gave no {want_type or 'hello'} line")


def test_shard_replicas_union_equals_unsharded():
    want_placements, want_reasons = unsharded_world()
    ftc = replica_ftc()
    farm = KwokLiteFarm()
    procs = []
    try:
        with shardmap.scoped(shardmap.ShardMap(1, 0)):
            clusterctl = FederatedClusterController(
                farm.fleet, api_resource_probe=["apps/v1/Deployment"])
        for i in range(SHARDS):
            procs.append(subprocess.Popen(
                [sys.executable, "-m", "kubeadmiral_tpu_torch.testing.shardreplica",
                 "--host-url", farm.host_server.url, "--shard-count", str(SHARDS),
                 "--shard-index", str(i), "--device", "cpu"],
                cwd=ROOT, stdin=subprocess.PIPE, stdout=subprocess.PIPE,
                stderr=tempfile.TemporaryFile(), text=True))
        hellos = [read_line(p) for p in procs]
        assert [h["shard"] for h in hellos] == list(range(SHARDS))
        assert all(h["ok"] and h["leader"] for h in hellos)
        # The members join before any object exists, as in the
        # unsharded world: a placement made while a cluster was still
        # joining would be the starting point of the next.
        add_clusters(farm.host, farm.add_member, farm.cluster_spec)
        deadline = time.monotonic() + 60.0
        while not all(
            all((get_condition(o, c) or {}).get("status") == "True" for c in (JOINED, READY))
            for o in farm.host_store.list(FEDERATED_CLUSTERS)
        ):
            assert time.monotonic() < deadline, "the members did not join"
            if not clusterctl.worker.step():
                time.sleep(0.05)
        add_objects(farm.host)
        deadline = time.monotonic() + 120.0
        while True:
            assert time.monotonic() < deadline, "the replicas did not settle"
            while clusterctl.worker.step():
                pass
            for p in procs:
                p.stdin.write("report\n")
                p.stdin.flush()
            reports = [read_line(p, "report") for p in procs]
            got = placements(farm.host, ftc.federated.resource)
            feds = farm.host.list(ftc.federated.resource)
            done = len(feds) == OBJECTS and all(
                (o.get("status") or {}).get("clusters")
                and all(c["status"] == "OK" for c in o["status"]["clusters"]) for o in feds)
            if done and all(r["settled"] for r in reports):
                break
            time.sleep(0.1)
        assert got == want_placements
        assert sum(r["owned_keys"] for r in reports) == OBJECTS
        for r in reports:
            owned = {k: v for k, v in want_reasons.items()
                     if shardmap.ShardMap(SHARDS, r["shard"]).owns(k)}
            assert r["reasons_keys"] == len(owned)
            assert r["reasons_hash"] == stable_json_hash(owned)
    finally:
        for p in procs:
            try:
                p.stdin.close()
            except OSError:
                pass
        for p in procs:
            try:
                p.wait(timeout=15)
            except subprocess.TimeoutExpired:
                p.kill()
                p.wait()
        farm.close()


def test_replica_arguments():
    args = shardreplica.build_parser().parse_args(
        ["--host-url", "http://h", "--shard-count", "3", "--shard-index", "2"])
    assert (args.shard_count, args.shard_index, args.device, args.ftc) == (
        3, 2, "cuda", "deployments.apps")
    with pytest.raises(SystemExit):
        shardreplica.build_parser().parse_args([])
