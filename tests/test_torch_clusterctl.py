"""The port's FederatedCluster controller against the JAX package's.

The cases of ``tests/test_clusterctl.py`` (resource aggregation, join,
ownership conflict, heartbeat, unhealthy and unreachable members,
removal, the join timeout) run unchanged over each package's modules —
the JAX test module's globals are pointed at the port's — and each
join/heartbeat case, run once per package, leaves the two fleets'
stores (host and members) equal object for object.  The sync
controller's finalizer case needs ``federation/sync.py``, which the
port does not have yet.
"""

import pytest

import test_clusterctl as CC

from kubeadmiral_tpu.federation import clusterctl as jax_ctl
from kubeadmiral_tpu.testing import fakekube as jax_fk
from kubeadmiral_tpu_torch.federation import clusterctl as ctl
from kubeadmiral_tpu_torch.federation import common as port_common
from kubeadmiral_tpu_torch.testing import fakekube as fk

NAMES = (
    "CLUSTER_UID_ANNOTATION", "FED_SYSTEM_NAMESPACE", "FEDERATED_CLUSTERS",
    "FederatedClusterController", "JOINED", "NAMESPACES", "NODES", "OFFLINE",
    "PODS", "READY", "SECRETS", "aggregate_resources", "get_condition",
    "pod_resource_requests",
)

AGGREGATION = ("test_sums_schedulable_nodes_only",
               "test_available_subtracts_running_pod_requests",
               "test_init_container_max_semantics")
HEARTBEAT = ("test_join_creates_member_artifacts",
             "test_unjoinable_when_owned_by_other_control_plane",
             "test_heartbeat_collects_resources",
             "test_unhealthy_member_goes_not_ready",
             "test_unreachable_member_goes_offline",
             "test_removal_cleans_member_and_releases")


def point_at(monkeypatch, package: str) -> None:
    """The JAX test module's globals pointed at one package."""
    if package == "port":
        for name in NAMES:
            monkeypatch.setattr(CC, name, getattr(ctl, name))
        monkeypatch.setattr(CC, "ClusterFleet", fk.ClusterFleet)
        monkeypatch.setattr(CC, "C", port_common)
    want = ctl if package == "port" else jax_ctl
    assert CC.FederatedClusterController is want.FederatedClusterController


@pytest.mark.parametrize("package", ("jax", "port"))
@pytest.mark.parametrize("case", AGGREGATION)
def test_aggregation_case(monkeypatch, package, case):
    point_at(monkeypatch, package)
    getattr(CC.TestAggregation(), case)()


@pytest.mark.parametrize("case", HEARTBEAT)
def test_join_and_heartbeat_case_same_store(monkeypatch, case):
    dumps = {}
    for package in ("jax", "port"):
        with monkeypatch.context() as m:
            point_at(m, package)
            inst = CC.TestJoinAndHeartbeat()
            inst.setup_method()
            getattr(inst, case)()
            dumps[package] = inst.fleet.dump()
    assert dumps["port"] == dumps["jax"]
    assert dumps["port"]["host"]["objects"]


@pytest.mark.parametrize("package", ("jax", "port"))
def test_join_timeout_case(monkeypatch, package):
    point_at(monkeypatch, package)
    CC.TestJoinTimeout().test_join_failure_becomes_terminal_after_timeout()


def test_breaker_open_member_goes_not_ready_on_both():
    """A member whose breaker trips (the read/write path failing while
    healthz answers) turns Ready=False with the breaker reason, and the
    store matches JAX's."""
    dumps = {}
    for mod, kube in ((jax_ctl, jax_fk), (ctl, fk)):
        fleet = kube.ClusterFleet()
        fleet.add_member("c1").create(mod.NODES, CC.make_node("n1"))
        controller = mod.FederatedClusterController(
            fleet, api_resource_probe=["apps/v1/Deployment"], clock=lambda: 0.0
        )
        fleet.host.create(mod.FEDERATED_CLUSTERS, CC.make_cluster_obj("c1"))
        controller.run_until_idle()
        b = controller.breakers.for_member("c1")
        for _ in range(controller.breakers.config.failure_threshold):
            b.record_failure()
        controller.worker.enqueue("c1")
        controller.run_until_idle()
        cluster = fleet.host.get(mod.FEDERATED_CLUSTERS, "c1")
        ready = mod.get_condition(cluster, mod.READY)
        assert (ready["status"], ready["reason"]) == ("False", mod.MEMBER_BREAKER_OPEN)
        dumps[mod.__name__.split(".")[0]] = fleet.dump()
    assert dumps["kubeadmiral_tpu_torch"] == dumps["kubeadmiral_tpu"]
