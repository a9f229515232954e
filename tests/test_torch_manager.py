"""The port's controller manager against the JAX package's.

* Every case of ``tests/test_manager.py`` (the FTC round trip, the
  health registry and server, leader election, the manager's FTC
  lifecycle — start, stop, restart on a spec change, watch detach — and
  the ``--controllers`` semantics) runs twice: over the JAX package as
  it is, and with the test module's globals pointed at the port's
  (``test_torch_sync.point_at_port``; the manager's default engine is
  the port's CPU engine there, as the card's engine needs CUDA).  Every
  store a case creates is equal between the two runs.
* A ``Pair``: a JAX ``ControllerManager`` over a JAX engine on the CPU
  and the port's over ``SchedulerEngine(device="cpu")``, each with a
  dispatch ledger of its own, driven by ``settle()`` through an FTC
  install, creates, a 1 % churn, a member join, an FTC spec change and
  an FTC delete, at pipeline depth 1 and 16: the masked stores are
  equal after every settle, and so are the ``shutdown()`` summaries,
  whose final snapshot the port writes under ``snapshot_dir=`` and JAX
  under ``KT_SNAPSHOT_DIR``.
"""

import importlib
import os

import pytest

import test_manager as TM
from test_e2e_slice import make_deployment, make_node
from test_torch_controlplane import first_difference, masked_dump
from test_torch_status import run_both, run_method
from test_torch_sync import method_cases

from kubeadmiral_tpu.runtime import slo as jax_slo
from kubeadmiral_tpu.runtime.devprof import DispatchLedger as JaxLedger
from kubeadmiral_tpu.scheduler.engine import SchedulerEngine as JaxEngine
from kubeadmiral_tpu_torch.runtime import manager as port_manager
from kubeadmiral_tpu_torch.runtime import slo as port_slo
from kubeadmiral_tpu_torch.runtime.devprof import DispatchLedger
from kubeadmiral_tpu_torch.runtime.metrics import Metrics
from kubeadmiral_tpu_torch.scheduler.engine import SchedulerEngine


class CpuControllerManager(port_manager.ControllerManager):
    """The port's manager with its default engine on the CPU."""

    def __init__(self, fleet, *, engine=None, metrics=None, **kw):
        metrics = metrics or Metrics()
        if engine is None:
            engine = SchedulerEngine(device="cpu", metrics=metrics)
        super().__init__(fleet, engine=engine, metrics=metrics, **kw)


def run_manager_case(cls, name):
    run = run_method(cls, name)

    def both(monkeypatch):
        def with_cpu_manager():
            # Swapped and put back here, inside run_both's context: a
            # setattr on the test's own monkeypatch would be undone after
            # that context, putting back the port's class it saw, and
            # leave it in test_manager for the tests that run later.
            if TM.ControllerManager is not port_manager.ControllerManager:
                return run()
            TM.ControllerManager = CpuControllerManager
            try:
                return run()
            finally:
                TM.ControllerManager = port_manager.ControllerManager

        return run_both(monkeypatch, (TM,), with_cpu_manager)

    return both


MANAGER_CASES = method_cases(
    TM.TestFTCRoundTrip, TM.TestHealthCheck, TM.TestLeaderElection, TM.TestControllerManager
)


@pytest.mark.parametrize(
    "cls,name", MANAGER_CASES, ids=[f"{c.__name__}.{n}" for c, n in MANAGER_CASES]
)
def test_manager_case(monkeypatch, cls, name):
    stores = run_manager_case(cls, name)(monkeypatch)
    if cls is TM.TestControllerManager and name != "test_controllers_flag_semantics":
        assert stores  # the case made a fleet, compared above


# -- a manager pair over one world ---------------------------------------------

GVK = "apps/v1/Deployment"
OBJECTS = 100
CLUSTERS = ("c1", "c2", "c3")


class Side:
    """One package's fleet and manager."""

    def __init__(self, root: str, engine, snapshot_dir: str, monkeypatch):
        def mod(name):
            return importlib.import_module(f"{root}.{name}")

        self.fk = mod("testing.fakekube")
        self.ftc = mod("models.ftc")
        self.policy = mod("models.policy")
        self.clusterctl = mod("federation.clusterctl")
        self.fleet = self.fk.ClusterFleet()
        self.host = self.fleet.host
        kw = {}
        if root == "kubeadmiral_tpu_torch":
            kw["snapshot_dir"] = snapshot_dir
        else:
            monkeypatch.setenv("KT_SNAPSHOT_DIR", snapshot_dir)
        self.manager = mod("runtime.manager").ControllerManager(
            self.fleet,
            engine=engine,
            cluster_controller_kwargs={"api_resource_probe": [GVK], "clock": lambda: 0.0},
            **kw,
        )
        monkeypatch.delenv("KT_SNAPSHOT_DIR", raising=False)
        self.engine = engine

    def ftc_object(self, name: str) -> dict:
        ftc = next(f for f in self.ftc.default_ftcs() if f.name == name)
        return self.ftc.ftc_to_object(ftc)

    def add_cluster(self, name: str) -> None:
        member = self.fleet.add_member(name)
        member.create(self.clusterctl.NODES, make_node("n1", "64", "128Gi"))
        self.host.create(
            self.clusterctl.FEDERATED_CLUSTERS,
            {
                "apiVersion": "core.kubeadmiral.io/v1alpha1",
                "kind": "FederatedCluster",
                "metadata": {"name": name},
                "spec": {},
            },
        )


class Pair:
    def __init__(self, monkeypatch, tmp_path, depth: int):
        monkeypatch.setenv("KT_PIPELINE_DEPTH", str(depth))
        jax_slo.reset_default()
        port_slo.reset_default()
        ref = JaxEngine(mesh=None, flight_recorder=None, devprof=JaxLedger(enabled=True))
        port = SchedulerEngine(device="cpu", flight_recorder=None, devprof=DispatchLedger())
        port.pipeline_depth = depth
        self.dirs = (str(tmp_path / "jax"), str(tmp_path / "port"))
        self.jax = Side("kubeadmiral_tpu", ref, self.dirs[0], monkeypatch)
        self.port = Side("kubeadmiral_tpu_torch", port, self.dirs[1], monkeypatch)
        self.sides = (self.jax, self.port)

    def each(self, fn) -> list:
        return [fn(s) for s in self.sides]

    def settle(self) -> None:
        self.each(lambda s: s.manager.settle())
        a, b = masked_dump(self.jax.fleet), masked_dump(self.port.fleet)
        assert a == b, first_difference(a, b)
        assert self.port.engine.tick_seq == self.jax.engine.tick_seq
        assert self.port.engine.last_tick_id == self.jax.engine.last_tick_id
        assert sorted(self.port.manager._ftcs) == sorted(self.jax.manager._ftcs)
        assert {
            name: sorted(rt.controllers) for name, rt in self.port.manager._ftcs.items()
        } == {name: sorted(rt.controllers) for name, rt in self.jax.manager._ftcs.items()}
        assert self.port.manager.health.readyz() == self.jax.manager.health.readyz()


@pytest.mark.parametrize("depth", [1, 16], ids=["depth1", "depth16"])
def test_manager_pair_stores_equal(monkeypatch, tmp_path, depth):
    pair = Pair(monkeypatch, tmp_path, depth)
    for name in CLUSTERS:
        pair.each(lambda s: s.add_cluster(name))
    pair.settle()
    # FTC install: the manager's watch starts the controller set.
    pair.each(lambda s: s.host.create(s.ftc.FEDERATED_TYPE_CONFIGS, s.ftc_object("deployments.apps")))
    pair.each(lambda s: s.host.create(
        s.policy.PROPAGATION_POLICIES,
        {
            "apiVersion": "core.kubeadmiral.io/v1alpha1",
            "kind": "PropagationPolicy",
            "metadata": {"name": "pp", "namespace": "default"},
            "spec": {"schedulingMode": "Divide"},
        },
    ))
    pair.settle()
    assert "deployments.apps/scheduler" in pair.port.manager.health.readyz()
    # Creates.
    for i in range(OBJECTS):
        dep = make_deployment(name=f"web-{i:03d}", replicas=(i % 7) + 1)
        pair.each(lambda s: s.host.create("apps/v1/deployments", dict(dep)))
    pair.settle()
    assert pair.port.engine.tick_seq >= 1
    # 1 % churn.
    for s in pair.sides:
        obj = s.host.get("apps/v1/deployments", "default/web-007")
        obj["spec"]["replicas"] = 40
        s.host.update("apps/v1/deployments", obj)
    pair.settle()
    # A member joins.
    pair.each(lambda s: s.add_cluster("c4"))
    pair.settle()
    # An FTC spec change restarts the set.
    for s in pair.sides:
        obj = s.host.get(s.ftc.FEDERATED_TYPE_CONFIGS, "deployments.apps")
        obj["spec"]["statusAggregation"] = None
        s.host.update(s.ftc.FEDERATED_TYPE_CONFIGS, obj)
    pair.settle()
    assert "statusaggregator" not in pair.port.manager._ftcs["deployments.apps"].controllers
    # An FTC delete stops it.
    pair.each(lambda s: s.host.delete(s.ftc.FEDERATED_TYPE_CONFIGS, "deployments.apps"))
    pair.settle()
    assert not pair.port.manager._ftcs

    summaries = pair.each(lambda s: s.manager.shutdown())
    jax_sum, port_sum = summaries
    assert port_sum["shed_writes"] == jax_sum["shed_writes"] == 0
    assert set(port_sum) == set(jax_sum)
    # The final snapshot: one file each, of the same tick, in each
    # package's own directory.
    for summary, directory in zip(summaries, pair.dirs):
        assert summary["snapshot"] is not None
        assert os.path.dirname(summary["snapshot"]) == directory
    assert os.path.basename(port_sum["snapshot"]) == os.path.basename(jax_sum["snapshot"])
    assert pair.port.manager.snapshots.last_result == pair.jax.manager.snapshots.last_result


def test_port_manager_snapshot_dir_is_an_argument(tmp_path):
    """No snapshot_dir: no snapshots; the JAX constructor's parameters
    and defaults, plus ``snapshot_dir``."""
    import inspect

    from kubeadmiral_tpu.runtime.manager import ControllerManager as JaxManager

    mine = inspect.signature(port_manager.ControllerManager.__init__).parameters
    theirs = inspect.signature(JaxManager.__init__).parameters
    assert [(p.name, p.default) for p in mine.values()][: len(theirs)] == [
        (p.name, p.default) for p in theirs.values()
    ]
    assert list(mine)[len(theirs):] == ["snapshot_dir"] and mine["snapshot_dir"].default is None
    fk = importlib.import_module("kubeadmiral_tpu_torch.testing.fakekube")
    manager = CpuControllerManager(fk.ClusterFleet())
    assert manager.snapshots is None
    manager = CpuControllerManager(fk.ClusterFleet(), snapshot_dir=str(tmp_path))
    assert manager.snapshots.store.dir == str(tmp_path)
    assert inspect.signature(port_manager.ControllerManager.shutdown).parameters[
        "deadline_s"
    ].default == 10
