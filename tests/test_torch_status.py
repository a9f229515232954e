"""The port's status, override and informer modules against the JAX package's.

The cases of ``tests/test_status.py`` (the ``StatusController``'s
collected fields and its skip cache, the ``StatusAggregator`` and the
Deployment, Job, Pod and single-cluster plugins),
``tests/test_override.py`` (cluster matching, ``parse_overrides`` and
the ``OverrideController``) and the informer cases of
``tests/test_runtime.py`` (``Informer`` and ``FederatedInformer``) run
twice: once as they are, over the JAX package, and once with the test
module's globals and the modules its cases import in their bodies
pointed at the port's (:func:`run_both`).  Every store a case creates is
recorded; after the two runs the stores are equal object for object,
with the events' wall-clock fields masked, and so are the gauges of any
``Metrics`` the case keeps.  No case is left out: these modules reach
neither the HTTP transport nor the manager.
"""

import importlib
import sys

import pytest

import test_override as OV
import test_runtime as RT
import test_status as ST
from test_torch_sync import (
    Stores,
    cpu_scheduler_controller,
    method_cases,
    point_at_port,
)

from kubeadmiral_tpu.runtime import slo as jax_slo
from kubeadmiral_tpu_torch.federation import schedulerctl as port_schedulerctl
from kubeadmiral_tpu_torch.runtime import slo as port_slo

# The modules the cases import inside their bodies.
LAZY = (
    "kubeadmiral_tpu.federation.common",
    "kubeadmiral_tpu.federation.statusctl",
    "kubeadmiral_tpu.federation.overridectl",
    "kubeadmiral_tpu.federation.automigration",
    "kubeadmiral_tpu.federation.schedulerctl",
    "kubeadmiral_tpu.models.ftc",
)


def _lazy_port(name: str):
    port = importlib.import_module("kubeadmiral_tpu_torch" + name[len("kubeadmiral_tpu"):])
    if port is port_schedulerctl:
        # The scheduler controller's default engine on the CPU.
        shim = type(port)(port.__name__)
        shim.__dict__.update(vars(port))
        shim.SchedulerController = cpu_scheduler_controller
        return shim
    return port


def point_lazy_imports(mp) -> None:
    """``import``/``from ... import`` of the LAZY modules inside a case
    body give the port's module (``sys.modules`` and the parent
    package's attribute)."""
    for name in LAZY:
        importlib.import_module(name)
        port = _lazy_port(name)
        mp.setitem(sys.modules, name, port)
        parent, _, leaf = name.rpartition(".")
        mp.setattr(sys.modules[parent], leaf, port)


def _gauges(obj):
    metrics = getattr(obj, "metrics", None)
    return dict(metrics.stores) if metrics is not None and hasattr(metrics, "stores") else None


def run_case(monkeypatch, modules, run, port: bool):
    """``run()`` over one package (the modules' globals and lazy imports
    pointed at the port's when ``port``); returns the dumps of the
    stores it made and what ``run()`` returned."""
    with monkeypatch.context() as mp:
        jax_slo.reset_default()
        port_slo.reset_default()
        if port:
            point_at_port(mp, *modules)
            point_lazy_imports(mp)
        stores = Stores(mp, *modules)
        out = run()
        return stores.dumps(), out


def run_both(monkeypatch, modules, run) -> list:
    """``run()`` over JAX, then over the port: the stores (and what
    ``run()`` returned) equal."""
    want, want_out = run_case(monkeypatch, modules, run, port=False)
    got, got_out = run_case(monkeypatch, modules, run, port=True)
    assert got == want
    assert got_out == want_out
    return got


def run_method(cls, name):
    """One case of a test class; returns the gauges of the ``Metrics``
    the case object keeps, if any."""

    def run():
        obj = cls()
        if hasattr(obj, "setup_method"):
            obj.setup_method()
        getattr(obj, name)()
        return _gauges(obj)

    return run


def case_ids(cases):
    return [f"{c.__module__}.{c.__name__}.{n}" for c, n in cases]


STATUS_CASES = method_cases(
    ST.TestStatusController, ST.TestWorkloadAggregation, ST.TestStatusAggregator,
    ST.TestJobAggregation, ST.TestPodAggregation, ST.TestSingleClusterAggregation,
)


@pytest.mark.parametrize("cls,name", STATUS_CASES, ids=case_ids(STATUS_CASES))
def test_status_case(monkeypatch, cls, name):
    stores = run_both(monkeypatch, (ST,), run_method(cls, name))
    if cls in (ST.TestStatusController, ST.TestStatusAggregator):
        assert stores  # the case made a fleet, compared above


OVERRIDE_CASES = method_cases(OV.TestClusterMatching, OV.TestParseOverrides, OV.TestOverrideController)


@pytest.mark.parametrize("cls,name", OVERRIDE_CASES, ids=case_ids(OVERRIDE_CASES))
def test_override_case(monkeypatch, cls, name):
    stores = run_both(monkeypatch, (OV,), run_method(cls, name))
    if cls is OV.TestOverrideController:
        assert stores


INFORMER_CASES = (
    "test_informer_cache_and_handlers",
    "test_federated_informer_multiplexes",
    "test_informer_close_detaches_watch",
)


@pytest.mark.parametrize("name", INFORMER_CASES)
def test_informer_case(monkeypatch, name):
    stores = run_both(monkeypatch, (RT,), getattr(RT, name))
    assert stores


def test_cases_reach_the_port():
    """After the swap the test modules' controllers and informers are
    the port's, and the overridectl module exports OVERRIDE_POLICIES as
    the JAX one does (``bench_e2e.py`` imports it from there)."""
    from kubeadmiral_tpu_torch.federation import overridectl, statusctl
    from kubeadmiral_tpu_torch.models import policy
    from kubeadmiral_tpu_torch.runtime import informer

    with pytest.MonkeyPatch.context() as mp:
        point_at_port(mp, ST, OV, RT)
        point_lazy_imports(mp)
        assert ST.StatusController is statusctl.StatusController
        assert OV.OverrideController is overridectl.OverrideController
        assert RT.Informer is informer.Informer
        from kubeadmiral_tpu.federation.statusctl import aggregate_job_status

        assert aggregate_job_status is statusctl.aggregate_job_status
    assert overridectl.OVERRIDE_POLICIES == policy.OVERRIDE_POLICIES
    assert statusctl.BULK_READS is True
