"""The port's sync controller and its helpers against the JAX package's.

The cases of ``tests/test_sync.py`` (field retention, the
``FederatedResource`` view, the ``SyncController``'s propagation,
version skip, migration, deletion cascade, orphaning, adoption,
unready clusters, pending controllers, and ConfigMap drift repair) and
of ``tests/test_history.py`` (the ``RevisionManager`` and its wiring
through sync in the end-to-end slice) run twice: once as they are, over
the JAX package, and once with the test module's globals pointed at the
port's modules and classes (:func:`point_at_port`).  Every store a case
creates is recorded (:class:`Stores`); after the two runs the stores
are equal object for object, with the events' wall-clock fields masked
(``cpworld.WALL_CLOCK_FIELDS``).  The end-to-end wiring case runs the
port's scheduler over ``SchedulerEngine(device="cpu")``.
"""

import importlib
import types

import pytest

import test_e2e_slice as E2E
import test_history as HI
import test_sync as SY

from kubeadmiral_tpu.runtime import slo as jax_slo
from kubeadmiral_tpu.testing import fakekube as jax_fk
from kubeadmiral_tpu_torch.federation import schedulerctl as port_schedulerctl
from kubeadmiral_tpu_torch.runtime import slo as port_slo
from kubeadmiral_tpu_torch.scheduler.engine import SchedulerEngine
from kubeadmiral_tpu_torch.testing import fakekube as port_fk
from kubeadmiral_tpu_torch.testing.cpworld import WALL_CLOCK_FIELDS

JAX_ROOT, PORT_ROOT = "kubeadmiral_tpu", "kubeadmiral_tpu_torch"


def _port_module(name: str):
    return importlib.import_module(PORT_ROOT + name[len(JAX_ROOT):])


def port_counterpart(value):
    """The port's module or object for a JAX package module, class or
    function (by module path and name); None for anything else."""
    if isinstance(value, types.ModuleType):
        name = value.__name__
        return _port_module(name) if name.startswith(JAX_ROOT + ".") else None
    module = getattr(value, "__module__", None)
    if isinstance(module, str) and module.startswith(JAX_ROOT + ".") and hasattr(value, "__name__"):
        return getattr(_port_module(module), value.__name__)
    return None


def cpu_scheduler_controller(host, ftc, engine=None, **kw):
    """The port's SchedulerController, its default engine on the CPU."""
    if engine is None:
        engine = SchedulerEngine(device="cpu")
    return port_schedulerctl.SchedulerController(host, ftc, engine=engine, **kw)


def point_at_port(monkeypatch, *modules, absent=()) -> None:
    """Every global of ``modules`` that comes from the JAX package
    replaced by the port's counterpart, but the names in ``absent``
    (parts not ported, which the cases run do not reach); the scheduler
    controller's default engine is the port's CPU engine."""
    for module in modules:
        for name, value in list(vars(module).items()):
            if name in absent:
                continue
            port = port_counterpart(value)
            if port is None:
                continue
            if port is port_schedulerctl.SchedulerController:
                port = cpu_scheduler_controller
            monkeypatch.setattr(module, name, port)


class Stores:
    """Records every ``ClusterFleet`` and ``FakeKube`` the given test
    modules create (their globals wrapped), for :meth:`dumps`."""

    def __init__(self, monkeypatch, *modules):
        self.seen = []
        for module in modules:
            for name in ("ClusterFleet", "FakeKube"):
                cls = vars(module).get(name)
                if isinstance(cls, type):
                    monkeypatch.setattr(module, name, self._recording(cls))

    def _recording(self, cls):
        seen = self.seen

        class Recorded(cls):
            def __init__(self, *a, **k):
                super().__init__(*a, **k)
                seen.append(self)

        Recorded.__name__ = Recorded.__qualname__ = cls.__name__
        return Recorded

    def dumps(self) -> list:
        out = []
        for store in self.seen:
            kubes = (
                [store.host, *store.members.values()] if hasattr(store, "members") else [store]
            )
            out.append([masked_dump(kube) for kube in kubes])
        return out


def masked_dump(kube) -> dict:
    dump = kube.dump()
    for resource, fields in WALL_CLOCK_FIELDS.items():
        for obj in dump["objects"].get(resource, {}).values():
            for field in fields:
                obj.pop(field, None)
    return dump


def run_case(monkeypatch, modules, run, port: bool) -> list:
    """``run()`` over one package (the modules' globals pointed at the
    port's when ``port``); returns the dumps of the stores it made."""
    with monkeypatch.context() as mp:
        jax_slo.reset_default()
        port_slo.reset_default()
        if port:
            point_at_port(mp, *modules)
        stores = Stores(mp, *modules)
        run()
        return stores.dumps()


def run_both(monkeypatch, modules, run) -> list:
    """``run()`` over JAX, then over the port: the stores equal."""
    want = run_case(monkeypatch, modules, run, port=False)
    got = run_case(monkeypatch, modules, run, port=True)
    assert got == want
    return got


def method_cases(*classes):
    return [
        (cls, name) for cls in classes for name in sorted(vars(cls)) if name.startswith("test_")
    ]


def run_method(cls, name):
    def run():
        obj = cls()
        if hasattr(obj, "setup_method"):
            obj.setup_method()
        getattr(obj, name)()

    return run


SYNC_CASES = method_cases(
    SY.TestRetention, SY.TestFederatedResource, SY.TestSyncController, SY.TestConfigMapDrift
)


@pytest.mark.parametrize("cls,name", SYNC_CASES, ids=[f"{c.__name__}.{n}" for c, n in SYNC_CASES])
def test_sync_case(monkeypatch, cls, name):
    stores = run_both(monkeypatch, (SY,), run_method(cls, name))
    if cls in (SY.TestSyncController, SY.TestConfigMapDrift):
        assert stores  # the case made a fleet, compared above


HISTORY_CASES = method_cases(HI.TestRevisionManager, HI.TestSyncRevisionWiring)


@pytest.mark.parametrize(
    "cls,name", HISTORY_CASES, ids=[f"{c.__name__}.{n}" for c, n in HISTORY_CASES]
)
def test_history_case(monkeypatch, cls, name):
    stores = run_both(monkeypatch, (HI, E2E), run_method(cls, name))
    assert stores


def test_point_at_port_covers_the_test_modules():
    """Every JAX-package global of the test modules has a port
    counterpart (a missing one would raise in ``point_at_port``), and
    the stores the cases create are the port's after the swap."""
    for module in (SY, HI, E2E):
        for value in vars(module).values():
            port = port_counterpart(value)
            if port is not None:
                assert getattr(port, "__module__", getattr(port, "__name__", "")).startswith(PORT_ROOT)
    assert port_counterpart(jax_fk.ClusterFleet) is port_fk.ClusterFleet
