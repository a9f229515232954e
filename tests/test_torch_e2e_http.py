"""The control plane over the port's HTTP transport.

* The cases of ``tests/test_e2e_slice.py`` over the port's kwok-lite
  farm, as ``tests/test_e2e_http.py`` runs them for the JAX package
  (``TestEndToEndSliceHTTP``, ``TestMultiKindPropagationHTTP``), the
  four flows of ``tests/test_e2e_http_flows.py`` (join, status and
  unjoin; an unreachable member; stuck pods and auto-migration; a
  profile switch), the 12-member fan-out of
  ``tests/test_e2e_http_scale.py`` and the subprocess farm of
  ``tests/test_kwok_subprocess.py`` (members as
  ``python -m kubeadmiral_tpu_torch.testing.kwokserver`` processes):
  each with the test module's globals and the modules its cases import
  pointed at the port's, the scheduler on the CPU engine.
* The HTTP ``Pair``: ``testing/cpworld.py``'s world at HTTP_WORLD
  through its six HTTP rounds (join, cold, churn, no-op resync,
  topology, partition) over the port's farm and CPU engine, over the
  JAX package's farm and engine (cpworld's globals pointed at the JAX
  package) and over the port's in-memory ``ClusterFleet``: after every
  round the three worlds' store digests, host and members, are equal
  under ``cpworld.transport_masked`` (``cpworld.TRANSPORT_ONLY`` left
  out), and the rounds' checked counts equal.
"""

import pytest

import test_e2e_http as EH
import test_e2e_http_flows as FL
import test_e2e_http_scale as SC
import test_e2e_slice as E2E
import test_kwok_subprocess as KS
from test_torch_controlplane import point_cpworld_at_jax
from test_torch_sync import method_cases, point_at_port
from test_torch_transport import case_ids, point_lazy, run_on_port

from kubeadmiral_tpu.runtime import slo as jax_slo
from kubeadmiral_tpu.runtime.devprof import DispatchLedger as JaxLedger
from kubeadmiral_tpu.runtime.flightrec import FlightRecorder as JaxRecorder
from kubeadmiral_tpu.scheduler.engine import SchedulerEngine as JaxEngine
from kubeadmiral_tpu.testing.kwoklite import KwokLiteFarm as JaxFarm
from kubeadmiral_tpu_torch.runtime import slo as port_slo
from kubeadmiral_tpu_torch.runtime.flightrec import FlightRecorder
from kubeadmiral_tpu_torch.scheduler.engine import SchedulerEngine
from kubeadmiral_tpu_torch.testing.kwoklite import KwokLiteFarm

# The HTTP classes inherit their cases from test_e2e_slice's.
SLICE_CASES = [
    (cls, name)
    for cls in (EH.TestEndToEndSliceHTTP, EH.TestMultiKindPropagationHTTP)
    for name in sorted(dir(cls)) if name.startswith("test_")
]


@pytest.mark.parametrize("cls,name", SLICE_CASES, ids=case_ids(SLICE_CASES))
def test_slice_case(monkeypatch, cls, name):
    run_on_port(monkeypatch, EH, cls, name, extra=(E2E,))


FLOW_CASES = method_cases(
    FL.TestClusterLifecycleHTTP, FL.TestAutoMigrationHTTP, FL.TestSchedulingProfileHTTP
)


@pytest.mark.parametrize("cls,name", FLOW_CASES, ids=case_ids(FLOW_CASES))
def test_flow_case(monkeypatch, cls, name):
    run_on_port(monkeypatch, FL, cls, name, extra=(E2E, SC))


@pytest.mark.parametrize(
    "module,name",
    [(SC, "test_wide_fanout_over_http"), (KS, "test_subprocess_members_propagate_and_collect")],
    ids=["wide_fanout_12_members", "subprocess_farm"],
)
def test_farm_case(monkeypatch, module, name):
    with monkeypatch.context() as mp:
        jax_slo.reset_default()
        port_slo.reset_default()
        point_at_port(mp, module, E2E)
        point_lazy(mp)
        assert module.KwokLiteFarm is KwokLiteFarm
        getattr(module, name)()


# The HTTP Pair's world: objects x clusters.
HTTP_WORLD = (60, 4)
CHECKED = ("placed", "pairs", "moved", "members_changed", "churned", "engine_ticks")


def http_rounds(monkeypatch, world: str) -> dict:
    """cpworld's HTTP rounds on one world ("port", "jax": over the
    package's farm; "memory": the port's ClusterFleet): per round the
    transport-masked digests and the checked counts."""
    from kubeadmiral_tpu_torch.testing import cpworld

    with monkeypatch.context() as mp:
        jax_slo.reset_default()
        port_slo.reset_default()
        farm = None
        if world == "jax":
            point_cpworld_at_jax(mp, cpworld)
            # The JAX client's watch streams do not report how far they
            # have delivered: its settles rest on a longer idle window.
            mp.setattr(cpworld, "GRACE_POLLS", 40)
            farm = JaxFarm()
            engine = JaxEngine(mesh=None, devprof=JaxLedger(enabled=True),
                               flight_recorder=JaxRecorder(enabled=True))
        else:
            if world == "port":
                farm = KwokLiteFarm()
            engine = SchedulerEngine(device="cpu", flight_recorder=FlightRecorder())
        try:
            plane = cpworld.ControlPlane(engine=engine, farm=farm, transport_masks=True)
            assert type(plane.manager).__module__.startswith(
                "kubeadmiral_tpu." if world == "jax" else "kubeadmiral_tpu_torch.")
            reports = cpworld.run_rounds(plane, *HTTP_WORLD, rounds=cpworld.HTTP_ROUNDS)
        finally:
            if farm is not None:
                farm.close()
    return {
        name: {"digests": r["digests"], "checked": {k: r.get(k) for k in CHECKED},
               "fault": r.get("fault")}
        for name, r in reports.items()
    }


def test_http_pair_stores_equal(monkeypatch):
    """The port over sockets, the JAX package over sockets and the
    port in memory: equal stores after each of the six rounds."""
    from kubeadmiral_tpu_torch.testing import cpworld

    port = http_rounds(monkeypatch, "port")
    jax = http_rounds(monkeypatch, "jax")
    memory = http_rounds(monkeypatch, "memory")
    assert list(port) == list(jax) == list(memory) == list(cpworld.HTTP_ROUNDS)
    for name in cpworld.HTTP_ROUNDS:
        assert cpworld.digest_diff(port[name]["digests"], jax[name]["digests"]) == [], name
        assert cpworld.digest_diff(port[name]["digests"], memory[name]["digests"]) == [], name
        checked = {k: v for k, v in port[name]["checked"].items() if k != "engine_ticks"}
        assert checked == {k: v for k, v in memory[name]["checked"].items() if k != "engine_ticks"}
    fault = port["partition"]["fault"]
    assert fault["sheds"] + fault["retries"] > 0, fault
    assert jax["partition"]["fault"]["sheds"] + jax["partition"]["fault"]["retries"] > 0
    assert memory["partition"]["fault"] == {
        "member": fault["member"], "breaker_opens": 0, "sheds": 0, "retries": 0}
    # The transport's own objects are in the HTTP worlds' stores and left
    # out of the digests.
    assert not any(
        cpworld.transport_only(store, resource, key)
        for store, d in port["cold"]["digests"].items()
        for resource, keys in d["objects"].items() for key in keys
    )
