"""The port's member-write dispatch and breaker accounting against the
JAX package's.

* The cases of ``tests/test_write_coalesce.py`` but its HTTP class
  (``TestBulkReadsHttp`` needs the HTTP transport, not ported): the
  coalescing window's chunking, order, per-object mode, partial-failure
  retry, mid-batch deadline, an open breaker mid-flush, the
  ``BatchSink``'s shed and telemetry, the coalescing A/B through the
  sync controller, admission and the watch-boundary trigger filters.
  Each runs over JAX and over the port (the test module's globals and
  lazy imports pointed at the port's); where the JAX case sets a
  ``KT_*`` variable, the port's run sets the module constant that took
  its place (:data:`ENV_CONSTANTS`).  Every store the case makes is
  equal between the runs, but in the three cases whose stores depend on
  timing (the deadline, and several bulk requests in flight).
* The breaker registry's accounting (failures, stalls, slow successes,
  ``note_ok``, sheds, retries, write latencies, batches) and its durable
  state: ``export_state()`` equals JAX's for the same history under an
  injected clock, and ``restore_state`` resumes the same states.
"""

import sys
import types

import pytest

import test_write_coalesce as WC
from test_torch_sync import Stores, cpu_scheduler_controller, method_cases, point_at_port

from kubeadmiral_tpu.runtime import slo as jax_slo
from kubeadmiral_tpu.transport import breaker as jax_breaker
from kubeadmiral_tpu_torch.federation import dispatch, federate, schedulerctl, sync
from kubeadmiral_tpu_torch.models import ftc as port_ftc
from kubeadmiral_tpu_torch.runtime import slo as port_slo
from kubeadmiral_tpu_torch.runtime import worker
from kubeadmiral_tpu_torch.transport import breaker


def _flag(value: str) -> bool:
    return value not in ("0", "false", "no")


# The JAX knobs these cases set, and the port's constants in their place.
ENV_CONSTANTS = {
    "KT_MEMBER_BATCH": (dispatch, "MEMBER_BATCH", int),
    "KT_MEMBER_INFLIGHT": (dispatch, "MEMBER_INFLIGHT", int),
    "KT_WRITE_COALESCE": (dispatch, "WRITE_COALESCE", _flag),
    "KT_RETRY_BASE_S": (dispatch, "RETRY_BASE_S", float),
    "KT_RETRY_MAX": (dispatch, "RETRY_MAX", int),
    "KT_ADMIT_DEPTH": (worker, "ADMIT_DEPTH", int),
    "KT_ADMIT_DELAY_MS": (worker, "ADMIT_DELAY_MS", float),
    "KT_ADMIT_BATCH": (worker, "ADMIT_BATCH", int),
}


class ConstantsPatch:
    """A ``monkeypatch`` whose ``setenv`` of a JAX knob sets the port's
    constant instead (``constants``: knob -> (module, name, convert))."""

    def __init__(self, mp, constants=None):
        self._mp = mp
        self._constants = ENV_CONSTANTS if constants is None else constants

    def setenv(self, name, value, prepend=None):
        module, attr, convert = self._constants[name]
        self._mp.setattr(module, attr, convert(value))

    def __getattr__(self, item):
        return getattr(self._mp, item)


def _lazy_modules():
    """The modules the cases import inside their bodies, as the port's
    (the scheduler controller's default engine on the CPU)."""
    shim = types.ModuleType(schedulerctl.__name__)
    shim.__dict__.update(vars(schedulerctl))
    shim.SchedulerController = cpu_scheduler_controller
    return {
        "kubeadmiral_tpu.federation.sync": sync,
        "kubeadmiral_tpu.federation.federate": federate,
        "kubeadmiral_tpu.federation.schedulerctl": shim,
        "kubeadmiral_tpu.models.ftc": port_ftc,
    }


def run_case(monkeypatch, cls, name, port: bool) -> list:
    with monkeypatch.context() as mp:
        jax_slo.reset_default()
        port_slo.reset_default()
        obj = cls()
        method = getattr(obj, name)
        if port:
            point_at_port(mp, WC)
            for mod_name, module in _lazy_modules().items():
                mp.setitem(sys.modules, mod_name, module)
        stores = Stores(mp, WC)
        if "monkeypatch" in method.__code__.co_varnames[: method.__code__.co_argcount]:
            method(ConstantsPatch(mp) if port else mp)
        else:
            method()
        return stores.dumps()


CASES = method_cases(
    WC.TestRunMemberBatches, WC.TestBatchSinkCoalesce, WC.TestCoalesceAB,
    WC.TestAdmission, WC.TestEventSigFilters,
)
# Cases whose store depends on timing: the split of shed and landed ops
# follows the wall clock, and with several bulk requests in flight the
# member store commits them in the threads' order.
TIMED = {
    "test_mid_batch_deadline_sheds_remainder",
    "test_pipelined_window_preserves_order",
    "test_batch_telemetry_emitted",
}


@pytest.mark.parametrize("cls,name", CASES, ids=[f"{c.__name__}.{n}" for c, n in CASES])
def test_write_coalesce_case(monkeypatch, cls, name):
    want = run_case(monkeypatch, cls, name, port=False)
    got = run_case(monkeypatch, cls, name, port=True)
    if name not in TIMED:
        assert got == want


def test_knob_constants_keep_jax_defaults(monkeypatch):
    """Unset, the JAX knobs read as the port's constants."""
    from kubeadmiral_tpu.federation import dispatch as jax_dispatch

    for name in ENV_CONSTANTS:
        monkeypatch.delenv(name, raising=False)
    monkeypatch.delenv("KT_DISPATCH_POOL", raising=False)
    monkeypatch.delenv("KT_DISPATCH_DEADLINE_S", raising=False)
    monkeypatch.delenv("KT_RETRY_CAP_S", raising=False)
    for fn in ("dispatch_pool_size", "dispatch_deadline", "write_coalesce",
               "member_batch", "member_inflight", "retry_max"):
        assert getattr(dispatch, fn)() == getattr(jax_dispatch, fn)(), fn

    class Fixed:
        def random(self):
            return 0.375

    for attempt in range(12):
        assert dispatch.retry_delay(attempt, Fixed()) == jax_dispatch.retry_delay(attempt, Fixed())
    assert sync.BULK_READS is True


def _history(registry, now, names=("m1", "m2", "m3")):
    """One script of member outcomes against ``registry``."""
    m1, m2, m3 = (registry.for_member(n) for n in names)
    m1.record_failure()
    m1.record_failure(latency_s=0.2)
    m1.note_ok(0.05)
    m2.record_failure(timeout=True)
    now[0] += 2.0
    m3.record_success(0.4)
    m3.note_ok(0.3)
    m3.record_failure(latency_s=1.5)  # a stall: opens at once
    now[0] += 1.25
    registry.count_shed(m2.name, 4)
    registry.count_retry(m1.name, 2)
    for i in range(5):
        registry.note_write(m1.name, 0.01 * (i + 1), ops=3)
        registry.note_batch(m1.name, 3, "ok" if i % 2 else "partial")
    registry.count_shed(m3.name)
    return registry


def _clocked(mod):
    now = [100.0]
    return mod.BreakerRegistry(clock=lambda: now[0]), now


def test_breaker_accounting_and_durable_state_match_jax():
    (port, pnow), (ref, rnow) = _clocked(breaker), _clocked(jax_breaker)
    _history(port, pnow)
    _history(ref, rnow)
    assert port.snapshot() == ref.snapshot()
    assert port.shed_total() == ref.shed_total() == 5
    assert sorted(port.open_members()) == sorted(ref.open_members()) == ["m2", "m3"]
    got, want = port.export_state(), ref.export_state()
    assert got.pop("wall") > 0 and want.pop("wall") > 0
    assert got == want
    # Resume both images into fresh registries (a wall stamp ahead of
    # now: no downtime is subtracted), a while later on their clocks.
    images = []
    for mod, image in ((breaker, got), (jax_breaker, want)):
        fresh, now = _clocked(mod)
        now[0] = 500.0
        seen = []
        fresh.on_transition(lambda *t: seen.append(t))
        fresh.restore_state({"wall": float("inf"), **image})
        steps = [fresh.allow("m2", consume_probe=False), fresh.for_member("m2").state]
        now[0] += 3.0
        steps += [fresh.allow("m3", consume_probe=False), fresh.for_member("m3").state]
        images.append((fresh.export_state()["members"], seen, steps, fresh.open_members()))
    assert images[0] == images[1]
    assert images[0][2][:2] == [False, "open"]


def test_members_report_lists_open_members():
    """The report merges every live registry by member name: names no
    other registry of the process uses."""
    registry, now = _clocked(breaker)
    _history(registry, now, names=("report-m1", "report-m2", "report-m3"))
    report = breaker.members_report()
    assert {"report-m2", "report-m3"} <= set(report["open"])
    assert report["members"]["report-m1"]["dispatch_retries"] == 2


def test_breaker_config_defaults_match_jax(monkeypatch):
    for name in ("KT_BREAKER_FAILURES", "KT_BREAKER_OPEN_S",
                 "KT_BREAKER_LATENCY_S", "KT_BREAKER_STALL_S"):
        monkeypatch.delenv(name, raising=False)
    fields = breaker.BreakerConfig.__slots__
    assert [getattr(breaker.BreakerConfig(), f) for f in fields] == [
        getattr(jax_breaker.BreakerConfig(), f) for f in fields
    ]
    cfg = breaker.BreakerConfig(failure_threshold=1, open_seconds=0.5)
    assert (cfg.failure_threshold, cfg.open_seconds) == (1, 0.5)
