"""The port's end-to-end SLO layer against the JAX package's.

The cases of ``tests/test_slo.py``'s ``TestProvenanceToken`` (the
token's mint, marks, expect, written and settle, echo suppression, the
freshness gauges, the exemplar ring), ``TestBurnRateEvaluator`` (the
multi-window burn rates of the catalog's objectives),
``TestSLOEndToEnd``'s reconcile round (cluster, federate, scheduler and
sync controllers: every token closes with an exact stage decomposition
and per-member write attribution) and ``TestStreamStageBuckets`` (the
stream's stage histogram ladder) run over JAX and over the port (the
test module's globals and lazy imports pointed at the port's; the
port's scheduler on ``SchedulerEngine(device="cpu")``).  Every store a
case makes is equal between the two runs, and so is the recorder's
summary where the case keeps one under a fake clock.  Left out:
``test_debug_slo_and_metrics_exposition`` (the HTTP health server) and
the chaos class (the fault-injecting transport), neither ported.
"""

import sys

import pytest

import test_e2e_slice as E2E
import test_slo as SL
from test_torch_sync import Stores, method_cases, point_at_port

from kubeadmiral_tpu.runtime import metric_catalog as jax_catalog
from kubeadmiral_tpu.runtime import slo as jax_slo
from kubeadmiral_tpu_torch.models import types as port_types
from kubeadmiral_tpu_torch.runtime import metric_catalog, slo
from kubeadmiral_tpu_torch.scheduler import streaming

LEFT_OUT = {"test_debug_slo_and_metrics_exposition"}
CASES = [
    case for case in method_cases(
        SL.TestProvenanceToken, SL.TestBurnRateEvaluator, SL.TestSLOEndToEnd,
        SL.TestStreamStageBuckets,
    )
    if case[1] not in LEFT_OUT
]
# The HTTP health server and the fault-injecting transport.
NOT_PORTED = ("HealthCheckRegistry", "HealthServer", "FaultPolicy")
LAZY = {
    "kubeadmiral_tpu.runtime.metric_catalog": metric_catalog,
    "kubeadmiral_tpu.scheduler.streaming": streaming,
    "kubeadmiral_tpu.models.types": port_types,
}


def _summary(rec) -> dict:
    """The recorder's summary without its wall-clock stamps."""
    out = rec.summary()
    out.pop("generated_at", None)
    for exemplar in out.get("slowest", ()):
        exemplar.pop("wall", None)
    return out


def run_case(monkeypatch, cls, name, port: bool):
    with monkeypatch.context() as mp:
        jax_slo.reset_default()
        slo.reset_default()
        if port:
            point_at_port(mp, SL, E2E, absent=NOT_PORTED)
            for mod_name, module in LAZY.items():
                mp.setitem(sys.modules, mod_name, module)
        stores = Stores(mp, SL, E2E)
        obj = cls()
        if hasattr(obj, "setup_method"):
            obj.setup_method()
        method = getattr(obj, name)
        recorder = None
        if "fresh_default" in method.__code__.co_varnames[: method.__code__.co_argcount]:
            recorder = SL.slo.SLORecorder(enabled=True)
            prev = SL.slo.set_default(recorder)
            try:
                method(recorder)
            finally:
                SL.slo.set_default(prev)
        else:
            method()
        rec = getattr(obj, "rec", None)
        return stores.dumps(), (_summary(rec) if rec is not None else None), recorder


@pytest.mark.parametrize("cls,name", CASES, ids=[f"{c.__name__}.{n}" for c, n in CASES])
def test_slo_case(monkeypatch, cls, name):
    want_stores, want_summary, want_rec = run_case(monkeypatch, cls, name, port=False)
    got_stores, got_summary, got_rec = run_case(monkeypatch, cls, name, port=True)
    assert got_stores == want_stores
    assert got_summary == want_summary
    if got_rec is not None:
        # The wall-clock round: the same events closed, stage by stage.
        got, want = _summary(got_rec), _summary(want_rec)
        assert {k: v["count"] for k, v in got["stages"].items()} == {
            k: v["count"] for k, v in want["stages"].items()
        }
        assert got["pending_events"] == want["pending_events"] == 0
        assert sorted(e["key"] for e in got["slowest"]) == sorted(
            e["key"] for e in want["slowest"]
        )


def test_objectives_and_knob_constants_match_jax(monkeypatch):
    """The catalog's objectives, and the recorder's settings at the JAX
    knobs' defaults."""
    for name in ("KT_SLO", "KT_SLO_WINDOWS_S", "KT_SLO_EXEMPLARS", "KT_SLO_PENDING_CAP",
                 "KT_SLO_MAX_AGE_S", "KT_SLO_E2E_P99_S", "KT_SLO_WRITE_P99_S",
                 "KT_SLO_FRESHNESS_S"):
        monkeypatch.delenv(name, raising=False)
    assert metric_catalog.SLO_OBJECTIVES == jax_catalog.SLO_OBJECTIVES
    assert metric_catalog.SLO_STAGES == jax_catalog.SLO_STAGES == slo.STAGES
    mine, theirs = slo.SLORecorder(), jax_slo.SLORecorder()
    for attr in ("enabled", "exemplars", "pending_cap", "max_age_s"):
        assert getattr(mine, attr) == getattr(theirs, attr), attr
    assert mine.evaluator.windows == theirs.evaluator.windows
    assert mine.evaluator.thresholds == theirs.evaluator.thresholds
