"""The decision flight recorder on the port, beside the JAX engine's.

The port's engine (``SchedulerEngine(device="cpu")``) and a JAX engine,
each with a fresh recorder of its package, take the same ticks at the
sequential dispatch and at the pipelined window's depth of 16: cold,
no-op, churn (the sub-batch slabs), drift (the gate and its recompute
slabs), drift-zero (fit flips: the unified survivor program), a tick
back, a scored tick and a webhook tick (which records nothing, as no
cache entry maps its rows to keys), on narrow chunks (several per tick,
certificate fallbacks included) and on dense ones.  After every tick
each object's record is equal: key, tick, program, placements, reason
counts, feasible count, top-k cluster indices and scores.  Also:
``explain(key)`` on both, an ``export_state`` / ``restore_state`` round
trip through pickle, and the ``flightrec_*`` gauges of the tick.
"""

import dataclasses
import pickle

import pytest

from test_drift_replan import _fitflip_world, _quarter_cpu
from test_drift_tick import halve_available
from test_engine_cache import make_world
from test_restart import clusters_eq
from test_torch_engine import _port

from kubeadmiral_tpu.runtime.flightrec import FlightRecorder as JaxRecorder
from kubeadmiral_tpu.runtime.flightrec import summarize_reasons as jax_summarize
from kubeadmiral_tpu.runtime.metrics import Metrics as JaxMetrics
from kubeadmiral_tpu.scheduler.engine import SchedulerEngine as JaxEngine
from kubeadmiral_tpu_torch.runtime.flightrec import FlightRecorder, summarize_reasons
from kubeadmiral_tpu_torch.runtime.metrics import Metrics
from kubeadmiral_tpu_torch.testing.worlds import webhook

WORLDS = {
    # Narrow chunks (bucket 32 above M = 16), three a tick.
    "narrow": (
        lambda: _fitflip_world(b=300, c=24),
        dict(chunk_size=128, min_bucket=32, min_cluster_bucket=8, narrow_m=16),
    ),
    # Dense chunks (bucket 8 under M), four a tick.
    "dense": (lambda: make_world(b=100, c=6), dict(chunk_size=32, min_bucket=8)),
}


class Pair:
    """The port's engine and the JAX engine at one depth, each with its
    own recorder and metrics registry."""

    def __init__(self, monkeypatch, depth: int, **kw):
        monkeypatch.setenv("KT_PIPELINE_DEPTH", str(depth))
        self.ref_rec = JaxRecorder(max_ticks=8, max_bytes=256 << 20, topk=8, enabled=True)
        self.port_rec = FlightRecorder()
        self.ref_metrics, self.port_metrics = JaxMetrics(), Metrics()
        self.ref = JaxEngine(
            mesh=None, devprof=None, metrics=self.ref_metrics,
            flight_recorder=self.ref_rec, **kw,
        )
        self.port = _port(monkeypatch, **kw)
        self.port.metrics, self.port.flightrec = self.port_metrics, self.port_rec
        self.port.pipeline_depth = depth

    def tick(self, units, clusters, **kw):
        got = self.port.schedule(units, clusters, **kw)
        assert clusters_eq(got, self.ref.schedule(units, clusters, **kw))
        return got


def record_fields(rec) -> tuple:
    return (
        rec.key, rec.tick, rec.program, dict(rec.placements),
        rec.reason_counts.tolist(), int(rec.feasible_n),
        rec.topk_idx.tolist(), rec.topk_scores.tolist(), tuple(rec.names),
    )


def assert_records_equal(port_rec, ref_rec, units) -> int:
    """Every unit's record equal on both recorders; returns how many
    units have one."""
    seen = 0
    for u in units:
        got, want = port_rec.lookup(u.key), ref_rec.lookup(u.key)
        assert (got is None) == (want is None), u.key
        if want is not None:
            assert record_fields(got) == record_fields(want), u.key
            seen += 1
    assert port_rec.stats() == ref_rec.stats()
    return seen


def ticks(units, clusters):
    """The sequence: (label, units, clusters, schedule keywords)."""
    churned = list(units)
    for i in range(0, len(units), 29):
        churned[i] = dataclasses.replace(
            churned[i], desired_replicas=(churned[i].desired_replicas or 1) + 3
        )
    drifted = [halve_available(c) if j == 0 else c for j, c in enumerate(clusters)]
    zeroed = [
        dataclasses.replace(c, available={k: 0 for k in c.available}) if j == 3 else c
        for j, c in enumerate(drifted)
    ]
    return [
        ("cold", units, clusters, {}),
        ("noop", units, clusters, {}),
        ("churn", churned, clusters, {}),
        ("drift", churned, drifted, {}),
        ("drift-zero", churned, zeroed, {}),
        ("fit-flip", churned, _quarter_cpu(drifted, 5), {}),
        ("back", churned, clusters, {}),
        ("scored", churned, clusters, {"want_scores": True}),
        ("webhook", churned, clusters, {"webhook_eval": webhook(seed=3)}),
    ]


@pytest.mark.parametrize("depth", [1, 16])
@pytest.mark.parametrize("world", sorted(WORLDS))
def test_records_equal_jax(world, depth, monkeypatch):
    make, kw = WORLDS[world]
    pair = Pair(monkeypatch, depth, **kw)
    units, clusters = make()
    recorded = {}
    for label, us, cs, skw in ticks(units, clusters):
        before = pair.port_rec.stats()["ticks_seen"]
        pair.tick(us, cs, **skw)
        assert pair.port_rec.stats()["ticks_seen"] == before + 1
        recorded[label] = assert_records_equal(pair.port_rec, pair.ref_rec, us)
        gauges = pair.port_metrics.snapshot()["gauges"]
        st = pair.port_rec.stats()
        assert gauges["flightrec_records"] == st["records"]
        assert gauges["flightrec_bytes"] == st["bytes"]
        assert gauges["flightrec_ring_ticks"] == st["ring_ticks"]
    assert recorded["cold"] == len(units)
    programs = {p for e in pair.port_rec.decisions()["ticks"] for p in e["programs"]}
    assert any(p.endswith(":sub") for p in programs), programs
    if world == "narrow":
        assert pair.port.drift_stats["unified"] > 0, pair.port.drift_stats
        assert any(p.endswith(":unified") for p in programs), programs
        assert pair.port.narrow_stats["rows"] > 0


def test_explain_and_state_round_trip(monkeypatch):
    make, kw = WORLDS["narrow"]
    pair = Pair(monkeypatch, 16, **kw)
    units, clusters = make()
    for _label, us, cs, skw in ticks(units, clusters)[:5]:
        pair.tick(us, cs, **skw)
    for u in units[:40]:
        got, want = pair.port_rec.explain(u.key), pair.ref_rec.explain(u.key)
        got.pop("age_seconds"), want.pop("age_seconds")
        assert got == want, u.key
        assert summarize_reasons(pair.port_rec.lookup(u.key)) == jax_summarize(
            pair.ref_rec.lookup(u.key)
        )
    assert pair.port_rec.explain("no/such-key") is None

    state = pickle.loads(pickle.dumps(pair.port_rec.export_state()))
    successor = FlightRecorder()
    successor.restore_state(state)
    assert successor.stats() == pair.port_rec.stats()
    for u in units:
        a, b = successor.lookup(u.key), pair.port_rec.lookup(u.key)
        assert record_fields(a) == record_fields(b)
    # Tick ids continue after the restored sequence.
    assert successor.begin_tick(1, 1) == pair.port_rec.stats()["ticks_seen"] + 1
    successor.end_tick()


def test_disabled_recorder_records_nothing(monkeypatch):
    make, kw = WORLDS["dense"]
    port = _port(monkeypatch, **kw)
    port.flightrec = FlightRecorder(enabled=False)
    units, clusters = make()
    port.schedule(units, clusters)
    assert port.flightrec.stats()["records"] == 0
    port.flightrec = None
    port.schedule(list(units), clusters)
    assert port.metrics.get_counter("engine_ticks_total") == 2
    assert "flightrec_records" not in port.metrics.snapshot()["gauges"]
