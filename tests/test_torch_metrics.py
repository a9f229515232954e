"""Tick telemetry on the port, beside the JAX engine's.

The port's engine and a JAX engine, each reporting into its own
``Metrics`` registry, take test_torch_flightrec.py's tick sequence
(cold, no-op, churn, drift, drift-zero, fit flips, back, scored,
webhook) at depths 1 and 16 on narrow and dense chunks.  After every
tick the two registries hold equal counters and gauges — series keys and
values — except the families in ``UNEQUAL``, each with its reason.
Histograms hold wall times and are compared by their series and
observation counts only.  Also: a restore's ``engine_snapshot_total``
results, ``resident_state_bytes`` gauges, ``featurize_rows`` and
``stale_repair_rows`` beside JAX's, and the engine's ``chunk_size`` and
``prewarm`` surface.
"""

import dataclasses
import pickle

import pytest

from test_restart import small_world
from test_torch_flightrec import WORLDS, Pair, ticks

from kubeadmiral_tpu.runtime.metrics import Metrics as JaxMetrics
from kubeadmiral_tpu.scheduler.engine import SchedulerEngine as JaxEngine
from kubeadmiral_tpu_torch.runtime.metrics import Metrics
from kubeadmiral_tpu_torch.scheduler import engine as engine_mod
from kubeadmiral_tpu_torch.scheduler.engine import SchedulerEngine

UNEQUAL = {
    # Byte counters: the port reads and uploads no padding rows
    # (ROADMAP queue 3 item 4), so its byte counts are smaller.
    "engine_fetch_bytes_total": "packed reads without pow2 padding rows",
    "engine_upload_bytes_total": "stale-row repairs and card-gathered slabs upload less",
    # No XLA behind the port: nothing is traced, compiled or cached.
    "engine_xla_compiles_total": "no XLA",
    "engine_persistent_cache_total": "no XLA",
    "engine_aot_programs_total": "no XLA",
}


def family(key: str) -> str:
    return key.split("{", 1)[0]


def comparable(registry) -> dict:
    snap = registry.snapshot()
    out = {
        kind: {k: v for k, v in snap[kind].items() if family(k) not in UNEQUAL}
        for kind in ("counters", "gauges")
    }
    out["histogram_counts"] = {
        k: h["count"]
        for k, h in snap["histograms"].items()
        if not k.startswith("engine_tick_stage_seconds")
    }
    return out


@pytest.mark.parametrize("depth", [1, 16])
@pytest.mark.parametrize("world", sorted(WORLDS))
def test_registries_equal_jax(world, depth, monkeypatch):
    make, kw = WORLDS[world]
    pair = Pair(monkeypatch, depth, **kw)
    units, clusters = make()
    for label, us, cs, skw in ticks(units, clusters):
        pair.tick(us, cs, **skw)
        got, want = comparable(pair.port_metrics), comparable(pair.ref_metrics)
        assert got == want, label
        assert pair.port.featurize_rows == pair.ref.featurize_rows, label
        assert pair.port.stale_repair_rows == pair.ref.stale_repair_rows, label
        assert pair.port.program_shapes == pair.ref.program_shapes, label
    counters = pair.port_metrics.snapshot()["counters"]
    for name in ("engine_dispatches_total", "engine_drift_rows_total",
                 "engine_featurize_rows_total", "engine_fetch_total"):
        assert any(family(k) == name for k in counters), name
    # The unequal byte families are emitted all the same.
    assert any(family(k) == "engine_fetch_bytes_total" for k in counters)


def test_restore_outcomes_counted_as_jax():
    """engine_snapshot_total{result} after fresh, stale and rejected
    resumes, equal on both engines."""
    units, clusters = small_world()
    snaps = {}
    for name, make_engine in (
        ("port", lambda m: SchedulerEngine(device="cpu", metrics=m)),
        ("ref", lambda m: JaxEngine(mesh=None, flight_recorder=None, devprof=None, metrics=m)),
    ):
        eng = make_engine(Metrics() if name == "port" else JaxMetrics())
        eng.schedule(units, clusters)
        snaps[name] = pickle.loads(pickle.dumps(eng.snapshot_state()))
    stale = list(clusters)
    stale[0] = dataclasses.replace(
        stale[0], available={k: v // 2 for k, v in stale[0].available.items()}
    )
    relabelled = list(clusters)
    relabelled[0] = dataclasses.replace(relabelled[0], labels={"region": "mars"})
    results = {}
    for name, make_engine in (
        ("port", lambda m: SchedulerEngine(device="cpu", metrics=m)),
        ("ref", lambda m: JaxEngine(mesh=None, flight_recorder=None, devprof=None, metrics=m)),
    ):
        m = Metrics() if name == "port" else JaxMetrics()
        for world in (clusters, stale, relabelled):
            eng = make_engine(m)
            eng.stage_restore(snaps[name], assume_fresh=world is clusters)
            eng.schedule(small_world()[0], world)
        counters = m.snapshot()["counters"]
        results[name] = {
            k: v for k, v in counters.items() if family(k) == "engine_snapshot_total"
        }
    assert results["port"] == results["ref"] == {
        "engine_snapshot_total{result=loaded_fresh}": 1.0,
        "engine_snapshot_total{result=loaded_stale}": 1.0,
        "engine_snapshot_total{result=rejected}": 1.0,
    }


def test_resident_state_bytes_families():
    units, clusters = small_world()
    eng = SchedulerEngine(device="cpu", metrics=Metrics())
    eng.schedule(units, clusters)
    got = eng.resident_state_bytes()
    entry = next(iter(eng._chunk_cache.values()))
    b, c = entry.prev_out[0].shape
    assert got["by_family"]["prev_planes"] == 15 * b * c
    assert got["by_family"]["tiebreak"] == 0
    assert got["by_family"]["vectors"] == 4 * b
    assert got["total"] == got["per_device"] == sum(got["by_family"].values())
    gauges = eng.metrics.snapshot()["gauges"]
    assert gauges["engine_resident_bytes{family=prev_planes}"] == 15 * b * c
    assert gauges["engine_resident_bytes_per_device"] == got["total"]


def test_chunk_size_and_prewarm_on_the_cpu(monkeypatch):
    eng = SchedulerEngine(device="cpu")
    assert eng.chunk_size == engine_mod.MEGACHUNK_ROWS
    monkeypatch.setattr(engine_mod, "MEGACHUNK_ROWS", 64)
    assert eng.chunk_size == 64
    with pytest.raises(AttributeError):
        eng.chunk_size = 8

    builds = []
    monkeypatch.setattr(engine_mod.phase1_mod, "_library", lambda: builds.append(1))
    thread = eng.prewarm(1000, 50, wait=True)
    assert not thread.is_alive()
    assert builds == [], "a CPU engine's prewarm must not build the kernel"


def test_prewarm_logs_a_build_failure(monkeypatch, caplog):
    """On the card a failed build is logged by the prewarm thread and
    not raised there: the first tick's own build raises it."""
    eng = SchedulerEngine(device="cpu")
    monkeypatch.setattr(eng, "device", engine_mod.torch.device("cuda"))

    def broken():
        raise RuntimeError("nvcc failed")

    monkeypatch.setattr(engine_mod.phase1_mod, "_library", broken)
    with caplog.at_level("WARNING", logger="kubeadmiral.engine"):
        thread = eng.prewarm(10, 10, wait=True)
    assert not thread.is_alive()
    assert "engine prewarm failed" in caplog.text


def test_prewarm_builds_the_kernel_for_a_card_engine(monkeypatch):
    eng = SchedulerEngine(device="cpu")
    monkeypatch.setattr(eng, "device", engine_mod.torch.device("cuda"))
    builds = []
    monkeypatch.setattr(engine_mod.phase1_mod, "_library", lambda: builds.append(1))
    thread = eng.prewarm(eng.chunk_size, 1, scalar_resources=["nvidia.com/gpu"], wait=True)
    assert not thread.is_alive() and builds == [1]
