"""The engine's geometry and cache keywords against the JAX engine.

Every ``SchedulerEngine`` keyword of the JAX engine's constructor that
shapes the chunk geometry, the candidate and wire widths, the cache
budget or the vocabulary caps, at a value other than its default, gives
the port's CPU engine the same results as a JAX engine built with the
same keywords, tick by tick over cold, no-op, churn, drift and back
(exact: results, ``last_changed`` and the cache, fetch, drift, survivor
and narrow counters).  A ``chunk_size`` that is not a power of two is
among them, and so are a cache budget that leaves chunks uncached and
vocabulary caps that force the dense featurizer.
"""

import dataclasses

import pytest

from test_drift_tick import halve_available
from test_engine_cache import make_world, results_equal

from kubeadmiral_tpu.scheduler.engine import SchedulerEngine as JaxEngine
from kubeadmiral_tpu_torch.scheduler.engine import SchedulerEngine

COUNTERS = (
    "cache_stats", "fetch_stats", "drift_stats", "survivor_stats", "narrow_stats",
    "featurize_rows",
)

CASES = {
    "chunk-96": dict(chunk_size=96, min_bucket=32),
    "chunk-1000": dict(chunk_size=1000, min_bucket=32, narrow_m=8),
    "min-bucket-32": dict(chunk_size=64, min_bucket=32),
    "narrow-m-8": dict(chunk_size=128, narrow_m=8, pack_k_min=8),
    "cache-small": dict(chunk_size=32, cache_bytes=40_000),
    "cache-zero": dict(chunk_size=64, cache_bytes=0),
    "vocab-dense": dict(chunk_size=64, vocab_caps={"taint_cap": 1, "sel_cap": 1}),
    "cell-budget": dict(cell_budget=64 * 16, megachunk_rows=512, min_bucket=16),
    "megachunk-rows": dict(megachunk_rows=48, min_bucket=16),
    "canonical-c": dict(canonical_c=8, chunk_size=128, min_bucket=8),
    "cluster-bucket-32": dict(min_cluster_bucket=32, chunk_size=128),
}


def _ticks(units, clusters):
    """(units, clusters) of cold, no-op, 1-row churn, drift and back."""
    churned = list(units)
    churned[1] = dataclasses.replace(churned[1], desired_replicas=(units[1].desired_replicas or 1) + 3)
    drifted = [halve_available(clusters[0])] + list(clusters[1:])
    return [
        (units, clusters), (units, clusters), (churned, clusters),
        (churned, drifted), (churned, clusters), (list(churned), clusters),
    ]


@pytest.mark.parametrize("case", sorted(CASES))
def test_keywords_match_jax_tick_by_tick(case):
    kw = CASES[case]
    units, clusters = make_world(b=230, c=16)
    port = SchedulerEngine(device="cpu", flight_recorder=None, devprof=None, **kw)
    ref = JaxEngine(mesh=None, flight_recorder=None, devprof=None, **kw)
    assert port._tick_geometry(len(clusters)) == ref._tick_geometry(len(clusters))
    assert port._snapshot_config() == {**ref._snapshot_config(), "mesh": None}
    for batch, cl in _ticks(units, clusters):
        results_equal(port.schedule(batch, cl), ref.schedule(batch, cl))
        assert port.last_changed == ref.last_changed
        for name in COUNTERS:
            assert getattr(port, name) == getattr(ref, name), name
    if case == "vocab-dense":
        assert all(e.fmt == "dense" for e in port._chunk_cache.values())
    if case == "cache-zero":
        assert port._chunk_cache == {}
    if case == "cache-small":
        assert 0 < len(port._chunk_cache) < -(-len(units) // 32)
    if case.startswith("chunk-"):
        assert port.chunk_size == kw["chunk_size"]


@pytest.mark.parametrize("chunk_size", [96, 100, 1000, 3000])
@pytest.mark.parametrize("n_clusters", [7, 300, 5000])
def test_non_pow2_chunk_geometry_and_buckets(chunk_size, n_clusters):
    """A non-pow2 chunk_size: the geometry, and the row bucket of every
    chunk length, equal the JAX engine's (eff_chunk = min(chunk_size,
    pow2))."""
    port = SchedulerEngine(device="cpu", chunk_size=chunk_size)
    ref = JaxEngine(mesh=None, flight_recorder=None, devprof=None, chunk_size=chunk_size)
    geo = port._tick_geometry(n_clusters)
    assert geo == ref._tick_geometry(n_clusters)
    _c, eff, ladder = geo
    for n in (1, 31, 64, 65, eff - 1, eff):
        for full in (False, True):
            assert port._bucket_rows(n, ladder, eff, full) == ref._bucket_rows(
                n, ladder, eff, full
            )


def test_snapshot_refused_across_geometry():
    """A snapshot taken at one chunk size is refused by an engine built
    with another (the restore never reinterprets planes)."""
    units, clusters = make_world(b=100, c=8)
    src = SchedulerEngine(device="cpu", chunk_size=64, flight_recorder=None)
    want = src.schedule(units, clusters)
    payload = src.snapshot_state()
    dst = SchedulerEngine(device="cpu", chunk_size=96, flight_recorder=None)
    dst.stage_restore(payload, assume_fresh=True)
    results_equal(dst.schedule(units, clusters), want)
    assert dst.restore_info["result"] == "rejected"
