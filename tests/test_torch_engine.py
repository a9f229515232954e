"""End-to-end parity: the port's ``SchedulerEngine(device="cpu")`` against
the JAX ``SchedulerEngine(mesh=None)`` — both its default (narrow solve,
packed fetch) and ``narrow=False`` — on cold ticks, with ``results_equal``
from tests/test_engine_cache.py.  Scenarios mirror tests/test_engine.py
(filters, sticky, auto-migration spill, dynamic weights, chunking), plus
seeded config 3 / config 5 worlds, vocabulary overflows that take the
dense-featurize fallback, and more objects than a chunk.
"""

import dataclasses

import pytest

from test_compact import rich_world
from test_engine import mk_cluster, mk_unit
from test_engine_cache import results_equal

from kubeadmiral_tpu.models.types import (
    AutoMigrationSpec,
    ClusterAffinity,
    MODE_DIVIDE,
    PreferredSchedulingTerm,
    SelectorRequirement,
    SelectorTerm,
    Taint,
    Toleration,
    parse_resources,
)
from kubeadmiral_tpu.scheduler.engine import SchedulerEngine as JaxEngine
from kubeadmiral_tpu_torch.scheduler import engine as engine_mod
from kubeadmiral_tpu_torch.scheduler.engine import SchedulerEngine
from kubeadmiral_tpu_torch.testing.sample_counts import sample_counts
from kubeadmiral_tpu_torch.testing.worlds import build_world


def _jax(**kw):
    return JaxEngine(mesh=None, flight_recorder=None, devprof=None, **kw)


def _port(**kw):
    """The port's CPU engine built with the JAX engine's keywords."""
    return SchedulerEngine(device="cpu", **kw)


def _check(units, clusters, **kw):
    """Port vs JAX default vs JAX dense (the same chunk geometry, vocabulary
    caps, candidate width and wire width): equal results, and on the
    port's narrow solve and packed wire the JAX default engine's
    narrow_stats, candidate width and overflow rows.  Returns (the port's
    engine, its results)."""
    port = _port(**kw)
    got = port.schedule(units, clusters)
    for narrow in (None, False):
        jax_engine = _jax(narrow=narrow, **kw)
        results_equal(got, jax_engine.schedule(units, clusters))
        if narrow is None:
            assert port.narrow_stats == jax_engine.narrow_stats
            assert port.narrow_last_m == jax_engine.narrow_last_m
            assert port.overflow_rows_total == jax_engine.overflow_rows_total
    return port, got


def _tainted():
    tainted = mk_cluster("b", taints=(Taint("dedicated", "infra", "NoSchedule"),))
    missing = mk_cluster("d")
    missing.api_resources = frozenset({"batch/v1/Job"})
    return [
        mk_cluster("a", labels={"region": "eu", "tier": "gold"}),
        tainted,
        mk_cluster("c", cpu="1", mem="1Gi", labels={"region": "us"}),
        missing,
        mk_cluster("e", cpu="64", mem="256Gi", cpu_free="60", labels={"tier": "gold"}),
    ]


def _filters_world():
    aff = ClusterAffinity(
        required=(
            SelectorTerm(
                match_expressions=(SelectorRequirement("region", "In", ("eu",)),)
            ),
        )
    )
    pref = ClusterAffinity(
        preferred=(
            PreferredSchedulingTerm(
                weight=50,
                preference=SelectorTerm(
                    match_expressions=(SelectorRequirement("tier", "In", ("gold",)),)
                ),
            ),
        )
    )
    units = [
        mk_unit("dup"),
        mk_unit("placed", cluster_names=frozenset({"a", "c"})),
        mk_unit("tolerant", tolerations=(Toleration(key="dedicated", operator="Exists"),)),
        mk_unit("eu-only", affinity=aff),
        mk_unit("gold-one", affinity=pref, max_clusters=1),
        mk_unit("heavy", resource_request=parse_resources({"cpu": "8", "memory": "32Gi"})),
        mk_unit("none", max_clusters=-1),
    ]
    return units, _tainted()


def _replicas_world():
    a = mk_cluster("a", cpu="100", cpu_free="10")
    b = mk_cluster("b", cpu="100", cpu_free="90")
    units = [
        mk_unit("static", scheduling_mode=MODE_DIVIDE, desired_replicas=10,
                weights={"a": 3, "b": 1}, avoid_disruption=False),
        mk_unit("dynamic", scheduling_mode=MODE_DIVIDE, desired_replicas=10,
                avoid_disruption=False),
        mk_unit("sticky", sticky_cluster=True, current_clusters={"a": 5},
                scheduling_mode=MODE_DIVIDE, desired_replicas=9),
        mk_unit("sticky-nil", sticky_cluster=True, current_clusters={"a": None},
                scheduling_mode=MODE_DIVIDE, desired_replicas=4),
        mk_unit("spill", scheduling_mode=MODE_DIVIDE, desired_replicas=10,
                weights={"a": 1000, "b": 1}, avoid_disruption=False,
                auto_migration=AutoMigrationSpec(estimated_capacity={"a": 3})),
        mk_unit("keep", scheduling_mode=MODE_DIVIDE, desired_replicas=12,
                avoid_disruption=True, current_clusters={"a": 7, "b": 1},
                auto_migration=AutoMigrationSpec(
                    keep_unschedulable_replicas=True, estimated_capacity={"b": 2})),
        mk_unit("bounded", scheduling_mode=MODE_DIVIDE, desired_replicas=20,
                min_replicas={"a": 4}, max_replicas={"b": 6}),
    ]
    return units, [a, b]


def _chunked_world():
    clusters = [mk_cluster(f"c{i}") for i in range(7)]
    units = [
        mk_unit(f"obj-{i}", scheduling_mode=MODE_DIVIDE, desired_replicas=i % 13,
                avoid_disruption=False)
        for i in range(50)
    ]
    return units, clusters


def _spread_world():
    """Divide rows without maxClusters over 20 clusters: the wire's K is
    PACK_K_MIN's bucket, so a small PACK_K_MIN overflows most rows."""
    clusters = [mk_cluster(f"c{i:02d}") for i in range(20)]
    units = [
        mk_unit(f"obj-{i}", scheduling_mode=MODE_DIVIDE, desired_replicas=5 + i % 40,
                avoid_disruption=False)
        for i in range(60)
    ]
    return units, clusters


def _wide_world():
    # 150 clusters bucket to 256 > M = 128: the default engine narrows.
    return build_world(200, 150, "5", seed=2)[:2]


SCENARIOS = {
    "filters": (_filters_world, {}),
    "replicas": (_replicas_world, {}),
    "rich": (lambda: rich_world(b=48, c=14, seed=7), {}),
    "chunked": (_chunked_world, {"chunk_size": 16, "min_bucket": 8}),
    "c3": (lambda: build_world(300, 40, "3", seed=1)[:2], {}),
    "c5": (lambda: build_world(300, 40, "5", seed=1)[:2], {}),
    "c3-multichunk": (lambda: build_world(300, 270, "3", seed=4)[:2],
                      {"chunk_size": 128}),
    # Vocabulary overflows: a chunk-level cap (gvk vocab > 1) and a
    # topology-level cap (more taint sets than the table holds) both
    # take the dense-featurize fallback.
    "gvk-overflow": (lambda: build_world(120, 30, "3", seed=5)[:2],
                     {"vocab_caps": {"gvk_cap": 1}}),
    "taint-overflow": (lambda: rich_world(b=40, c=14, seed=3),
                       {"vocab_caps": {"taint_cap": 1}}),
    # The default candidate width on a bucket wider than M: narrow.
    "c5-wide": (_wide_world, {}),
    # M patched to the cluster bucket: the dense tick on the same world.
    "c5-wide-dense": (_wide_world, {"narrow_m": 256}),
    "pack-k-2": (_spread_world, {"pack_k_min": 2}),
}


# Every scenario at the default candidate width, and those that do not
# fix their own at M = 8, which narrows the 40- and 14-cluster worlds
# (bucket 64 and 16) too.
CASES = [pytest.param(name, None, id=name) for name in sorted(SCENARIOS)] + [
    pytest.param(name, 8, id=f"{name}-m8")
    for name in sorted(SCENARIOS)
    if "narrow_m" not in SCENARIOS[name][1]
]


@pytest.mark.parametrize("name,narrow_m", CASES)
def test_cold_tick_matches_jax_engine(name, narrow_m, monkeypatch):
    """Results, narrow_stats and overflow rows equal the JAX default
    engine's."""
    build, kw = SCENARIOS[name]
    if narrow_m is not None:
        kw = {**kw, "narrow_m": narrow_m}
    units, clusters = build()
    dense_calls = []
    real = engine_mod.featurize
    monkeypatch.setattr(
        engine_mod, "featurize", lambda *a, **k: dense_calls.append(1) or real(*a, **k)
    )
    port, got = _check(units, clusters, **kw)
    assert len(got) == len(units)
    assert any(r.clusters for r in got)
    # Only the overflow scenarios take the dense-featurize fallback.
    assert bool(dense_calls) == name.endswith("-overflow")
    stats = port.narrow_stats
    if name == "c5-wide" or (narrow_m and name in ("c3", "c5", "c3-multichunk")):
        assert port.narrow_last_m > 0 and stats["rows"] + stats["fallback"] == len(units)
    if name == "c5-wide-dense":
        assert port.narrow_last_m == 0 and stats == {"rows": 0, "fallback": 0}
        assert port.overflow_rows_total > 0  # the dense tick's planes, packed
    if name == "pack-k-2":
        assert port.overflow_rows_total > len(units) // 2


@pytest.mark.parametrize("config", ["3", "5"])
def test_worlds_match_bench_build_world(config, monkeypatch):
    """testing/worlds.py is bench.py's build_world with its environment
    knobs turned into arguments: same seed, same world."""
    import numpy as np

    import bench

    n, c = 90, 31
    monkeypatch.setattr(bench, "CONFIG", config)
    monkeypatch.setattr(bench, "N_OBJECTS", n)
    monkeypatch.setattr(bench, "N_CLUSTERS", c)
    want_units, want_clusters, want_followers = bench.build_world(np.random.default_rng(6))
    units, clusters, followers = build_world(n, c, config, seed=6)
    assert followers == want_followers
    assert [dataclasses.astuple(x) for x in clusters] == [
        dataclasses.astuple(x) for x in want_clusters
    ]
    assert [dataclasses.astuple(x) for x in units] == [
        dataclasses.astuple(x) for x in want_units
    ]


def test_chunk_geometry_matches_jax():
    port, jax_engine = SchedulerEngine(device="cpu"), _jax()
    for c in (0, 7, 40, 500, 513, 2000, 5000, 12000):
        assert port._tick_geometry(c) == jax_engine._tick_geometry(c), c
        _, eff, ladder = port._tick_geometry(c)
        for n in (1, 65, 300, eff + 1):
            for full in (False, True):
                assert port._bucket_rows(n, ladder, eff, full) == jax_engine._bucket_rows(
                    n, ladder, eff, full
                ), (c, n, full)


def test_replicas_sum_and_results_are_frozen(monkeypatch):
    units, clusters = _chunked_world()
    results = _port(chunk_size=16, min_bucket=8).schedule(units, clusters)
    for i, res in enumerate(results):
        assert sum(res.clusters.values()) == i % 13
    with pytest.raises(TypeError):
        results[0].clusters["x"] = 1
    with pytest.raises(dataclasses.FrozenInstanceError):
        results[0].clusters = {}


def test_empty_inputs_and_overflow_match_jax(monkeypatch):
    engine = SchedulerEngine(device="cpu")
    assert engine.schedule([], [mk_cluster("a")]) == []
    _check([mk_unit("web")], [])
    huge = mk_unit("huge", scheduling_mode=MODE_DIVIDE, desired_replicas=5_000_000,
                   avoid_disruption=False)
    with pytest.raises(OverflowError):
        engine.schedule([huge], [mk_cluster("a"), mk_cluster("b")])


def test_sample_counts_match_jax_engine():
    """The CPU sampler's counts (which PERF.md's predictions scale) are
    the JAX default engine's on the same world sample."""
    got = sample_counts("3", 96, seed=2)
    units, clusters, _ = build_world(96, 500, "3", seed=2)
    jax_engine = _jax()
    jax_engine.schedule(units, clusters)
    assert got["narrow_m"] == jax_engine.narrow_last_m > 0
    assert got["narrow_stats"] == jax_engine.narrow_stats
    assert got["overflow_rows"] == jax_engine.overflow_rows_total
    assert got["dense_plane_bytes"] == 6 * 96 * 512
    assert 0 < got["fetch_vs_dense"] < 1
