"""The port's drift gate through the engine, beside the JAX engine.

Each case of tests/test_drift_tick.py and tests/test_survivor_unified.py
runs on the port's ``SchedulerEngine(device="cpu")`` and on a JAX engine,
both at the sequential dispatch (port ``pipeline_depth`` 1, JAX
``KT_PIPELINE_DEPTH=1``) and, in ``test_case_at_depth_16``, both at the
pipelined window's default depth of 16, tick by tick: results,
``drift_stats``, ``survivor_stats``,
``fetch_stats``, ``narrow_stats``, ``last_changed`` and
``upload_bytes["cluster"]`` are equal after every tick, and the JAX
tests' own assertions hold on the port.  The JAX keywords are set as
the port's module constants.
"""

import dataclasses
import sys

import numpy as np
import pytest

from test_drift_replan import _clusters, _fitflip_world, _quarter_cpu, GVK
from test_drift_tick import halve_available
from test_engine_cache import make_world, results_equal
from test_engine_vs_sequential import random_cluster, random_unit
from test_torch_engine import _port

from kubeadmiral_tpu.bench_support import sequential_schedule
from kubeadmiral_tpu.models.types import (
    ClusterState,
    MODE_DIVIDE,
    SchedulingUnit,
    Taint,
    parse_resources,
)
from kubeadmiral_tpu.scheduler.engine import SchedulerEngine as JaxEngine

COUNTERS = ("drift_stats", "survivor_stats", "fetch_stats", "narrow_stats")


# The pipeline depth of both engines of a Pair (test_case_at_depth_16
# sets 16).
DEPTH = 1


class Pair:
    """The port's engine and the JAX engine taking the same ticks, both
    at pipeline depth DEPTH."""

    def __init__(self, monkeypatch, **kw):
        monkeypatch.setenv("KT_PIPELINE_DEPTH", str(DEPTH))
        self.monkeypatch, self.kw = monkeypatch, kw
        self.ref = JaxEngine(mesh=None, flight_recorder=None, devprof=None, **kw)
        self.port = _port(monkeypatch, **kw)
        self.port.pipeline_depth = DEPTH

    def tick(self, units, clusters):
        got = self.port.schedule(units, clusters)
        results_equal(got, self.ref.schedule(units, clusters))
        for name in COUNTERS:
            assert getattr(self.port, name) == getattr(self.ref, name), name
        assert self.port.last_changed == self.ref.last_changed
        assert self.port.upload_bytes["cluster"] == self.ref.upload_bytes["cluster"]
        return got

    def fresh(self, units, clusters):
        return _port(self.monkeypatch, **self.kw).schedule(units, clusters)

    @property
    def stats(self):
        return self.port.drift_stats


def _nfeas_consistent(engine) -> None:
    """Every cached chunk's feasible counts equal its prev_feas row sums."""
    checked = 0
    for entry in engine._chunk_cache.values():
        if entry.prev_feas is None or entry.prev_nfeas is None:
            continue
        want = (entry.prev_feas.numpy() != 0).sum(axis=1).astype(np.int32)
        np.testing.assert_array_equal(entry.prev_nfeas.numpy(), want)
        checked += 1
    assert checked > 0


SURVIVOR_KW = dict(chunk_size=128, min_bucket=32, min_cluster_bucket=8, narrow_m=16)


def _warm(pair, units, clusters):
    pair.tick(units, clusters)
    pair.tick(list(units), clusters)


class TestDriftTick:
    def test_drift_matches_sequential_oracle(self, monkeypatch):
        rng = np.random.default_rng(20260804)
        clusters = [random_cluster(rng, j) for j in range(16)]
        names = [c.name for c in clusters]
        units = [random_unit(rng, i, names) for i in range(96)]
        pair = Pair(monkeypatch, chunk_size=32, min_bucket=16, min_cluster_bucket=8)
        pair.tick(units, clusters)
        drifted = [halve_available(c) if j in (0, 5) else c for j, c in enumerate(clusters)]
        got = pair.tick(units, drifted)
        assert pair.stats["gated"] >= 1, pair.stats
        want = sequential_schedule(units, drifted)
        for i, (g, w) in enumerate(zip(got, want)):
            assert g.clusters == {names[j]: reps for j, reps in w.items()}, i

    def test_randomized_drift_sequence(self, monkeypatch):
        rng = np.random.default_rng(7)
        clusters = [random_cluster(rng, j) for j in range(14)]
        names = [c.name for c in clusters]
        units = [random_unit(rng, i, names) for i in range(72)]
        pair = Pair(monkeypatch, chunk_size=32, min_bucket=16, min_cluster_bucket=8)
        pair.tick(units, clusters)
        for step in range(8):
            kind = step % 4
            if kind == 0:
                j = int(rng.integers(0, len(clusters)))
                clusters = [halve_available(c) if i == j else c for i, c in enumerate(clusters)]
            elif kind == 1:
                picks = set(rng.integers(0, len(clusters), 2).tolist())
                clusters = [
                    dataclasses.replace(
                        c,
                        available={**c.available,
                                   "cpu": max(0, c.available.get("cpu", 0) - 1500)},
                    )
                    if i in picks else c
                    for i, c in enumerate(clusters)
                ]
            elif kind == 2:
                units = list(units)
                for r in rng.integers(0, len(units), 3):
                    units[int(r)] = dataclasses.replace(
                        units[int(r)], desired_replicas=int(rng.integers(1, 50))
                    )
                j = int(rng.integers(0, len(clusters)))
                clusters = [halve_available(c) if i == j else c for i, c in enumerate(clusters)]
            else:
                clusters = [
                    dataclasses.replace(
                        c, available={k: max(0, v - v // 10) for k, v in c.available.items()}
                    )
                    for c in clusters
                ]
            got = pair.tick(units, clusters)
            results_equal(got, pair.fresh(units, clusters))
        assert pair.stats["gated"] >= 2 and pair.stats["skip"] > 0, pair.stats

    def test_infeasible_drift_column_skips_everything(self, monkeypatch):
        clusters = [
            ClusterState(
                name=f"m-{j}",
                labels={},
                taints=(Taint("walled", "off", "NoSchedule"),) if j == 0 else (),
                allocatable=parse_resources({"cpu": "32", "memory": "64Gi"}),
                available=parse_resources({"cpu": "16", "memory": "32Gi"}),
                api_resources=frozenset({GVK}),
            )
            for j in range(6)
        ]
        units = [
            SchedulingUnit(
                gvk=GVK, namespace="ns", name=f"w-{i}", scheduling_mode=MODE_DIVIDE,
                desired_replicas=9, resource_request=parse_resources({"cpu": "100m"}),
            )
            for i in range(24)
        ]
        pair = Pair(monkeypatch, chunk_size=32, min_bucket=8)
        first = pair.tick(units, clusters)
        upload = pair.port.upload_bytes["object"]
        drifted = [halve_available(c) if j == 0 else c for j, c in enumerate(clusters)]
        got = pair.tick(units, drifted)
        assert pair.stats["recompute"] == 0 and pair.stats["skip"] == len(units), pair.stats
        assert pair.port.upload_bytes["object"] == upload
        results_equal(got, first)

    def test_sticky_rows_never_recompute(self, monkeypatch):
        units, clusters = make_world(b=32, c=8)
        units = [
            dataclasses.replace(u, sticky_cluster=True, current_clusters={clusters[i % 8].name: 3})
            for i, u in enumerate(units)
        ]
        pair = Pair(monkeypatch, chunk_size=32, min_bucket=8)
        pair.tick(units, clusters)
        drifted = [halve_available(clusters[0])] + clusters[1:]
        got = pair.tick(units, drifted)
        assert pair.stats["gated"] >= 1 and pair.stats["recompute"] == 0, pair.stats
        results_equal(got, pair.fresh(units, drifted))

    def test_finite_max_clusters_rank_refinement(self, monkeypatch):
        units, clusters = make_world(b=24, c=8)
        units = [dataclasses.replace(u, max_clusters=3, tolerations=()) for u in units]
        pair = Pair(monkeypatch, chunk_size=32, min_bucket=8)
        pair.tick(units, clusters)
        drifted = [halve_available(c) if j == 1 else c for j, c in enumerate(clusters)]
        got = pair.tick(units, drifted)
        assert pair.stats["skip"] == len(units), pair.stats
        results_equal(got, pair.fresh(units, drifted))

        def cluster(name, cpu_avail):
            return ClusterState(
                name=name, labels={},
                allocatable=parse_resources({"cpu": "64", "memory": "64Gi"}),
                available=parse_resources({"cpu": str(cpu_avail), "memory": "60Gi"}),
                api_resources=frozenset({GVK}),
            )

        clusters2 = [cluster("lead", 60), cluster("next", 50)]
        units2 = [
            SchedulingUnit(
                gvk=GVK, namespace="ns", name=f"s-{i}", scheduling_mode="Duplicate",
                max_clusters=1, resource_request=parse_resources({"cpu": "100m"}),
            )
            for i in range(6)
        ]
        pair2 = Pair(monkeypatch, chunk_size=32, min_bucket=8)
        before = pair2.tick(units2, clusters2)
        assert all(r.cluster_set == {"lead"} for r in before)
        drifted2 = [cluster("lead", 4), clusters2[1]]
        after = pair2.tick(units2, drifted2)
        assert pair2.stats["recompute"] + pair2.stats["fallback"] > 0, pair2.stats
        assert all(r.cluster_set == {"next"} for r in after)

    def test_finite_k_dynamic_weights_recompute(self, monkeypatch):
        def cluster(name, cpu_avail):
            return ClusterState(
                name=name, labels={},
                allocatable=parse_resources({"cpu": "64", "memory": "256Gi"}),
                available=parse_resources({"cpu": str(cpu_avail), "memory": "128Gi"}),
                api_resources=frozenset({GVK}),
            )

        clusters = [cluster("big", 48), cluster("mid", 24), cluster("sml", 6)]
        units = [
            SchedulingUnit(
                gvk=GVK, namespace="ns", name=f"w-{i}", scheduling_mode=MODE_DIVIDE,
                desired_replicas=100, max_clusters=2,
                resource_request=parse_resources({"cpu": "100m"}),
            )
            for i in range(8)
        ]
        pair = Pair(monkeypatch, chunk_size=32, min_bucket=8)
        before = pair.tick(units, clusters)
        drifted = [cluster("big", 12)] + clusters[1:]
        got = pair.tick(units, drifted)
        assert any(g.clusters != p.clusters for g, p in zip(got, before))
        assert pair.stats["recompute"] + pair.stats["fallback"] > 0, pair.stats
        results_equal(got, pair.fresh(units, drifted))

    def test_empty_drift_dispatches_nothing(self, monkeypatch):
        """A cluster change that leaves the cluster tensors equal (a
        resource no unit requests) is a new view but an empty drift."""
        units, clusters = make_world(b=40, c=8)
        pair = Pair(monkeypatch, chunk_size=16, min_bucket=8)
        first = pair.tick(units, clusters)
        touched = [
            dataclasses.replace(c, available={**c.available, "example.com/widgets": 5})
            if j == 2 else c
            for j, c in enumerate(clusters)
        ]
        skips = pair.port.fetch_stats["skip"]
        got = pair.tick(units, touched)
        assert pair.port.fetch_stats["skip"] - skips == 3 and pair.stats["gated"] == 3
        assert pair.port.last_changed == []
        results_equal(got, first)


class TestSurvivors:
    def test_unified_settles_fit_flips(self, monkeypatch):
        units, clusters = _fitflip_world()
        pair = Pair(monkeypatch, **SURVIVOR_KW)
        _warm(pair, units, clusters)
        drifted = _quarter_cpu(clusters, 3)
        got = pair.tick(units, drifted)
        assert pair.stats["unified"] > 0, pair.stats
        for kind in ("resolve", "replan", "score_only"):
            assert pair.stats[kind] == 0
        stats = pair.port.survivor_stats
        assert 0 < stats["rows"] <= stats["padded_rows"] and stats["groups"] > 0
        assert pair.port.last_changed
        results_equal(got, pair.fresh(units, drifted))

    def test_mixed_modes_ride_one_stream(self, monkeypatch):
        units, clusters = _fitflip_world(b=96, c=24)
        pair = Pair(monkeypatch, **SURVIVOR_KW)
        _warm(pair, units, clusters)
        world = _quarter_cpu(clusters, 3)
        world = [
            dataclasses.replace(c, available=dict(c.allocatable)) if j == 7 else c
            for j, c in enumerate(world)
        ]
        got = pair.tick(units, world)
        assert pair.stats["unified"] > 0, pair.stats
        results_equal(got, pair.fresh(units, world))

    def test_wide_delta_rides_unified(self, monkeypatch):
        units, clusters = _fitflip_world(b=96, c=48)
        pair = Pair(monkeypatch, **SURVIVOR_KW)
        _warm(pair, units, clusters)
        world = [
            dataclasses.replace(
                c,
                available={"cpu": max(1, int(c.available["cpu"] * 0.6)),
                           "memory": c.available["memory"]},
            )
            if j < 10 else c
            for j, c in enumerate(clusters)
        ]
        got = pair.tick(units, world)
        assert pair.stats["gated"] >= 1 and pair.stats["unified"] > 0, pair.stats
        results_equal(got, pair.fresh(units, world))

    def test_planner_spill_falls_back_to_slabs(self, monkeypatch):
        clusters = _clusters(40, cpu=256, avail_fn=lambda j: {"cpu": "200", "memory": "400Gi"})
        units = [
            SchedulingUnit(
                gvk=GVK, namespace="ns", name=f"wide-{i:04d}", scheduling_mode=MODE_DIVIDE,
                desired_replicas=400, resource_request=parse_resources({"cpu": f"{2 + i % 3}"}),
            )
            for i in range(48)
        ]
        pair = Pair(monkeypatch, **{**SURVIVOR_KW, "chunk_size": 64})
        _warm(pair, units, clusters)
        drifted = _quarter_cpu(clusters, 1)
        drifted[1] = dataclasses.replace(
            drifted[1], available=parse_resources({"cpu": "1", "memory": "400Gi"})
        )
        got = pair.tick(units, drifted)
        assert pair.stats["unified_fallback"] > 0, pair.stats
        assert pair.port.survivor_stats["fallback_rows"] > 0
        results_equal(got, pair.fresh(units, drifted))

    def test_nfeas_stays_exact_across_churn_drift_chain(self, monkeypatch):
        rng = np.random.default_rng(5)
        units, clusters = _fitflip_world(b=96, c=24)
        pair = Pair(monkeypatch, **SURVIVOR_KW)
        _warm(pair, units, clusters)
        _nfeas_consistent(pair.port)
        world, cur = list(clusters), list(units)
        for step in range(4):
            if step % 2 == 0:
                cur = list(cur)
                for i in rng.integers(0, len(cur), 7):
                    u = cur[int(i)]
                    cur[int(i)] = dataclasses.replace(
                        u,
                        desired_replicas=int(rng.integers(1, 40)),
                        resource_request=parse_resources({"cpu": f"{1 + int(rng.integers(0, 6))}"}),
                    )
            else:
                world = _quarter_cpu(world, int(rng.integers(0, len(world))))
            got = pair.tick(cur, world)
            if step % 2:
                assert pair.stats["gated"] >= 1, pair.stats
            results_equal(got, pair.fresh(cur, world))
            _nfeas_consistent(pair.port)
        for entry in pair.port._chunk_cache.values():
            assert not entry.stale_rows

    def test_missing_nfeas_is_derived(self, monkeypatch):
        units, clusters = _fitflip_world(b=64, c=20)
        pair = Pair(monkeypatch, **{**SURVIVOR_KW, "chunk_size": 64})
        _warm(pair, units, clusters)
        for entry in pair.port._chunk_cache.values():
            entry.prev_nfeas = None
        drifted = _quarter_cpu(clusters, 3)
        got = pair.tick(units, drifted)
        assert pair.stats["gated"] >= 1
        results_equal(got, pair.fresh(units, drifted))
        _nfeas_consistent(pair.port)


@pytest.mark.parametrize(
    "case",
    [
        pytest.param(getattr(cls(), name), id=f"{cls.__name__}.{name}")
        for cls in (TestDriftTick, TestSurvivors)
        for name in sorted(vars(cls))
        if name.startswith("test_")
    ],
)
def test_case_at_depth_16(case, monkeypatch):
    """Every case above with both engines at the pipelined window's
    default depth: the drift gate's full dispatches (mass-change chunks,
    ungated chunks) and the ticks around it go through the windows."""
    monkeypatch.setattr(sys.modules[__name__], "DEPTH", 16)
    case(monkeypatch)
