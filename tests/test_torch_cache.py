"""The port's chunk cache, no-op replay, sub-batch path and delta fetch
against the JAX engine: each case of tests/test_engine_cache.py run on
the port's ``SchedulerEngine(device="cpu")`` beside a JAX engine taking
the same ticks, both at the sequential dispatch (port ``pipeline_depth``
1, JAX ``KT_PIPELINE_DEPTH=1``) and, in ``test_case_at_depth_16``, both
at the pipelined window's default depth of 16.  Every tick's results
equal the JAX engine's and a fresh port engine's cold tick; the JAX
test's assertions hold on the port; where both engines take the same
path, the cache and fetch counters are equal too.  Both engines take
the same keywords.
"""

import dataclasses
import sys

import pytest

from test_engine_cache import make_world, results_equal
from test_torch_engine import _port

from kubeadmiral_tpu.models.types import ClusterState, parse_resources
from kubeadmiral_tpu.scheduler.engine import SchedulerEngine as JaxEngine
from kubeadmiral_tpu_torch.testing.worlds import build_world


# The pipeline depth of both engines of a pair (test_case_at_depth_16
# sets 16).
DEPTH = 1


def _pair(monkeypatch, cache_bytes=16 << 30, **kw):
    """(the port's engine, the JAX engine) with the same geometry, both
    at pipeline depth DEPTH."""
    monkeypatch.setenv("KT_PIPELINE_DEPTH", str(DEPTH))
    ref = JaxEngine(
        mesh=None, flight_recorder=None, devprof=None, cache_bytes=cache_bytes, **kw
    )
    port = _port(cache_bytes=cache_bytes, **kw)
    port.pipeline_depth = DEPTH
    return port, ref


def _both(engine, ref, units, clusters, **kw):
    """One tick on each engine; results equal; returns the port's."""
    got = engine.schedule(units, clusters, **kw)
    results_equal(got, ref.schedule(units, clusters, **kw))
    return got


def _fresh(monkeypatch, units, clusters, **kw):
    return _port(**kw).schedule(units, clusters)


def _same_counters(engine, ref):
    assert engine.cache_stats == ref.cache_stats
    assert engine.fetch_stats == ref.fetch_stats


class TestEngineCache:
    def test_unchanged_retick_hits_and_matches(self, monkeypatch):
        units, clusters = make_world()
        engine, ref = _pair(monkeypatch, chunk_size=32)
        first = _both(engine, ref, units, clusters)
        resubmitted = [dataclasses.replace(units[0])] + list(units[1:])
        second = _both(engine, ref, resubmitted, clusters)
        assert engine.cache_stats["hit"] >= 2  # both chunks
        results_equal(first, second)
        _same_counters(engine, ref)

    def test_small_churn_patches_and_matches_fresh(self, monkeypatch):
        units, clusters = make_world()
        engine, ref = _pair(monkeypatch, chunk_size=32)
        _both(engine, ref, units, clusters)
        churned = list(units)
        for k in (3, 40):
            churned[k] = dataclasses.replace(
                units[k],
                desired_replicas=(units[k].desired_replicas or 1) + 7,
                resource_request=parse_resources({"cpu": "900m"}),
            )
        got = _both(engine, ref, churned, clusters)
        assert engine.cache_stats["patch"] >= 2
        results_equal(got, _fresh(monkeypatch, churned, clusters, chunk_size=32))
        _same_counters(engine, ref)

    def test_resource_drift_keeps_cache_and_matches_fresh(self, monkeypatch):
        units, clusters = make_world()
        engine, ref = _pair(monkeypatch, chunk_size=32)
        _both(engine, ref, units, clusters)
        drifted = [
            dataclasses.replace(
                cl, available=parse_resources({"cpu": "2", "memory": "8Gi"})
            )
            for cl in clusters
        ]
        got = _both(engine, ref, units, drifted)
        assert engine.cache_stats["hit"] >= 2
        assert engine.cache_stats["miss"] == 2  # only the cold tick
        results_equal(got, _fresh(monkeypatch, units, drifted, chunk_size=32))
        assert engine.cache_stats == ref.cache_stats

    def test_topology_change_invalidates(self, monkeypatch):
        units, clusters = make_world()
        engine, ref = _pair(monkeypatch, chunk_size=32)
        _both(engine, ref, units, clusters)
        relabeled = [
            dataclasses.replace(cl, labels={**cl.labels, "tier": "gold"})
            for cl in clusters
        ]
        got = _both(engine, ref, units, relabeled)
        assert engine.cache_stats["miss"] >= 4  # cold tick + invalidated
        results_equal(got, _fresh(monkeypatch, units, relabeled, chunk_size=32))
        _same_counters(engine, ref)

    def test_mass_churn_falls_back_to_full_featurize(self, monkeypatch):
        units, clusters = make_world()
        engine, ref = _pair(monkeypatch, chunk_size=32)
        _both(engine, ref, units, clusters)
        churned = [dataclasses.replace(u, desired_replicas=50) for u in units]
        got = _both(engine, ref, churned, clusters)
        assert engine.cache_stats["patch"] == 0
        results_equal(got, _fresh(monkeypatch, churned, clusters, chunk_size=32))
        _same_counters(engine, ref)

    def test_delta_fetch_paths_engage_and_match(self, monkeypatch):
        """A re-tick replays with no dispatch, a drift dispatches every
        chunk, a churn rides the sub-batch path, churn with drift takes
        the full dispatch with the delta fetch."""
        units, clusters = make_world()
        engine, ref = _pair(monkeypatch, chunk_size=32)
        _both(engine, ref, units, clusters)
        assert engine.fetch_stats == {
            "noop": 0, "subbatch": 0, "skip": 0, "delta": 0, "full": 2,
        }

        second = _both(engine, ref, units, clusters)
        assert engine.fetch_stats["noop"] == 2
        results_equal(second, _fresh(monkeypatch, units, clusters, chunk_size=32))
        _same_counters(engine, ref)

        drifted = [dataclasses.replace(cl, available=dict(cl.available)) for cl in clusters]
        drifted[0] = dataclasses.replace(
            drifted[0], available=parse_resources({"cpu": "1", "memory": "1Gi"})
        )
        before = dict(engine.fetch_stats)
        third = _both(engine, ref, units, drifted)
        assert engine.fetch_stats["noop"] == before["noop"]
        dispatched = sum(
            engine.fetch_stats[k] - before[k] for k in ("skip", "delta", "full")
        )
        assert dispatched == 2
        results_equal(third, _fresh(monkeypatch, units, drifted, chunk_size=32))

        _both(engine, ref, units, clusters)

        churned = list(units)
        churned[5] = dataclasses.replace(
            units[5], desired_replicas=37,
            resource_request=parse_resources({"cpu": "700m"}),
        )
        before = dict(engine.fetch_stats)
        got = _both(engine, ref, churned, clusters)
        assert engine.fetch_stats["subbatch"] >= 1
        assert engine.fetch_stats["subbatch"] - before["subbatch"] == (
            ref.fetch_stats["subbatch"] - before["subbatch"]
        )
        results_equal(got, _fresh(monkeypatch, churned, clusters, chunk_size=32))

        churned2 = list(churned)
        churned2[7] = dataclasses.replace(churned[7], desired_replicas=11)
        drifted = list(clusters)
        drifted[0] = dataclasses.replace(
            clusters[0], available=parse_resources({"cpu": "2", "memory": "4Gi"})
        )
        before = dict(engine.fetch_stats)
        got2 = _both(engine, ref, churned2, drifted)
        assert engine.fetch_stats["subbatch"] == before["subbatch"]
        assert sum(engine.fetch_stats[k] for k in ("skip", "delta", "full")) > sum(
            before[k] for k in ("skip", "delta", "full")
        )
        results_equal(got2, _fresh(monkeypatch, churned2, drifted, chunk_size=32))

    def test_results_are_immutable_shared_views(self, monkeypatch):
        units, clusters = make_world(b=8)
        engine, ref = _pair(monkeypatch, chunk_size=8)
        first = _both(engine, ref, units, clusters)
        with pytest.raises(TypeError):
            first[0].clusters["poison"] = 1
        with pytest.raises(dataclasses.FrozenInstanceError):
            first[0].clusters = {}
        second = _both(engine, ref, units, clusters)
        assert "poison" not in second[0].clusters
        assert second[0] is first[0]  # replayed, shared

    def test_cache_budget_zero_disables(self, monkeypatch):
        units, clusters = make_world()
        engine, ref = _pair(monkeypatch, chunk_size=32, cache_bytes=0)
        first = _both(engine, ref, units, clusters)
        second = _both(engine, ref, list(units), clusters)
        assert engine.cache_stats["hit"] == 0
        assert engine._chunk_cache == {}
        results_equal(first, second)
        _same_counters(engine, ref)


class TestLazyDeviceRepair:
    def test_drift_after_churn_matches_fresh(self, monkeypatch):
        """A churn tick (sub-batch, eager input repair) then a drift tick
        that reuses the repaired device inputs: results exact."""
        units, clusters = make_world(b=48, c=8)
        kw = dict(chunk_size=64, min_bucket=8)
        engine, ref = _pair(monkeypatch, **kw)
        _both(engine, ref, units, clusters)
        _both(engine, ref, units, clusters)
        churned = list(units)
        for i in (2, 7, 11):
            churned[i] = dataclasses.replace(churned[i], desired_replicas=50 + i)
        _both(engine, ref, churned, clusters)
        assert engine.fetch_stats["subbatch"] >= 1
        assert engine._chunk_cache[0].stale_rows is None  # repaired eagerly
        _same_counters(engine, ref)
        drifted = list(clusters)
        drifted[0] = dataclasses.replace(
            drifted[0],
            available={k: max(0, v // 3) for k, v in drifted[0].available.items()},
        )
        upload = engine.upload_bytes["object"]
        got = _both(engine, ref, churned, drifted)
        assert engine.upload_bytes["object"] == upload  # device inputs reused
        results_equal(got, _fresh(monkeypatch, churned, drifted, **kw))
        churned2 = list(churned)
        churned2[5] = dataclasses.replace(churned2[5], desired_replicas=33)
        got2 = _both(engine, ref, churned2, drifted)
        results_equal(got2, _fresh(monkeypatch, churned2, drifted, **kw))


def test_drift_after_churn_fetches_delta_not_full(monkeypatch):
    """Cold, churn (sub-batch, prev planes written back), then a drift:
    the drift dispatch delta-fetches, never the whole chunk."""
    units, clusters = make_world(b=48, c=10)
    engine, ref = _pair(monkeypatch, min_bucket=8)
    _both(engine, ref, units, clusters)
    churned = list(units)
    churned[3] = dataclasses.replace(churned[3], desired_replicas=40)
    churned[17] = dataclasses.replace(churned[17], desired_replicas=1)
    _both(engine, ref, churned, clusters)
    assert engine.fetch_stats["subbatch"] >= 1, engine.fetch_stats
    full_before = engine.fetch_stats["full"]
    drifted = [
        dataclasses.replace(
            c, available={k: max(0, v // 2) for k, v in c.available.items()}
        )
        if i == 0
        else c
        for i, c in enumerate(clusters)
    ]
    got = _both(engine, ref, churned, drifted)
    assert got == _fresh(monkeypatch, churned, drifted, min_bucket=8)
    assert engine.fetch_stats["delta"] >= 1, engine.fetch_stats
    assert engine.fetch_stats["full"] == full_before, engine.fetch_stats


def test_label_churn_miss_carries_prev_outputs(monkeypatch):
    """A topology miss over unchanged cluster names keeps the previous
    outputs: the re-dispatch skips or delta-fetches."""
    units, clusters = make_world(b=48, c=10)
    engine, ref = _pair(monkeypatch, min_bucket=8)
    _both(engine, ref, units, clusters)
    full_before = engine.fetch_stats["full"]
    relabeled = [
        dataclasses.replace(c, labels=dict(c.labels, extra="yes")) if i == 1 else c
        for i, c in enumerate(clusters)
    ]
    got = _both(engine, ref, units, relabeled)
    assert got == _fresh(monkeypatch, units, relabeled, min_bucket=8)
    assert engine.cache_stats["miss"] >= 2, engine.cache_stats
    assert engine.fetch_stats["full"] == full_before, engine.fetch_stats
    assert engine.fetch_stats["delta"] + engine.fetch_stats["skip"] >= 1
    _same_counters(engine, ref)
    assert engine.last_changed == ref.last_changed


def test_renamed_fleet_never_reuses_stale_decodes(monkeypatch):
    """A renamed fleet with the same output pattern is not carried: the
    decodes map columns to names."""
    units, _ = make_world(b=4, c=2)
    engine, ref = _pair(monkeypatch, min_bucket=8)
    fleet_a = [
        ClusterState(
            name=n,
            labels={},
            allocatable=parse_resources({"cpu": "64", "memory": "256Gi"}),
            available=parse_resources({"cpu": "32", "memory": "128Gi"}),
            api_resources=frozenset({"apps/v1/Deployment"}),
        )
        for n in ("slow", "fast")
    ]
    fleet_b = [dataclasses.replace(c, name=n) for c, n in zip(fleet_a, ("small", "big"))]
    res_a = _both(engine, ref, units, fleet_a)
    res_b = _both(engine, ref, units, fleet_b)
    assert {n for r in res_b for n in r.clusters} <= {"small", "big"}
    assert res_b == _fresh(monkeypatch, units, fleet_b, min_bucket=8)
    assert res_a != res_b
    _same_counters(engine, ref)


def test_whole_batch_noop_gate_is_identity_keyed(monkeypatch):
    """The same list against the same view replays in O(1) into a fresh
    list of shared rows; a fresh list with a changed row falls through."""
    units, clusters = make_world(40, 6)
    engine, ref = _pair(monkeypatch, chunk_size=16, min_bucket=8)
    first = _both(engine, ref, units, clusters)
    noops_before = engine.fetch_stats["noop"]
    again = _both(engine, ref, units, clusters)
    assert again == first and again is not first
    assert again[0] is first[0]
    assert engine.fetch_stats["noop"] > noops_before
    assert engine.last_changed == []
    walks = engine.cache_stats["hit"]
    _both(engine, ref, list(units), clusters)  # fresh list, same objects
    assert engine.cache_stats["hit"] == walks  # replayed by the id arm
    churned = list(units)
    row = next(i for i, u in enumerate(units) if u.scheduling_mode == "Divide")
    churned[row] = dataclasses.replace(
        churned[row], desired_replicas=(churned[row].desired_replicas or 1) + 5
    )
    changed = _both(engine, ref, churned, clusters)
    assert changed is not first
    assert sum(r != f for r, f in zip(changed, first)) >= 1
    _same_counters(engine, ref)
    assert engine.last_changed == ref.last_changed == [row]


def test_warm_fallback_rows_are_fetched(monkeypatch):
    """A narrow full dispatch on warm chunks whose outputs do not change
    (a label no unit selects on, so the miss carries the prev planes):
    rows the certificate sends to the dense re-solve are fetched whatever
    the diff says, as in the JAX engine, and are the tick's changed rows."""
    units, clusters, _ = build_world(300, 40, "3", seed=1)
    kw = dict(chunk_size=128, narrow_m=8)  # M = 32 on a bucket of 64
    engine, ref = _pair(monkeypatch, **kw)
    cold = _both(engine, ref, units, clusters)
    assert engine.narrow_stats["fallback"] > 0
    solved = []
    real = engine._apply_cert_fallback

    def spy(out, cert_np, device_in, fmt, n, timings):
        out, rows = real(out, cert_np, device_in, fmt, n, timings)
        if rows is not None:
            solved.extend(rows.tolist())
        return out, rows

    monkeypatch.setattr(engine, "_apply_cert_fallback", spy)
    relabeled = [
        dataclasses.replace(cl, labels={**cl.labels, "extra": "1"}) if j == 1 else cl
        for j, cl in enumerate(clusters)
    ]
    before = dict(engine.fetch_stats)
    got = _both(engine, ref, units, relabeled)
    results_equal(got, _fresh(monkeypatch, units, relabeled, **kw))
    results_equal(got, cold)  # no output moved ...
    assert solved  # ... yet the re-solved rows ...
    assert engine.fetch_stats["delta"] > before["delta"]  # ... were fetched
    assert len(engine.last_changed) == len(solved)
    assert engine.last_changed == ref.last_changed
    _same_counters(engine, ref)
    assert engine.narrow_stats == ref.narrow_stats


_CASES = [
    pytest.param(getattr(cls(), name), id=f"{cls.__name__}.{name}")
    for cls in (TestEngineCache, TestLazyDeviceRepair)
    for name in sorted(vars(cls))
    if name.startswith("test_")
] + [
    pytest.param(fn, id=fn.__name__)
    for fn in (
        test_drift_after_churn_fetches_delta_not_full,
        test_label_churn_miss_carries_prev_outputs,
        test_renamed_fleet_never_reuses_stale_decodes,
        test_whole_batch_noop_gate_is_identity_keyed,
        test_warm_fallback_rows_are_fetched,
    )
]


@pytest.mark.parametrize("case", _CASES)
def test_case_at_depth_16(case, monkeypatch):
    """Every case above with both engines at the pipelined window's
    default depth: the port's window against the JAX engine's."""
    monkeypatch.setattr(sys.modules[__name__], "DEPTH", 16)
    case(monkeypatch)
