"""The port's follower union (``kubeadmiral_tpu_torch/ops/follower.py``)
against the JAX package's (``kubeadmiral_tpu/ops/follower.py``): the
cases of tests/test_follower_ops.py on both indices (the union, the
bipartite check, the incremental recompute driven by changed rows), and
the union applied by the engine (``schedule(follower_index=)``) over
cold, no-op, churn and drift ticks, the port's engine beside the JAX
engine (``test_torch_scores.Pair``), at depth 1 and 16.
"""

import dataclasses

import pytest

import test_torch_scores
from test_drift_tick import halve_available
from test_follower_ops import make_world, naive_union
from test_torch_scores import Pair

from kubeadmiral_tpu.ops.follower import FollowerIndex as JaxFollowerIndex
from kubeadmiral_tpu.scheduler.engine import ScheduleResult as JaxResult
from kubeadmiral_tpu_torch.ops.follower import FollowerIndex
from kubeadmiral_tpu_torch.scheduler.engine import ScheduleResult


def _results(cls, n, pattern):
    return [cls(clusters=pattern(i)) for i in range(n)]


def _clusters_of(results):
    return [dict(r.clusters) for r in results]


def test_union_matches_jax_and_naive():
    follows = {3: (0, 1, 2), 7: (4, 5), 11: (8,)}

    def pattern(i):
        return {f"c{i % 3}": i, f"c{(i + 1) % 3}": 1}

    mine = FollowerIndex(follows).apply(_results(ScheduleResult, 12, pattern), changed=None)
    theirs = JaxFollowerIndex(follows).apply(_results(JaxResult, 12, pattern), changed=None)
    assert _clusters_of(mine) == _clusters_of(theirs)
    assert _clusters_of(mine) == _clusters_of(
        naive_union(_results(JaxResult, 12, pattern), follows)
    )
    assert all(v is None for f in follows for v in mine[f].clusters.values())
    with pytest.raises(TypeError):
        mine[3].clusters["c9"] = None  # frozen, as the engine's results


def test_bipartite_enforced_as_jax():
    for follows in ({3: (1, 2), 2: (0,)}, {1: (0,), 0: (5,)}):
        with pytest.raises(ValueError) as mine:
            FollowerIndex(follows)
        with pytest.raises(ValueError) as theirs:
            JaxFollowerIndex(follows)
        assert str(mine.value) == str(theirs.value)


@pytest.mark.parametrize("changed", [None, [], [0], [4, 5], [9]])
def test_incremental_affected_matches_jax(changed):
    follows = {3: (0, 1), 7: (4, 5), 8: (0, 5)}
    mine, theirs = FollowerIndex(follows), JaxFollowerIndex(follows)
    assert set(mine.affected(changed)) == set(theirs.affected(changed))  # cold
    r1 = _results(ScheduleResult, 10, lambda i: {"a": 1})
    j1 = _results(JaxResult, 10, lambda i: {"a": 1})
    mine.apply(r1, changed=None)
    theirs.apply(j1, changed=None)
    cached = dict(mine._cache)
    assert set(mine.affected(changed)) == set(theirs.affected(changed))
    r2, j2 = list(r1), list(j1)
    for row in changed or ():
        r2[row] = ScheduleResult(clusters={f"b{row}": 2})
        j2[row] = JaxResult(clusters={f"b{row}": 2})
    out = mine.apply(r2, changed=changed)
    assert _clusters_of(out) == _clusters_of(theirs.apply(j2, changed=changed))
    stale = set(mine.affected(changed))
    for f in follows:
        assert (mine._cache[f] is cached[f]) == (f not in stale)


def test_engine_applies_the_union_over_ticks(monkeypatch):
    """tests/test_follower_ops.py's engine integration, extended by a
    fresh list, a second churn, a drift and a mass churn: follower rows
    equal their leaders' union after every tick, the no-op replays the
    cached union, and a new index object is not the gate's."""
    units, clusters = make_world(b=40)
    follows = {11: (8, 9, 10), 30: (3, 25), 39: (0,)}
    pair = Pair(monkeypatch, chunk_size=8)
    fidx = (FollowerIndex(follows), JaxFollowerIndex(follows))

    def unions_hold(results):
        for f, leaders in follows.items():
            want = set()
            for leader in leaders:
                want.update(results[leader].clusters)
            assert set(results[f].clusters) == want
            assert all(v is None for v in results[f].clusters.values())

    r1 = pair.tick(units, clusters, fidx=fidx)
    unions_hold(r1)
    assert pair.port.last_changed is None
    r2 = pair.tick(units, clusters, fidx=fidx)
    assert pair.port.last_changed == []
    assert r2[11] is r1[11]
    noop = pair.port.fetch_stats["noop"]
    pair.tick(units, clusters, fidx=(FollowerIndex(follows), JaxFollowerIndex(follows)))
    assert pair.port.fetch_stats["noop"] == noop + 5  # a chunk walk, not the gate
    churned = list(units)
    churned[9] = dataclasses.replace(units[9], desired_replicas=units[9].desired_replicas + 50)
    r3 = pair.tick(churned, clusters, fidx=fidx)
    assert 9 in pair.port.last_changed
    unions_hold(r3)
    churned2 = list(churned)
    for i in (3, 25):
        churned2[i] = dataclasses.replace(churned[i], desired_replicas=1)
    unions_hold(pair.tick(churned2, clusters, fidx=fidx))
    drifted = [halve_available(c) if j == 0 else c for j, c in enumerate(clusters)]
    unions_hold(pair.tick(churned2, drifted, fidx=fidx))
    mass = [dataclasses.replace(u, desired_replicas=u.desired_replicas + 3) for u in churned2]
    unions_hold(pair.tick(mass, drifted, fidx=fidx))
    assert pair.port.timings["follower"] >= 0.0


def test_case_at_depth_16(monkeypatch):
    """The engine case with both engines at the window's default depth."""
    monkeypatch.setattr(test_torch_scores, "DEPTH", 16)
    test_engine_applies_the_union_over_ticks(monkeypatch)
