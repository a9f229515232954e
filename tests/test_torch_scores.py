"""Score decoding on the port's engine, beside the JAX engine.

Every case of tests/test_engine_cache.py's ``TestScoresCachePaths``,
tests/test_drift_tick.py's ``TestWantScoresBypass`` and the
``want_scores`` case of tests/test_packed_export.py runs on the port's
``SchedulerEngine(device="cpu")`` and on a JAX engine taking the same
ticks, both at the sequential dispatch (port ``pipeline_depth`` 1, JAX
``KT_PIPELINE_DEPTH=1``) and, in ``test_case_at_depth_16``, both at the
pipelined window's default depth of 16.  After every tick the results
and their score dicts, ``last_changed``, the pack-K hints, the overflow
row count, ``tick_seq`` and the cache, fetch, drift and narrow counters
are equal (byte counters are not: the port reads no padding rows).  The
JAX tests' own assertions hold on the port.  Added cases: the toggle
from scores to a plain tick, chunks whose decodes differ in scores
sharing sub-batch slabs, and score-carrying overflow rows (a low wire
width) in several chunks, delta and full fetches in one window.  The
JAX keywords are set as the port's module constants.
"""

import dataclasses
import inspect
import sys

import numpy as np
import pytest

from test_drift_tick import halve_available
from test_engine_cache import make_world
from test_engine_vs_sequential import random_cluster, random_unit
from test_torch_engine import _port

from kubeadmiral_tpu.scheduler.engine import SchedulerEngine as JaxEngine
from kubeadmiral_tpu_torch.scheduler.engine import SchedulerEngine

COUNTERS = ("cache_stats", "fetch_stats", "drift_stats", "narrow_stats")

# The pipeline depth of both engines of a Pair (test_case_at_depth_16
# sets 16).
DEPTH = 1


def scored_equal(got, want):
    """Equal placements and equal score dicts, row by row."""
    assert len(got) == len(want)
    for i, (a, b) in enumerate(zip(got, want)):
        assert dict(a.clusters) == dict(b.clusters), (i, dict(a.clusters), dict(b.clusters))
        assert dict(a.scores) == dict(b.scores), (i, dict(a.scores), dict(b.scores))


def pack_hints(engine) -> dict:
    return {i: e.pack_k_hint for i, e in engine._chunk_cache.items()}


class Pair:
    """The port's engine and the JAX engine taking the same ticks, both
    at pipeline depth DEPTH; ``tick`` holds every observable equal."""

    def __init__(self, monkeypatch, **kw):
        monkeypatch.setenv("KT_PIPELINE_DEPTH", str(DEPTH))
        self.monkeypatch, self.kw = monkeypatch, kw
        self.ref = JaxEngine(mesh=None, flight_recorder=None, devprof=None, **kw)
        self.port = _port(monkeypatch, **kw)
        self.port.pipeline_depth = DEPTH

    def tick(self, units, clusters, fidx=None, **kw):
        """One tick on each engine with the same keywords; ``fidx`` is a
        (port, JAX) pair of follower indices.  Returns the port's."""
        port_f, ref_f = fidx if fidx is not None else (None, None)
        got = self.port.schedule(units, clusters, follower_index=port_f, **kw)
        want = self.ref.schedule(units, clusters, follower_index=ref_f, **kw)
        scored_equal(got, want)
        for name in COUNTERS:
            assert getattr(self.port, name) == getattr(self.ref, name), name
        assert self.port.last_changed == self.ref.last_changed
        assert pack_hints(self.port) == pack_hints(self.ref)
        assert self.port.overflow_rows_total == self.ref.overflow_rows_total
        assert self.port.tick_seq == self.ref.tick_seq
        return got

    def fresh(self, units, clusters, **kw):
        """A fresh port engine's cold tick."""
        return _port(self.monkeypatch, **self.kw).schedule(units, clusters, **kw)


class TestScoresCachePaths:
    """tests/test_engine_cache.py's TestScoresCachePaths on the port."""

    KW = dict(chunk_size=32, min_bucket=8)

    def test_want_scores_toggle_never_replays_stale_placements(self, monkeypatch):
        units, clusters = make_world(b=24, c=6)
        pair = Pair(monkeypatch, **self.KW)
        pair.tick(units, clusters, want_scores=True)
        churned = list(units)
        churned[4] = dataclasses.replace(churned[4], desired_replicas=77)
        with_scores = pair.tick(churned, clusters, want_scores=True)
        plain = pair.tick(churned, clusters, want_scores=False)
        fresh = pair.fresh(churned, clusters)
        assert [r.clusters for r in plain] == [r.clusters for r in fresh]
        assert [r.clusters for r in with_scores] == [r.clusters for r in fresh]
        assert sum(v for v in plain[4].clusters.values() if v) >= 77

    def test_want_scores_retick_takes_noop_path_with_scores(self, monkeypatch):
        units, clusters = make_world(b=24, c=6)
        pair = Pair(monkeypatch, **self.KW)
        first = pair.tick(units, clusters, want_scores=True)
        second = pair.tick(units, clusters, want_scores=True)
        assert pair.port.fetch_stats["noop"] >= 1
        scored_equal(first, second)
        assert any(r.scores for r in second)

    def test_want_scores_churn_takes_subbatch_and_keeps_scores(self, monkeypatch):
        units, clusters = make_world(b=32, c=6)
        pair = Pair(monkeypatch, **self.KW)
        pair.tick(units, clusters, want_scores=True)
        churned = list(units)
        churned[5] = dataclasses.replace(churned[5], desired_replicas=9)
        got = pair.tick(churned, clusters, want_scores=True)
        assert pair.port.fetch_stats["subbatch"] >= 1
        scored_equal(got, pair.fresh(churned, clusters, want_scores=True))

    def test_plain_cache_upgrades_to_scores_via_full_fetch(self, monkeypatch):
        units, clusters = make_world(b=24, c=6)
        pair = Pair(monkeypatch, **self.KW)
        pair.tick(units, clusters)  # prev_has_scores False
        full = pair.port.fetch_stats["full"]
        scored = pair.tick(units, clusters, want_scores=True)
        assert any(r.scores for r in scored)
        assert pair.port.fetch_stats["full"] == full + 1  # one full re-fetch
        before = dict(pair.port.fetch_stats)
        again = pair.tick(units, clusters, want_scores=True)
        assert pair.port.fetch_stats["noop"] > before["noop"]
        scored_equal(scored, again)

    def test_scored_decode_serves_a_plain_tick(self, monkeypatch):
        """Scores, then a plain tick on a fresh list of the same units:
        the gate's key differs, so the chunks replay per chunk, the
        scored decodes included."""
        units, clusters = make_world(b=48, c=6)
        pair = Pair(monkeypatch, **self.KW)
        scored = pair.tick(units, clusters, want_scores=True)
        before = dict(pair.port.fetch_stats)
        plain = pair.tick(list(units), clusters)
        assert pair.port.fetch_stats["noop"] - before["noop"] == 2
        assert pair.port.cache_stats["hit"] == 2
        assert all(a is b for a, b in zip(plain, scored))

    def test_subbatch_strips_scores_of_plain_decodes(self, monkeypatch):
        """Two chunks whose cached decodes differ in scores share the
        sub-batch slabs: the slabs decode scores, and the rows merged
        into the plain decode carry none."""
        units, clusters = make_world(b=64, c=6)
        pair = Pair(monkeypatch, **self.KW)
        pair.tick(units, clusters, want_scores=True)
        mass = list(units)
        for i in range(32, 64):  # chunk 1 re-fetched whole, plain
            mass[i] = dataclasses.replace(units[i], desired_replicas=40 + i % 7)
        pair.tick(mass, clusters)
        assert [pair.port._chunk_cache[i].prev_has_scores for i in (0, 1)] == [True, False]
        churned = list(mass)
        for i in (3, 40):
            churned[i] = dataclasses.replace(mass[i], desired_replicas=13)
        got = pair.tick(churned, clusters)
        assert pair.port.fetch_stats["subbatch"] >= 2
        assert got[3].scores and not got[40].scores
        fresh = pair.fresh(churned, clusters, want_scores=True)
        assert [r.clusters for r in got] == [r.clusters for r in fresh]
        assert got[3].scores == fresh[3].scores


class TestWantScoresBypass:
    def test_want_scores_drift_bypasses_gate_and_stays_exact(self, monkeypatch):
        units, clusters = make_world(b=32, c=8)
        pair = Pair(monkeypatch, chunk_size=32, min_bucket=8)
        pair.tick(units, clusters, want_scores=True)
        drifted = [halve_available(c) if j == 0 else c for j, c in enumerate(clusters)]
        got = pair.tick(units, drifted, want_scores=True)
        assert pair.port.drift_stats["gated"] == 0, pair.port.drift_stats
        scored_equal(got, pair.fresh(units, drifted, want_scores=True))

    def test_plain_drift_after_scores_bypasses_gate(self, monkeypatch):
        """A plain drift tick over scored decodes takes no gate either
        (the stored score dicts would go stale) and keeps the scores."""
        units, clusters = make_world(b=32, c=8)
        pair = Pair(monkeypatch, chunk_size=32, min_bucket=8)
        pair.tick(units, clusters, want_scores=True)
        drifted = [halve_available(c) if j == 0 else c for j, c in enumerate(clusters)]
        got = pair.tick(units, drifted)
        assert pair.port.drift_stats["gated"] == 0, pair.port.drift_stats
        scored_equal(got, pair.fresh(units, drifted, want_scores=True))


def test_packed_want_scores_identical(monkeypatch):
    """tests/test_packed_export.py's want_scores case: the port equals
    the JAX engine in its packed and its dense fetch format."""
    from test_packed_export import make_world as packed_world

    _, units, clusters, _ = packed_world(seed=23)
    kw = dict(chunk_size=16, min_bucket=8, min_cluster_bucket=8, pack_k_min=16)
    pair = Pair(monkeypatch, **kw)
    got = pair.tick(units, clusters, want_scores=True)
    dense = JaxEngine(
        mesh=None, flight_recorder=None, devprof=None, fetch_format="dense", **kw
    ).schedule(units, clusters, want_scores=True)
    scored_equal(got, dense)
    assert any(r.scores for r in got)


def _overflow_world(b=120, c=20, seed=5):
    rng = np.random.default_rng(seed)
    clusters = [random_cluster(rng, j) for j in range(c)]
    names = [cl.name for cl in clusters]
    return rng, [random_unit(rng, i, names) for i in range(b)], clusters, names


def test_score_carrying_overflow_rows(monkeypatch):
    """A wire of K = 8 slots over 20 clusters: rows overflow in every
    chunk, and their re-fetch carries the score plane on a cold scored
    tick (full fetches), a scored churn tick (sub-batch slabs) and a
    scored drift tick with one chunk mass-churned (delta and full
    fetches in one window); a plain tick after it replays the scores."""
    rng, units, clusters, names = _overflow_world()
    pair = Pair(monkeypatch, chunk_size=32, min_bucket=8, pack_k_min=8)
    pair.tick(units, clusters, want_scores=True)
    assert pair.port.overflow_rows_total > 0
    assert pair.port.fetch_stats["full"] == 4

    churned = list(units)
    for i in (1, 40, 77):
        churned[i] = dataclasses.replace(
            units[i], desired_replicas=(units[i].desired_replicas or 1) + 11
        )
    over = pair.port.overflow_rows_total
    got = pair.tick(churned, clusters, want_scores=True)
    assert pair.port.fetch_stats["subbatch"] == 3
    scored_equal(got, pair.fresh(churned, clusters, want_scores=True))

    mass = list(churned)
    for i in range(64, 96):  # chunk 2 mass-churned: a full fetch
        mass[i] = random_unit(rng, 1000 + i, names)
    drifted = [halve_available(c) if j == 0 else c for j, c in enumerate(clusters)]
    before = dict(pair.port.fetch_stats)
    got = pair.tick(mass, drifted, want_scores=True)
    assert pair.port.fetch_stats["full"] > before["full"]
    assert pair.port.fetch_stats["delta"] + pair.port.fetch_stats["skip"] > (
        before["delta"] + before["skip"]
    )
    assert pair.port.overflow_rows_total > over
    scored_equal(got, pair.fresh(mass, drifted, want_scores=True))
    again = pair.tick(list(mass), drifted)
    scored_equal(again, got)


def test_schedule_signature_matches_jax():
    """The same parameters, in the same order, with the same defaults."""
    mine = inspect.signature(SchedulerEngine.schedule).parameters
    theirs = inspect.signature(JaxEngine.schedule).parameters
    assert [(p.name, p.kind, p.default) for p in mine.values()] == [
        (p.name, p.kind, p.default) for p in theirs.values()
    ]


def test_tick_seq_advances_once_per_tick_with_units(monkeypatch):
    units, clusters = make_world(b=24, c=6)
    pair = Pair(monkeypatch, chunk_size=32, min_bucket=8)
    for batch, kw in (
        (units, {}), (units, {}), ([], {}), (units, {"want_scores": True}),
        (units[:5], {"webhook_eval": lambda su, cls: None}), (list(units), {}),
    ):
        pair.port.schedule(batch, clusters, **kw)
        pair.ref.schedule(batch, clusters, **kw)
        assert pair.port.tick_seq == pair.ref.tick_seq
        assert pair.port.last_tick_id == pair.port.tick_seq
    assert pair.port.tick_seq == 5


def test_caller_view_is_used_as_given(monkeypatch):
    """A caller-built ClusterView is used as is: two ticks on the same
    view object replay through the gate; a view over other capacities
    schedules against those capacities, not the cluster list's."""
    from kubeadmiral_tpu.scheduler.featurize import _build_cluster_view as jax_view
    from kubeadmiral_tpu_torch.scheduler.featurize import _build_cluster_view

    units, clusters = make_world(b=40, c=8)
    drifted = [halve_available(c) if j < 3 else c for j, c in enumerate(clusters)]
    pair = Pair(monkeypatch, chunk_size=32, min_bucket=8)
    mine, theirs = _build_cluster_view(drifted, units), jax_view(drifted, units)
    got = pair.port.schedule(units, clusters, view=mine)
    scored_equal(got, pair.ref.schedule(units, clusters, view=theirs))
    scored_equal(got, pair.fresh(units, drifted))
    again = pair.port.schedule(units, clusters, view=mine)
    pair.ref.schedule(units, clusters, view=theirs)
    assert all(a is b for a, b in zip(again, got))
    for name in COUNTERS:
        assert getattr(pair.port, name) == getattr(pair.ref, name), name


_CASES = [
    pytest.param(getattr(cls(), name), id=f"{cls.__name__}.{name}")
    for cls in (TestScoresCachePaths, TestWantScoresBypass)
    for name in sorted(vars(cls))
    if name.startswith("test_")
] + [
    pytest.param(fn, id=fn.__name__)
    for fn in (
        test_packed_want_scores_identical,
        test_score_carrying_overflow_rows,
        test_tick_seq_advances_once_per_tick_with_units,
        test_caller_view_is_used_as_given,
    )
]


@pytest.mark.parametrize("case", _CASES)
def test_case_at_depth_16(case, monkeypatch):
    """Every case above with both engines at the pipelined window's
    default depth: the port's window against the JAX engine's."""
    monkeypatch.setattr(sys.modules[__name__], "DEPTH", 16)
    case(monkeypatch)
