"""The pipelined dispatch window of the port's engine against the JAX
engine's, on the CPU.

Each case runs the port's ``SchedulerEngine(device="cpu")`` with
``pipeline_depth`` set and a JAX engine built under the same
``KT_PIPELINE_DEPTH``, tick by tick: results, ``last_changed``, the
chunks' pack-K hints, ``overflow_rows_total`` and the cache, fetch,
narrow, drift and survivor counters are equal.  The cases: the JAX
package's pipelined-vs-sequential test (depth 3), a window of one chunk
and a tick whose chunk count is not a multiple of the depth, a window
mixing skip, delta and full fetches, certificate fallbacks and
K-overflow rows in several chunks of one window, the cache budget
(none, and one that holds some chunks of a tick), and planner rows that
outlast the round budget (the chunk is dispatched again at its drain).
The JAX keywords are set as the port's module constants.
"""

import dataclasses

import pytest

from test_engine import mk_cluster, mk_unit
from test_engine_cache import make_world, results_equal
from test_torch_engine import _port

from kubeadmiral_tpu.models.types import MODE_DIVIDE
from kubeadmiral_tpu.scheduler.engine import SchedulerEngine as JaxEngine
from kubeadmiral_tpu_torch.scheduler import engine as engine_mod
from kubeadmiral_tpu_torch.testing.sample_counts import recorded_dispatches
from kubeadmiral_tpu_torch.testing.worlds import build_world

COUNTERS = ("cache_stats", "fetch_stats", "narrow_stats", "drift_stats", "survivor_stats")


def _hints(engine):
    return [e.pack_k_hint for _, e in sorted(engine._chunk_cache.items())]


class Pair:
    """The port's engine and the JAX engine at pipeline depth ``depth``;
    ``windows`` records the size of every window the port drains."""

    def __init__(self, monkeypatch, depth, cache_bytes=16 << 30, **kw):
        monkeypatch.setenv("KT_PIPELINE_DEPTH", str(depth))
        self.ref = JaxEngine(
            mesh=None, flight_recorder=None, devprof=None, cache_bytes=cache_bytes, **kw
        )
        assert self.ref.pipeline_depth == depth
        self.port = _port(monkeypatch, **kw)
        self.port.pipeline_depth = depth
        self.windows = []
        drain = self.port._drain_window

        def recorded(items, *args):
            if items:
                self.windows.append(len(items))
            return drain(items, *args)

        monkeypatch.setattr(self.port, "_drain_window", recorded)

    def tick(self, units, clusters):
        got = self.port.schedule(units, clusters)
        results_equal(got, self.ref.schedule(units, clusters))
        for name in COUNTERS:
            assert getattr(self.port, name) == getattr(self.ref, name), name
        assert self.port.last_changed == self.ref.last_changed
        assert self.port.overflow_rows_total == self.ref.overflow_rows_total
        assert _hints(self.port) == _hints(self.ref)
        return got

    def windows_of(self, units, clusters):
        """The window sizes of one tick."""
        start = len(self.windows)
        self.tick(units, clusters)
        return self.windows[start:]


def test_pipelined_chunks_match_sequential(monkeypatch):
    """tests/test_engine.py's case: depth 3 against depth 1 on the port,
    and the port at depth 3 against JAX at depth 3, cold and churn."""
    clusters = [mk_cluster(f"c{i}") for i in range(7)]
    units = [
        mk_unit(
            f"obj-{i}",
            scheduling_mode=MODE_DIVIDE,
            desired_replicas=(i % 13) + 1,
            avoid_disruption=False,
        )
        for i in range(50)
    ]
    kw = dict(chunk_size=16, min_bucket=8)
    piped = Pair(monkeypatch, 3, **kw)
    seq = _port(monkeypatch, **kw)
    seq.pipeline_depth = 1
    assert seq.schedule(units, clusters) == piped.tick(units, clusters)
    assert piped.windows == [3, 1]
    churned = list(units)
    churned[5] = dataclasses.replace(churned[5], desired_replicas=40)
    churned[30] = dataclasses.replace(churned[30], desired_replicas=2)
    got = piped.tick(churned, clusters)
    assert seq.schedule(churned, clusters) == got


@pytest.mark.parametrize(
    "objects,depth,windows",
    [(12, 16, [1]), (72, 2, [2, 2, 1]), (72, 4, [4, 1]), (72, 5, [5])],
    ids=["one-chunk", "depth-2", "depth-4", "depth-5"],
)
def test_window_sizes_follow_the_depth(objects, depth, windows, monkeypatch):
    """A window of one chunk, and chunk counts that are and are not a
    multiple of the depth; a relabel then dispatches every chunk again
    through windows of the same sizes (delta against the kept planes)."""
    units, clusters = make_world(b=objects, c=12)
    pair = Pair(monkeypatch, depth, chunk_size=16, min_bucket=8)
    assert pair.windows_of(units, clusters) == windows
    relabeled = [
        dataclasses.replace(cl, labels={**cl.labels, "extra": "1"}) for cl in clusters
    ]
    assert pair.windows_of(units, relabeled) == windows
    assert pair.port.fetch_stats["full"] == len(pair.port._chunk_cache)


def test_one_window_mixes_skip_delta_and_full(monkeypatch):
    """A relabel (a topology miss that keeps the previous planes) with
    no unit changed in chunk 0, three in chunk 1 and every unit in chunk
    2: one window of three chunks takes skip, delta and full."""
    units, clusters = make_world(b=192, c=12)
    pair = Pair(monkeypatch, 16, chunk_size=64, min_bucket=8)
    pair.tick(units, clusters)
    relabeled = [
        dataclasses.replace(cl, labels={**cl.labels, "extra": "1"}) if j == 3 else cl
        for j, cl in enumerate(clusters)
    ]
    churned = list(units)
    for i in (64 + 1, 64 + 2, 64 + 4):
        churned[i] = dataclasses.replace(units[i], desired_replicas=units[i].desired_replicas + 9)
    for i in range(128, 192):
        churned[i] = dataclasses.replace(units[i], desired_replicas=units[i].desired_replicas + 1)
    before = dict(pair.port.fetch_stats)
    assert pair.windows_of(churned, relabeled) == [3]
    paths = {k: v - before[k] for k, v in pair.port.fetch_stats.items() if v - before[k]}
    assert paths == {"skip": 1, "delta": 1, "full": 1}


def test_certificate_fallback_in_several_chunks_of_a_window(monkeypatch):
    """M = 8 over 48 clusters, every seventh row a Divide row on dynamic
    weights over all of them (the rest Duplicate): those rows fail the
    certificate in every chunk of the window, in different numbers;
    their dense re-solve lands on the right chunk, and on a warm relabel
    that moves no placement the re-solved rows, and only they, are
    fetched (the forced mask bits) and reported changed, as in the JAX
    engine."""
    units, clusters = make_world(b=96, c=48)
    units = [
        dataclasses.replace(u, scheduling_mode=MODE_DIVIDE, desired_replicas=97, weights={})
        if i % 7 == 0
        else dataclasses.replace(u, scheduling_mode="Duplicate")
        for i, u in enumerate(units)
    ]
    pair = Pair(monkeypatch, 16, chunk_size=32, narrow_m=8)
    solved = []
    real = pair.port._apply_cert_fallback

    def spy(out, cert_np, device_in, fmt, n, timings):
        out, rows = real(out, cert_np, device_in, fmt, n, timings)
        solved.append(0 if rows is None else len(rows))
        return out, rows

    monkeypatch.setattr(pair.port, "_apply_cert_fallback", spy)
    assert pair.windows_of(units, clusters) == [3]
    assert len(solved) == 3 and all(solved) and len(set(solved)) > 1, solved
    solved.clear()
    relabeled = [
        dataclasses.replace(cl, labels={**cl.labels, "extra": "1"}) if j == 1 else cl
        for j, cl in enumerate(clusters)
    ]
    pair.tick(units, relabeled)
    assert len(solved) == 3 and all(solved), solved
    assert pair.port.last_changed == list(range(0, 96, 7))


def test_overflow_rows_in_several_chunks_of_a_window(monkeypatch):
    """Rows selecting more clusters than the wire's K slots in several
    chunks of one window: their re-fetch is one batched gather."""
    units, clusters, _ = build_world(300, 40, "3", seed=3)
    pair = Pair(monkeypatch, 16, chunk_size=64, pack_k_min=8)
    batches = []
    real = pair.port._fetch_overflow_window

    def spy(jobs, timings):
        if jobs:
            batches.append(len(jobs))
        return real(jobs, timings)

    monkeypatch.setattr(pair.port, "_fetch_overflow_window", spy)
    pair.tick(units, clusters)
    assert batches and max(batches) >= 2, batches
    assert pair.port.overflow_rows_total > 0


@pytest.mark.parametrize("entries", [0, 2.5], ids=["no-cache", "some-chunks"])
def test_cache_budget_inside_a_window(entries, monkeypatch):
    """A budget of no entry, and one of two and a half full chunks (it
    holds some of a tick's five chunks, not all): entries are stored at the drain, charged and evicted in the
    JAX engine's order (mass churn and a relabel miss every chunk, each
    miss evicting its old entry before re-admitting it)."""
    units, clusters = make_world(b=72, c=12)
    kw = dict(chunk_size=16, min_bucket=8)
    probe = _port(monkeypatch, **kw)
    probe.schedule(units, clusters)
    budget = int(entries * probe._chunk_cache[0].nbytes)
    monkeypatch.setattr(engine_mod, "CACHE_BYTES", budget)
    pair = Pair(monkeypatch, 16, cache_bytes=budget, **kw)
    churned = [dataclasses.replace(u, desired_replicas=u.desired_replicas + 2) for u in units]
    relabeled = [dataclasses.replace(cl, labels={**cl.labels, "x": "y"}) for cl in clusters]
    for batch, cl in (
        (units, clusters), (list(units), clusters), (churned, clusters), (churned, relabeled),
    ):
        pair.tick(batch, cl)
        assert sorted(pair.port._chunk_cache) == sorted(pair.ref._chunk_cache)
        assert pair.port._cache_used == pair.ref._cache_used
    assert (len(pair.port._chunk_cache) > 0) == (entries > 0)
    assert len(pair.port._chunk_cache) < 5


@pytest.mark.parametrize("rounds", [0, 1])
def test_planner_rows_past_the_budget_are_dispatched_again(rounds, monkeypatch):
    """With the round budget cut to ``rounds``, windowed chunks whose
    planner rows are still going are dispatched again at their drain
    with the checked loop: results and counters still equal JAX's, one
    extra tick dispatch per re-dispatched chunk."""
    monkeypatch.setattr(engine_mod, "PLANNER_ROUNDS", rounds)
    units, clusters, _ = build_world(300, 40, "3", seed=1)
    pair = Pair(monkeypatch, 16, chunk_size=64, narrow_m=8)
    with recorded_dispatches() as calls:
        pair.tick(units, clusters)
    reruns = pair.port.planner_reruns
    assert reruns > 0
    fallbacks = pair.port.narrow_stats["fallback"]
    narrow = [c for c in calls if c[0] == "narrow"]
    assert len(narrow) == 5 + reruns
    assert len(calls) - len(narrow) >= (fallbacks > 0)


def test_depth_one_is_the_sequential_path(monkeypatch):
    """At depth 1 every chunk drains alone as a window of one, no round
    budget runs, and every counter equals the JAX engine's sequential
    dispatch."""
    units, clusters = make_world(b=72, c=12)
    pair = Pair(monkeypatch, 1, chunk_size=16, min_bucket=8)
    budgets = []
    real = engine_mod.RoundBudget

    def counted(rounds):
        budgets.append(rounds)
        return real(rounds)

    monkeypatch.setattr(engine_mod, "RoundBudget", counted)
    pair.tick(units, clusters)
    relabeled = [dataclasses.replace(cl, labels={**cl.labels, "x": "y"}) for cl in clusters]
    pair.tick(units, relabeled)
    assert pair.windows == [1] * 10 and budgets == [] and pair.port.planner_reruns == 0
