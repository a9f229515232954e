"""The JAX package's streaming front end (``scheduler/streaming.py``)
driven by the port's engine.

``StreamingScheduler`` takes any engine with the JAX engine's surface:
``schedule(units, clusters, follower_index=, dirty_rows=)``,
``tick_seq`` (its dirty-row hint is sound only while no other caller
ticked the engine), ``last_tick_id`` and ``_tick_geometry`` (it grows
its placeholder rows by one engine chunk).  tests/test_streaming.py's
randomized event log (row churn, arrivals, deletes, single-column and
mass capacity drift; its flight-recorder checks are left out: the port
has no flight recorder) runs through two streams, one on the port's CPU
engine and one on a JAX engine; every flush equals the JAX stream's
flush and a fresh port engine's stop-the-world tick, and after the
first flush every flush hands the port's engine the dirty-row hint.
Both at depth 1 and at the window's default depth of 16.
"""

import dataclasses

import numpy as np
import pytest

from test_engine_cache import results_equal
from test_engine_vs_sequential import random_cluster, random_unit
from test_torch_engine import _port

from kubeadmiral_tpu.scheduler.engine import SchedulerEngine as JaxEngine
from kubeadmiral_tpu.scheduler.streaming import StreamingScheduler, is_placeholder
from kubeadmiral_tpu_torch.ops.follower import FollowerIndex
from kubeadmiral_tpu.ops.follower import FollowerIndex as JaxFollowerIndex

KW = dict(chunk_size=32, min_bucket=16, min_cluster_bucket=8)


def _engines(monkeypatch, depth):
    monkeypatch.setenv("KT_PIPELINE_DEPTH", str(depth))
    ref = JaxEngine(mesh=None, flight_recorder=None, devprof=None, **KW)
    port = _port(monkeypatch, **KW)
    port.pipeline_depth = depth
    return port, ref


def _spy_dirty(engine) -> list:
    """Record the dirty_rows argument of every schedule call."""
    seen = []
    real = engine.schedule

    def schedule(units, clusters, **kw):
        seen.append(kw.get("dirty_rows"))
        return real(units, clusters, **kw)

    engine.schedule = schedule
    return seen


@pytest.mark.parametrize("depth", [1, 16])
def test_randomized_event_log_matches_jax_and_stop_the_world(monkeypatch, depth):
    rng = np.random.default_rng(11)
    clusters = [random_cluster(rng, j) for j in range(14)]
    names = [c.name for c in clusters]
    units = [random_unit(rng, i, names) for i in range(64)]
    port, ref = _engines(monkeypatch, depth)
    follows = {5: (1, 2), 40: (33,)}
    fidx = FollowerIndex(follows)
    mine = StreamingScheduler(port, clusters, units, slab_rows=6, slab_age_ms=1e9,
                              follower_index=fidx)
    theirs = StreamingScheduler(ref, clusters, units, slab_rows=6, slab_age_ms=1e9,
                                follower_index=JaxFollowerIndex(follows))
    assert mine.grow_block == theirs.grow_block == port._tick_geometry(14)[1]
    dirty = _spy_dirty(port)
    streams = (mine, theirs)
    results_equal(mine.flush(), theirs.flush())
    results_equal(mine.flush(), theirs.flush())

    arrivals = 0
    for step in range(10):
        kind = step % 5
        if kind == 0:  # updates
            for r in rng.integers(0, 64, 4):
                u = mine.units[int(r)]
                if is_placeholder(u):
                    continue
                new = dataclasses.replace(u, desired_replicas=int(rng.integers(1, 60)))
                for s in streams:
                    s.offer(new)
        elif kind == 1:  # arrivals
            for _ in range(3):
                new = random_unit(rng, 1000 + arrivals, names)
                arrivals += 1
                for s in streams:
                    s.offer(new)
        elif kind == 2:  # deletes
            live = [u for u in mine.units if not is_placeholder(u)]
            for r in rng.integers(0, len(live), 2):
                for s in streams:
                    s.remove(live[int(r)].key)
        elif kind == 3:  # single-column capacity drift + churn
            j = int(rng.integers(0, len(clusters)))
            base = mine.clusters[j]
            new_cluster = dataclasses.replace(
                base, available={k: max(0, v // 2) for k, v in base.available.items()}
            )
            u = mine.units[int(rng.integers(0, 64))]
            new = (
                None if is_placeholder(u)
                else dataclasses.replace(u, desired_replicas=int(rng.integers(1, 60)))
            )
            for s in streams:
                s.update_cluster(new_cluster)
                if new is not None:
                    s.offer(new)
        else:  # mass drift: every column moves
            fleet = [
                dataclasses.replace(
                    c, available={k: max(0, v - v // 7) for k, v in c.available.items()}
                )
                for c in mine.clusters
            ]
            for s in streams:
                s.offer_capacity(fleet)

        got = mine.flush()
        results_equal(got, theirs.flush())
        assert port.last_changed == ref.last_changed
        assert mine.units == theirs.units
        assert port.tick_seq == ref.tick_seq == mine._last_engine_tick
        assert port.last_tick_id == port.tick_seq
        want = _port(monkeypatch, **KW).schedule(mine.units, mine.clusters)
        results_equal(
            [r for i, r in enumerate(got) if i not in follows],
            [r for i, r in enumerate(want) if i not in follows],
        )
        for f, leaders in follows.items():
            union = set()
            for leader in leaders:
                union.update(want[leader].clusters)
            assert set(got[f].clusters) == union
    assert port.drift_stats["gated"] >= 1, port.drift_stats
    assert port.fetch_stats["full"] >= 1
    assert dirty[0] is None  # the first flush: no tick of ours yet
    assert all(d is not None for d in dirty[1:])  # then the hint is taken


def test_hint_dropped_after_another_callers_tick(monkeypatch):
    """A tick by another caller between two flushes advances tick_seq,
    so the next flush walks every row (dirty_rows None)."""
    rng = np.random.default_rng(3)
    clusters = [random_cluster(rng, j) for j in range(8)]
    names = [c.name for c in clusters]
    units = [random_unit(rng, i, names) for i in range(40)]
    port, _ = _engines(monkeypatch, 1)
    stream = StreamingScheduler(port, clusters, units, slab_rows=100, slab_age_ms=1e9)
    dirty = _spy_dirty(port)
    stream.flush()
    stream.offer(dataclasses.replace(units[3], desired_replicas=7))
    stream.flush()
    port.schedule(units[:5], clusters)  # another caller
    stream.offer(dataclasses.replace(units[4], desired_replicas=9))
    got = stream.flush()
    # The stream's flushes and the other caller's tick, in order.
    assert dirty == [None, [3], None, None]
    results_equal(got, _port(monkeypatch, **KW).schedule(stream.units, stream.clusters))


@pytest.mark.parametrize("chunk_size", [None, 32, 1024])
@pytest.mark.parametrize("n_clusters", [1, 7, 12, 300, 500, 600, 5000, 20000])
def test_tick_geometry_matches_jax(monkeypatch, chunk_size, n_clusters):
    """The geometry the stream grows by: (c_bucket, eff_chunk, ladder)
    equal to the JAX engine's.  The port's MEGACHUNK_ROWS stands for
    both JAX's chunk_size and megachunk_rows (4096 each by default), so
    chunk sizes are powers of two here: a JAX chunk_size of 1000 has no
    counterpart."""
    kw = {} if chunk_size is None else {"chunk_size": chunk_size}
    ref = JaxEngine(mesh=None, flight_recorder=None, devprof=None, **kw)
    assert _port(monkeypatch, **kw)._tick_geometry(n_clusters) == ref._tick_geometry(n_clusters)
