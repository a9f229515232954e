"""The streaming front end on the port (``scheduler/streaming.py``).

The port's ``StreamingScheduler`` over the port's CPU engine, beside the
JAX package's ``StreamingScheduler`` over a JAX engine, each engine with
a flight recorder of its package.  tests/test_streaming.py's randomized
event log (row churn, arrivals, deletes, single-column and mass
capacity drift) goes through both streams, each in the types of its
package; every flush equals the JAX stream's flush (results,
``last_changed``, the unit list, tick ids) and a fresh port engine's
stop-the-world tick, and the flight-recorder records of every row the
flush re-decided equal both the JAX engine's and the fresh engine's
(tests/test_streaming.py's flight-recorder checks).  After the first
flush every flush hands the port's engine the dirty-row hint.  Both at
depth 1 and at the window's default depth of 16.  Also: the slab
mechanics cases of tests/test_streaming.py on the port's classes, the
placeholder block (one engine chunk: ``MEGACHUNK_ROWS``), the dropped
hint after another caller's tick, the tenant ledger's flush counts
against JAX's, and the port's ``_tick_geometry`` against JAX's.
"""

import dataclasses

import numpy as np
import pytest

import test_streaming as jax_streaming_tests
from test_engine_cache import results_equal
from test_engine_vs_sequential import random_cluster, random_unit
from test_torch_engine import _port

from kubeadmiral_tpu.ops.follower import FollowerIndex as JaxFollowerIndex
from kubeadmiral_tpu.runtime import tenancy as jax_tenancy
from kubeadmiral_tpu.runtime.devprof import DispatchLedger as JaxLedger
from kubeadmiral_tpu.runtime.flightrec import FlightRecorder as JaxRecorder
from kubeadmiral_tpu.scheduler.engine import SchedulerEngine as JaxEngine
from kubeadmiral_tpu.scheduler.streaming import StreamingScheduler as JaxStreamingScheduler
from kubeadmiral_tpu_torch.models import types as port_types
from kubeadmiral_tpu_torch.ops.follower import FollowerIndex
from kubeadmiral_tpu_torch.runtime import tenancy
from kubeadmiral_tpu_torch.runtime.devprof import DispatchLedger
from kubeadmiral_tpu_torch.runtime.flightrec import FlightRecorder
from kubeadmiral_tpu_torch.scheduler import engine as engine_mod
from kubeadmiral_tpu_torch.scheduler import streaming
from kubeadmiral_tpu_torch.scheduler.streaming import StreamingScheduler, is_placeholder

KW = dict(chunk_size=32, min_bucket=16, min_cluster_bucket=8)


def to_port(x):
    """A JAX package value (a ``models.types`` dataclass, or containers
    of them) as the same value in the port's types."""
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        cls = getattr(port_types, type(x).__name__)
        return cls(**{f.name: to_port(getattr(x, f.name)) for f in dataclasses.fields(x)})
    if isinstance(x, tuple):
        return tuple(to_port(v) for v in x)
    if isinstance(x, list):
        return [to_port(v) for v in x]
    if isinstance(x, dict):
        return {k: to_port(v) for k, v in x.items()}
    return x


def _engines(monkeypatch, depth, port_rec=None, ref_rec=None):
    monkeypatch.setenv("KT_PIPELINE_DEPTH", str(depth))
    # Each engine its own dispatch ledger: its tick ids are then the
    # engine's tick count.
    ref = JaxEngine(mesh=None, flight_recorder=ref_rec, devprof=JaxLedger(enabled=True), **KW)
    port = _port(monkeypatch, **KW)
    port.devprof = DispatchLedger()
    port.flightrec = port_rec
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


def record_fields(rec, replan_topk: bool = True) -> tuple:
    topk = (rec.topk_idx.tolist(), rec.topk_scores.tolist()) if replan_topk else ()
    return (
        dict(rec.placements), rec.reason_counts.tolist(), int(rec.feasible_n), topk,
    )


class Streams:
    """The port's stream (port types) and the JAX stream (JAX types),
    fed the same events."""

    def __init__(self, mine, theirs):
        self.mine, self.theirs = mine, theirs

    def offer(self, unit):
        self.mine.offer(to_port(unit))
        self.theirs.offer(unit)

    def remove(self, key):
        self.mine.remove(key)
        self.theirs.remove(key)

    def update_cluster(self, cluster):
        self.mine.update_cluster(to_port(cluster))
        self.theirs.update_cluster(cluster)

    def offer_capacity(self, fleet):
        self.mine.offer_capacity(to_port(fleet))
        self.theirs.offer_capacity(fleet)


@pytest.mark.parametrize("depth", [1, 16])
def test_randomized_event_log_matches_jax_and_stop_the_world(monkeypatch, depth):
    rng = np.random.default_rng(11)
    clusters = [random_cluster(rng, j) for j in range(14)]
    names = [c.name for c in clusters]
    units = [random_unit(rng, i, names) for i in range(64)]
    port_rec = FlightRecorder(max_ticks=2, max_bytes=1 << 26)
    ref_rec = JaxRecorder(max_ticks=2, max_bytes=1 << 26, topk=8, enabled=True)
    port, ref = _engines(monkeypatch, depth, port_rec, ref_rec)
    follows = {5: (1, 2), 40: (33,)}
    mine = StreamingScheduler(port, to_port(clusters), to_port(units), slab_rows=6,
                              slab_age_ms=1e9, follower_index=FollowerIndex(follows))
    theirs = JaxStreamingScheduler(ref, clusters, units, slab_rows=6, slab_age_ms=1e9,
                                   follower_index=JaxFollowerIndex(follows))
    assert mine.grow_block == theirs.grow_block == port._tick_geometry(14)[1]
    dirty = _spy_dirty(port)
    both = Streams(mine, theirs)
    results_equal(mine.flush(), theirs.flush())
    results_equal(mine.flush(), theirs.flush())

    arrivals = 0
    records = 0
    for step in range(10):
        kind = step % 5
        if kind == 0:  # updates
            for r in rng.integers(0, 64, 4):
                u = theirs.units[int(r)]
                if jax_streaming_tests.is_placeholder(u):
                    continue
                both.offer(dataclasses.replace(u, desired_replicas=int(rng.integers(1, 60))))
        elif kind == 1:  # arrivals
            for _ in range(3):
                both.offer(random_unit(rng, 1000 + arrivals, names))
                arrivals += 1
        elif kind == 2:  # deletes
            live = [u for u in theirs.units if not jax_streaming_tests.is_placeholder(u)]
            for r in rng.integers(0, len(live), 2):
                both.remove(live[int(r)].key)
        elif kind == 3:  # single-column capacity drift + churn
            j = int(rng.integers(0, len(clusters)))
            base = theirs.clusters[j]
            both.update_cluster(dataclasses.replace(
                base, available={k: max(0, v // 2) for k, v in base.available.items()}
            ))
            u = theirs.units[int(rng.integers(0, 64))]
            if not jax_streaming_tests.is_placeholder(u):
                both.offer(dataclasses.replace(u, desired_replicas=int(rng.integers(1, 60))))
        else:  # mass drift: every column moves -> the gate bails
            both.offer_capacity([
                dataclasses.replace(
                    c, available={k: max(0, v - v // 7) for k, v in c.available.items()}
                )
                for c in theirs.clusters
            ])

        got = mine.flush()
        results_equal(got, theirs.flush())
        assert port.last_changed == ref.last_changed
        assert mine.units == to_port(theirs.units)
        assert mine.clusters == to_port(theirs.clusters)
        assert port.tick_seq == ref.tick_seq == mine._last_engine_tick
        assert port.last_tick_id == ref.last_tick_id == port.tick_seq
        oracle_rec = FlightRecorder(max_ticks=2, max_bytes=1 << 26)
        oracle = _port(monkeypatch, **KW)
        oracle.flightrec = oracle_rec
        want = oracle.schedule(mine.units, mine.clusters)
        results_equal(
            [r for i, r in enumerate(got) if i not in follows],
            [r for i, r in enumerate(want) if i not in follows],
        )
        for f, leaders in follows.items():
            union = set()
            for leader in leaders:
                union.update(want[leader].clusters)
            assert set(got[f].clusters) == union
        # The records of the rows this flush re-decided: equal to the JAX
        # engine's, and to a stop-the-world engine's but for the top-k of
        # rows the selection-known replan settled (tests/test_streaming.py).
        for row in port.last_changed or []:
            u = mine.units[row]
            if is_placeholder(u):
                continue
            a, b, c = port_rec.lookup(u.key), ref_rec.lookup(u.key), oracle_rec.lookup(u.key)
            assert a is not None and b is not None and c is not None, u.key
            assert a.program == b.program, u.key
            assert record_fields(a) == record_fields(b), u.key
            replan = a.program.endswith(":replan")
            assert record_fields(a, not replan) == record_fields(c, not replan), u.key
            records += 1
        assert port_rec.stats() == ref_rec.stats()
    assert records > 0
    assert port.drift_stats["gated"] >= 1, port.drift_stats
    assert port.fetch_stats["full"] >= 1
    assert mine.flushes == theirs.flushes >= 10
    assert mine.flush_stats == theirs.flush_stats
    assert mine.events_total == theirs.events_total
    assert mine.rows_flushed == theirs.rows_flushed
    assert dirty[0] is None  # the first flush: no tick of ours yet
    assert all(d is not None for d in dirty[1:])  # then the hint is taken


def test_hint_dropped_after_another_callers_tick(monkeypatch):
    """A tick by another caller between two flushes advances tick_seq,
    so the next flush walks every row (dirty_rows None)."""
    rng = np.random.default_rng(3)
    clusters = to_port([random_cluster(rng, j) for j in range(8)])
    names = [c.name for c in clusters]
    units = to_port([random_unit(rng, i, names) for i in range(40)])
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


class _PortEngine:
    """``SchedulerEngine(chunk_size=..., ...)`` of the JAX test module as
    the port's CPU engine (the JAX keywords as the port's constants)."""

    def __init__(self, monkeypatch):
        self.monkeypatch = monkeypatch

    def __call__(self, flight_recorder=None, **kw):
        engine = _port(self.monkeypatch, **kw)
        engine.flightrec = flight_recorder
        return engine


SLAB_CASES = sorted(n for n in dir(jax_streaming_tests.TestSlabMechanics) if n.startswith("test_"))


@pytest.mark.parametrize("case", SLAB_CASES)
def test_slab_mechanics_on_the_port(monkeypatch, case):
    """tests/test_streaming.py's slab cases (watermarks, arrivals into
    placeholders and growth, deletes, placeholder rows, a capacity event
    through the drift gate) with the test module's engine, stream,
    placeholder and unit classes pointed at the port's."""
    for name, value in (
        ("SchedulerEngine", _PortEngine(monkeypatch)),
        ("StreamingScheduler", StreamingScheduler),
        ("is_placeholder", streaming.is_placeholder),
        ("make_placeholder", streaming.make_placeholder),
        ("SchedulingUnit", port_types.SchedulingUnit),
        ("ClusterState", port_types.ClusterState),
        ("parse_resources", port_types.parse_resources),
        ("MODE_DIVIDE", port_types.MODE_DIVIDE),
    ):
        monkeypatch.setattr(jax_streaming_tests, name, value)
    getattr(jax_streaming_tests.TestSlabMechanics(), case)()


@pytest.mark.parametrize("n_clusters", [14, 500, 5000])
def test_grow_block_is_one_engine_chunk(n_clusters):
    """A placeholder block of one engine chunk (MEGACHUNK_ROWS rows at
    the c3 and c5 widths too) leaves every cached chunk untouched; the
    except branch of the stream's geometry read is never taken."""
    rng = np.random.default_rng(n_clusters)
    clusters = to_port([random_cluster(rng, j) for j in range(n_clusters)])
    engine = engine_mod.SchedulerEngine(device="cpu")
    stream = StreamingScheduler(engine, clusters)
    assert stream.grow_block == engine._tick_geometry(n_clusters)[1]
    assert stream.grow_block == engine_mod.MEGACHUNK_ROWS == engine.chunk_size
    ref = JaxStreamingScheduler(
        JaxEngine(mesh=None, flight_recorder=None, devprof=None), clusters
    )
    assert stream.grow_block == ref.grow_block
    assert (stream.slab_rows, stream.slab_age_ms) == (ref.slab_rows, ref.slab_age_ms)


def test_arrival_growth_keeps_cached_chunks(monkeypatch):
    """An arrival past the last placeholder grows the world by one chunk:
    the two cached chunks hit, the new chunk alone is featurized."""
    rng = np.random.default_rng(5)
    clusters = to_port([random_cluster(rng, j) for j in range(10)])
    names = [c.name for c in clusters]
    units = to_port([random_unit(rng, i, names) for i in range(64)])
    port, _ = _engines(monkeypatch, 16)
    stream = StreamingScheduler(port, clusters, units, slab_rows=100, slab_age_ms=1e9)
    stream.flush()
    stream.offer(to_port(random_unit(rng, 500, names)))
    cache0 = dict(port.cache_stats)
    got = stream.flush()
    assert len(stream.units) == 64 + stream.grow_block == 96
    grew = {k: v - cache0.get(k, 0) for k, v in port.cache_stats.items() if v - cache0.get(k, 0)}
    assert grew == {"hit": 2, "miss": 1}, grew
    results_equal(got, _port(monkeypatch, **KW).schedule(stream.units, stream.clusters))


def test_flush_counts_per_tenant_match_jax(monkeypatch):
    """``tenancy.note_flush``: with a ledger installed, each flush adds
    its upserts and deletes per tenant, as JAX's stream does."""
    rng = np.random.default_rng(9)
    clusters = [random_cluster(rng, j) for j in range(8)]
    names = [c.name for c in clusters]
    units = [random_unit(rng, i, names) for i in range(40)]
    port, ref = _engines(monkeypatch, 1)
    mine = StreamingScheduler(port, to_port(clusters), to_port(units), slab_rows=100,
                              slab_age_ms=1e9)
    theirs = JaxStreamingScheduler(ref, clusters, units, slab_rows=100, slab_age_ms=1e9)
    ledgers = (tenancy.TenantLedger(), jax_tenancy.TenantLedger())
    monkeypatch.setattr(tenancy, "_default", ledgers[0])
    monkeypatch.setattr(jax_tenancy, "_default", ledgers[1])
    both = Streams(mine, theirs)
    for step in range(3):
        for r in rng.integers(0, 40, 5):
            both.offer(dataclasses.replace(units[int(r)], namespace=f"t{step}",
                                           desired_replicas=int(rng.integers(1, 30))))
        both.offer(random_unit(rng, 900 + step, names))
        both.remove(units[step].key)
        both.update_cluster(clusters[step])
        results_equal(mine.flush(), theirs.flush())
    got = {n: t.rows_flushed for n, t in ledgers[0]._tenants.items()}
    want = {n: t["rows_flushed"] for n, t in ledgers[1].summary()["tenants"].items()}
    assert got == want and sum(got.values()) == mine.rows_flushed
    family = "tenant_rows_flushed_total"
    assert ledgers[0].metrics.counter_family(family) == ledgers[1].metrics.counter_family(family)


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
