"""Streaming scheduler front-end: coalesced row-slab micro-batches.

A copy of ``kubeadmiral_tpu/scheduler/streaming.py`` for the port's control
plane.

The engine's tick loop is batch-shaped — give it the whole pending set,
get the whole decision set.  A live control plane is not: watch/informer
churn arrives as discrete events, and cluster capacity drifts while the
world runs.  This module converts between the two WITHOUT reintroducing
a stop-the-world revalidation edge:

* **Row slabs.**  Object upserts/deletes accumulate into a bounded slab
  (size watermark ``slab_rows``, age watermark ``slab_age_ms``).
  A flush applies the slab to the canonical unit list and re-schedules
  through :meth:`SchedulerEngine.schedule`, whose incremental machinery
  featurizes ONLY the changed rows and rides the sub-batch narrow path
  — a flush costs O(slab), not O(world).

* **Column-wise drift absorption.**  Cluster-capacity events swap the
  cluster list; the engine's drift gate diffs the changed columns
  against the device-resident planes and re-solves only the rows whose
  decisions can actually move (most through the sort-free
  ``drift_resolve`` program).  The full-revalidation path is never
  re-entered while the topology holds.

* **Fixed row geometry.**  New objects land in pre-grown placeholder
  slots (inert rows that schedule nowhere) so arrivals do not shift the
  chunk geometry; the placeholder pool grows in blocks when exhausted
  (one amortized tail-chunk re-featurize per block).

Interleaved streaming is bit-identical to a stop-the-world replay of
the same event log by construction: each flush IS an engine tick over
the post-event world, and the engine's incremental paths are certified
exact (tests/test_streaming.py drives the randomized differential).

The JAX module's knobs are arguments with its defaults: ``slab_rows``
(SLAB_ROWS, 1024; ``KT_SLAB_ROWS``), ``slab_age_ms`` (SLAB_AGE_MS, 50;
``KT_SLAB_AGE_MS``) and ``grow_block`` (``KT_SLAB_GROW``; by default one
engine chunk).  As in the JAX module, the default row watermark is per
device: a meshed engine's scales with its objects axis.
"""

from __future__ import annotations

import logging
import threading
import time
from collections import deque
from dataclasses import dataclass
from typing import Optional, Sequence

from kubeadmiral_tpu_torch.models import types as T
from kubeadmiral_tpu_torch.runtime import lockcheck
from kubeadmiral_tpu_torch.runtime import slo as SLO
from kubeadmiral_tpu_torch.runtime import tenancy
from kubeadmiral_tpu_torch.runtime import trace
from kubeadmiral_tpu_torch.runtime.metrics import Metrics, null_metrics

log = logging.getLogger("kubeadmiral.streaming")

# Stream stage/latency buckets: the engine/apply
# stages are ms-scale, but the `queued` stage legitimately reaches
# SECONDS under slab-age coalescing and backpressure — the default
# ladder's 10s top bucket would saturate to +Inf on a backed-up stream
# and percentile interpolation would lose the tail.  One extended
# ladder for the whole family keeps the series comparable while giving
# the queued stage finite buckets out to 120s.
STREAM_STAGE_BUCKETS = (
    0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5,
    1.0, 2.5, 5.0, 10.0, 30.0, 60.0, 120.0,
)

# The slab's row and age watermarks (KT_SLAB_ROWS, KT_SLAB_AGE_MS).
SLAB_ROWS = 1024
SLAB_AGE_MS = 50.0

# A gvk no member cluster serves: the row fails the APIResources filter
# everywhere, selects nothing, and carries no policy structure — the
# engine treats it like a padded row that happens to be real.
PLACEHOLDER_GVK = "kubeadmiral.io/v0/SlabPlaceholder"


def make_placeholder(slot: int) -> T.SchedulingUnit:
    """An inert unit occupying one pre-grown row slot."""
    return T.SchedulingUnit(
        gvk=PLACEHOLDER_GVK,
        namespace="__slab__",
        name=f"slot-{slot}",
        scheduling_mode=T.MODE_DUPLICATE,
    )


def is_placeholder(unit: T.SchedulingUnit) -> bool:
    return unit.gvk == PLACEHOLDER_GVK


@dataclass
class _Event:
    kind: str  # "upsert" | "delete" | "capacity"
    payload: object
    t: float


@lockcheck.shared_field_guard
class StreamingScheduler:
    """Always-on front-end over a :class:`SchedulerEngine`.

    Thread-safe for one producer + one pump thread (a lock guards the
    event queue; flushes serialize on the engine's own schedule lock).
    Results for the whole world are exposed as :attr:`results`, aligned
    with :attr:`units`; per-event placement-visible latency is recorded
    to the ``engine_stream_latency_seconds`` histogram and the bounded
    :attr:`latencies` deque (bench percentiles)."""

    # The producer<->pump surface: watch/informer threads append
    # events, the pump drains them (ktlint lock-discipline +
    # runtime/lockcheck.py).  World/result state (_units, results) is
    # pump-thread-only by contract and stays undeclared.
    _shared_fields_ = {"_pending": "_lock"}

    def __init__(
        self,
        engine,
        clusters: Sequence[T.ClusterState],
        units: Sequence[T.SchedulingUnit] = (),
        slab_rows: Optional[int] = None,
        slab_age_ms: Optional[float] = None,
        grow_block: Optional[int] = None,
        metrics: Optional[Metrics] = None,
        follower_index=None,
        clock=time.monotonic,
    ):
        self.engine = engine
        self.metrics = metrics if metrics is not None else (
            getattr(engine, "metrics", None) or null_metrics()
        )
        if slab_rows is None:
            # Per-device slab sizing: the churn slabs ride the engine's
            # rows-sharded dispatch (a slab's rows split over the lanes,
            # each lane solving its share and the results written into
            # the lanes that own the rows), so a meshed engine's row
            # watermark scales with its objects axis; an explicit
            # slab_rows is taken verbatim.  A clusters axis splits each
            # row's columns over the entries of its lane, not the rows,
            # so a lane's share of a slab's rows is the same: the
            # watermark scales with the objects axis alone.
            slab_rows = SLAB_ROWS
            mesh = getattr(engine, "mesh", None)
            if mesh is not None:
                slab_rows *= int(mesh.devices.shape[0])
        self.slab_rows = int(slab_rows)
        self.slab_age_ms = float(
            SLAB_AGE_MS if slab_age_ms is None else slab_age_ms
        )
        if grow_block is None:
            # Grow in whole engine chunks: appending a full chunk of
            # placeholders leaves every existing chunk's cache entry
            # untouched, so a growth step costs ONE tail-chunk
            # featurize instead of re-featurizing the tail chunk on
            # every sub-chunk extension.
            try:
                grow_block = engine._tick_geometry(len(clusters))[1]
            except Exception:
                grow_block = getattr(engine, "chunk_size", 1024)
        self.grow_block = max(1, int(grow_block))
        self.follower_index = follower_index
        self.clock = clock
        self._lock = lockcheck.make_lock("streaming")
        self._pending: deque[_Event] = deque()
        self._units: list[T.SchedulingUnit] = list(units)
        self._clusters: list[T.ClusterState] = list(clusters)
        self._row_of: dict[str, int] = {
            u.key: i for i, u in enumerate(self._units)
        }
        self._free: list[int] = [
            i for i, u in enumerate(self._units) if is_placeholder(u)
        ]
        self.results: list = []
        self.flush_stats = {"rows": 0, "age": 0, "manual": 0, "capacity": 0}
        self.events_total = {"upsert": 0, "delete": 0, "capacity": 0}
        self.rows_flushed = 0
        self.flushes = 0
        # Monotonic flush correlation id: stamped on the stream.flush
        # span (with the engine tick id it produced) so /debug/trace
        # shows one connected event -> placement-written timeline.
        self._flush_seq = 0
        self.last_flush_id = 0
        # Delta-featurization hint plumbing: the engine tick counter as
        # of OUR last flush — the dirty-row hint is only sound when no
        # other caller ticked the engine in between (their world would
        # have replaced the cached unit rows the hint promises are
        # unchanged).
        self._last_engine_tick: Optional[int] = None
        # Bounded recent event->placement-visible latencies (seconds).
        self.latencies: deque[float] = deque(maxlen=200_000)

    # -- event ingestion --------------------------------------------------
    def offer(self, unit: T.SchedulingUnit) -> None:
        """Object add/update (a watch upsert)."""
        with trace.hot_span("stream.offer", kind="upsert", key=unit.key):
            with self._lock:
                self._pending.append(_Event("upsert", unit, self.clock()))
                self.events_total["upsert"] += 1
                self._note_depth()

    def remove(self, key: str) -> None:
        """Object delete: the row reverts to an inert placeholder."""
        with trace.hot_span("stream.offer", kind="delete", key=key):
            with self._lock:
                self._pending.append(_Event("delete", key, self.clock()))
                self.events_total["delete"] += 1
                self._note_depth()

    def offer_capacity(self, clusters: Sequence[T.ClusterState]) -> None:
        """Whole-fleet capacity snapshot (cheap: the engine diffs it
        column-wise against the previous view)."""
        with trace.hot_span("stream.offer", kind="capacity"):
            with self._lock:
                self._pending.append(
                    _Event("capacity", list(clusters), self.clock())
                )
                self.events_total["capacity"] += 1
                self._note_depth()

    def update_cluster(self, cluster: T.ClusterState) -> None:
        """Single-member capacity update — the common drift event."""
        with trace.hot_span("stream.offer", kind="capacity", key=cluster.name):
            with self._lock:
                base = self._pending_clusters_locked()
                fleet = [
                    cluster if c.name == cluster.name else c for c in base
                ]
                self._pending.append(_Event("capacity", fleet, self.clock()))
                self.events_total["capacity"] += 1
                self._note_depth()

    def _pending_clusters_locked(self) -> list[T.ClusterState]:
        for ev in reversed(self._pending):
            if ev.kind == "capacity":
                return ev.payload
        return self._clusters

    def _note_depth(self) -> None:
        self.metrics.store("engine_stream_slab_depth", len(self._pending))

    # -- watermarks -------------------------------------------------------
    def pending(self) -> int:
        with self._lock:
            return len(self._pending)

    def oldest_age(self) -> float:
        """Seconds the oldest pending event has waited (0 when empty)."""
        with self._lock:
            if not self._pending:
                return 0.0
            return self.clock() - self._pending[0].t

    def should_flush(self) -> bool:
        with self._lock:
            if not self._pending:
                return False
            if len(self._pending) >= self.slab_rows:
                return True
            return (
                (self.clock() - self._pending[0].t) * 1e3 >= self.slab_age_ms
            )

    # -- flushing ---------------------------------------------------------
    def pump(self) -> Optional[list]:
        """Flush when a watermark trips; returns the fresh results list
        or None when below both watermarks."""
        with self._lock:
            if not self._pending:
                return None
            by_rows = len(self._pending) >= self.slab_rows
            by_age = (
                (self.clock() - self._pending[0].t) * 1e3 >= self.slab_age_ms
            )
            if not (by_rows or by_age):
                return None
            trigger = "rows" if by_rows else "age"
        return self._flush(trigger)

    def flush(self) -> list:
        """Unconditional flush (empty slab = plain re-tick)."""
        return self._flush("manual")

    def _grow_locked(self, extra: int) -> None:
        base = len(self._units)
        blocks = -(-extra // self.grow_block)
        for i in range(blocks * self.grow_block):
            slot = base + i
            ph = make_placeholder(slot)
            self._units.append(ph)
            self._free.append(slot)
        self.metrics.store("engine_stream_world_rows", len(self._units))

    def _flush(self, trigger: str) -> list:
        t_flush = self.clock()
        with self._lock:
            self._flush_seq += 1
            fid = self._flush_seq
        with trace.span("stream.flush", flush=fid, trigger=trigger) as f_span:
            with self._lock:
                drained = list(self._pending)
                self._pending.clear()
                self.metrics.store("engine_stream_slab_depth", 0)
                had_capacity = False
                world0 = len(self._units)
                dirty: set[int] = set()
                for ev in drained:
                    if ev.kind == "capacity":
                        self._clusters = list(ev.payload)
                        had_capacity = True
                        continue
                    if ev.kind == "delete":
                        row = self._row_of.pop(ev.payload, None)
                        if row is not None:
                            self._units[row] = make_placeholder(row)
                            self._free.append(row)
                            dirty.add(row)
                        continue
                    unit = ev.payload
                    row = self._row_of.get(unit.key)
                    if row is None:
                        if not self._free:
                            self._grow_locked(1)
                        row = self._free.pop()
                        self._row_of[unit.key] = row
                    self._units[row] = unit
                    dirty.add(row)
                # Fresh list: the engine's no-op gate treats the container
                # as immutable (content-identity replays still work).
                units = list(self._units)
                clusters = self._clusters
                # Every pre-grown placeholder row past the previous
                # world length is new to the engine too.
                if len(self._units) > world0:
                    dirty.update(range(world0, len(self._units)))
            # SLO provenance through the slab: upsert events carrying a
            # token close their coalesce ("slab") stage at flush start
            # and their "engine" stage when the solve returns.
            upsert_keys = (
                [ev.payload.key for ev in drained if ev.kind == "upsert"]
                if SLO.active()
                else ()
            )
            SLO.mark_many(upsert_keys, "slab", t_flush)
            t_engine = self.clock()
            # The event log knows EXACTLY which rows moved — hand the
            # engine that set so its featurize identity walk is
            # O(changed), not O(world).  Sound only when this scheduler
            # was also the engine's previous caller (tick counter
            # unchanged since our last flush); anything else falls back
            # to the full walk.
            dirty_rows = (
                sorted(dirty)
                if self._last_engine_tick == self.engine.tick_seq
                else None
            )
            results = self.engine.schedule(
                units, clusters, follower_index=self.follower_index,
                dirty_rows=dirty_rows,
            )
            self._last_engine_tick = self.engine.tick_seq
            now = self.clock()
            SLO.mark_many(upsert_keys, "engine", now)
            tick_id = getattr(self.engine, "last_tick_id", 0)
            # Correlate the flush with the engine tick it produced: the
            # engine.schedule span nests under this one on the thread,
            # and the shared tick id links the /debug/waterfall entry.
            f_span.set(
                events=len(drained), tick=tick_id,
                engine_ms=round((now - t_engine) * 1e3, 3),
            )
            with self._lock:
                self.results = results
                self.flushes += 1
                self.last_flush_id = fid
                n_rows = sum(1 for ev in drained if ev.kind != "capacity")
                self.rows_flushed += n_rows
                self.flush_stats[trigger] = self.flush_stats.get(trigger, 0) + 1
                if had_capacity:
                    self.flush_stats["capacity"] += 1
                m = self.metrics
                m.counter("engine_stream_flushes_total", trigger=trigger)
                # Stage-decomposed event latency: how long events sat
                # coalescing in the slab vs the engine solve itself vs
                # the publish bookkeeping — the split the e2e p99 budget
                # is tuned against (docs/observability.md).
                m.histogram(
                    "engine_stream_stage_seconds",
                    max(0.0, t_engine - t_flush),
                    buckets=STREAM_STAGE_BUCKETS,
                    stage="apply",
                )
                m.histogram(
                    "engine_stream_stage_seconds",
                    max(0.0, now - t_engine),
                    buckets=STREAM_STAGE_BUCKETS,
                    stage="engine",
                )
                for ev in drained:
                    m.counter("engine_stream_events_total", kind=ev.kind)
                    lat = now - ev.t
                    m.histogram(
                        "engine_stream_latency_seconds", lat,
                        buckets=STREAM_STAGE_BUCKETS,
                    )
                    m.histogram(
                        "engine_stream_stage_seconds",
                        max(0.0, t_flush - ev.t),
                        buckets=STREAM_STAGE_BUCKETS,
                        stage="queued",
                    )
                    self.latencies.append(lat)
                m.store("engine_stream_slab_rows", n_rows)
                m.histogram(
                    "engine_stream_flush_seconds", now - t_flush
                )
            # Per-tenant flush accounting (runtime/tenancy.py; no-op
            # unless a ledger is installed) — outside the slab lock: the
            # ledger takes its own lock and needs nothing of ours.
            if tenancy.active():
                by_tenant: dict[str, int] = {}
                for ev in drained:
                    if ev.kind == "capacity":
                        continue
                    t_name = tenancy.tenant_of_key(
                        getattr(ev.payload, "key", "") or ""
                    )
                    by_tenant[t_name] = by_tenant.get(t_name, 0) + 1
                for t_name, rows in by_tenant.items():
                    tenancy.note_flush(t_name, rows)
        if log.isEnabledFor(logging.DEBUG):
            log.debug(
                "flush=%d tick=%d trigger=%s events=%d rows=%d "
                "capacity=%s engine_ms=%.1f",
                fid, tick_id, trigger, len(drained), n_rows, had_capacity,
                (now - t_engine) * 1e3,
            )
        return results

    def drain(self, deadline_s: float = 5.0) -> Optional[list]:
        """Graceful-shutdown drain: flush whatever is coalescing in the
        slab so the final pre-exit snapshot describes the post-event
        world, bounded by ``deadline_s`` (a flush that cannot finish in
        budget is abandoned — the events are NOT lost, they are already
        reflected in the canonical unit list and the successor's relist
        re-derives them).  Returns the final results list, or None when
        nothing was pending."""
        with self._lock:
            if not self._pending:
                return None
        done: list = []

        def run():
            try:
                done.append(self._flush("manual"))
            except Exception:
                log.warning("shutdown drain flush failed", exc_info=True)

        t = threading.Thread(target=run, name="stream-drain", daemon=True)
        t.start()
        t.join(max(0.0, deadline_s))
        if t.is_alive():
            log.warning(
                "shutdown drain exceeded %.1fs; abandoning the in-flight "
                "flush (successor relist re-derives the slab)", deadline_s,
            )
            return None
        return done[0] if done else None

    # -- introspection ----------------------------------------------------
    @property
    def units(self) -> list[T.SchedulingUnit]:
        with self._lock:
            return list(self._units)

    @property
    def clusters(self) -> list[T.ClusterState]:
        with self._lock:
            return list(self._clusters)

    def result_of(self, key: str):
        """The current placement of one object (None when unknown)."""
        with self._lock:
            row = self._row_of.get(key)
            if row is None or row >= len(self.results):
                return None
            return self.results[row]
