"""Reconcile workers.

A copy of ``kubeadmiral_tpu/runtime/worker.py`` for the port's control
plane.  The JAX module's admission knobs ``KT_ADMIT_DEPTH``,
``KT_ADMIT_DELAY_MS`` and ``KT_ADMIT_BATCH`` are the module constants
``ADMIT_DEPTH`` (10,000), ``ADMIT_DELAY_MS`` (50) and ``ADMIT_BATCH``
(0) here, read when a worker is built; the port reads no environment
variable.

The reference's universal engine is ReconcileWorker: a queue feeding N
goroutines that call ``reconcile(key) -> Result`` with per-key backoff
(reference: pkg/controllers/util/worker/worker.go:37-174).  Two variants
here:

* :class:`Worker` — the direct analogue for per-object controllers
  (sync, federate, status, ...), stepped explicitly (``step()``) or in a
  thread loop (``run()``).
* :class:`BatchWorker` — the tick-native variant: drains *all* due keys
  and hands them to one callback, which is how the scheduler amortizes a
  whole pending set into one XLA dispatch.

Results mirror worker.Result: success resets backoff; ``backoff=True``
requeues with exponential delay; ``requeue_after`` schedules a fixed
revisit.
"""

from __future__ import annotations

import logging
import threading
import time
from dataclasses import dataclass
from typing import Callable, Iterable, Optional

from kubeadmiral_tpu_torch.runtime import tenancy, trace
from kubeadmiral_tpu_torch.runtime.queue import Backoff, DirtyQueue
from kubeadmiral_tpu_torch.runtime.metrics import Metrics, null_metrics

log = logging.getLogger("kubeadmiral.worker")


ADMIT_DEPTH = 10000
ADMIT_DELAY_MS = 50
ADMIT_BATCH = 0


def admit_depth() -> int:
    """ADMIT_DEPTH: queue depth past which new enqueues are admitted
    with a coalescing delay instead of immediately (0 disables).  Under
    an event flood the queue keeps deduping by key while ticks drain
    BIGGER, LESS FREQUENT batches — freshness gauges degrade gracefully
    instead of per-event latency p99 ballooning on tick thrash."""
    return ADMIT_DEPTH


def admit_delay_s() -> float:
    """ADMIT_DELAY_MS: the coalescing delay applied to enqueues past
    the admission depth."""
    return ADMIT_DELAY_MS / 1e3


def admit_batch() -> int:
    """ADMIT_BATCH: max keys one drain hands a tick (0 = unlimited).
    Bounds a single tick's latency when a flood has already queued
    more work than one tick should absorb."""
    return ADMIT_BATCH


@dataclass
class Result:
    success: bool = True
    requeue_after: Optional[float] = None
    backoff: bool = False

    @staticmethod
    def ok() -> "Result":
        return Result()

    @staticmethod
    def retry() -> "Result":
        return Result(success=False, backoff=True)

    @staticmethod
    def after(seconds: float) -> "Result":
        return Result(success=True, requeue_after=seconds)


class _WorkerBase:
    def __init__(self, name: str, metrics: Optional[Metrics] = None, clock=None):
        self.name = name
        self.queue = DirtyQueue() if clock is None else DirtyQueue(clock)
        self.backoff = Backoff()
        self.metrics = metrics or null_metrics()
        self._stop = threading.Event()
        self._threads: list[threading.Thread] = []
        # Admission knobs resolved once per worker: the enqueue path
        # runs per watch event.
        self._admit_depth = admit_depth()
        self._admit_delay = admit_delay_s()
        self._admit_batch = admit_batch()
        # Shard routing consulted per enqueue — the informer/worker
        # boundary is where a replica decides whether a key is its own.
        # Resolved once like the admission knobs; with one shard (the
        # default) owns() is a single attribute compare.
        from kubeadmiral_tpu_torch.federation import shardmap

        self._shard = shardmap.get_default()
        # Threads currently inside a reconcile (ident -> depth).  An
        # in-process store delivers watch events synchronously on the
        # writing thread, so an event arriving on one of these threads
        # mid-reconcile is an echo of this controller's OWN write —
        # handlers consult is_own_thread() to skip the self-requeue.
        self._active: dict[int, int] = {}

    def is_own_thread(self) -> bool:
        return threading.get_ident() in self._active

    def _enter(self) -> int:
        ident = threading.get_ident()
        self._active[ident] = self._active.get(ident, 0) + 1
        return ident

    def _exit(self, ident: int) -> None:
        depth = self._active.get(ident, 1) - 1
        if depth <= 0:
            self._active.pop(ident, None)
        else:
            self._active[ident] = depth

    def enqueue(self, key: str, delay: float = 0.0) -> None:
        if not self._shard.owns(key):
            return
        # Queue-depth-driven admission: past ADMIT_DEPTH pending
        # keys, new work coalesces behind a short delay (dedupe by key
        # makes repeated events free) so a flood turns into bigger
        # amortized ticks instead of tick thrash.
        if delay <= 0.0 and self._admit_depth > 0:
            # Unlocked dict-len read: an approximate depth is fine for a
            # soft threshold, and the add below takes the lock anyway.
            if len(self.queue._pending) > self._admit_depth:
                delay = self._admit_delay
                if delay > 0.0:
                    self.metrics.counter(
                        "worker_admission_total", controller=self.name
                    )
                    # Per-tenant deferral attribution — the data the
                    # weighted fair-admission item will arbitrate on
                    # (no-op unless a ledger is installed).
                    if tenancy.active():
                        tenancy.note_admission(tenancy.tenant_of_key(key))
        self.queue.add(key, delay)

    def _drain(self) -> list[str]:
        """drain_due plus the queue telemetry every controller shares:
        depth/age gauges and per-key wait histograms, labeled by
        controller name."""
        keys = self.queue.drain_due(limit=self._admit_batch)
        self.metrics.gauge("worker_queue_depth", len(self.queue), controller=self.name)
        self.metrics.gauge(
            "worker_queue_oldest_age_seconds",
            self.queue.oldest_age(),
            controller=self.name,
        )
        if keys:
            waits = self.queue.last_drain_waits
            # Bound per-tick histogram work: a 100k-key batch drain
            # observes a sample plus the max, not every key.
            for w in waits[:64]:
                self.metrics.histogram(
                    "worker_queue_wait_seconds", w, controller=self.name
                )
            if len(waits) > 64:
                self.metrics.histogram(
                    "worker_queue_wait_seconds", max(waits), controller=self.name
                )
        return keys

    def enqueue_all(self, keys: Iterable[str], delay: float = 0.0) -> None:
        for k in keys:
            if self._shard.owns(k):
                self.queue.add(k, delay)

    def enqueue_many(self, keys: Iterable[str]) -> None:
        """Batch-event intake: one admission decision for the whole
        flush (the depth probe and deferral bookkeeping run once, not
        per key), then per-key adds — the coalesced-delivery analogue
        of :meth:`enqueue`."""
        keys = [k for k in keys if self._shard.owns(k)]
        if not keys:
            return
        delay = 0.0
        if self._admit_depth > 0 and len(self.queue._pending) > self._admit_depth:
            delay = self._admit_delay
            if delay > 0.0:
                self.metrics.counter(
                    "worker_admission_total", controller=self.name
                )
                if tenancy.active():
                    # One ledger call per tenant per flush, not per key:
                    # note_admission takes the ledger lock, and a 100k-
                    # key flush would pay it 100k times.
                    counts: dict[str, int] = {}
                    for k in keys:
                        t = tenancy.tenant_of_key(k)
                        counts[t] = counts.get(t, 0) + 1
                    for t, n in counts.items():
                        tenancy.note_admission(t, n)
        for k in keys:
            self.queue.add(k, delay)

    def stop(self) -> None:
        self._stop.set()
        with self.queue._wakeup:
            self.queue._wakeup.notify_all()
        for t in self._threads:
            t.join(timeout=5)

    def run(self, workers: int = 1) -> None:
        for i in range(workers):
            t = threading.Thread(
                target=self._loop, name=f"{self.name}-{i}", daemon=True
            )
            t.start()
            self._threads.append(t)

    def _loop(self) -> None:
        while not self._stop.is_set():
            if not self.step():
                self.queue.wait(timeout=0.5)

    def step(self) -> bool:  # pragma: no cover - overridden
        raise NotImplementedError


class Worker(_WorkerBase):
    """One key per reconcile call."""

    def __init__(self, name, reconcile: Callable[[str], Result], **kw):
        super().__init__(name, **kw)
        self._reconcile = reconcile

    def step(self) -> bool:
        keys = self._drain()
        if not keys:
            return False
        for key in keys:
            self._dispatch(key)
        return True

    def _dispatch(self, key: str) -> None:
        ident = self._enter()
        start = time.perf_counter()
        try:
            # Sampled: a per-key span at e2e scale is millions of ring
            # appends that evict each other — keep 1-in-N (trace.py).
            with trace.hot_span("worker.reconcile", controller=self.name, key=key):
                with self.metrics.timer(f"{self.name}.latency"):
                    result = self._reconcile(key)
        except Exception:
            # The panic-equivalent: the reconcile escaped instead of
            # returning Result.retry().
            self.metrics.counter(f"{self.name}.panic")
            self.metrics.counter("worker_exceptions_total", controller=self.name)
            log.exception(
                "reconcile panic: controller=%s key=%s", self.name, key
            )
            result = Result.retry()
        finally:
            self._exit(ident)
        self.metrics.counter(f"{self.name}.throughput")
        self.metrics.counter("worker_reconciles_total", controller=self.name)
        self.metrics.histogram(
            "worker_process_seconds",
            time.perf_counter() - start,
            controller=self.name,
        )
        self._requeue(key, result)

    def _requeue(self, key: str, result: Result) -> None:
        if result.success:
            self.backoff.reset(key)
            if result.requeue_after is not None:
                self.metrics.counter("worker_requeues_total", controller=self.name)
                self.queue.add(key, result.requeue_after)
        elif result.backoff:
            self.metrics.counter("worker_retries_total", controller=self.name)
            self.queue.add(key, self.backoff.next_delay(key))


class BatchWorker(_WorkerBase):
    """All due keys -> one callback (the batching tick)."""

    def __init__(
        self,
        name,
        reconcile_batch: Callable[[list[str]], dict[str, Result]],
        **kw,
    ):
        super().__init__(name, **kw)
        self._reconcile_batch = reconcile_batch

    def step(self) -> bool:
        keys = self._drain()
        if not keys:
            return False
        ident = self._enter()
        start = time.perf_counter()
        try:
            with trace.span("worker.tick", controller=self.name, keys=len(keys)):
                with self.metrics.timer(f"{self.name}.tick_latency"):
                    results = self._reconcile_batch(keys)
        except Exception:
            self.metrics.counter(f"{self.name}.panic")
            self.metrics.counter("worker_exceptions_total", controller=self.name)
            log.exception(
                "batch-tick panic: controller=%s keys=%d", self.name, len(keys)
            )
            results = {k: Result.retry() for k in keys}
        finally:
            self._exit(ident)
        self.metrics.counter(f"{self.name}.throughput", len(keys))
        self.metrics.counter(
            "worker_reconciles_total", len(keys), controller=self.name
        )
        self.metrics.histogram(
            "worker_tick_seconds", time.perf_counter() - start, controller=self.name
        )
        retried = requeued = 0
        for key in keys:
            result = results.get(key, Result.ok())
            if result.success:
                self.backoff.reset(key)
                if result.requeue_after is not None:
                    requeued += 1
                    self.queue.add(key, result.requeue_after)
            elif result.backoff:
                retried += 1
                self.queue.add(key, self.backoff.next_delay(key))
        if retried:
            self.metrics.counter(
                "worker_retries_total", retried, controller=self.name
            )
        if requeued:
            self.metrics.counter(
                "worker_requeues_total", requeued, controller=self.name
            )
        return True
