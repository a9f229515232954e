"""Keyed work queues with delay + backoff.

A copy of ``kubeadmiral_tpu/runtime/queue.py`` for the port's control
plane.

Merges the reference's two queue layers (reference:
pkg/controllers/util/delayingdeliver/delaying_deliverer.go — a min-heap
timer queue with latest-wins per key — and pkg/controllers/util/worker/
worker.go — per-key exponential backoff, 5s initial / 1m max) into one
structure tuned for the tick architecture: controllers *drain everything
due at once* so the scheduler can batch the whole pending set into a
single device dispatch, instead of popping one key per goroutine.
"""

from __future__ import annotations

import heapq
import threading
import time

from kubeadmiral_tpu_torch.runtime import lockcheck
from dataclasses import dataclass, field


@dataclass(order=True)
class _Entry:
    due: float
    seq: int
    key: str = field(compare=False)


class Backoff:
    """Per-key exponential backoff (worker.go:86-91, 146-155)."""

    def __init__(self, initial: float = 5.0, maximum: float = 60.0):
        self.initial = initial
        self.maximum = maximum
        self._delays: dict[str, float] = {}

    def next_delay(self, key: str) -> float:
        delay = self._delays.get(key, self.initial)
        self._delays[key] = min(delay * 2, self.maximum)
        return delay

    def reset(self, key: str) -> None:
        self._delays.pop(key, None)


@lockcheck.shared_field_guard
class DirtyQueue:
    """Thread-safe delayed queue; at most one pending entry per key
    (latest-wins, like DelayingDeliverer's key map)."""

    # Every field below is touched by producer add()s and the worker's
    # drain loop concurrently; _wakeup is a Condition OVER _lock, so
    # `with self._wakeup:` satisfies the same lock (ktlint
    # lock-discipline + runtime/lockcheck.py).
    _shared_fields_ = {
        "_heap": "_lock|_wakeup",
        "_pending": "_lock|_wakeup",
        "_enqueued_at": "_lock|_wakeup",
        "_seq": "_lock|_wakeup",
        "last_drain_waits": "_lock|_wakeup",
    }

    def __init__(self, clock=time.monotonic):
        self._clock = clock
        self._lock = lockcheck.make_lock("dirtyqueue")
        self._heap: list[_Entry] = []
        self._pending: dict[str, _Entry] = {}
        # key -> first-enqueue time while pending: the true queue wait
        # (a dedupe re-add does not reset the clock).  Telemetry only —
        # drain_due publishes the drained keys' waits in
        # ``last_drain_waits`` and ``oldest_age()`` gauges what's left.
        self._enqueued_at: dict[str, float] = {}
        self.last_drain_waits: list[float] = []
        self._seq = 0
        self._wakeup = threading.Condition(self._lock)

    def add(self, key: str, delay: float = 0.0) -> None:
        due = self._clock() + delay
        with self._wakeup:
            cur = self._pending.get(key)
            if cur is not None:
                if cur.due <= due:
                    return  # an earlier delivery is already scheduled
                cur.key = _TOMBSTONE  # lazy-delete the later one
            else:
                self._enqueued_at[key] = self._clock()
            self._seq += 1
            entry = _Entry(due, self._seq, key)
            self._pending[key] = entry
            heapq.heappush(self._heap, entry)
            self._wakeup.notify()

    def drain_due(self, limit: int = 0) -> list[str]:
        """Pop every key whose delivery time has arrived (at most
        ``limit`` keys when limit > 0 — the admission drain cap that
        bounds one tick's batch under an event flood)."""
        now = self._clock()
        out: list[str] = []
        waits: list[float] = []
        with self._lock:
            while self._heap and self._heap[0].due <= now:
                if limit and len(out) >= limit:
                    break
                entry = heapq.heappop(self._heap)
                if entry.key is _TOMBSTONE:
                    continue
                del self._pending[entry.key]
                enq = self._enqueued_at.pop(entry.key, None)
                if enq is not None:
                    waits.append(max(0.0, now - enq))
                out.append(entry.key)
            if out:
                self.last_drain_waits = waits
        return out

    def next_due_in(self) -> float | None:
        """Seconds until the earliest pending key is due (0 when one is
        due now, None when empty) — lets pollers distinguish a key
        coalescing behind a short admission delay from a long-fuse
        requeue."""
        with self._lock:
            while self._heap and self._heap[0].key is _TOMBSTONE:
                heapq.heappop(self._heap)
            if not self._heap:
                return None
            return max(0.0, self._heap[0].due - self._clock())

    def oldest_age(self) -> float:
        """Age of the longest-pending key (0 when empty) — the queue-lag
        gauge a stuck controller shows first."""
        with self._lock:
            if not self._enqueued_at:
                return 0.0
            return max(0.0, self._clock() - min(self._enqueued_at.values()))

    def wait(self, timeout: float | None = None) -> None:
        """Block until something may be due (new entry or head deadline)."""
        with self._wakeup:
            head = self._heap[0].due if self._heap else None
            now = self._clock()
            if head is not None and head <= now:
                return
            delay = None if head is None else head - now
            if timeout is not None:
                delay = timeout if delay is None else min(delay, timeout)
            self._wakeup.wait(delay)

    def __len__(self) -> int:
        with self._lock:
            return len(self._pending)


_TOMBSTONE: str = "\x00tombstone\x00"
