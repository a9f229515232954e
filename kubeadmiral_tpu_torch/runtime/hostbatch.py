"""Host-side bulk write staging for batch-tick controllers.

A copy of ``kubeadmiral_tpu/runtime/hostbatch.py`` for the port's control
plane.

One BatchWorker tick stages every object's host writes here and flushes
them as ``host.batch()`` round trips (transport/apiserver.py
_serve_batch) — the host-side sibling of dispatch.BatchSink's per-member
bulk writes.  Used by the sync controller (status/annotation/version
writes) and the scheduler (placement persists).
"""

from __future__ import annotations

from typing import Callable, Optional


class HostBatch:
    """Host-side write staging for one BatchWorker tick: every object's
    status/annotation update rides ONE ``host.batch()`` round trip per
    drain instead of one round trip per write.  Callbacks may stage
    follow-up ops (the syncing annotation uses the resourceVersion the
    status write returned), so ``flush`` drains until quiescent.
    Per-op conflicts fall back to the caller's synchronous retry loops."""

    def __init__(self, host):
        self.host = host
        self._ops: list[tuple[dict, Callable[[dict], None], Optional[Callable[[], None]]]] = []

    def stage(
        self,
        op: dict,
        on_result: Callable[[dict], None],
        on_panic: Optional[Callable[[], None]] = None,
    ) -> None:
        self._ops.append((op, on_result, on_panic))

    def flush(self) -> None:
        while self._ops:
            ops, self._ops = self._ops, []
            try:
                results = self.host.batch([op for op, _, _ in ops])
            except Exception as e:
                results = [
                    {"code": 500, "status": {"reason": "Transport", "message": str(e)}}
                ] * len(ops)
            if len(results) < len(ops):
                results = list(results) + [
                    {"code": 500, "status": {"reason": "Transport",
                                             "message": "batch result missing"}}
                ] * (len(ops) - len(results))
            for (_, on_result, on_panic), result in zip(ops, results):
                try:
                    on_result(result)
                except Exception:
                    # A callback (or its synchronous fallback) died: the
                    # object must RETRY, not silently pass as finished.
                    if on_panic is not None:
                        on_panic()
