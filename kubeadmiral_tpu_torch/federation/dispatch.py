"""Per-cluster write dispatch for the sync controller.

A copy of ``kubeadmiral_tpu/federation/dispatch.py`` for the port's control
plane.

The reference fans member-cluster writes out to per-cluster goroutines
with a shared timeout and collects a per-cluster propagation status +
version map (reference: pkg/controllers/sync/dispatch/operation.go:102-123,
managed.go:108-655, unmanaged.go).  Here the write fan-out is routed
through a *sink*:

* :class:`ImmediateSink` — the goroutine analogue: each operation runs
  inline (local in-process members) or on a bounded pool (network
  members), one client round trip per operation.
* :class:`BatchSink` — the tick-native variant: a whole BatchWorker tick
  of sync reconciles stages its member writes here, and ``flush()``
  issues bulk ``client.batch()`` round trips per member cluster covering
  every staged object (transport/apiserver.py _serve_batch).  Per-op
  conflict/failure results flow back through the same continuations, so
  status/version bookkeeping is identical to the immediate path.

Both sinks flush through the **per-member coalescing window**
(:func:`run_member_batches`): a member's staged ops split into
MEMBER_BATCH-sized bulk requests, up to MEMBER_INFLIGHT in flight
at once (the engine's KT_PIPELINE_DEPTH trick at the HTTP layer), with
the deadline and breaker re-checked between chunks.  WRITE_COALESCE=0
reverts to one request per (object, member) op — the reference's
fan-out shape, kept as the bit-identical A/B baseline.  Point reads
batch the same way (:func:`bulk_get`; KT_BULK_READS consumers in sync
and the status controllers).

The fan-out is **stall-proof** (docs/operations.md § Degraded member
runbook): every flush path enforces the per-tick deadline budget
(DISPATCH_DEADLINE_S), retryable failures get a bounded jittered
backoff budget (``run_batch_with_retries``), writes to a member whose
circuit breaker (transport/breaker.py) is open short-circuit to
ClusterNotReady without touching a socket, and a member that stalls a
flush sheds its writes to the owning worker's backoff requeue — the
tick's critical path scales with the HEALTHY members only.

Statuses mirror fedtypesv1a1.PropagationStatus values.
"""

from __future__ import annotations

import json
import logging
import random
import threading
import time
import weakref
from concurrent.futures import Future, ThreadPoolExecutor
from concurrent.futures import TimeoutError as FuturesTimeout
from typing import Callable, Optional

from kubeadmiral_tpu_torch.federation import common as C
from kubeadmiral_tpu_torch.federation import retain
from kubeadmiral_tpu_torch.runtime import slo, tenancy, trace
from kubeadmiral_tpu_torch.federation.retain import CURRENT_REVISION_ANNOTATION
from kubeadmiral_tpu_torch.federation.rollout import (
    LAST_RS_NAME,
    LATEST_RS_NAME,
    MAX_SURGE_PATH,
    MAX_UNAVAILABLE_PATH,
)
from kubeadmiral_tpu_torch.utils.unstructured import copy_json, delete_path, get_path, set_path
from kubeadmiral_tpu_torch.federation.resource import (
    FederatedResource,
    has_managed_label,
    is_explicitly_unmanaged,
    object_needs_update,
    object_version,
)
from kubeadmiral_tpu_torch.testing.fakekube import (
    AlreadyExists,
    Conflict,
    FakeKube,
    NotFound,
)

# PropagationStatus values (reference: pkg/apis/types/v1alpha1/types_status.go).
OK = "OK"
WAITING = "Waiting"
CLUSTER_NOT_READY = "ClusterNotReady"
CLUSTER_TERMINATING = "ClusterTerminating"
CACHED_RETRIEVAL_FAILED = "CachedRetrievalFailed"
COMPUTE_RESOURCE_FAILED = "ComputeResourceFailed"
APPLY_OVERRIDES_FAILED = "ApplyOverridesFailed"
FIELD_RETENTION_FAILED = "FieldRetentionFailed"
CREATION_FAILED = "CreationFailed"
UPDATE_FAILED = "UpdateFailed"
DELETION_FAILED = "DeletionFailed"
ALREADY_EXISTS = "AlreadyExists"
WAITING_FOR_REMOVAL = "WaitingForRemoval"
DELETION_TIMED_OUT = "DeletionTimedOut"
CREATION_TIMED_OUT = "CreationTimedOut"
UPDATE_TIMED_OUT = "UpdateTimedOut"
MANAGED_LABEL_FALSE = "ManagedLabelFalse"
FINALIZER_CHECK_FAILED = "FinalizerCheckFailed"

ADOPTED_ANNOTATION = C.PREFIX + "adopted"

log = logging.getLogger("kubeadmiral.dispatch")


# -- retry / deadline budget ----------------------------------------------
# The JAX module's knobs, as constants with its defaults: the per-op
# fan-out pool (KT_DISPATCH_POOL), the per-tick deadline budget
# (KT_DISPATCH_DEADLINE_S), write coalescing (KT_WRITE_COALESCE), ops
# per bulk request (KT_MEMBER_BATCH), bulk requests in flight per member
# (KT_MEMBER_INFLIGHT), and the retry backoff's base, cap and attempts
# (KT_RETRY_BASE_S, KT_RETRY_CAP_S, KT_RETRY_MAX).
DISPATCH_POOL = 8
DISPATCH_DEADLINE_S = 30.0
WRITE_COALESCE = True
MEMBER_BATCH = 128
MEMBER_INFLIGHT = 4
RETRY_BASE_S = 0.05
RETRY_CAP_S = 2.0
RETRY_MAX = 3


def dispatch_pool_size() -> int:
    """Bounded in-flight window of the per-op fan-out (DISPATCH_POOL)."""
    return max(1, int(DISPATCH_POOL))


def dispatch_deadline() -> float:
    """The per-tick member-write deadline budget (DISPATCH_DEADLINE_S):
    no flush path may block its caller past this, whatever a member
    socket does."""
    return float(DISPATCH_DEADLINE_S)


def write_coalesce() -> bool:
    """WRITE_COALESCE: stage-and-batch member writes (default).  0
    reverts to ONE request per (object, member) operation — the
    reference's dispatch/operation.go model, kept as the bit-identical
    A/B baseline for the coalesced path."""
    return bool(WRITE_COALESCE)


def member_batch() -> int:
    """MEMBER_BATCH: max operations per bulk member request.  A
    member's staged writes flush as ceil(n / batch) pipelined requests,
    so one request never grows unboundedly large (bounded request
    latency, bounded retry blast radius)."""
    return max(1, int(MEMBER_BATCH))


def member_inflight() -> int:
    """MEMBER_INFLIGHT: bulk requests concurrently in flight per
    member during one flush — the engine's KT_PIPELINE_DEPTH trick at
    the HTTP layer."""
    return max(1, int(MEMBER_INFLIGHT))


# Ops shed before their bulk request was ever dispatched (deadline
# expiry mid-flush, breaker opening mid-flush) carry this marker so the
# flush skips their continuations: statuses stay at the pre-recorded
# *_TIMED_OUT values and the owning worker's backoff requeue re-drives
# them — identical semantics to the whole-cluster shed path.
_SHED = {"code": 503, "status": {"reason": "Shed",
                                 "message": "write shed before dispatch"},
         "shed": True}

# Histogram buckets for coalesced batch sizes (ops per bulk request).
_BATCH_BUCKETS = (1, 2, 4, 8, 16, 32, 64, 128, 256, 512, 1024)


def _op_tenant(op: dict) -> str:
    """The tenant a member-write op belongs to: namespace (and labels,
    for the tenancy.TENANT_LABEL override) of the op's object, falling back
    to the namespace half of its "ns/name" key (delete verbs carry no
    object)."""
    meta = (op.get("object") or {}).get("metadata") or {}
    ns = meta.get("namespace", "")
    if not ns:
        key = op.get("key", "")
        ns = key.partition("/")[0] if "/" in key else ""
    return tenancy.tenant_of(ns, meta.get("labels"))


def _note_shed_tenants(items) -> None:
    """Per-tenant shed attribution (no-op unless a ledger is installed).
    ``items`` may be raw op dicts or the sinks' (op, continuation)
    staging entries."""
    if not tenancy.active():
        return
    for item in items:
        op = item[0] if isinstance(item, tuple) else item
        tenancy.note_shed(_op_tenant(op))


def _note_write_tenants(ops, elapsed: float) -> None:
    """Per-tenant write attribution for one completed batch round trip:
    the batch latency lands once per tenant, weighted by its op count."""
    if not tenancy.active():
        return
    groups: dict[str, int] = {}
    for op in ops:
        t = _op_tenant(op)
        groups[t] = groups.get(t, 0) + 1
    for t, n_ops in groups.items():
        tenancy.note_write(t, elapsed, ops=n_ops)


def retry_delay(attempt: int, rng=None) -> float:
    """Bounded exponential backoff with jitter for retryable member-write
    failures: uniform in [span/2, span] of the capped exponential
    (RETRY_BASE_S doubling per attempt up to RETRY_CAP_S) — the
    half floor keeps retries off the member's heels, the jitter keeps a
    fleet of dispatchers from thundering in phase."""
    base = RETRY_BASE_S
    cap = RETRY_CAP_S
    span = min(cap, base * (2 ** min(attempt, 10)))
    r = (rng or random).random()
    return span * (0.5 + 0.5 * r)


def retry_max() -> int:
    return max(0, int(RETRY_MAX))


def _refreshed_conflict_op(client, op: dict) -> Optional[dict]:
    """409-after-conflict-refresh: re-read the member object's current
    resourceVersion into a COPY of the update op (the staged object may
    be the shared desired-cache assembly).  None when the refresh read
    fails — the conflict then stays with the caller as before."""
    obj = op.get("object") or {}
    meta = obj.get("metadata", {})
    ns = meta.get("namespace", "")
    name = meta.get("name")
    if not name:
        return None
    key = f"{ns}/{name}" if ns else name
    try:
        fresh = client.get(op["resource"], key)
    except Exception:
        return None
    new_obj = copy_json(obj)
    new_obj.setdefault("metadata", {})["resourceVersion"] = (
        fresh.get("metadata", {}).get("resourceVersion")
    )
    return {**op, "object": new_obj}


def run_batch_with_retries(
    client,
    ops: list[dict],
    deadline: float,
    cluster: str = "",
    breakers=None,
) -> list[dict]:
    """``client.batch`` with the bounded retry budget: transport-level
    failures and 5xx results are re-sent with exponential backoff +
    jitter while the deadline budget allows (RETRY_MAX attempts
    beyond the first); 409 Conflicts on update verbs retry once with a
    refreshed resourceVersion.  Always returns one result per op
    (transport failures become code-500 entries).  Feeds the member's
    circuit breaker: a final transport-level failure records a breaker
    failure (a stall-slow one opens it immediately), a completed batch
    records success."""
    n = len(ops)
    results: list[Optional[dict]] = [None] * n
    current: dict[int, dict] = dict(enumerate(ops))
    pending = list(range(n))
    conflict_refreshed: set[int] = set()
    breaker = breakers.for_member(cluster) if breakers is not None else None
    attempt = 0
    started = time.monotonic()
    transport_failed = False
    while True:
        try:
            out = list(client.batch([current[i] for i in pending]))
            transport_failed = False
        except Exception as e:  # transport-level failure: every op failed
            out = []
            transport_failed = True
            transport_result = {
                "code": 500,
                "status": {"reason": "Transport", "message": str(e)},
            }
        if len(out) < len(pending):
            filler = (
                transport_result
                if transport_failed
                else {"code": 500, "status": {"reason": "Transport",
                                              "message": "batch result missing"}}
            )
            out = out + [filler] * (len(pending) - len(out))
        for slot, res in zip(pending, out):
            results[slot] = res
        retryable: list[int] = []
        for slot in pending:
            res = results[slot]
            code = res.get("code") or 0
            if code >= 500:
                retryable.append(slot)
            elif (
                code == 409
                and (res.get("status") or {}).get("reason") == "Conflict"
                and current[slot].get("verb") in ("update", "update_status")
                and slot not in conflict_refreshed
            ):
                refreshed = _refreshed_conflict_op(client, current[slot])
                if refreshed is not None:
                    conflict_refreshed.add(slot)
                    current[slot] = refreshed
                    retryable.append(slot)
        if not retryable:
            break
        delay = retry_delay(attempt)
        if attempt >= retry_max() or time.monotonic() + delay >= deadline:
            break
        if breakers is not None:
            breakers.count_retry(cluster, len(retryable))
        log.debug(
            "retrying %d member-write op(s): cluster=%s attempt=%d "
            "delay_ms=%.0f", len(retryable), cluster, attempt + 1, delay * 1e3,
        )
        # The backoff wait IS the retry path's latency — a span makes it
        # visible in /debug/trace next to the member_flush it delays.
        with trace.span(
            "dispatch.retry", cluster=cluster, attempt=attempt + 1,
            ops=len(retryable),
        ):
            time.sleep(delay)
        pending = retryable
        attempt += 1
    elapsed = time.monotonic() - started
    final_transport = transport_failed or any(
        (r or {}).get("code") == 500
        and ((r or {}).get("status") or {}).get("reason") == "Transport"
        for r in results
    )
    if breaker is not None:
        if final_transport:
            breaker.record_failure(latency_s=elapsed)
        else:
            breaker.note_ok(elapsed)
    # Per-member write attribution (retries included): the histogram a
    # slow member shows up in when the engine is innocent
    # (member_write_seconds{cluster}), joined with breaker state at
    # GET /debug/members via the registry's latency reservoir.
    if cluster and not final_transport:
        slo.member_write(cluster, elapsed)
        _note_write_tenants(ops, elapsed)
        if breakers is not None:
            breakers.note_write(cluster, elapsed, ops=n)
    return [r if r is not None else {"code": 500, "status": {
        "reason": "Transport", "message": "batch never ran"}} for r in results]


def _note_chunk(breakers, cluster: str, n_ops: int, results: list[dict]) -> None:
    """Per-bulk-request telemetry: batch-size histogram + outcome
    counter (member_bulk_writes_total{cluster,result}) + the registry's
    batch reservoir feeding GET /debug/members."""
    if breakers is None or not cluster:
        return
    outcome = "ok"
    for r in results:
        code = (r or {}).get("code") or 0
        reason = ((r or {}).get("status") or {}).get("reason")
        if code >= 500 and reason == "Transport":
            outcome = "transport"
            break
        if code >= 400:
            outcome = "partial"
    breakers.note_batch(cluster, n_ops, outcome)
    metrics = getattr(breakers, "metrics", None)
    if metrics is not None:
        metrics.counter(
            "member_bulk_writes_total", cluster=cluster, result=outcome
        )
        metrics.histogram("member_batch_ops", n_ops, buckets=_BATCH_BUCKETS)


def run_member_batches(
    client,
    ops: list[dict],
    deadline: float,
    cluster: str = "",
    breakers=None,
    thread_registry: Optional[set] = None,
) -> list[dict]:
    """One member's staged writes as coalesced, pipelined bulk requests.

    Ops split into MEMBER_BATCH-sized chunks (WRITE_COALESCE=0:
    one op per request — the per-object A/B path) and dispatch under a
    MEMBER_INFLIGHT-bounded window; each chunk rides
    :func:`run_batch_with_retries`, so per-op 409/5xx retry semantics
    are identical to the un-coalesced path.  Between chunks the deadline
    budget and the member's breaker are re-checked: a deadline expiry
    mid-flush sheds the REMAINING chunks (their ops return the shed
    marker — continuations must not run, member_shed_writes_total
    counts them), and a breaker that opened mid-flush sheds without
    touching another socket.  Always returns one result per op."""
    n = len(ops)
    if n == 0:
        return []
    size = member_batch() if write_coalesce() else 1
    chunks = [ops[i:i + size] for i in range(0, n, size)]
    breaker = breakers.for_member(cluster) if breakers is not None else None

    def blocked() -> bool:
        if time.monotonic() >= deadline:
            return True
        return breaker is not None and not breaker.allow(consume_probe=False)

    # Pool threads have no view of the flushing thread's span stack:
    # capture the open dispatch span here so each chunk's span (and the
    # traceparent header its HTTP request carries) stays parented under
    # the flush — without this, pipelined chunks start orphan traces.
    flush_span = trace.get_default().current()

    def run_chunk(chunk: list[dict]) -> list[dict]:
        # In-process stores deliver watch events synchronously on the
        # writing thread: a pipelined chunk thread must count as "own
        # write" for the controller's echo suppression, or every member
        # write re-enqueues its object for a spurious re-sync.
        ident = threading.get_ident()
        added = thread_registry is not None and ident not in thread_registry
        if added:
            thread_registry.add(ident)
        try:
            if blocked():
                return [_SHED] * len(chunk)
            with trace.get_default().span_from(
                "dispatch.member_chunk", flush_span,
                cluster=cluster, ops=len(chunk),
            ):
                res = run_batch_with_retries(
                    client, chunk, deadline, cluster=cluster,
                    breakers=breakers,
                )
            _note_chunk(breakers, cluster, len(chunk), res)
            return res
        finally:
            if added:
                thread_registry.discard(ident)

    inflight = member_inflight()
    # A plain in-process store has no round trips to pipeline: chunk
    # threads would cost GIL churn and move its synchronous watch
    # delivery off the flushing thread for nothing.
    if type(client) is FakeKube:
        inflight = 1
    if len(chunks) == 1 or inflight <= 1:
        out: list[dict] = []
        for chunk in chunks:
            out.extend(run_chunk(chunk))
        shed_n = sum(1 for r in out if r.get("shed"))
        if shed_n:
            if breakers is not None:
                breakers.count_shed(cluster, shed_n)
            _note_shed_tenants(
                op for op, r in zip(ops, out) if r.get("shed"))
        return out
    # Pipelined window: up to MEMBER_INFLIGHT bulk requests in
    # flight at once (each chunk re-checks deadline/breaker at start,
    # so a mid-flush expiry degrades to shed markers, never new
    # sockets).  The pool is per-flush-per-member but bounded by the
    # caller's own concurrency (the sink's cluster fan-out pool).
    pool = ThreadPoolExecutor(
        max_workers=min(inflight, len(chunks)),
        thread_name_prefix=f"member-batch-{cluster}",
    )
    try:
        futures = [pool.submit(run_chunk, chunk) for chunk in chunks]
        out = []
        for f, chunk in zip(futures, chunks):
            try:
                out.extend(f.result())
            except Exception as e:  # defensive: run_chunk shouldn't raise
                out.extend(
                    [{"code": 500, "status": {"reason": "Transport",
                                              "message": str(e)}}] * len(chunk)
                )
    finally:
        pool.shutdown(wait=False)
    shed_n = sum(1 for r in out if r.get("shed"))
    if shed_n:
        if breakers is not None:
            breakers.count_shed(cluster, shed_n)
        _note_shed_tenants(op for op, r in zip(ops, out) if r.get("shed"))
    return out


_BULK_MISS = object()


def bulk_get(
    client,
    resource: str,
    keys: list[str],
    cluster: str = "",
    breakers=None,
) -> Optional[dict[str, Optional[dict]]]:
    """Batched point reads: ``get`` verbs through the bulk protocol,
    MEMBER_BATCH keys per request.  Returns {key: obj | None-for-404}
    — a key absent from the result means the read failed non-fatally and
    the caller should fall back to a direct read.  Returns None outright
    on a transport-level failure (the whole endpoint is unreachable;
    breaker evidence recorded)."""
    out: dict[str, Optional[dict]] = {}
    size = member_batch()
    breaker = breakers.for_member(cluster) if breakers is not None else None
    for i in range(0, len(keys), size):
        chunk = keys[i:i + size]
        start = time.monotonic()
        try:
            results = client.batch(
                [{"verb": "get", "resource": resource, "key": k} for k in chunk]
            )
        except Exception:
            if breaker is not None:
                breaker.record_failure(latency_s=time.monotonic() - start)
            return None
        if breaker is not None:
            breaker.note_ok(time.monotonic() - start)
        for k, res in zip(chunk, results):
            code = (res or {}).get("code")
            if code == 200:
                out[k] = res.get("object")
            elif code == 404:
                out[k] = None
            # anything else: leave the key out — direct-read fallback
    return out


# -- sinks ---------------------------------------------------------------
# Live sinks, for graceful shutdown: SIGTERM drains in-flight flushes
# under a bounded deadline and then finalizes every sink that still
# holds staged or in-flight writes — queued writes are SHED (recorded
# via member_shed_writes_total; the apiserver-durable state re-drives
# them on the next boot), never silently dropped, and no
# dispatch-flush-<cluster> helper thread survives the drain.
_LIVE_SINKS: "weakref.WeakSet" = weakref.WeakSet()


def finalize_all_sinks(deadline_s: float = 0.0) -> int:
    """Finalize every live sink (manager shutdown path); returns the
    number of writes shed."""
    shed = 0
    end = time.monotonic() + max(0.0, deadline_s)
    for sink in list(_LIVE_SINKS):
        try:
            shed += sink.finalize(max(0.0, end - time.monotonic()))
        except Exception:
            log.warning("sink finalize failed", exc_info=True)
    return shed


class ImmediateSink:
    """One client call per operation, inline or on a bounded pool
    (operation.go:102-123's per-cluster goroutine fan-out; pool size =
    the in-flight window, DISPATCH_POOL).

    Under WRITE_COALESCE (pooled mode only — the inline in-process
    path has no round trips to amortize), submits stage into a
    per-member buffer instead of dispatching one call per op; ``wait()``
    flushes each member's buffer through the pipelined bulk window
    (:func:`run_member_batches`), one pooled task per member."""

    def __init__(
        self,
        client_for_cluster: Callable[[str], FakeKube],
        pool: Optional[ThreadPoolExecutor] = None,
        inline: bool = False,
        breakers=None,
    ):
        self.client_for_cluster = client_for_cluster
        self._pool = pool
        self._own_pool = False
        self._inline = inline
        # (cluster, future, ops): ops is the shed weight a cancel counts.
        self._futures: list[tuple[str, Future, int]] = []
        self._finalized = False
        self.breakers = breakers
        self._coalesce = write_coalesce() and not inline
        self._staged: dict[str, list[tuple[dict, Callable[[dict], None]]]] = {}
        _LIVE_SINKS.add(self)

    def _flush_member(self, cluster: str, entries: list, deadline: float) -> None:
        """One member's coalesced buffer -> pipelined bulk batches."""
        with trace.span(
            "dispatch.member_write", cluster=cluster, ops=len(entries)
        ):
            if self.breakers is not None and not self.breakers.allow(
                cluster, consume_probe=False
            ):
                self.breakers.count_shed(cluster, len(entries))
                _note_shed_tenants(entries)
                return
            try:
                client = self.client_for_cluster(cluster)
            except Exception as e:
                results = [
                    {"code": 500, "status": {"reason": "Transport", "message": str(e)}}
                ] * len(entries)
            else:
                results = run_member_batches(
                    client,
                    [op for op, _ in entries],
                    deadline,
                    cluster=cluster,
                    breakers=self.breakers,
                )
            for (_, continuation), result in zip(entries, results):
                if result.get("shed"):
                    continue  # pre-recorded *_TIMED_OUT status stands
                try:
                    continuation(result)
                except Exception:
                    pass  # continuations record their own failures

    def submit(self, cluster: str, op: dict, continuation: Callable[[dict], None]) -> None:
        if self._finalized:
            # A stale continuation must never write into an already-
            # finalized status/version map; the sink is single-round.
            raise RuntimeError(
                "ImmediateSink already finalized by wait(); build a fresh sink"
            )
        if self._coalesce:
            self._staged.setdefault(cluster, []).append((op, continuation))
            return

        def run() -> None:
            with trace.span("dispatch.member_write", cluster=cluster):
                start = time.monotonic()
                try:
                    client = self.client_for_cluster(cluster)
                    result = client.batch([op])[0]
                except Exception as e:  # transport-level failure
                    result = {"code": 500, "status": {"reason": "Transport", "message": str(e)}}
                    if self.breakers is not None:
                        self.breakers.for_member(cluster).record_failure(
                            latency_s=time.monotonic() - start
                        )
                else:
                    elapsed = time.monotonic() - start
                    if self.breakers is not None:
                        self.breakers.for_member(cluster).note_ok(elapsed)
                        self.breakers.note_write(cluster, elapsed, ops=1)
                    slo.member_write(cluster, elapsed)
                    _note_write_tenants((op,), elapsed)
                continuation(result)

        if self._inline:
            try:
                run()
            except Exception:
                pass  # continuations record their own failures
            return
        if self._pool is None:
            self._pool = ThreadPoolExecutor(max_workers=dispatch_pool_size())
            self._own_pool = True
        self._futures.append((cluster, self._pool.submit(run), 1))

    def _flush_staged(self, deadline: float) -> None:
        """Coalesced mode: hand each member's buffered ops to one pooled
        flush task (the per-member pipelined bulk window runs inside)."""
        staged, self._staged = self._staged, {}
        if not staged:
            return
        if self._pool is None:
            self._pool = ThreadPoolExecutor(max_workers=dispatch_pool_size())
            self._own_pool = True
        for cluster, entries in staged.items():
            self._futures.append(
                (
                    cluster,
                    self._pool.submit(
                        self._flush_member, cluster, entries, deadline
                    ),
                    len(entries),
                )
            )

    def wait(self, timeout: float) -> None:
        """Drain the fan-out under the deadline.  On expiry, not-yet-
        started futures are CANCELLED (their pre-recorded *_TIMED_OUT
        statuses stand) and the sink becomes unusable — a late submit
        raises instead of mutating a finalized status map."""
        deadline = time.monotonic() + timeout
        self._flush_staged(deadline)
        try:
            for cluster, f, n_ops in self._futures:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    if f.cancel() and self.breakers is not None:
                        self.breakers.count_shed(cluster, n_ops)
                    continue
                try:
                    f.result(timeout=remaining)
                except FuturesTimeout:
                    if f.cancel() and self.breakers is not None:
                        self.breakers.count_shed(cluster, n_ops)
                except Exception:  # failure statuses were pre-recorded
                    pass
        finally:
            self._futures.clear()
            self._finalized = True
            if self._own_pool and self._pool is not None:
                self._pool.shutdown(wait=False, cancel_futures=True)
                self._pool = None
                self._own_pool = False

    def finalize(self, deadline_s: float = 0.0) -> int:
        """Graceful-shutdown drain: give in-flight writes ``deadline_s``
        to land, CANCEL (and count as shed) whatever has not started,
        and finalize the sink — a late submit raises.  Returns the shed
        count."""
        if self._finalized:
            return 0
        shed = 0
        # Coalesced ops still buffered never dispatched: all shed.
        staged, self._staged = self._staged, {}
        for cluster, entries in staged.items():
            shed += len(entries)
            if self.breakers is not None:
                self.breakers.count_shed(cluster, len(entries))
            _note_shed_tenants(entries)
        end = time.monotonic() + max(0.0, deadline_s)
        pending = list(self._futures)
        for cluster, f, n_ops in pending:
            if f.cancel():
                shed += n_ops
                if self.breakers is not None:
                    self.breakers.count_shed(cluster, n_ops)
                continue
            try:
                f.result(timeout=max(0.0, end - time.monotonic()))
            except FuturesTimeout:
                shed += n_ops  # running past the drain budget: abandoned
                if self.breakers is not None:
                    self.breakers.count_shed(cluster, n_ops)
            except Exception:
                pass
        self._futures.clear()
        self._finalized = True
        if self._own_pool and self._pool is not None:
            self._pool.shutdown(wait=False, cancel_futures=True)
            self._pool = None
            self._own_pool = False
        if shed:
            log.warning("ImmediateSink finalize shed %d write(s)", shed)
        return shed


class BatchSink:
    """Stage operations across MANY federated objects, flush ONE
    ``client.batch()`` per member cluster.  Shared by every dispatcher of
    a sync BatchWorker tick; the controller flushes before it finalizes
    any object's status."""

    def __init__(
        self,
        client_for_cluster: Callable[[str], FakeKube],
        pool: Optional[ThreadPoolExecutor] = None,
        thread_registry: Optional[set] = None,
        breakers=None,
        deadline: Optional[float] = None,
    ):
        self.client_for_cluster = client_for_cluster
        self._pool = pool
        self._staged: dict[str, list[tuple[dict, Callable[[dict], None]]]] = {}
        self.flushed = True
        self.breakers = breakers
        self.deadline = dispatch_deadline() if deadline is None else deadline
        # dispatch-flush-<cluster> helper threads this sink spawned for
        # stall-capable serial flushes; joined by finalize() so a
        # graceful shutdown leaves none behind (a genuinely stalled one
        # is daemon and its writes were already shed + accounted).
        self._helper_threads: list[threading.Thread] = []
        self._finalized = False
        _LIVE_SINKS.add(self)
        # Threads currently executing this sink's writes.  In-process
        # member stores deliver watch events synchronously on the writing
        # thread, so the owning controller treats events on these threads
        # as echoes of its own writes (the pool-flush analogue of the
        # tick-thread check).
        self.thread_registry = thread_registry if thread_registry is not None else set()

    def submit(self, cluster: str, op: dict, continuation: Callable[[dict], None]) -> None:
        if self._finalized:
            # The shutdown drain already shed this sink's queue; a late
            # stage would be silently lost — fail loudly instead.
            raise RuntimeError(
                "BatchSink already finalized by shutdown; build a fresh sink"
            )
        self._staged.setdefault(cluster, []).append((op, continuation))
        self.flushed = False

    def _client_can_stall(self, cluster: str) -> bool:
        """Whether this cluster's client can park a thread (sockets, or
        a fault-injecting proxy).  A plain in-process FakeKube cannot,
        and the serial path keeps calling it directly — no thread spawn
        on the local hot path."""
        try:
            client = self.client_for_cluster(cluster)
        except Exception:
            return False  # resolution failures are fast
        return type(client) is not FakeKube

    def flush(self, timeout: Optional[float] = None) -> None:
        """One batch round trip per member, in parallel across members
        when a pool is present.  Continuations run on the flushing
        thread(s); per-op failures stay in the results.

        The deadline budget (``timeout``, default DISPATCH_DEADLINE_S)
        is enforced on EVERY path: pooled flushes time out per future,
        and the serial path runs stall-capable clients on a bounded
        helper thread — a hung member sheds its writes (statuses stay at
        their pre-recorded *_TIMED_OUT values and the owning worker's
        backoff requeue re-drives them) instead of parking the tick."""
        if timeout is None:
            timeout = self.deadline
        staged, self._staged = self._staged, {}
        self.flushed = True
        if not staged:
            return
        deadline = time.monotonic() + timeout

        def flush_cluster(cluster: str, entries: list) -> None:
            # Register only our own ident and remove only what we added:
            # with BatchWorker(workers>1) two concurrent ticks flush their
            # own sinks into a SHARED registry, so a blanket clear() here
            # would wipe the other tick's in-flight registrations and its
            # member-write echoes would re-enqueue keys.
            ident = threading.get_ident()
            added = ident not in self.thread_registry
            if added:
                self.thread_registry.add(ident)
            try:
                with trace.span(
                    "dispatch.member_flush", cluster=cluster, ops=len(entries)
                ):
                    # A breaker that opened between staging and flush
                    # (a sibling batch's transport failures) sheds the
                    # WHOLE staged batch without touching a socket.
                    if self.breakers is not None and not self.breakers.allow(
                        cluster, consume_probe=False
                    ):
                        self.breakers.count_shed(cluster, len(entries))
                        _note_shed_tenants(entries)
                        return
                    try:
                        client = self.client_for_cluster(cluster)
                    except Exception as e:
                        results = [
                            {"code": 500, "status": {"reason": "Transport", "message": str(e)}}
                        ] * len(entries)
                    else:
                        results = run_member_batches(
                            client,
                            [op for op, _ in entries],
                            deadline,
                            cluster=cluster,
                            breakers=self.breakers,
                            thread_registry=self.thread_registry,
                        )
                    for (_, continuation), result in zip(entries, results):
                        if result.get("shed"):
                            # Shed before dispatch: the pre-recorded
                            # *_TIMED_OUT status stands.
                            continue
                        try:
                            continuation(result)
                        except Exception:
                            pass  # continuations record their own failures
            finally:
                if added:
                    self.thread_registry.discard(ident)

        def shed(cluster: str, entries: list, stalled: bool) -> None:
            """Deadline expired for this member's flush.  Statuses stay
            at their pre-recorded *_TIMED_OUT values; a genuinely
            stalled flush (vs one merely queued behind a sick sibling)
            also opens the member's breaker."""
            log.warning(
                "shedding %d member write(s): cluster=%s stalled=%s "
                "(deadline %.1fs expired; statuses stay *_TIMED_OUT, the "
                "owning worker's backoff requeue re-drives them)",
                len(entries), cluster, stalled, timeout,
            )
            with trace.span(
                "dispatch.shed", cluster=cluster, ops=len(entries),
                stalled=stalled,
            ):
                _note_shed_tenants(entries)
                if self.breakers is None:
                    return
                self.breakers.count_shed(cluster, len(entries))
                if stalled:
                    self.breakers.for_member(cluster).record_failure(
                        timeout=True
                    )

        if self._pool is not None:
            futures = {
                self._pool.submit(flush_cluster, cluster, entries): (cluster, entries)
                for cluster, entries in staged.items()
            }
            for f, (cluster, entries) in futures.items():
                try:
                    f.result(timeout=max(0.0, deadline - time.monotonic()))
                except FuturesTimeout:
                    # cancel() succeeds only when the flush never started
                    # (queued behind siblings): shed without blaming the
                    # member.  A running one IS stalled in its client.
                    shed(cluster, entries, stalled=not f.cancel())
                except Exception:
                    pass
        else:
            for cluster, entries in staged.items():
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    shed(cluster, entries, stalled=False)
                    continue
                if not self._client_can_stall(cluster):
                    flush_cluster(cluster, entries)
                    continue
                t = threading.Thread(
                    target=flush_cluster,
                    args=(cluster, entries),
                    name=f"dispatch-flush-{cluster}",
                    daemon=True,
                )
                self._helper_threads.append(t)
                t.start()
                t.join(remaining)
                if t.is_alive():
                    # Left to die on the client's own timeout; the tick
                    # moves on.
                    shed(cluster, entries, stalled=True)
        self._helper_threads = [t for t in self._helper_threads if t.is_alive()]

    def wait(self, timeout: float) -> None:
        # Dispatchers sharing this sink call wait() after the controller
        # has flushed the tick; anything still staged (a mid-reconcile
        # wait, e.g. the deletion path) flushes now.
        if not self.flushed:
            self.flush(timeout)

    def finalize(self, deadline_s: float = 0.0) -> int:
        """Graceful-shutdown drain (SIGTERM path): writes still STAGED
        are shed — recorded via the existing member_shed_writes_total
        counter, with their pre-recorded *_TIMED_OUT statuses standing,
        exactly like a deadline expiry — and the dispatch-flush helper
        threads are joined under the remaining budget so none survives
        the drain (a thread that outlives it belongs to a stalled
        member whose writes were already shed + breaker-opened).
        Returns the shed count; a later submit raises."""
        if self._finalized:
            return 0
        self._finalized = True
        staged, self._staged = self._staged, {}
        self.flushed = True
        shed = 0
        for cluster, entries in staged.items():
            shed += len(entries)
            log.warning(
                "shutdown: shedding %d staged member write(s): cluster=%s",
                len(entries), cluster,
            )
            if self.breakers is not None:
                self.breakers.count_shed(cluster, len(entries))
            _note_shed_tenants(entries)
        end = time.monotonic() + max(0.0, deadline_s)
        for t in self._helper_threads:
            t.join(max(0.0, end - time.monotonic()))
        self._helper_threads = [t for t in self._helper_threads if t.is_alive()]
        return shed


def _result_error(result: dict) -> str:
    status = result.get("status") or {}
    return status.get("message") or status.get("reason") or f"code {result.get('code')}"


def _set_last_replicaset_name(obj: dict, cluster_obj: dict) -> None:
    """When a new template revision is being dispatched, remember which
    ReplicaSet was newest BEFORE it, so stale latest-replicaset
    annotations are recognizable (retain.go setLastReplicasetName)."""
    if cluster_obj is None:
        return
    ann = obj.get("metadata", {}).get("annotations", {})
    revision = ann.get(CURRENT_REVISION_ANNOTATION)
    if revision is None:
        return
    cluster_ann = cluster_obj.get("metadata", {}).get("annotations", {})
    last_dispatched = cluster_ann.get(CURRENT_REVISION_ANNOTATION)
    if last_dispatched is not None and revision != last_dispatched:
        rs_name = cluster_ann.get(LATEST_RS_NAME)
        if rs_name is not None:
            obj.setdefault("metadata", {}).setdefault("annotations", {})[
                LAST_RS_NAME
            ] = rs_name


def _retain_template(
    obj: dict, cluster_obj: dict, replicas_path: str, keep_rollout_settings: bool
) -> None:
    """Keep the member's current pod template (and optionally its rollout
    knobs) in the desired object: "not your turn yet"
    (retain.go retainTemplate)."""
    tpl = get_path(cluster_obj, "spec.template")
    if tpl is not None:
        set_path(obj, "spec.template", tpl)
    else:
        delete_path(obj, "spec.template")
    ann = obj.setdefault("metadata", {}).setdefault("annotations", {})
    cluster_revision = cluster_obj.get("metadata", {}).get("annotations", {}).get(
        CURRENT_REVISION_ANNOTATION
    )
    if cluster_revision is not None:
        ann[CURRENT_REVISION_ANNOTATION] = cluster_revision
    else:
        ann.pop(CURRENT_REVISION_ANNOTATION, None)
    if keep_rollout_settings:
        if replicas_path:
            replicas = get_path(cluster_obj, replicas_path)
            if replicas is not None:
                set_path(obj, replicas_path, replicas)
            else:
                delete_path(obj, replicas_path)
        for path in (MAX_SURGE_PATH, MAX_UNAVAILABLE_PATH):
            dotted = path[1:].replace("/", ".")
            value = get_path(cluster_obj, dotted)
            if value is not None:
                set_path(obj, dotted, value)
            else:
                delete_path(obj, dotted)


class ManagedDispatcher:
    """One sync round's write fan-out (managed.go:77-126).

    ``client_for_cluster`` returns the member apiserver handle; failures
    of individual operations are recorded per cluster, never raised.
    ``sink`` routes the writes (shared BatchSink across a tick, or a
    private ImmediateSink mirroring the reference's goroutines)."""

    def __init__(
        self,
        client_for_cluster: Callable[[str], FakeKube],
        fed_resource: FederatedResource,
        resource: str,
        replicas_path: str = "",
        skip_adopting: bool = True,
        pool: Optional[ThreadPoolExecutor] = None,
        timeout: float = 30.0,
        rollout_overrides: Optional[Callable[[str], list]] = None,
        inline: bool = False,
        sink=None,
        on_written: Optional[Callable[[str, dict], None]] = None,
        breakers=None,
    ):
        self.client_for_cluster = client_for_cluster
        self.fed = fed_resource
        self.resource = resource
        self.replicas_path = replicas_path
        self.skip_adopting = skip_adopting
        self.timeout = timeout
        self.rollout_overrides = rollout_overrides
        self.breakers = breakers if breakers is not None else getattr(
            sink, "breakers", None
        )
        self._sink = sink or ImmediateSink(
            client_for_cluster, pool=pool, inline=inline, breakers=self.breakers
        )
        self._on_written = on_written
        self._lock = threading.Lock()
        self._status: dict[str, str] = {}
        self._versions: dict[str, str] = {}
        self._errors: dict[str, str] = {}
        self._resources_updated = False
        # Desired-object assembly dedup: clusters sharing an override
        # patch list share ONE assembled object (consumers that mutate —
        # the retention paths — copy first; create paths hand the shared
        # object to clients, which serialize/copy on write).
        self._desired_cache: dict[object, dict] = {}
        # id(patches) -> serialized cache key: the patch lists live in
        # fed._ordered_overrides()'s cached dict (pinned by self.fed for
        # this dispatcher's lifetime, so ids cannot be recycled), and
        # re-serializing the same list per member cluster was a
        # measurable share of the sync hot path.
        self._patch_keys: dict[int, str] = {}

    # -- bookkeeping -----------------------------------------------------
    def _submit(self, cluster: str, op: dict, continuation: Callable[[dict], None]) -> None:
        """Stage one member write, short-circuiting through the member's
        circuit breaker: an OPEN member costs a status record, never a
        thread parked on a dead socket (the ClusterNotReady propagation
        the reference assigns unreachable members).  In HALF_OPEN the
        first write through is the probe; the rest shed until it lands."""
        if self.breakers is not None:
            breaker = self.breakers.for_member(cluster)
            if not breaker.allow():
                self.breakers.count_shed(cluster)
                _note_shed_tenants((op,))
                self.record_error(
                    cluster, CLUSTER_NOT_READY, "member circuit breaker open"
                )
                return
        self._sink.submit(cluster, op, continuation)

    def record_status(self, cluster: str, status: str) -> None:
        with self._lock:
            self._status[cluster] = status

    def record_error(self, cluster: str, status: str, err: str) -> None:
        with self._lock:
            self._status[cluster] = status
            self._errors[cluster] = err

    def _record_version(self, cluster: str, version: str) -> None:
        with self._lock:
            self._versions[cluster] = version
            self._status[cluster] = OK

    def _record_written(self, cluster: str, obj: dict) -> None:
        """A real write landed: record version AND surface the written
        object (its raw resourceVersion feeds the controller's watch-echo
        suppression).  Version-based skips must NOT come through here —
        they produce no watch event to suppress."""
        self._record_version(cluster, object_version(obj))
        if self._on_written is not None:
            self._on_written(cluster, obj)

    def wait(self) -> bool:
        """Block until every operation finishes or the shared deadline
        passes (managed.go:126-159); returns False when any cluster ended
        in a non-OK, non-waiting state."""
        self._sink.wait(self.timeout)
        with self._lock:
            return all(
                s in (OK, WAITING_FOR_REMOVAL, WAITING)
                for s in self._status.values()
            )

    @property
    def version_map(self) -> dict[str, str]:
        with self._lock:
            return dict(self._versions)

    @property
    def status_map(self) -> dict[str, str]:
        with self._lock:
            return dict(self._status)

    @property
    def resources_updated(self) -> bool:
        return self._resources_updated

    # -- desired-object assembly ----------------------------------------
    def _desired(self, cluster: str, mutable: bool = False) -> dict:
        """Assembled desired object for a cluster.  Clusters whose
        override patch lists are identical (the common case — overrides
        come from shared policies) get ONE shared assembly; pass
        ``mutable=True`` to receive a private copy (retention paths
        mutate the object in place)."""
        extra = self.rollout_overrides(cluster) if self.rollout_overrides else None
        patches = self.fed._ordered_overrides().get(cluster) or ()
        if not patches and not extra:
            key = ""  # the common no-override case skips key serialization
        elif extra is None:
            key = self._patch_keys.get(id(patches))
            if key is None:
                key = json.dumps([patches, None], sort_keys=True, default=str)
                with self._lock:
                    self._patch_keys[id(patches)] = key
        else:
            key = json.dumps([patches, extra], sort_keys=True, default=str)
        with self._lock:
            obj = self._desired_cache.get(key)
        if obj is None:
            obj = self.fed.object_for_cluster(cluster)
            obj = self.fed.apply_overrides(obj, cluster, extra)
            retain.record_propagated_keys(obj)
            with self._lock:
                self._desired_cache[key] = obj
        if mutable:
            return copy_json(obj)
        return obj

    # -- operations ------------------------------------------------------
    def create(self, cluster: str) -> None:
        """Create, falling back to adoption-aware update on AlreadyExists
        (managed.go:325-400)."""
        self.record_status(cluster, CREATION_TIMED_OUT)
        try:
            obj = self._desired(cluster)
        except Exception as e:
            return self.record_error(cluster, COMPUTE_RESOURCE_FAILED, str(e))

        def done(result: dict) -> None:
            code = result.get("code")
            if code == 201:
                self._resources_updated = True
                self._record_written(cluster, result["object"])
                return
            if not (
                code == 409
                and (result.get("status") or {}).get("reason") == "AlreadyExists"
            ):
                return self.record_error(cluster, CREATION_FAILED, _result_error(result))
            # AlreadyExists: the adoption-aware fallback (rare path, runs
            # direct client calls on the flushing thread).
            client = self.client_for_cluster(cluster)
            try:
                existing = client.get(self.resource, self.fed.key)
            except NotFound as e:
                return self.record_error(cluster, CREATION_FAILED, str(e))
            if self.skip_adopting:
                return self.record_error(
                    cluster, ALREADY_EXISTS, "resource pre-exists in cluster"
                )
            if not has_managed_label(existing):
                existing.setdefault("metadata", {}).setdefault("annotations", {})[
                    ADOPTED_ANNOTATION
                ] = "true"
            self._update_now(cluster, existing, adopting=True)

        self._submit(
            cluster, {"verb": "create", "resource": self.resource, "object": obj}, done
        )

    def update(self, cluster: str, cluster_obj: dict, recorded_version: str = "") -> None:
        self.record_status(cluster, UPDATE_TIMED_OUT)
        self._stage_update(cluster, cluster_obj, recorded_version=recorded_version)

    def _prepare_update(
        self,
        cluster: str,
        cluster_obj: dict,
        recorded_version: str = "",
        adopting: bool = False,
    ) -> Optional[dict]:
        """(managed.go:402-476): retention + version-based skip.  Returns
        the object to write, or None when bookkeeping already settled the
        cluster (skip or failure, recorded)."""
        if is_explicitly_unmanaged(cluster_obj):
            self.record_error(
                cluster,
                MANAGED_LABEL_FALSE,
                f"object has label {C.MANAGED_LABEL}=false",
            )
            return None
        try:
            obj = self._desired(cluster, mutable=True)
        except Exception as e:
            self.record_error(cluster, COMPUTE_RESOURCE_FAILED, str(e))
            return None
        if adopting:
            ann = cluster_obj.get("metadata", {}).get("annotations", {})
            if ann.get(ADOPTED_ANNOTATION):
                obj.setdefault("metadata", {}).setdefault("annotations", {})[
                    ADOPTED_ANNOTATION
                ] = "true"
        try:
            retain.retain_cluster_fields(self.fed.target_kind, obj, cluster_obj)
            retain.retain_replicas(obj, cluster_obj, self.fed.obj, self.replicas_path)
            if self.fed.target_kind == "Deployment":
                _set_last_replicaset_name(obj, cluster_obj)
        except Exception as e:
            self.record_error(cluster, FIELD_RETENTION_FAILED, str(e))
            return None

        if recorded_version and not object_needs_update(
            obj, cluster_obj, recorded_version, self.replicas_path
        ):
            # Current: still record the version so status reflects it.
            self._record_version(cluster, recorded_version)
            return None
        return obj

    def _update_done(self, cluster: str) -> Callable[[dict], None]:
        def done(result: dict) -> None:
            if result.get("code") == 200:
                self._resources_updated = True
                self._record_written(cluster, result["object"])
            else:
                self.record_error(cluster, UPDATE_FAILED, _result_error(result))

        return done

    def _stage_update(
        self,
        cluster: str,
        cluster_obj: dict,
        recorded_version: str = "",
        adopting: bool = False,
    ) -> None:
        obj = self._prepare_update(cluster, cluster_obj, recorded_version, adopting)
        if obj is None:
            return
        self._submit(
            cluster,
            {"verb": "update", "resource": self.resource, "object": obj},
            self._update_done(cluster),
        )

    def _update_now(self, cluster: str, cluster_obj: dict, adopting: bool = False) -> None:
        """Direct (non-staged) update, used by the create fallback which
        already runs on a flushing thread."""
        obj = self._prepare_update(cluster, cluster_obj, adopting=adopting)
        if obj is None:
            return
        client = self.client_for_cluster(cluster)
        try:
            updated = client.update(self.resource, obj)
        except Exception as e:
            return self.record_error(cluster, UPDATE_FAILED, str(e))
        self._resources_updated = True
        self._record_written(cluster, updated)

    def patch_and_keep_template(
        self,
        cluster: str,
        cluster_obj: dict,
        keep_rollout_settings: bool,
        recorded_version: str = "",
    ) -> None:
        """Dispatch everything EXCEPT the pod template: an unplanned
        cluster waits its rollout turn with its current template (and,
        with ``keep_rollout_settings``, its current replicas/fenceposts)
        (managed.go:483-560 PatchAndKeepTemplate)."""
        self.record_status(cluster, UPDATE_TIMED_OUT)
        if is_explicitly_unmanaged(cluster_obj):
            return self.record_error(
                cluster,
                MANAGED_LABEL_FALSE,
                f"object has label {C.MANAGED_LABEL}=false",
            )
        try:
            obj = self._desired(cluster, mutable=True)
        except Exception as e:
            return self.record_error(cluster, COMPUTE_RESOURCE_FAILED, str(e))
        try:
            retain.retain_cluster_fields(self.fed.target_kind, obj, cluster_obj)
            retain.retain_replicas(
                obj, cluster_obj, self.fed.obj, self.replicas_path
            )
            # No _set_last_replicaset_name here: _retain_template just
            # forced the revision annotations equal, so the real
            # update() path is where the last-RS marker gets written.
            _retain_template(
                obj, cluster_obj, self.replicas_path, keep_rollout_settings
            )
        except Exception as e:
            return self.record_error(cluster, FIELD_RETENTION_FAILED, str(e))

        if recorded_version and not object_needs_update(
            obj, cluster_obj, recorded_version, self.replicas_path
        ):
            self._record_version(cluster, recorded_version)
            return
        self._submit(
            cluster,
            {"verb": "update", "resource": self.resource, "object": obj},
            self._update_done(cluster),
        )

    def delete(self, cluster: str) -> None:
        """Delete from a member cluster (unmanaged.go Delete): the object
        stays WAITING_FOR_REMOVAL until the member confirms it gone."""
        self.record_status(cluster, DELETION_TIMED_OUT)

        def done(result: dict) -> None:
            code = result.get("code")
            if code == 404:
                with self._lock:
                    self._status.pop(cluster, None)
                return
            if code != 200:
                return self.record_error(cluster, DELETION_FAILED, _result_error(result))
            self._resources_updated = True
            client = self.client_for_cluster(cluster)
            if client.try_get(self.resource, self.fed.key) is None:
                with self._lock:
                    self._status.pop(cluster, None)
            else:
                self.record_status(cluster, WAITING_FOR_REMOVAL)

        self._submit(
            cluster,
            {"verb": "delete", "resource": self.resource, "key": self.fed.key},
            done,
        )

    def remove_managed_label(self, cluster: str, cluster_obj: dict) -> None:
        """Orphaning: strip the managed label + adopted annotation instead
        of deleting (unmanaged.go RemoveManagedLabel)."""
        self.record_status(cluster, UPDATE_TIMED_OUT)
        # Deep copy: cluster_obj may be a no-copy store VIEW, and a
        # shallow dict() would mutate the store's nested metadata.
        obj = copy_json(cluster_obj)
        labels = obj.get("metadata", {}).get("labels", {})
        labels.pop(C.MANAGED_LABEL, None)
        obj.get("metadata", {}).get("annotations", {}).pop(ADOPTED_ANNOTATION, None)

        def done(result: dict) -> None:
            if result.get("code") == 200:
                with self._lock:
                    self._status.pop(cluster, None)
            else:
                self.record_error(cluster, UPDATE_FAILED, _result_error(result))

        self._submit(
            cluster, {"verb": "update", "resource": self.resource, "object": obj}, done
        )
