"""Lightweight span tracer for the reconcile path.

The part of ``kubeadmiral_tpu/runtime/trace.py`` that the worker, the
controllers, the streaming front end and the member dispatch call: a
context-manager span API with a thread-local stack (so child spans
record their parent and share its trace id), explicitly parented spans
for work handed to another thread (``Tracer.span_from``) and a bounded
ring of completed spans.  Overhead per span is two ``perf_counter``
calls and a deque append, so it stays on.

The ring exports as Chrome trace-event JSON (``Tracer.chrome_trace``,
served at ``GET /debug/trace`` by ``runtime/profiling.py``, which merges
the dispatch ledger's device lanes in on the same :func:`epoch`).  The
export carries ``otherData.wall_epoch``, the wall-clock instant of this
process's epoch, so two processes' traces align on one timeline.

Cross-process correlation: :func:`current_traceparent` renders the
innermost open span as a W3C traceparent header value
(``00-<trace id>-<span id>-01``); the HTTP client
(``transport/client.py``) injects it on every request, and
:meth:`Tracer.server_span` on the apiserver side adopts the inbound
trace id and parent, so the server-side span is a true child of the
caller's span across process boundaries.  The JAX module's
``KT_TRACE_SAMPLE_N`` is SAMPLE_N here, with its default.
"""

from __future__ import annotations

import itertools
import json
import os
import threading
import time
from collections import deque
from contextlib import contextmanager
from typing import Optional

DEFAULT_RING = 16384

# One epoch per process: span timestamps are seconds since this moment,
# comparable across threads and tracers.
_EPOCH = time.perf_counter()


def epoch() -> float:
    """The process trace epoch (a perf_counter reading): other
    timestamp sources merging into the Chrome trace — the dispatch
    ledger's device lanes (runtime/devprof.py) — subtract this so one
    trace load shows host spans and device records on one timeline."""
    return _EPOCH


def wall_epoch() -> float:
    """The wall-clock time (``time.time()``) of :func:`epoch` — the
    per-process anchor that makes two processes' trace timestamps
    comparable: ``wall = wall_epoch() + span.start``.  Recomputed from
    the current clocks on each call (drift between the two clocks over
    a process lifetime is far below the microsecond resolution of the
    export)."""
    return time.time() - (time.perf_counter() - _EPOCH)


def format_traceparent(trace_id: str, span_id: int) -> str:
    """``00-<32 hex trace id>-<16 hex span id>-01`` (W3C traceparent)."""
    return f"00-{trace_id}-{span_id & ((1 << 64) - 1):016x}-01"


def parse_traceparent(header: Optional[str]) -> Optional[tuple[str, int]]:
    """(trace_id, parent span id) from a traceparent header, or None
    for anything malformed — a bad header degrades to an unparented
    server span, never an error on the request path."""
    if not header:
        return None
    parts = header.strip().split("-")
    if len(parts) != 4 or parts[0] != "00":
        return None
    trace_id, span_hex = parts[1], parts[2]
    if len(trace_id) != 32 or len(span_hex) != 16:
        return None
    try:
        int(trace_id, 16)
        span_id = int(span_hex, 16)
    except ValueError:
        return None
    if span_id == 0 or int(trace_id, 16) == 0:
        return None
    return trace_id.lower(), span_id


class Span:
    __slots__ = (
        "name", "span_id", "parent_id", "trace_id", "start", "end",
        "args", "tid", "thread_name",
    )

    def __init__(
        self, name: str, span_id: int, parent_id: Optional[int],
        trace_id: str, args: dict,
    ):
        self.name = name
        self.span_id = span_id
        self.parent_id = parent_id
        self.trace_id = trace_id
        self.start = time.perf_counter() - _EPOCH
        self.end: Optional[float] = None
        self.args = args
        self.tid = threading.get_ident()
        self.thread_name = threading.current_thread().name

    def set(self, **args) -> None:
        """Attach attributes to an open span (e.g. a result count known
        only at the end of the work)."""
        self.args.update(args)

    def traceparent(self) -> str:
        """This span as a traceparent header value."""
        return format_traceparent(self.trace_id, self.span_id)


class Tracer:
    def __init__(self, ring: int = DEFAULT_RING):
        # Bounded deque; append/clear/iteration-snapshot are each atomic
        # under the GIL, so the hot record path takes NO lock — a storm
        # of writer threads must not serialize on the tracer.
        self._ring: deque[Span] = deque(maxlen=ring)
        self._ids = itertools.count(1)
        # A random 32-bit prefix over the local counter keeps span ids
        # unique across tracers (and keeps the hot path a counter
        # increment).
        self._id_base = int.from_bytes(os.urandom(4), "big") << 32
        self._local = threading.local()

    def _stack(self) -> list:
        stack = getattr(self._local, "stack", None)
        if stack is None:
            stack = self._local.stack = []
        return stack

    def _span_gen(self, name, trace_id, parent_id, args):
        stack = self._stack()
        sp = Span(name, self._id_base | next(self._ids), parent_id, trace_id, args)
        stack.append(sp)
        try:
            yield sp
        finally:
            sp.end = time.perf_counter() - _EPOCH
            stack.pop()
            self._ring.append(sp)

    @contextmanager
    def span(self, name: str, **args):
        stack = self._stack()
        if stack:
            trace_id, parent_id = stack[-1].trace_id, stack[-1].span_id
        else:
            # A fresh 128-bit trace id per root span, lowercase hex.
            trace_id, parent_id = os.urandom(16).hex(), None
        yield from self._span_gen(name, trace_id, parent_id, args)

    @contextmanager
    def span_from(self, name: str, parent: Optional[Span], **args):
        """A span explicitly parented on ``parent`` — for work handed to
        another thread (pool-submitted dispatch chunks), where the
        submitting thread's stack is invisible to the worker.  A None
        parent falls back to :meth:`span` semantics."""
        if parent is None:
            with self.span(name, **args) as sp:
                yield sp
            return
        yield from self._span_gen(name, parent.trace_id, parent.span_id, args)

    @contextmanager
    def server_span(self, name: str, traceparent: Optional[str], **args):
        """The server half of cross-process propagation: a span adopting
        the inbound header's trace id with the caller's span as parent,
        so a member-apiserver write shows up as a child of the manager's
        dispatch span in the assembled trace.  No/invalid header opens
        an ordinary (locally rooted) span."""
        ctx = parse_traceparent(traceparent)
        if ctx is None:
            with self.span(name, **args) as sp:
                yield sp
            return
        trace_id, parent_id = ctx
        args["remote_parent"] = True
        yield from self._span_gen(name, trace_id, parent_id, args)

    def current(self) -> Optional[Span]:
        stack = self._stack()
        return stack[-1] if stack else None

    def current_traceparent(self) -> Optional[str]:
        """The innermost open span as a traceparent header value, or
        None when this thread has no open span."""
        sp = self.current()
        return sp.traceparent() if sp is not None else None

    def clear(self) -> None:
        self._ring.clear()

    def spans(self) -> list[Span]:
        return list(self._ring)

    def chrome_trace(self) -> dict:
        """The completed ring as Chrome trace-event JSON: one complete
        ("X") event per span (ts/dur in microseconds), span/parent/trace
        ids in args so nesting survives tools that ignore timing, plus
        thread-name metadata events and the per-process wall-clock
        anchor (``otherData.wall_epoch``)."""
        pid = os.getpid()
        events = []
        threads: dict[int, str] = {}
        for sp in self.spans():
            threads.setdefault(sp.tid, sp.thread_name)
            args = {"span_id": sp.span_id, "trace_id": sp.trace_id}
            if sp.parent_id is not None:
                args["parent_id"] = sp.parent_id
            args.update(sp.args)
            events.append(
                {
                    "name": sp.name,
                    "ph": "X",
                    "ts": round(sp.start * 1e6, 3),
                    "dur": round(((sp.end or sp.start) - sp.start) * 1e6, 3),
                    "pid": pid,
                    "tid": sp.tid,
                    "args": args,
                }
            )
        for tid, tname in threads.items():
            events.append(
                {
                    "name": "thread_name",
                    "ph": "M",
                    "pid": pid,
                    "tid": tid,
                    "args": {"name": tname},
                }
            )
        return {
            "traceEvents": events,
            "displayTimeUnit": "ms",
            "otherData": {"wall_epoch": wall_epoch(), "pid": pid},
        }

    def chrome_trace_json(self) -> str:
        return json.dumps(self.chrome_trace())


_default = Tracer()


def get_default() -> Tracer:
    return _default


def span(name: str, **args):
    """Open a span on the process-default tracer."""
    return _default.span(name, **args)


# -- sampled hot-path spans ---------------------------------------------------
#
# Per-event handler spans (worker.reconcile) cost two perf_counter calls,
# a dict build and a deque append PER EVENT — at the 10000x500 scale that
# is millions of spans whose ring evicts all but the last 16k anyway.
# hot_span() keeps 1 in SAMPLE_N of them, with a fast no-allocation
# pass-through for the skipped ones.  Ticks and coarser once-per-batch
# spans stay unconditional — sampling is only for per-event/per-key
# fan-out sites.

SAMPLE_N = 64

_sample_counter = itertools.count()


class _NullSpan:
    """The skipped-sample stand-in: accepts set() and traceparent()."""

    __slots__ = ()

    def set(self, **args) -> None:
        pass

    def traceparent(self) -> Optional[str]:
        return None


_NULL_SPAN = _NullSpan()


@contextmanager
def _null_span():
    yield _NULL_SPAN


def hot_span(name: str, **args):
    """A sampled span for per-event hot paths: records 1 in SAMPLE_N
    calls on the default tracer, a cheap counter bump + no-op context
    otherwise.  Sampled-out calls leave the thread's span stack
    untouched (children of a skipped span root normally)."""
    if next(_sample_counter) % SAMPLE_N:
        return _null_span()
    args["sampled_1_in"] = SAMPLE_N
    return _default.span(name, **args)


def current_traceparent() -> Optional[str]:
    """The calling thread's innermost open span on the default tracer,
    as a traceparent header value (None with no open span)."""
    return _default.current_traceparent()
