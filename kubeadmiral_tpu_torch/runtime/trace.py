"""Lightweight span tracer for the reconcile path.

The part of ``kubeadmiral_tpu/runtime/trace.py`` that the worker, the
controllers, the streaming front end and the member dispatch call: a
context-manager span API with a thread-local stack (so child spans
record their parent and share its trace id), explicitly parented spans
for work handed to another thread (``Tracer.span_from``) and a bounded
ring of completed spans.  Overhead per span is two ``perf_counter``
calls and a deque append, so it stays on.

Left out until the HTTP transport is ported, since nothing in process
reaches them: the W3C traceparent propagation
(``current_traceparent``, ``Tracer.server_span``) and the Chrome
trace-event export served at ``GET /debug/trace``.  The JAX module's ``KT_TRACE_SAMPLE_N`` is
SAMPLE_N here, with its default.
"""

from __future__ import annotations

import itertools
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

    def current(self) -> Optional[Span]:
        stack = self._stack()
        return stack[-1] if stack else None

    def clear(self) -> None:
        self._ring.clear()

    def spans(self) -> list[Span]:
        return list(self._ring)


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
    """The skipped-sample stand-in: accepts set()."""

    __slots__ = ()

    def set(self, **args) -> None:
        pass


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
