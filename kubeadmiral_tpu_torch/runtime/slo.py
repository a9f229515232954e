"""End-to-end SLO provenance: the token half the scheduling path feeds.

The part of ``kubeadmiral_tpu/runtime/slo.py`` that the store, the
federate controller and the scheduler controller call.  A birth
timestamp (a provenance token) is minted where a watch event enters the
control plane (``FakeKube._notify`` and the batch flush call
:func:`ingest`) for the source resources the federate controller
registers (:func:`track`).  Pipeline stages close marks on the token as
the object moves: ``queued`` (ingress → scheduler tick pickup), ``slab``
(scheduling-unit assembly), ``engine`` (the solve), ``fetch`` (placement
persisted to the host), then ``dispatch`` and ``write`` on the member
half.

Left out until the member half (sync, dispatch) is ported, since
nothing on the scheduling path reaches them: the token's completion
(``expect`` / ``written`` / ``settle``), the stage histograms and
exemplar ring, the freshness gauges, the burn-rate evaluator and
``member_write``.  The JAX module's ``KT_SLO*`` knobs configure those
parts; of them only ``KT_SLO`` (token path on, the default) and
``KT_SLO_PENDING_CAP`` (PENDING_CAP) apply here, as constants with
JAX's defaults.
"""

from __future__ import annotations

import threading
import time
import weakref
from typing import Iterable, Optional

from kubeadmiral_tpu_torch.runtime import metric_catalog as MC
from kubeadmiral_tpu_torch.runtime.metrics import Metrics

# Provenance stage vocabulary, in pipeline order.
STAGES = MC.SLO_STAGES

# In-flight tokens kept at most (the JAX module's KT_SLO_PENDING_CAP
# default); later events are counted as dropped.
PENDING_CAP = 200000


class _Pending:
    """One in-flight provenance token."""

    __slots__ = ("key", "birth", "gen", "marks")

    def __init__(self, key: str, birth: float, gen: Optional[int]):
        self.key = key
        self.birth = birth
        self.gen = gen
        self.marks: list[tuple[str, float]] = []


class SLORecorder:
    """Provenance tokens and their stage marks.

    One instance per control plane (the process default mirrors
    trace/flightrec); its own :class:`Metrics` registry holds
    ``slo_events_total``.
    """

    def __init__(self, metrics: Optional[Metrics] = None, clock=time.monotonic):
        self.enabled = True
        self.metrics = metrics if metrics is not None else Metrics()
        self.clock = clock
        self._lock = threading.RLock()
        self._pending: dict[str, _Pending] = {}
        # Ingress stores whose events mint tokens: store → {resources}.
        # Weak keys so a torn-down fleet's host cannot alias a recycled
        # id, and the recorder never pins test fleets alive.
        self._tracked: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()
        # Last seen metadata.generation per key: MODIFIED events that do
        # not bump it (finalizer/annotation/status echoes of our own
        # writes) must not re-mint — they are not new intent.
        self._gen: dict[str, int] = {}

    def track(self, store, resource: str) -> None:
        """Register (store, resource) as a token-minting ingress."""
        with self._lock:
            try:
                resources = self._tracked.get(store)
                if resources is None:
                    resources = set()
                    self._tracked[store] = resources
                resources.add(resource)
            except TypeError:
                pass  # un-weakref-able store: nothing to track

    def tracked(self, store, resource: str) -> bool:
        try:
            resources = self._tracked.get(store)
        except TypeError:
            return False
        return resources is not None and resource in resources

    def ingest(self, store, resource: str, event: str, obj: dict) -> None:
        """Called by the store's dispatch point ONCE per event.  Mints a
        token for tracked resources; DELETED forgets; MODIFIED without a
        generation bump is an echo and mints nothing."""
        if not self.enabled or not self.tracked(store, resource):
            return
        meta = obj.get("metadata", {}) or {}
        ns = meta.get("namespace", "")
        name = meta.get("name", "")
        key = f"{ns}/{name}" if ns else name
        if not name:
            return
        if event == "DELETED":
            self.forget(key)
            return
        gen = meta.get("generation")
        t = self.clock()
        with self._lock:
            if gen is not None:
                last = self._gen.get(key)
                if last is not None and int(gen) <= last:
                    self.metrics.counter("slo_events_total", result="echo")
                    return
                self._gen[key] = int(gen)
            if key in self._pending:
                # Newer intent supersedes the in-flight token: latency is
                # measured from the LAST event that changed the object.
                self.metrics.counter("slo_events_total", result="superseded")
            elif len(self._pending) >= PENDING_CAP:
                self.metrics.counter("slo_events_total", result="dropped")
                return
            else:
                self.metrics.counter("slo_events_total", result="minted")
            self._pending[key] = _Pending(key, t, gen)

    def forget(self, key: str) -> None:
        """Object deleted: its pending token (if any) is void."""
        with self._lock:
            self._gen.pop(key, None)
            if self._pending.pop(key, None) is not None:
                self.metrics.counter("slo_events_total", result="forgotten")

    def mark_many(
        self, keys: Iterable[str], stage: str, t: Optional[float] = None
    ) -> None:
        """Close ``stage`` for every pending key in one lock hold (the
        batch controllers' path).  First mark wins per stage — a re-run
        of the same pipeline pass keeps the original boundary."""
        if t is None:
            t = self.clock()
        with self._lock:
            for key in keys:
                entry = self._pending.get(key)
                if entry is None:
                    continue
                if any(s == stage for s, _ in entry.marks):
                    continue
                entry.marks.append((stage, t))


# -- process default -------------------------------------------------------
_default: Optional[SLORecorder] = None
_default_lock = threading.Lock()


def get_default() -> SLORecorder:
    global _default
    rec = _default
    if rec is None:
        with _default_lock:
            rec = _default
            if rec is None:
                rec = _default = SLORecorder()
    return rec


def set_default(recorder: SLORecorder) -> SLORecorder:
    """Install a recorder as the process default (tests, embedders);
    returns the previous one."""
    global _default
    with _default_lock:
        prev = _default
        _default = recorder
    return prev


def reset_default() -> SLORecorder:
    """Fresh default recorder."""
    return set_default(SLORecorder()) or get_default()


# -- module-level hooks (all early-out when the token path is off) ---------
def active() -> bool:
    """Cheap hot-path guard: is the default recorder's token path on?
    Callers use it to skip building key lists for mark_many()."""
    return get_default().enabled


def track(store, resource: str) -> None:
    get_default().track(store, resource)


def ingest(store, resource: str, event: str, obj: dict) -> None:
    rec = get_default()
    if rec.enabled:
        rec.ingest(store, resource, event, obj)


def mark_many(keys: Iterable[str], stage: str, t: Optional[float] = None) -> None:
    rec = get_default()
    if rec.enabled:
        rec.mark_many(keys, stage, t)
