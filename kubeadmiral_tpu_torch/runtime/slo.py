"""End-to-end SLO subsystem: event provenance, freshness, burn rates.

A copy of ``kubeadmiral_tpu/runtime/slo.py`` for the port's control
plane.

Every latency number this control plane reported before this module
stopped at a subsystem boundary: ``engine_stream_stage_seconds`` ends at
the engine tick, the dispatch ledger attributes device time, and
``worker_*_seconds`` time one controller's queue.  None of them measure
what a member cluster experiences — the time from a watch event entering
the control plane to the resulting placement being durably WRITTEN (and
acked) in the member apiserver.  This module closes that gap:

* **Provenance tokens.**  A birth timestamp is minted where a watch
  event enters the control plane — ``FakeKube._notify`` (in-process
  fleets), ``transport/client._ResourceWatch._dispatch`` (HTTP watch
  streams), with ``runtime/informer.Informer`` as the fallback ingress
  for stores that do not self-ingest — for the *tracked* source
  resources (the federate controller registers its FTC's source).
  Pipeline stages close marks on the token as the object moves:
  ``queued`` (ingress → scheduler tick pickup), ``slab`` (scheduling-
  unit assembly / streaming slab coalesce), ``engine`` (the XLA solve),
  ``fetch`` (placement persisted to the host), ``dispatch`` (sync staged
  the member writes), ``write`` (member apiserver acked).  The
  decomposition *sums to the measured end-to-end latency by
  construction* — stages are consecutive intervals of one clock.
  Emitted as ``slo_event_to_written_seconds{stage=...}`` (plus
  ``stage="total"``).

* **Exemplar ring.**  The slowest-N closed events are retained fully
  decomposed (flightrec-style bounded ring) and served at
  ``GET /debug/slo`` — "which event was slow, and in which stage".

* **Freshness.**  ``slo_oldest_pending_event_seconds`` /
  ``slo_unwritten_placements`` measure how stale the written world is
  versus the observed world: an event whose expected member writes have
  not all acked stays pending, so a silently-wedged dispatch path is
  visible even when no new events flow.  Sampled by the monitor
  controller's tick (federation/monitor.py).

* **Burn-rate evaluator.**  Declared objectives (the catalog lives in
  runtime/metric_catalog.py ``SLO_OBJECTIVES`` and is lint-enforced like
  metric names) are evaluated continuously in-process over multiple
  windows, exposed as ``slo_burn_rate{objective,window}`` gauges and a
  red/green summary on ``/debug/slo``, and embedded in bench detail
  (bench_e2e.py) where ``tools/bench_gate.py`` gates the e2e p99.

The JAX module's knobs are constants here, with its defaults: ``KT_SLO``
(the token path on) is the recorder's ``enabled=True``,
``KT_SLO_WINDOWS_S`` is WINDOWS_S, ``KT_SLO_EXEMPLARS`` EXEMPLARS,
``KT_SLO_PENDING_CAP`` PENDING_CAP, ``KT_SLO_MAX_AGE_S`` MAX_AGE_S (0 =
never expire pending tokens), and ``KT_SLO_E2E_P99_S`` /
``KT_SLO_WRITE_P99_S`` / ``KT_SLO_FRESHNESS_S`` the objectives'
``threshold_s`` in runtime/metric_catalog.py.
"""

from __future__ import annotations

import heapq
import itertools
import threading
import time
import weakref
from collections import deque
from typing import Iterable, Optional, Sequence

from kubeadmiral_tpu_torch.runtime import metric_catalog as MC
from kubeadmiral_tpu_torch.runtime import tenancy as _tenancy
from kubeadmiral_tpu_torch.runtime.metrics import Metrics

# Provenance stage vocabulary, in pipeline order (metrics-lint checks it
# against metric_catalog.SLO_STAGES; docs/observability.md documents the
# boundary each stage closes at).
STAGES = ("queued", "slab", "engine", "fetch", "dispatch", "write")

# Event→written latencies legitimately span µs (in-proc no-op rounds) to
# minutes (a hard-down member holding a placement hostage): the bucket
# ladder extends DEFAULT_BUCKETS past 10s so outage-scale latencies stay
# in finite buckets and percentile interpolation keeps resolution.
SLO_BUCKETS = (
    0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5,
    1.0, 2.5, 5.0, 10.0, 30.0, 60.0, 120.0, 300.0,
)


# Burn-rate windows in seconds, fast then slow (KT_SLO_WINDOWS_S).
WINDOWS_S: tuple[float, ...] = (60.0, 300.0)
# Slowest closed events kept as exemplars (KT_SLO_EXEMPLARS).
EXEMPLARS = 32
# In-flight tokens kept at most; later events are counted as dropped
# (KT_SLO_PENDING_CAP).
PENDING_CAP = 200000
# Seconds after which a pending token expires; 0 never (KT_SLO_MAX_AGE_S).
MAX_AGE_S = 0.0


class _Pending:
    """One in-flight provenance token."""

    __slots__ = (
        "key", "birth", "wall", "gen", "marks", "expected", "acked",
        "last_ack", "tenant",
    )

    def __init__(self, key: str, birth: float, gen: Optional[int],
                 tenant: str = ""):
        self.key = key
        self.birth = birth
        self.wall = time.time()
        self.gen = gen
        self.marks: list[tuple[str, float]] = []
        self.expected: Optional[set] = None  # placements sync declared
        self.acked: set = set()
        self.last_ack: Optional[float] = None
        self.tenant = tenant  # namespace-derived (runtime/tenancy.py)


class SLOEvaluator:
    """Multi-window burn-rate evaluation of the declared objectives.

    ``ratio`` objectives track the fraction of observed events over
    their latency threshold against the error budget ``1 - target``
    (burn 1.0 = spending budget exactly as fast as allowed); ``gauge``
    objectives burn as ``value / threshold`` (the freshness lag).  An
    objective is RED when EVERY window is burning ≥ 1 — the classic
    multi-window alert shape: the slow window proves it is not a blip,
    the fast window proves it is still happening.
    """

    def __init__(self, clock=time.monotonic, windows: Optional[Sequence[float]] = None):
        self.clock = clock
        self.windows = tuple(windows) if windows else WINDOWS_S
        self._lock = threading.Lock()
        self.objectives: dict[str, MC.SLOObjectiveSpec] = {}
        self.thresholds: dict[str, float] = {}
        for name, spec in MC.SLO_OBJECTIVES.items():
            self.objectives[name] = spec
            self.thresholds[name] = spec.threshold_s
        # ratio: cumulative (total, bad); gauge: last sampled value.
        self._totals = {n: 0 for n in self.objectives}
        self._bad = {n: 0 for n in self.objectives}
        self._value = {n: 0.0 for n in self.objectives}
        # Snapshot history per objective for window math, trimmed past
        # the slowest window: ratio → (t, total, bad); gauge → (t, ratio).
        # Seeded with a zero snapshot at birth so the FIRST evaluation
        # already has a window baseline (without it, evaluate() would
        # report burn 0 until its second pass regardless of traffic).
        horizon = max(self.windows) * 1.5 + 10.0
        self._horizon = horizon
        born = self.clock()
        # maxlen bounds a tight /debug/slo poll loop; at the default
        # windows it still holds minutes of 10 Hz samples.
        self._snaps: dict[str, deque] = {
            n: deque(
                [(born, 0.0)] if spec.kind == "gauge" else [(born, 0, 0)],
                maxlen=4096,
            )
            for n, spec in self.objectives.items()
        }
        self._status: dict[str, dict] = {}

    def observe(self, name: str, seconds: float) -> None:
        spec = self.objectives.get(name)
        if spec is None or spec.kind != "ratio":
            return
        with self._lock:
            self._totals[name] += 1
            if seconds > self.thresholds[name]:
                self._bad[name] += 1

    def sample_gauge(self, name: str, value: float) -> None:
        spec = self.objectives.get(name)
        if spec is None or spec.kind != "gauge":
            return
        with self._lock:
            self._value[name] = float(value)

    def _window_burn_locked(self, name: str, now: float, window: float) -> float:
        spec = self.objectives[name]
        snaps = self._snaps[name]
        cutoff = now - window
        if spec.kind == "gauge":
            burns = [r for (t, r) in snaps if t >= cutoff]
            burns.append(self._value[name] / max(1e-9, self.thresholds[name]))
            return max(burns)
        # ratio: the newest snapshot at or before the window start is the
        # baseline; shorter history evaluates over what exists.
        base_t, base_total, base_bad = snaps[0] if snaps else (now, 0, 0)
        for (t, total, bad) in snaps:
            if t <= cutoff:
                base_t, base_total, base_bad = t, total, bad
            else:
                break
        d_total = self._totals[name] - base_total
        d_bad = self._bad[name] - base_bad
        if d_total <= 0:
            return 0.0
        budget = max(1e-9, 1.0 - spec.target)
        return (d_bad / d_total) / budget

    def evaluate(self, now: Optional[float] = None, metrics=None) -> dict:
        """One evaluation pass: snapshot, window burns, red/green.
        Returns {objective: {"burn": {window: x}, "red": bool, ...}}."""
        if now is None:
            now = self.clock()
        status: dict[str, dict] = {}
        with self._lock:
            for name, spec in self.objectives.items():
                snaps = self._snaps[name]
                if spec.kind == "gauge":
                    snaps.append(
                        (now, self._value[name] / max(1e-9, self.thresholds[name]))
                    )
                else:
                    snaps.append((now, self._totals[name], self._bad[name]))
                while snaps and snaps[0][0] < now - self._horizon:
                    snaps.popleft()
                burns = {
                    w: self._window_burn_locked(name, now, w)
                    for w in self.windows
                }
                entry = {
                    "kind": spec.kind,
                    "target": spec.target,
                    "threshold_s": self.thresholds[name],
                    "burn": {f"{int(w)}s": round(b, 4) for w, b in burns.items()},
                    "red": all(b >= 1.0 for b in burns.values()),
                }
                if spec.kind == "ratio":
                    entry["events"] = self._totals[name]
                    entry["breaches"] = self._bad[name]
                else:
                    entry["value_s"] = round(self._value[name], 4)
                status[name] = entry
            self._status = status
        if metrics is not None:
            for name, entry in status.items():
                for window, burn in entry["burn"].items():
                    metrics.store(
                        "slo_burn_rate", burn, objective=name, window=window
                    )
        return status

    def status(self) -> dict:
        """The most recent evaluation (empty before the first pass)."""
        with self._lock:
            return dict(self._status)


class SLORecorder:
    """Provenance tokens + stage histograms + freshness + evaluator.

    One instance per control plane (the process default mirrors
    trace/flightrec); its own :class:`Metrics` registry holds the
    ``slo_*`` / ``member_write_seconds`` families unless ``attach()``
    points emission at a shared one.
    """

    def __init__(
        self,
        enabled: Optional[bool] = None,
        metrics: Optional[Metrics] = None,
        clock=time.monotonic,
        exemplars: Optional[int] = None,
        pending_cap: Optional[int] = None,
        windows: Optional[Sequence[float]] = None,
    ):
        self.enabled = True if enabled is None else bool(enabled)
        self.metrics = metrics if metrics is not None else Metrics()
        self.clock = clock
        self.exemplars = (
            EXEMPLARS
            if exemplars is None
            else int(exemplars)
        )
        self.pending_cap = (
            PENDING_CAP
            if pending_cap is None
            else int(pending_cap)
        )
        # 0 disables expiry: a wedged dispatch path must stay visible in
        # the freshness gauges indefinitely, not quietly age out.
        self.max_age_s = MAX_AGE_S
        self.evaluator = SLOEvaluator(clock=clock, windows=windows)
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
        self._seq = itertools.count(1)
        # Slowest-N min-heap of (total_s, seq, exemplar-dict).
        self._slow: list = []

    # -- wiring -----------------------------------------------------------
    def attach(self, metrics: Metrics) -> None:
        """Point emission at a shared registry (manager wiring)."""
        self.metrics = metrics

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

    # -- ingress ----------------------------------------------------------
    def ingest(self, store, resource: str, event: str, obj: dict) -> None:
        """Called by the transport/store dispatch point ONCE per event.
        Mints a token for tracked resources; DELETED forgets; MODIFIED
        without a generation bump is an echo and mints nothing."""
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
        tenant = _tenancy.tenant_of(ns, meta.get("labels"))
        t = self.clock()
        with self._lock:
            if gen is not None:
                last = self._gen.get(key)
                if last is not None and int(gen) <= last:
                    self.metrics.counter("slo_events_total", result="echo")
                    return
                self._gen[key] = int(gen)
            self._mint_locked(key, t, gen, tenant)

    def mint(self, key: str, t: Optional[float] = None, gen: Optional[int] = None) -> None:
        if not self.enabled:
            return
        with self._lock:
            self._mint_locked(
                key, self.clock() if t is None else t, gen,
                _tenancy.tenant_of_key(key),
            )

    def _mint_locked(
        self, key: str, t: float, gen: Optional[int], tenant: str = ""
    ) -> None:
        if key in self._pending:
            # Newer intent supersedes the in-flight token: latency is
            # measured from the LAST event that changed the object.
            self.metrics.counter("slo_events_total", result="superseded")
        elif len(self._pending) >= self.pending_cap:
            self.metrics.counter("slo_events_total", result="dropped")
            return
        else:
            self.metrics.counter("slo_events_total", result="minted")
        self._pending[key] = _Pending(key, t, gen, tenant)

    def forget(self, key: str) -> None:
        """Object deleted: its pending token (if any) is void."""
        if not self.enabled:
            return
        with self._lock:
            self._gen.pop(key, None)
            if self._pending.pop(key, None) is not None:
                self.metrics.counter("slo_events_total", result="forgotten")

    # -- stage marks -------------------------------------------------------
    def mark(self, key: str, stage: str, t: Optional[float] = None) -> None:
        if not self.enabled:
            return
        self.mark_many((key,), stage, t)

    def mark_many(
        self, keys: Iterable[str], stage: str, t: Optional[float] = None
    ) -> None:
        """Close ``stage`` for every pending key in one lock hold (the
        batch controllers' path).  First mark wins per stage — a re-run
        of the same pipeline pass keeps the original boundary."""
        if not self.enabled:
            return
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

    def expect(self, key: str, clusters: Iterable[str], t: Optional[float] = None) -> None:
        """Sync declared the placements this event must reach: the token
        closes (and freshness clears) only when every one has acked."""
        if not self.enabled:
            return
        with self._lock:
            entry = self._pending.get(key)
            if entry is not None:
                entry.expected = set(clusters)

    # -- completion --------------------------------------------------------
    def written(self, key: str, cluster: str, t: Optional[float] = None) -> None:
        """One member write acked.  The token finalizes when all expected
        placements have acked (or on the first ack when no expectation
        was declared)."""
        if not self.enabled:
            return
        if t is None:
            t = self.clock()
        with self._lock:
            entry = self._pending.get(key)
            if entry is None:
                return
            entry.acked.add(cluster)
            entry.last_ack = t
            if entry.expected is not None and (entry.expected - entry.acked):
                return
            del self._pending[key]
        self._finalize(entry, t)

    def written_many(
        self, pairs: Iterable[tuple[str, str]], t: Optional[float] = None
    ) -> None:
        """Batch of member-write acks — :meth:`written` for a whole sync
        flush under ONE lock hold (finalizations collected inside,
        histogram work done outside the lock).  Acks land with one
        shared timestamp: within a flush the per-op ack spread is
        bookkeeping skew, not member latency."""
        if not self.enabled:
            return
        if t is None:
            t = self.clock()
        done: list[_Pending] = []
        with self._lock:
            for key, cluster in pairs:
                entry = self._pending.get(key)
                if entry is None:
                    continue
                entry.acked.add(cluster)
                entry.last_ack = t
                if entry.expected is not None and (entry.expected - entry.acked):
                    continue
                del self._pending[key]
                done.append(entry)
        for entry in done:
            self._finalize(entry, t)

    def settle(self, key: str) -> None:
        """The sync round for this object ended fully OK.  A token with
        acked writes finalizes at its last ack (partial version-skips
        must not lose the sample); one with none — a pure no-op round —
        is dropped quietly."""
        if not self.enabled:
            return
        with self._lock:
            entry = self._pending.pop(key, None)
            if entry is None:
                return
            if not entry.acked:
                self.metrics.counter("slo_events_total", result="settled")
                return
        self._finalize(entry, entry.last_ack)

    def _finalize(self, entry: _Pending, t_end: float) -> None:
        m = self.metrics
        stages: dict[str, float] = {}
        prev = entry.birth
        for stage, tm in sorted(entry.marks, key=lambda p: p[1]):
            stages[stage] = max(0.0, tm - prev)
            prev = max(prev, tm)
        stages["write"] = max(0.0, t_end - prev)
        total = max(0.0, t_end - entry.birth)
        for stage, dur in stages.items():
            m.histogram(
                "slo_event_to_written_seconds", dur,
                buckets=SLO_BUCKETS, stage=stage,
            )
        m.histogram(
            "slo_event_to_written_seconds", total,
            buckets=SLO_BUCKETS, stage="total",
        )
        m.counter("slo_events_total", result="written")
        self.evaluator.observe("event_to_written_p99", total)
        # Per-tenant attribution (runtime/tenancy.py; no-op unless a
        # ledger is installed): the token's namespace-derived tenant
        # carries the whole stage decomposition.
        _tenancy.note_event(
            entry.tenant or _tenancy.tenant_of_key(entry.key),
            total, stages,
        )
        exemplar = {
            "key": entry.key,
            "total_s": round(total, 6),
            "stages_s": {s: round(v, 6) for s, v in stages.items()},
            "acked": sorted(entry.acked),
            "wall": entry.wall,
        }
        with self._lock:
            item = (total, next(self._seq), exemplar)
            if len(self._slow) < max(1, self.exemplars):
                heapq.heappush(self._slow, item)
            elif total > self._slow[0][0]:
                heapq.heapreplace(self._slow, item)

    # -- per-member attribution -------------------------------------------
    def member_write(self, cluster: str, seconds: float) -> None:
        """One member batch round trip (retries included) completed —
        dispatch feeds this so a slow MEMBER is distinguishable from a
        slow engine (the member-vs-engine triage in docs/operations.md)."""
        if not self.enabled:
            return
        self.metrics.histogram(
            "member_write_seconds", seconds, buckets=SLO_BUCKETS,
            cluster=cluster,
        )
        self.evaluator.observe("member_write_p99", seconds)

    # -- freshness ---------------------------------------------------------
    def pending_count(self) -> int:
        with self._lock:
            return len(self._pending)

    def oldest_pending_seconds(self, now: Optional[float] = None) -> float:
        if now is None:
            now = self.clock()
        with self._lock:
            if not self._pending:
                return 0.0
            return max(0.0, now - min(e.birth for e in self._pending.values()))

    def unwritten_placements(self) -> int:
        """Expected member writes not yet acked (tokens without a
        declared expectation count 1: the object itself is unwritten)."""
        with self._lock:
            total = 0
            for e in self._pending.values():
                if e.expected is None:
                    total += 1
                else:
                    total += len(e.expected - e.acked)
            return total

    def _expire_locked(self, now: float) -> None:
        if self.max_age_s <= 0:
            return
        stale = [
            k for k, e in self._pending.items()
            if now - e.birth > self.max_age_s
        ]
        for k in stale:
            del self._pending[k]
            self.metrics.counter("slo_events_total", result="expired")

    def publish(self, extra: Optional[Metrics] = None, now: Optional[float] = None) -> None:
        """Emit the freshness gauge pair (monitor tick / bench sampling).
        ``extra`` mirrors into a second registry (the monitor's shared
        one) when it differs from the recorder's own."""
        if not self.enabled:
            return
        if now is None:
            now = self.clock()
        with self._lock:
            self._expire_locked(now)
        oldest = self.oldest_pending_seconds(now)
        unwritten = self.unwritten_placements()
        for m in {id(self.metrics): self.metrics,
                  **({id(extra): extra} if extra is not None else {})}.values():
            m.store("slo_oldest_pending_event_seconds", oldest)
            m.store("slo_unwritten_placements", unwritten)
        self.evaluator.sample_gauge("freshness", oldest)

    def evaluate(
        self, extra: Optional[Metrics] = None, now: Optional[float] = None
    ) -> dict:
        """Freshness sample + one evaluator pass; returns the red/green
        status map and emits slo_burn_rate gauges."""
        if not self.enabled:
            return {}
        self.publish(extra=extra, now=now)
        status = self.evaluator.evaluate(now=now, metrics=self.metrics)
        if extra is not None and extra is not self.metrics:
            for name, entry in status.items():
                for window, burn in entry["burn"].items():
                    extra.store(
                        "slo_burn_rate", burn, objective=name, window=window
                    )
        return status

    # -- /debug/slo --------------------------------------------------------
    def summary(self, slowest: Optional[int] = None) -> dict:
        """The GET /debug/slo payload (schema in docs/observability.md)."""
        if not self.enabled:
            return {"enabled": False}
        now = self.clock()
        status = self.evaluate(now=now)
        stages = {}
        for stage in STAGES + ("total",):
            qs = self.metrics.histogram_quantiles(
                "slo_event_to_written_seconds", (0.5, 0.99), stage=stage
            )
            count = self.metrics.histogram_count(
                "slo_event_to_written_seconds", stage=stage
            )
            if count:
                stages[stage] = {
                    "count": count,
                    "p50_s": round(qs[0.5], 6) if qs[0.5] is not None else None,
                    "p99_s": round(qs[0.99], 6) if qs[0.99] is not None else None,
                }
        with self._lock:
            slow = sorted(self._slow, key=lambda it: -it[0])
            pending = len(self._pending)
        if slowest is not None:
            slow = slow[:slowest]
        return {
            "enabled": True,
            "generated_at": time.time(),
            "pending_events": pending,
            "oldest_pending_s": round(self.oldest_pending_seconds(now), 4),
            "unwritten_placements": self.unwritten_placements(),
            "stages": stages,
            "objectives": status,
            "red": sorted(n for n, e in status.items() if e.get("red")),
            "slowest": [ex for (_, _, ex) in slow],
        }


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
def _rec() -> Optional[SLORecorder]:
    rec = _default
    if rec is None:
        rec = get_default()
    return rec if rec.enabled else None


def active() -> bool:
    """Cheap hot-path guard: is the default recorder's token path on?
    Callers use it to skip building key lists for mark_many()."""
    rec = _default
    if rec is None:
        rec = get_default()
    return rec.enabled


def track(store, resource: str) -> None:
    rec = _default or get_default()
    rec.track(store, resource)


def ingest(store, resource: str, event: str, obj: dict) -> None:
    rec = _rec()
    if rec is not None:
        rec.ingest(store, resource, event, obj)


def mark(key: str, stage: str, t: Optional[float] = None) -> None:
    rec = _rec()
    if rec is not None:
        rec.mark(key, stage, t)


def mark_many(keys: Iterable[str], stage: str, t: Optional[float] = None) -> None:
    rec = _rec()
    if rec is not None:
        rec.mark_many(keys, stage, t)


def expect(key: str, clusters: Iterable[str]) -> None:
    rec = _rec()
    if rec is not None:
        rec.expect(key, clusters)


def written(key: str, cluster: str) -> None:
    rec = _rec()
    if rec is not None:
        rec.written(key, cluster)


def written_many(pairs: Iterable[tuple[str, str]]) -> None:
    rec = _rec()
    if rec is not None:
        rec.written_many(pairs)


def settle(key: str) -> None:
    rec = _rec()
    if rec is not None:
        rec.settle(key)


def forget(key: str) -> None:
    rec = _rec()
    if rec is not None:
        rec.forget(key)


def member_write(cluster: str, seconds: float) -> None:
    rec = _rec()
    if rec is not None:
        rec.member_write(cluster, seconds)
