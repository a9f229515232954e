"""Per-member circuit breakers: the member fault-tolerance core.

A copy of ``kubeadmiral_tpu/transport/breaker.py`` for the port's control
plane.

KubeAdmiral's lineage treats member unavailability as a first-class
state (ClusterNotReady propagation status, Offline/Ready conditions),
not an exception path.  This module gives every consumer of a member
client one shared view of that state:

* a :class:`MemberBreaker` per member cluster — CLOSED while healthy;
  consecutive failures, a single stall/timeout, or a latency EWMA past
  threshold OPEN it; after a cool-down it goes HALF_OPEN and admits one
  probe at a time; a successful probe (a real round trip — dispatch
  write, member read, or the cluster controller's healthz heartbeat)
  CLOSEs it again;
* a :class:`BreakerRegistry` per fleet (``for_fleet``) shared by the
  sync dispatch fan-out, the cluster controller's heartbeat, the status
  controller and the monitor, so a member that stalled one sync flush
  is invisible to the next tick's reads too — no thread ever parks on
  a socket the fleet already knows is dead;
* catalog-enforced telemetry (``member_breaker_state``,
  ``member_dispatch_retries_total``, ``member_shed_writes_total``,
  ``member_probe_latency``) and the ``GET /debug/members`` report
  (``members_report`` aggregates every live registry).

Thresholds: :class:`BreakerConfig`'s defaults are the JAX module's
``KT_BREAKER_*`` defaults, as constants: FAILURE_THRESHOLD (3
consecutive failures open), OPEN_SECONDS (5 s cool-down before
half-open), LATENCY_THRESHOLD_S (5 s EWMA latency opens),
STALL_THRESHOLD_S (a single failure slower than this counts as a stall
and opens immediately — the "one deadline, then short-circuit"
contract).
"""

from __future__ import annotations

import time
import weakref
from collections import deque
from typing import Callable, Optional

from kubeadmiral_tpu_torch.runtime import lockcheck

CLOSED = "closed"
HALF_OPEN = "half_open"
OPEN = "open"

# Gauge encoding for member_breaker_state{cluster}.
STATE_CODE = {CLOSED: 0, HALF_OPEN: 1, OPEN: 2}

TransitionCallback = Callable[[str, str, str], None]  # (member, old, new)


# BreakerConfig's defaults (KT_BREAKER_FAILURES, KT_BREAKER_OPEN_S,
# KT_BREAKER_LATENCY_S, KT_BREAKER_STALL_S).
FAILURE_THRESHOLD = 3
OPEN_SECONDS = 5.0
LATENCY_THRESHOLD_S = 5.0
STALL_THRESHOLD_S = 1.0


class BreakerConfig:
    """Thresholds shared by every breaker of a registry."""

    __slots__ = (
        "failure_threshold",
        "open_seconds",
        "latency_threshold_s",
        "stall_threshold_s",
        "ewma_alpha",
    )

    def __init__(
        self,
        failure_threshold: Optional[int] = None,
        open_seconds: Optional[float] = None,
        latency_threshold_s: Optional[float] = None,
        stall_threshold_s: Optional[float] = None,
        ewma_alpha: float = 0.3,
    ):
        self.failure_threshold = (
            failure_threshold
            if failure_threshold is not None
            else FAILURE_THRESHOLD
        )
        self.open_seconds = (
            open_seconds
            if open_seconds is not None
            else OPEN_SECONDS
        )
        self.latency_threshold_s = (
            latency_threshold_s
            if latency_threshold_s is not None
            else LATENCY_THRESHOLD_S
        )
        self.stall_threshold_s = (
            stall_threshold_s
            if stall_threshold_s is not None
            else STALL_THRESHOLD_S
        )
        self.ewma_alpha = ewma_alpha


@lockcheck.shared_field_guard
class MemberBreaker:
    """One member's circuit state.  Thread-safe; the CLOSED fast paths
    (``allow`` with a closed breaker, ``note_ok`` with no failure
    history) are lock-free attribute reads so the per-(object, cluster)
    hot loops pay nothing while the fleet is healthy."""

    # Circuit state shared by every dispatch/sync thread of the fleet
    # (ktlint lock-discipline + runtime/lockcheck.py); reads may be
    # lock-free (the documented fast paths), writes never.
    _shared_fields_ = {
        "_state": "_lock",
        "_consecutive": "_lock",
        "_opened_at": "_lock",
        "_probe_inflight": "_lock",
        "_ewma_latency": "_lock",
        "_failures_total": "_lock",
        "_opens_total": "_lock",
        "_last_error_at": "_lock",
    }

    def __init__(self, name: str, config: BreakerConfig,
                 registry: Optional["BreakerRegistry"] = None,
                 clock=time.monotonic):
        self.name = name
        self.config = config
        self._registry = registry
        self._clock = clock
        self._lock = lockcheck.make_lock("breaker")
        self._state = CLOSED
        self._consecutive = 0
        self._opened_at = 0.0
        self._probe_inflight = False
        self._ewma_latency: Optional[float] = None
        self._failures_total = 0
        self._opens_total = 0
        self._last_error_at: Optional[float] = None

    @property
    def state(self) -> str:
        return self._state

    # -- admission --------------------------------------------------------
    def allow(self, consume_probe: bool = True) -> bool:
        """May a call proceed to this member right now?

        CLOSED: always.  OPEN: no, until the cool-down elapses (then the
        breaker turns HALF_OPEN).  HALF_OPEN: one in-flight probe at a
        time when ``consume_probe`` (the write paths — the call itself
        is the probe); ``consume_probe=False`` is the cheap read-side
        check (open-and-cooling means no)."""
        if self._state is CLOSED:  # lock-free fast path
            return True
        fired = None
        with self._lock:
            if self._state == CLOSED:
                return True
            if self._state == OPEN:
                if self._clock() - self._opened_at < self.config.open_seconds:
                    return False
                fired = self._transition_locked(HALF_OPEN)
                self._probe_inflight = False
            # HALF_OPEN
            if not consume_probe:
                result = True
            elif self._probe_inflight:
                result = False
            else:
                self._probe_inflight = True
                result = True
        if fired:
            self._fire(*fired)
        return result

    # -- evidence ---------------------------------------------------------
    def note_ok(self, latency_s: Optional[float] = None) -> None:
        """Record an incidental successful round trip.  Free while the
        breaker is closed and clean; otherwise full success recording
        (a real round trip through a suspect member is a probe)."""
        if self._state is CLOSED and self._consecutive == 0:
            return
        self.record_success(latency_s)

    def record_success(self, latency_s: Optional[float] = None,
                       probe: bool = False) -> None:
        fired = None
        with self._lock:
            if latency_s is not None:
                a = self.config.ewma_alpha
                self._ewma_latency = (
                    latency_s
                    if self._ewma_latency is None
                    else a * latency_s + (1 - a) * self._ewma_latency
                )
            self._consecutive = 0
            self._probe_inflight = False
            if self._state == HALF_OPEN:
                fired = self._transition_locked(CLOSED)
            elif self._state == OPEN:
                # An out-of-band probe (the heartbeat) closes only once
                # the cool-down elapsed — before that, a lone success
                # must not defeat the open window's load shedding.
                if probe and (
                    self._clock() - self._opened_at >= self.config.open_seconds
                ):
                    fired = self._transition_locked(CLOSED)
            elif (
                self._state == CLOSED
                and self._ewma_latency is not None
                and self.config.latency_threshold_s > 0
                and self._ewma_latency > self.config.latency_threshold_s
            ):
                # Latency EWMA past threshold: the member answers, but so
                # slowly it would serialize the tick — open anyway.
                fired = self._open_locked()
        if fired:
            self._fire(*fired)

    def record_failure(self, latency_s: Optional[float] = None,
                       timeout: bool = False) -> None:
        """A failed round trip.  ``timeout=True`` (a stall: deadline or
        STALL_THRESHOLD_S exceeded) opens immediately — one parked
        deadline is all a dead member gets."""
        if latency_s is not None and latency_s >= self.config.stall_threshold_s:
            timeout = True
        fired = None
        with self._lock:
            self._consecutive += 1
            self._failures_total += 1
            self._last_error_at = self._clock()
            self._probe_inflight = False
            if self._state == HALF_OPEN:
                fired = self._open_locked()
            elif self._state == CLOSED and (
                timeout or self._consecutive >= self.config.failure_threshold
            ):
                fired = self._open_locked()
        if fired:
            self._fire(*fired)

    # -- transitions ------------------------------------------------------
    def _open_locked(self):
        self._opened_at = self._clock()
        self._opens_total += 1
        return self._transition_locked(OPEN)

    def _transition_locked(self, new: str):
        old, self._state = self._state, new
        return (old, new) if old != new else None

    def _fire(self, old: str, new: str) -> None:
        if self._registry is not None:
            self._registry._on_breaker_transition(self.name, old, new)

    def snapshot(self) -> dict:
        with self._lock:
            out = {
                "state": self._state,
                "consecutive_failures": self._consecutive,
                "failures_total": self._failures_total,
                "opens_total": self._opens_total,
                "ewma_latency_ms": (
                    round(self._ewma_latency * 1000.0, 3)
                    if self._ewma_latency is not None
                    else None
                ),
            }
            if self._state != CLOSED:
                out["opened_ago_s"] = round(self._clock() - self._opened_at, 3)
            if self._last_error_at is not None:
                out["last_error_ago_s"] = round(
                    self._clock() - self._last_error_at, 3
                )
        return out

    # -- durable state (runtime/snapshot.py) -------------------------------
    def export_state(self) -> dict:
        """Restart-durable image of this breaker.  Open windows export
        their REMAINING cool-down (clocks are process-local monotonic,
        so absolute open timestamps would be meaningless to a
        successor)."""
        with self._lock:
            remaining = 0.0
            if self._state != CLOSED:
                remaining = max(
                    0.0,
                    self.config.open_seconds - (self._clock() - self._opened_at),
                )
            return {
                "state": self._state,
                "remaining_s": remaining,
                "consecutive": self._consecutive,
                "failures_total": self._failures_total,
                "opens_total": self._opens_total,
                "ewma_latency_s": self._ewma_latency,
            }

    def restore_state(self, state: dict, downtime_s: float = 0.0) -> None:
        """Resume a pre-crash breaker: an OPEN member stays OPEN with the
        remaining cool-down (minus the measured downtime) instead of
        getting a free probe storm on the first post-restart tick; a
        HALF_OPEN member re-enters the open window's tail (its probe
        outcome died with the old process).  The half-open probe then
        fires when the ORIGINAL window would have elapsed, never from a
        restarted full window."""
        fired = None
        with self._lock:
            new = state.get("state", CLOSED)
            if new == HALF_OPEN:
                new = OPEN
            remaining = max(
                0.0, float(state.get("remaining_s", 0.0)) - max(0.0, downtime_s)
            )
            self._consecutive = int(state.get("consecutive", 0))
            self._failures_total = int(state.get("failures_total", 0))
            self._opens_total = int(state.get("opens_total", 0))
            ewma = state.get("ewma_latency_s")
            self._ewma_latency = float(ewma) if ewma is not None else None
            self._probe_inflight = False
            if new == OPEN:
                # Re-anchor the open window so exactly `remaining`
                # cool-down is left on this process's clock.
                self._opened_at = (
                    self._clock() - (self.config.open_seconds - remaining)
                )
                fired = self._transition_locked(OPEN)
            else:
                fired = self._transition_locked(CLOSED)
        if fired:
            self._fire(*fired)


# Live registries, for the aggregated /debug/members report.
_REGISTRIES: "weakref.WeakSet[BreakerRegistry]" = weakref.WeakSet()


@lockcheck.shared_field_guard
class BreakerRegistry:
    """One fleet's breakers + shed/retry accounting + telemetry."""

    _shared_fields_ = {
        "_breakers": "_lock",
        "_callbacks": "_lock",
        "_shed": "_lock",
        "_retries": "_lock",
        "_write_lat": "_lock",
        "_write_ops": "_lock",
        "_write_flushes": "_lock",
        "_batch_sizes": "_lock",
        "_bulk_counts": "_lock",
    }

    def __init__(self, metrics=None, config: Optional[BreakerConfig] = None,
                 clock=time.monotonic):
        self.metrics = metrics
        self.config = config or BreakerConfig()
        self._clock = clock
        self._lock = lockcheck.make_lock("breaker-registry")
        self._breakers: dict[str, MemberBreaker] = {}
        self._callbacks: list[TransitionCallback] = []
        self._shed: dict[str, int] = {}
        self._retries: dict[str, int] = {}
        # Per-member write-latency reservoir (dispatch feeds it via
        # note_write): bounded recent samples + cumulative totals, so
        # /debug/members joins write p50/p99 with breaker state and a
        # slow member is triaged without leaving the endpoint.
        self._write_lat: dict[str, "deque[float]"] = {}
        self._write_ops: dict[str, int] = {}
        self._write_flushes: dict[str, int] = {}
        # Coalesced bulk-write attribution (dispatch.run_member_batches
        # feeds note_batch): recent per-request batch sizes + cumulative
        # outcome counts, joined into GET /debug/members so an operator
        # sees whether a member's writes actually coalesce.
        self._batch_sizes: dict[str, "deque[int]"] = {}
        self._bulk_counts: dict[str, dict[str, int]] = {}
        _REGISTRIES.add(self)

    def for_member(self, name: str) -> MemberBreaker:
        breaker = self._breakers.get(name)  # lock-free hot path
        if breaker is not None:
            return breaker
        with self._lock:
            breaker = self._breakers.get(name)
            if breaker is None:
                breaker = MemberBreaker(
                    name, self.config, registry=self, clock=self._clock
                )
                self._breakers[name] = breaker
                self._emit_state(name, CLOSED)
            return breaker

    def allow(self, name: str, consume_probe: bool = True) -> bool:
        return self.for_member(name).allow(consume_probe=consume_probe)

    def on_transition(self, callback: TransitionCallback) -> None:
        with self._lock:
            self._callbacks.append(callback)

    def _on_breaker_transition(self, name: str, old: str, new: str) -> None:
        self._emit_state(name, new)
        with self._lock:
            callbacks = list(self._callbacks)
        for cb in callbacks:
            try:
                cb(name, old, new)
            except Exception:
                pass  # observers must not break state accounting

    def _emit_state(self, name: str, state: str) -> None:
        if self.metrics is not None:
            self.metrics.gauge(
                "member_breaker_state", STATE_CODE[state], cluster=name
            )

    # -- shed / retry accounting (dispatch feeds these) --------------------
    def count_shed(self, name: str, n: int = 1) -> None:
        with self._lock:
            self._shed[name] = self._shed.get(name, 0) + n
        if self.metrics is not None:
            self.metrics.counter("member_shed_writes_total", n, cluster=name)

    def count_retry(self, name: str, n: int = 1) -> None:
        with self._lock:
            self._retries[name] = self._retries.get(name, 0) + n
        if self.metrics is not None:
            self.metrics.counter(
                "member_dispatch_retries_total", n, cluster=name
            )

    def note_write(self, name: str, seconds: float, ops: int = 1) -> None:
        """One completed write batch against this member (dispatch's
        per-member attribution feed; retries included in ``seconds``)."""
        with self._lock:
            reservoir = self._write_lat.get(name)
            if reservoir is None:
                reservoir = self._write_lat[name] = deque(maxlen=256)
            reservoir.append(float(seconds))
            self._write_ops[name] = self._write_ops.get(name, 0) + int(ops)
            self._write_flushes[name] = self._write_flushes.get(name, 0) + 1

    def note_batch(self, name: str, ops: int, outcome: str) -> None:
        """One coalesced bulk request against this member completed
        (outcome: ok | partial | transport)."""
        with self._lock:
            reservoir = self._batch_sizes.get(name)
            if reservoir is None:
                reservoir = self._batch_sizes[name] = deque(maxlen=256)
            reservoir.append(int(ops))
            counts = self._bulk_counts.setdefault(name, {})
            counts[outcome] = counts.get(outcome, 0) + 1

    def shed_total(self) -> int:
        with self._lock:
            return sum(self._shed.values())

    # -- durable state (runtime/snapshot.py) -------------------------------
    def export_state(self) -> dict:
        """Restart-durable registry image: per-member breaker states
        plus a wall-clock stamp so restore can subtract the downtime
        from open windows."""
        with self._lock:
            breakers = list(self._breakers.values())
        return {
            "wall": time.time(),
            "members": {b.name: b.export_state() for b in breakers},
        }

    def restore_state(self, payload: dict) -> None:
        """Resume pre-crash breaker states: a member whose breaker was
        OPEN stays skipped (ClusterNotReady) on the first post-restart
        tick, and its half-open probe resumes after the REMAINING
        cool-down — a controller restart is never a probe amnesty."""
        downtime = max(0.0, time.time() - float(payload.get("wall", time.time())))
        for name, state in (payload.get("members") or {}).items():
            self.for_member(name).restore_state(state, downtime_s=downtime)

    def open_members(self) -> list[str]:
        with self._lock:
            breakers = list(self._breakers.values())
        return [b.name for b in breakers if b.state != CLOSED]

    def snapshot(self) -> dict:
        with self._lock:
            breakers = dict(self._breakers)
            shed = dict(self._shed)
            retries = dict(self._retries)
            write_lat = {n: sorted(d) for n, d in self._write_lat.items()}
            write_ops = dict(self._write_ops)
            write_flushes = dict(self._write_flushes)
            batch_sizes = {n: sorted(d) for n, d in self._batch_sizes.items()}
            bulk_counts = {n: dict(c) for n, c in self._bulk_counts.items()}
        out = {}
        for name, breaker in sorted(breakers.items()):
            entry = breaker.snapshot()
            entry["shed_writes"] = shed.get(name, 0)
            entry["dispatch_retries"] = retries.get(name, 0)
            ranked = write_lat.get(name)
            if ranked:
                entry["write_latency"] = {
                    "flushes": write_flushes.get(name, 0),
                    "ops": write_ops.get(name, 0),
                    "p50_ms": round(ranked[len(ranked) // 2] * 1e3, 3),
                    "p99_ms": round(
                        ranked[min(len(ranked) - 1, int(len(ranked) * 0.99))]
                        * 1e3, 3,
                    ),
                    "max_ms": round(ranked[-1] * 1e3, 3),
                }
            sizes = batch_sizes.get(name)
            if sizes:
                entry["batch"] = {
                    "requests": bulk_counts.get(name, {}),
                    "p50_ops": sizes[len(sizes) // 2],
                    "max_ops": sizes[-1],
                }
            out[name] = entry
        return out


def for_fleet(fleet, metrics=None,
              config: Optional[BreakerConfig] = None) -> BreakerRegistry:
    """The fleet's shared registry, created on first use: every
    controller of one control plane must see the same member state (a
    member that stalled sync's flush is short-circuited by the next
    read too)."""
    registry = getattr(fleet, "_member_breakers", None)
    if registry is None:
        registry = BreakerRegistry(metrics=metrics, config=config)
        fleet._member_breakers = registry
    return registry


def members_report() -> dict:
    """The GET /debug/members payload: every live registry's member
    snapshots (one control plane per process is the common case; tests
    run several, which merge here keyed by member name)."""
    members: dict[str, dict] = {}
    for registry in list(_REGISTRIES):
        for name, entry in registry.snapshot().items():
            members[name] = entry
    return {
        "members": members,
        "open": sorted(n for n, e in members.items() if e["state"] != CLOSED),
        "generated_at": time.time(),
    }
