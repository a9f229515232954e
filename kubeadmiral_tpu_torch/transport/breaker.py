"""Per-member circuit breakers: the member fault-tolerance core.

The part of ``kubeadmiral_tpu/transport/breaker.py`` that the cluster
controller calls.  KubeAdmiral's lineage treats member unavailability
as a first-class state (ClusterNotReady propagation status,
Offline/Ready conditions), not an exception path:

* a :class:`MemberBreaker` per member cluster — CLOSED while healthy;
  consecutive failures, a single stall/timeout, or a latency EWMA past
  threshold OPEN it; after a cool-down it goes HALF_OPEN and admits one
  probe at a time; a successful probe (the cluster controller's healthz
  heartbeat) CLOSEs it again;
* a :class:`BreakerRegistry` per fleet (``for_fleet``) shared by every
  controller of one control plane, which emits ``member_breaker_state``
  and tells its observers of each transition.

The thresholds are :class:`BreakerConfig`'s constants, the JAX module's
``KT_BREAKER_*`` defaults.  Left out until the member half (sync
dispatch, status, monitor) is ported, since nothing on the scheduling
path reaches them: the incidental-success path (``note_ok``), the shed,
retry, write-latency and batch accounting, the durable state that
``runtime/snapshot.py`` carries, and the ``/debug/members`` report.
"""

from __future__ import annotations

import threading
import time
from typing import Callable, Optional

from kubeadmiral_tpu_torch.runtime import lockcheck

CLOSED = "closed"
HALF_OPEN = "half_open"
OPEN = "open"

# Gauge encoding for member_breaker_state{cluster}.
STATE_CODE = {CLOSED: 0, HALF_OPEN: 1, OPEN: 2}

TransitionCallback = Callable[[str, str, str], None]  # (member, old, new)


class BreakerConfig:
    """Thresholds shared by every breaker of a registry: 3 consecutive
    failures open (``KT_BREAKER_FAILURES``), 5 s cool-down before
    half-open (``KT_BREAKER_OPEN_S``), a 5 s latency EWMA opens
    (``KT_BREAKER_LATENCY_S``), and a single failure slower than 1 s is
    a stall that opens at once (``KT_BREAKER_STALL_S``: "one deadline,
    then short-circuit")."""

    failure_threshold = 3
    open_seconds = 5.0
    latency_threshold_s = 5.0
    stall_threshold_s = 1.0
    ewma_alpha = 0.3


@lockcheck.shared_field_guard
class MemberBreaker:
    """One member's circuit state.  Thread-safe; the CLOSED fast path
    of ``allow`` is a lock-free attribute read so the per-(object,
    cluster) hot loops pay nothing while the fleet is healthy."""

    # Circuit state shared by every thread of the fleet
    # (runtime/lockcheck.py); reads may be lock-free (the documented
    # fast path), writes never.
    _shared_fields_ = {
        "_state": "_lock",
        "_consecutive": "_lock",
        "_opened_at": "_lock",
        "_probe_inflight": "_lock",
        "_ewma_latency": "_lock",
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

    @property
    def state(self) -> str:
        return self._state

    # -- admission --------------------------------------------------------
    def allow(self, consume_probe: bool = True) -> bool:
        """May a call proceed to this member right now?

        CLOSED: always.  OPEN: no, until the cool-down elapses (then the
        breaker turns HALF_OPEN).  HALF_OPEN: one in-flight probe at a
        time when ``consume_probe`` (the call itself is the probe);
        ``consume_probe=False`` is the cheap read-side check
        (open-and-cooling means no)."""
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
        ``stall_threshold_s`` exceeded) opens immediately — one parked
        deadline is all a dead member gets."""
        if latency_s is not None and latency_s >= self.config.stall_threshold_s:
            timeout = True
        fired = None
        with self._lock:
            self._consecutive += 1
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
        return self._transition_locked(OPEN)

    def _transition_locked(self, new: str):
        old, self._state = self._state, new
        return (old, new) if old != new else None

    def _fire(self, old: str, new: str) -> None:
        if self._registry is not None:
            self._registry._on_breaker_transition(self.name, old, new)


@lockcheck.shared_field_guard
class BreakerRegistry:
    """One fleet's breakers and their transition observers."""

    _shared_fields_ = {
        "_breakers": "_lock",
        "_callbacks": "_lock",
    }

    def __init__(self, metrics=None, clock=time.monotonic):
        self.metrics = metrics
        self.config = BreakerConfig()
        self._clock = clock
        self._lock = lockcheck.make_lock("breaker-registry")
        self._breakers: dict[str, MemberBreaker] = {}
        self._callbacks: list[TransitionCallback] = []

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


def for_fleet(fleet, metrics=None) -> BreakerRegistry:
    """The fleet's shared registry, created on first use: every
    controller of one control plane must see the same member state."""
    registry = getattr(fleet, "_member_breakers", None)
    if registry is None:
        registry = BreakerRegistry(metrics=metrics)
        fleet._member_breakers = registry
    return registry
