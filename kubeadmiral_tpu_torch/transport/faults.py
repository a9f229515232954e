"""Member fault injection: the chaos seam for transport and testing.

A copy of ``kubeadmiral_tpu/transport/faults.py`` for the port's control
plane.

Nothing in the control plane may *assume* a healthy member; this module
is how tests and benches make that falsifiable.  A :class:`FaultPolicy`
describes one member's misbehavior — added latency, an error rate,
dropped connections, a stalled watch stream, a hard (connect-timeout)
partition, or flapping between partitioned and healthy — optionally
scheduled over time (``start_s`` delay, ``duration_s`` auto-expiry).
A :class:`FaultInjector` holds the per-member policies and resolves
them into instantaneous :class:`FaultAction`\\ s at request time.

Two enforcement points honor the same injector:

* **server side** — :class:`transport.apiserver.KubeApiServer` (and the
  kwok-lite farm wiring it up) gates every request and watch stream, so
  HTTP clients experience real timeouts, severed sockets and silent
  watch streams;
* **client side** — :class:`FaultyKube` wraps any FakeKube-duck-typed
  client so purely in-process fleets are injectable too (partition
  becomes a bounded sleep + :class:`TransportError`, a stalled watch
  buffers events until the stall clears).

The circuit breakers (:mod:`kubeadmiral_tpu_torch.transport.breaker`) and the
stall-proof dispatch fan-out (:mod:`kubeadmiral_tpu_torch.federation.dispatch`)
are tested exclusively through this seam (``tests/test_faults.py``,
``make chaos``).
"""

from __future__ import annotations

import random
import threading
import time
from dataclasses import dataclass
from typing import Callable, Optional

from kubeadmiral_tpu_torch.transport.client import TransportError


@dataclass(frozen=True)
class FaultPolicy:
    """One member's scheduled misbehavior.  All fields compose; the
    zero policy is a no-op."""

    latency_s: float = 0.0      # added to every request
    jitter_s: float = 0.0       # uniform extra latency in [0, jitter_s)
    error_rate: float = 0.0     # fraction of requests answered HTTP 500
    drop_rate: float = 0.0      # fraction of connections severed, no response
    partition: bool = False     # hard partition: requests hang, then sever
    watch_stall: bool = False   # watch streams stop delivering (and heartbeating)
    flap_period_s: float = 0.0  # >0: partition toggles with this period
    flap_duty: float = 0.5      # fraction of each flap period spent partitioned
    start_s: float = 0.0        # schedule: engage this long after set_fault()
    duration_s: float = 0.0     # >0: auto-expire this long after engaging


@dataclass(frozen=True)
class FaultAction:
    """A policy resolved at one instant for one request."""

    latency_s: float = 0.0
    error: bool = False
    drop: bool = False
    partition: bool = False
    watch_stall: bool = False


class FaultInjector:
    """Per-member fault policies with time-based resolution.

    Thread-safe; shared by every apiserver of a farm and by client-side
    :class:`FaultyKube` proxies.  ``partition_hang_s`` caps how long a
    server handler holds a partitioned request before severing (the
    client's own timeout fires first in practice)."""

    def __init__(self, clock=time.monotonic, seed: int = 0,
                 partition_hang_s: float = 30.0):
        self._clock = clock
        self._lock = threading.Lock()
        self._rng = random.Random(seed)
        self._policies: dict[str, tuple[FaultPolicy, float]] = {}
        self.partition_hang_s = partition_hang_s

    # -- policy management -----------------------------------------------
    def set_fault(self, member: str, policy: Optional[FaultPolicy]) -> None:
        with self._lock:
            if policy is None:
                self._policies.pop(member, None)
            else:
                self._policies[member] = (policy, self._clock())

    def clear(self, member: str) -> None:
        self.set_fault(member, None)

    def clear_all(self) -> None:
        with self._lock:
            self._policies.clear()

    def policy(self, member: str) -> Optional[FaultPolicy]:
        with self._lock:
            entry = self._policies.get(member)
        return entry[0] if entry is not None else None

    # -- resolution -------------------------------------------------------
    def _resolve(self, member: str) -> Optional[tuple[FaultPolicy, float]]:
        """(policy, seconds-since-engaged), or None when no policy is
        active right now (not yet started, or expired)."""
        with self._lock:
            entry = self._policies.get(member)
            if entry is None:
                return None
            policy, set_at = entry
            t = self._clock() - set_at - policy.start_s
            if t < 0:
                return None  # scheduled but not engaged yet
            if policy.duration_s > 0 and t > policy.duration_s:
                del self._policies[member]  # expired
                return None
            return policy, t

    def action(self, member: str) -> Optional[FaultAction]:
        """Resolve one request's fate; None = no active fault."""
        resolved = self._resolve(member)
        if resolved is None:
            return None
        policy, t = resolved
        partitioned = policy.partition
        if policy.flap_period_s > 0:
            phase = (t % policy.flap_period_s) / policy.flap_period_s
            partitioned = phase < policy.flap_duty
        with self._lock:
            r_err = self._rng.random()
            r_drop = self._rng.random()
            r_lat = self._rng.random()
        latency = policy.latency_s + policy.jitter_s * r_lat
        return FaultAction(
            latency_s=latency,
            error=r_err < policy.error_rate,
            drop=r_drop < policy.drop_rate,
            partition=partitioned,
            watch_stall=policy.watch_stall,
        )

    def partitioned(self, member: str) -> bool:
        act = self.action(member)
        return act is not None and act.partition

    def watch_stalled(self, member: str) -> bool:
        resolved = self._resolve(member)
        if resolved is None:
            return False
        policy, _ = resolved
        return policy.watch_stall or self.partitioned(member)


class _StallGate:
    """Wraps one watch handler: while the member's watch is stalled,
    events buffer in order; they drain before the first post-stall event
    is delivered (a stalled-then-recovered stream catches up, it never
    loses events — the in-process fleets have no relist to fall back
    on)."""

    def __init__(self, handler: Callable, member: str, injector: FaultInjector):
        self._handler = handler
        self._member = member
        self._injector = injector
        self._lock = threading.Lock()
        self._buffer: list[tuple[str, dict]] = []
        # Preserve owner detection (fakekube.handler_owner) through the
        # wrapper so unwatch_owner() still finds this registration.
        owner = getattr(handler, "__self__", None)
        if owner is None:
            owner = getattr(getattr(handler, "func", None), "__self__", None)
        if owner is not None:
            self.__self__ = owner

    def __call__(self, event: str, obj: dict) -> None:
        with self._lock:
            if self._injector.watch_stalled(self._member):
                self._buffer.append((event, obj))
                return
            drained, self._buffer = self._buffer, []
        for ev, o in drained:
            self._handler(ev, o)
        self._handler(event, obj)

    def drain(self) -> None:
        """Deliver anything buffered (called opportunistically once the
        stall clears; the next live event also drains)."""
        with self._lock:
            if self._injector.watch_stalled(self._member):
                return
            drained, self._buffer = self._buffer, []
        for ev, o in drained:
            self._handler(ev, o)


class FaultyKube:
    """A fault-injecting proxy over any FakeKube-duck-typed client.

    CRUD/batch/list calls resolve the member's policy first: partition
    sleeps up to ``timeout`` (in slices, so a flap shorter than the
    timeout lets the request through late) then raises
    :class:`TransportError`; injected errors and drops raise
    immediately; latency sleeps then proceeds.  Watch registrations are
    wrapped in a :class:`_StallGate`."""

    def __init__(self, inner, name: str, injector: FaultInjector,
                 timeout: float = 1.0, clock=time.monotonic):
        self._inner = inner
        self.name = name
        self._injector = injector
        self._timeout = timeout
        self._clock = clock
        self._gates: dict[tuple[str, int], _StallGate] = {}
        self._gates_lock = threading.Lock()

    # -- the fault gate ---------------------------------------------------
    def _gate(self) -> None:
        act = self._injector.action(self.name)
        if act is None:
            return
        if act.partition:
            deadline = self._clock() + self._timeout
            while self._clock() < deadline:
                time.sleep(min(0.02, self._timeout))
                if not self._injector.partitioned(self.name):
                    return  # flap cleared mid-request: serve it late
            raise TransportError(f"{self.name}: partitioned (fault injected)")
        if act.drop:
            raise TransportError(f"{self.name}: connection dropped (fault injected)")
        if act.error:
            if act.latency_s:
                time.sleep(act.latency_s)
            raise TransportError(f"{self.name}: injected error")
        if act.latency_s:
            time.sleep(act.latency_s)

    # -- gated CRUD seam --------------------------------------------------
    def create(self, resource, obj, **kw):
        self._gate()
        return self._inner.create(resource, obj, **kw)

    def get(self, resource, key):
        self._gate()
        return self._inner.get(resource, key)

    def try_get(self, resource, key):
        self._gate()
        return self._inner.try_get(resource, key)

    def try_get_view(self, resource, key):
        self._gate()
        view = getattr(self._inner, "try_get_view", None)
        if view is not None:
            return view(resource, key)
        return self._inner.try_get(resource, key)

    def update(self, resource, obj, **kw):
        self._gate()
        return self._inner.update(resource, obj, **kw)

    def update_status(self, resource, obj, **kw):
        self._gate()
        return self._inner.update_status(resource, obj, **kw)

    def delete(self, resource, key):
        self._gate()
        return self._inner.delete(resource, key)

    def batch(self, operations):
        self._gate()
        return self._inner.batch(operations)

    def list(self, resource, *a, **kw):
        self._gate()
        return self._inner.list(resource, *a, **kw)

    def list_view(self, resource, *a, **kw):
        self._gate()
        return self._inner.list_view(resource, *a, **kw)

    def keys(self, resource):
        self._gate()
        return self._inner.keys(resource)

    def scan(self, resource, fn):
        self._gate()
        return self._inner.scan(resource, fn)

    @property
    def healthy(self) -> bool:
        try:
            self._gate()
        except TransportError:
            return False
        return bool(getattr(self._inner, "healthy", True))

    # -- watch (stall-gated) ----------------------------------------------
    def watch(self, resource, handler, replay: bool = True) -> None:
        gate = _StallGate(handler, self.name, self._injector)
        with self._gates_lock:
            self._gates[(resource, id(handler))] = gate
        self._inner.watch(resource, gate, replay=replay)

    def unwatch(self, resource, handler) -> None:
        with self._gates_lock:
            gate = self._gates.pop((resource, id(handler)), None)
        self._inner.unwatch(resource, gate if gate is not None else handler)

    def unwatch_owner(self, owner) -> None:
        self._inner.unwatch_owner(owner)

    def drain_stalled(self) -> None:
        """Flush every stall gate's buffer (tests call this after
        clearing a watch_stall so convergence doesn't wait for the next
        live event)."""
        with self._gates_lock:
            gates = list(self._gates.values())
        for gate in gates:
            gate.drain()

    # Everything else (dump/restore, current_rv, watch_all, ...) passes
    # through un-gated: those are host-side/diagnostic surfaces.
    def __getattr__(self, item):
        return getattr(self._inner, item)
