"""Instrumented lock wrapper + shared-field write guard.

A copy of ``kubeadmiral_tpu/runtime/lockcheck.py`` for the port's
control plane.  The JAX module reads ``KT_LOCKCHECK``; the port reads no
environment variable: the check is off unless :func:`enable` turns it
on (before the classes that use :func:`shared_field_guard` are imported,
for their write guard; locks made after the call are checked either way).

Python has no TSan; the thread-stress suite (tests/test_stress_threads)
fuzzes for divergence but can only see races that LOSE.  This module is
the deterministic half: when the check is on (default off), every lock built via
:func:`make_lock` records, per thread, the set of locks currently held,
and the module maintains a global acquisition-order graph:

* **Lock-order inversions.**  Acquiring B while holding A records the
  edge A→B; a later acquisition of A while holding B — the classic
  deadlock shape, which only hangs when two threads hit the window
  together — is reported immediately, with both stacks, even when the
  storm got lucky.  Same-name edges (two instances of the same lock
  class) are ignored: order within a class is not expressible by name.

* **Declared-shared field writes.**  Classes annotate their
  cross-thread state in a ``_shared_fields_`` registry
  (``{"field": "lockattr"}`` — alternates joined with ``|``), the same
  registry the static pass (``tools/ktlint`` rule ``lock-discipline``)
  checks mutation sites against.  :func:`shared_field_guard` wraps the
  class's ``__setattr__`` so a REBIND of a declared field off-lock is
  recorded at runtime too (the race class of a worker thread
  persisting empty placements through an unlocked reassignment).
  Container mutations (``.append``/``[k] = v``) don't pass through
  ``__setattr__`` — those are the static rule's half of the contract.

Violations are collected, not raised: a storm must run to completion so
every inversion is reported at once.  Tests call :func:`reset` before
the storm and assert :func:`violations` is empty after.  Overhead when
disabled is zero (plain ``threading.Lock``/``RLock`` objects are
returned and classes are left untouched).

"""

from __future__ import annotations

import threading
import traceback
from typing import Callable, Optional

__all__ = [
    "enabled",
    "enable",
    "make_lock",
    "make_rlock",
    "CheckedLock",
    "shared_field_guard",
    "assumes_held",
    "violations",
    "reset",
]


_enabled = False


def enabled() -> bool:
    """Instrumented locks + shared-field write guard (default off)."""
    return _enabled


def enable(on: bool = True) -> None:
    """Turn the check on (or off) for locks and classes made after the
    call — the JAX module's ``KT_LOCKCHECK=1``."""
    global _enabled
    _enabled = bool(on)


# -- violation collection -------------------------------------------------

_violations: list[str] = []
_violations_lock = threading.Lock()


def _record(kind: str, message: str) -> None:
    stack = "".join(traceback.format_stack(limit=8)[:-2])
    with _violations_lock:
        _violations.append(f"[{kind}] {message}\n{stack}")


def violations() -> list[str]:
    """Every violation recorded since the last :func:`reset`."""
    with _violations_lock:
        return list(_violations)


def reset() -> None:
    """Clear recorded violations AND the acquisition-order graph."""
    with _violations_lock:
        _violations.clear()
    with _graph_lock:
        _edges.clear()


# -- lock-order graph -----------------------------------------------------

# (held_name, acquired_name) -> one representative stack (first seen).
_edges: dict[tuple[str, str], str] = {}
_graph_lock = threading.Lock()

_tls = threading.local()


def _held_stack() -> list["CheckedLock"]:
    stack = getattr(_tls, "held", None)
    if stack is None:
        stack = []
        _tls.held = stack
    return stack


class CheckedLock:
    """A ``threading.Lock``/``RLock`` proxy that tracks per-thread
    acquisition order and detects inversions at acquire time."""

    def __init__(self, name: str, reentrant: bool = False):
        self.name = name
        self._lock = threading.RLock() if reentrant else threading.Lock()
        self._reentrant = reentrant

    # Condition() consults _is_owned when the wrapped lock provides it;
    # our per-thread held stack answers exactly that question.
    def _is_owned(self) -> bool:
        return self.held_by_current()

    def held_by_current(self) -> bool:
        return any(entry is self for entry in _held_stack())

    def _note_acquired(self) -> None:
        held = _held_stack()
        for prior in held:
            if prior is self or prior.name == self.name:
                continue  # re-entry / same-class nesting: not orderable by name
            edge = (prior.name, self.name)
            inverse = (self.name, prior.name)
            with _graph_lock:
                other = _edges.get(inverse)
                if edge not in _edges:
                    _edges[edge] = "".join(
                        traceback.format_stack(limit=6)[:-3]
                    )
            if other is not None:
                _record(
                    "lock-order-inversion",
                    f"acquired {self.name!r} while holding {prior.name!r}, "
                    f"but the opposite order was previously recorded at:\n"
                    f"{other}",
                )
        held.append(self)

    def acquire(self, blocking: bool = True, timeout: float = -1) -> bool:
        ok = self._lock.acquire(blocking, timeout)
        if ok:
            self._note_acquired()
        return ok

    def release(self) -> None:
        held = _held_stack()
        for i in range(len(held) - 1, -1, -1):
            if held[i] is self:
                del held[i]
                break
        self._lock.release()

    def locked(self) -> bool:
        return self._lock.locked() if not self._reentrant else self.held_by_current()

    def __enter__(self):
        self.acquire()
        return self

    def __exit__(self, *exc):
        self.release()
        return False


def make_lock(name: str):
    """A lock for a declared-shared structure: plain ``threading.Lock``
    in production, :class:`CheckedLock` when the check is on."""
    if enabled():
        return CheckedLock(name)
    return threading.Lock()


def make_rlock(name: str):
    if enabled():
        return CheckedLock(name, reentrant=True)
    return threading.RLock()


# -- declared-shared field guard ------------------------------------------


def _lock_held(obj, lock_spec: str) -> bool:
    for lock_name in lock_spec.split("|"):
        lock = getattr(obj, lock_name, None)
        if isinstance(lock, threading.Condition):
            lock = lock._lock
        if lock is None:
            continue
        if isinstance(lock, CheckedLock):
            if lock.held_by_current():
                return True
        else:
            # Uninstrumented lock (constructed before enablement or a
            # plain Lock): ownership is unknowable — don't guess.
            return True
    return False


def shared_field_guard(cls):
    """Class decorator: when the check is on, record any rebind of a
    ``_shared_fields_`` field made without its declared lock held.
    Writes during ``__init__`` (pre-publication) are exempt — the
    guard arms when ``__init__`` returns."""
    if not enabled():
        return cls
    fields = dict(getattr(cls, "_shared_fields_", {}) or {})
    if not fields:
        return cls

    orig_setattr = cls.__setattr__
    orig_init = cls.__init__

    def __setattr__(self, name, value):
        if name in fields and getattr(self, "_lockcheck_armed_", False):
            if not _lock_held(self, fields[name]):
                _record(
                    "shared-field-write",
                    f"{cls.__name__}.{name} rebound without holding "
                    f"{fields[name]!r}",
                )
        orig_setattr(self, name, value)

    def __init__(self, *args, **kwargs):
        orig_init(self, *args, **kwargs)
        orig_setattr(self, "_lockcheck_armed_", True)

    cls.__setattr__ = __setattr__
    cls.__init__ = __init__
    return cls


def assumes_held(lock_spec: str) -> Callable:
    """Method decorator: the caller must already hold ``lock_spec``
    (``"lockattr"`` or ``"a|b"`` alternates).  The static
    lock-discipline rule treats decorated methods as lock-held context;
    when the check is on the assumption is VERIFIED on every entry."""

    def deco(fn):
        if not enabled():
            fn.__assumes_held__ = lock_spec
            return fn

        def wrapper(self, *args, **kwargs):
            if not _lock_held(self, lock_spec):
                _record(
                    "assumes-held",
                    f"{type(self).__name__}.{fn.__name__} entered without "
                    f"holding {lock_spec!r}",
                )
            return fn(self, *args, **kwargs)

        wrapper.__name__ = fn.__name__
        wrapper.__doc__ = fn.__doc__
        wrapper.__assumes_held__ = lock_spec
        wrapper.__wrapped__ = fn
        return wrapper

    return deco
