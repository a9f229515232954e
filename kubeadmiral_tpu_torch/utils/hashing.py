"""FNV hashing compatible with the reference control plane's choices.

The reference uses Go's ``hash/fnv`` in two places that shape scheduling
semantics, so the exact bit patterns matter for parity:

* the replica planner tie-breaks equal-weight clusters by ``fnv.New32()``
  (FNV-1, 32-bit) over ``clusterName + replicaSetKey``
  (reference: pkg/controllers/util/planner/planner.go:184-198), and
* scheduling-trigger dedupe hashes a canonical JSON encoding with
  ``fnv.New32a()`` (reference:
  pkg/controllers/scheduler/schedulingtriggers.go:106-148).

Pure-Python/numpy implementations.
"""

from __future__ import annotations

import json
from typing import Any, Iterable

import numpy as np

_FNV32_PRIME = np.uint32(16777619)


def fnv32(data: bytes) -> int:
    """FNV-1 32-bit (multiply, then xor) — matches Go's ``fnv.New32()``."""
    h = 2166136261
    for b in data:
        h = ((h * 16777619) & 0xFFFFFFFF) ^ b
    return h


def fnv32a(data: bytes) -> int:
    """FNV-1a 32-bit (xor, then multiply) — matches Go's ``fnv.New32a()``."""
    h = 2166136261
    for b in data:
        h = ((h ^ b) * 16777619) & 0xFFFFFFFF
    return h


def fnv32_batch(prefixes: Iterable[str], suffix: str) -> np.ndarray:
    """FNV-1 of ``prefix + suffix`` for many prefixes, one suffix.
    Returns uint32[N]."""
    suffix_b = suffix.encode()
    prefs = list(prefixes)
    out = np.empty(len(prefs), dtype=np.uint32)
    for i, p in enumerate(prefs):
        out[i] = fnv32(p.encode() + suffix_b)
    return out


def fnv32_extend(state: int | np.ndarray, data: bytes) -> int | np.ndarray:
    """Continue an FNV-1 hash from a previous state over extra bytes:
    ``fnv32(a + b) == fnv32_extend(fnv32(a), b)``.  Accepts a scalar
    state or a uint32 ndarray of states (vectorized)."""
    if isinstance(state, np.ndarray):
        h = state.astype(np.uint32).copy()
        with np.errstate(over="ignore"):
            for b in data:
                h = (h * _FNV32_PRIME) ^ np.uint32(b)
        return h
    h = int(state)
    for b in data:
        h = ((h * 16777619) & 0xFFFFFFFF) ^ b
    return h


def uint32_to_sortable_int32(h: np.ndarray) -> np.ndarray:
    """Map uint32 to int32 preserving unsigned order (for int32 sorts)."""
    return (h.astype(np.int64) - 2**31).astype(np.int32)


def stable_json_hash(value: Any) -> int:
    """FNV-1a over a canonical (sorted-key, compact) JSON encoding.

    The trigger-hash analogue: the reference marshals a sorted struct to
    JSON and hashes it so that reconciles with unchanged inputs can be
    skipped (schedulingtriggers.go:106-148). Python dicts are sorted and
    sets canonicalized so the encoding never depends on iteration order
    or PYTHONHASHSEED; other non-JSON types raise rather than hash
    unstably.
    """

    def canonical(v: Any) -> Any:
        # json.dumps only consults this hook for non-JSON types; nested
        # non-JSON elements inside the returned value are routed back here.
        if isinstance(v, (set, frozenset)):
            return sorted(v, key=lambda x: json.dumps(x, sort_keys=True, default=canonical))
        if isinstance(v, tuple):
            return list(v)
        raise TypeError(f"unhashable trigger value of type {type(v).__name__}")

    enc = json.dumps(value, sort_keys=True, separators=(",", ":"), default=canonical)
    return fnv32a(enc.encode())
