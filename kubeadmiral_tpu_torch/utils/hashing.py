"""FNV-1 hashing compatible with the reference control plane's choices.

The replica planner tie-breaks equal-weight clusters by ``fnv.New32()``
(FNV-1, 32-bit) over ``clusterName + replicaSetKey`` (reference:
pkg/controllers/util/planner/planner.go:184-198), so the exact bit
patterns matter for parity.  Pure-Python/numpy implementations.
"""

from __future__ import annotations

from typing import Iterable

import numpy as np

_FNV32_PRIME = np.uint32(16777619)


def fnv32(data: bytes) -> int:
    """FNV-1 32-bit (multiply, then xor) — matches Go's ``fnv.New32()``."""
    h = 2166136261
    for b in data:
        h = ((h * 16777619) & 0xFFFFFFFF) ^ b
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
