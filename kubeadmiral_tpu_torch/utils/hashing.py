"""FNV hashing compatible with the reference control plane's choices.

The reference uses Go's ``hash/fnv`` in two places that shape scheduling
semantics, so the exact bit patterns matter for parity:

* the replica planner tie-breaks equal-weight clusters by ``fnv.New32()``
  (FNV-1, 32-bit) over ``clusterName + replicaSetKey``
  (reference: pkg/controllers/util/planner/planner.go:184-198), and
* scheduling-trigger dedupe hashes a canonical JSON encoding with
  ``fnv.New32a()`` (reference:
  pkg/controllers/scheduler/schedulingtriggers.go:106-148).

The byte loops run in the port's native C++ library when it builds
(``kubeadmiral_tpu_torch/native``, g++ at first use), with these
pure-Python/numpy implementations as the fallback; both give the same
values.
"""

from __future__ import annotations

import ctypes
import json
from typing import Any, Iterable

import numpy as np

from kubeadmiral_tpu_torch import native

_FNV32_PRIME = np.uint32(16777619)

# Resolved at the first hash call, so importing this module never waits
# for the on-demand build.
_UNRESOLVED = object()
_NATIVE: Any = _UNRESOLVED


def _native_lib():
    global _NATIVE
    if _NATIVE is _UNRESOLVED:
        _NATIVE = native.load()
    return _NATIVE


def fnv32(data: bytes) -> int:
    """FNV-1 32-bit (multiply, then xor) — matches Go's ``fnv.New32()``."""
    lib = _native_lib()
    if lib is not None:
        return lib.kadm_fnv32(data, len(data))
    return fnv32_py(data)


def fnv32_py(data: bytes) -> int:
    """``fnv32`` in pure Python."""
    h = 2166136261
    for b in data:
        h = ((h * 16777619) & 0xFFFFFFFF) ^ b
    return h


def fnv32a(data: bytes) -> int:
    """FNV-1a 32-bit (xor, then multiply) — matches Go's ``fnv.New32a()``."""
    lib = _native_lib()
    if lib is not None:
        return lib.kadm_fnv32a(data, len(data))
    return fnv32a_py(data)


def fnv32a_py(data: bytes) -> int:
    """``fnv32a`` in pure Python."""
    h = 2166136261
    for b in data:
        h = ((h ^ b) * 16777619) & 0xFFFFFFFF
    return h


def fnv32_batch(prefixes: Iterable[str], suffix: str) -> np.ndarray:
    """FNV-1 of ``prefix + suffix`` for many prefixes, one suffix.
    Returns uint32[N]."""
    suffix_b = suffix.encode()
    prefs = list(prefixes)
    lib = _native_lib()
    if lib is not None and prefs:
        encoded = [p.encode() for p in prefs]
        offsets = np.zeros(len(encoded) + 1, dtype=np.uint64)
        np.cumsum([len(e) for e in encoded], out=offsets[1:])
        out = np.empty(len(encoded), dtype=np.uint32)
        lib.kadm_fnv32_batch(
            b"".join(encoded),
            offsets.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)),
            len(encoded),
            suffix_b,
            len(suffix_b),
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)),
        )
        return out
    out = np.empty(len(prefs), dtype=np.uint32)
    for i, p in enumerate(prefs):
        out[i] = fnv32_py(p.encode() + suffix_b)
    return out


def fnv32_extend(state: int | np.ndarray, data: bytes) -> int | np.ndarray:
    """Continue an FNV-1 hash from a previous state over extra bytes:
    ``fnv32(a + b) == fnv32_extend(fnv32(a), b)``.  Accepts a scalar
    state or a uint32 ndarray of states (vectorized)."""
    lib = _native_lib()
    scalar = not isinstance(state, np.ndarray)
    h = np.asarray([int(state)] if scalar else state).astype(np.uint32)
    if lib is not None:
        h = np.ascontiguousarray(h)
        lib.kadm_fnv32_extend_batch(
            h.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)), h.size, data, len(data)
        )
        return int(h[0]) if scalar else h
    if scalar:
        return fnv32_extend_py(int(state), data)
    with np.errstate(over="ignore"):
        for b in data:
            h = (h * _FNV32_PRIME) ^ np.uint32(b)
    return h


def fnv32_extend_py(state: int, data: bytes) -> int:
    """The scalar ``fnv32_extend`` in pure Python."""
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
    return fnv32a(_canonical_json(value))


def stable_json_hash_py(value: Any) -> int:
    """``stable_json_hash`` with the byte loop in pure Python."""
    return fnv32a_py(_canonical_json(value))


def _canonical_json(value: Any) -> bytes:
    def canonical(v: Any) -> Any:
        # json.dumps only consults this hook for non-JSON types; nested
        # non-JSON elements inside the returned value are routed back here.
        if isinstance(v, (set, frozenset)):
            return sorted(v, key=lambda x: json.dumps(x, sort_keys=True, default=canonical))
        if isinstance(v, tuple):
            return list(v)
        raise TypeError(f"unhashable trigger value of type {type(v).__name__}")

    enc = json.dumps(value, sort_keys=True, separators=(",", ":"), default=canonical)
    return enc.encode()
