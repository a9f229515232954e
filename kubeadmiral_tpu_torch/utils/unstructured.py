"""Dotted-path access into unstructured objects.

A copy of ``kubeadmiral_tpu/utils/unstructured.py`` for the port's control
plane.

The FTC pathDefinition addresses replicas/status fields with dotted
paths like "spec.replicas" (reference: unstructured helpers in
pkg/controllers/util and types_federatedtypeconfig.go pathDefinition).
"""

from __future__ import annotations

import copy as _copy

from typing import Any, Optional


def get_path(obj: dict, path: str, default: Any = None) -> Any:
    if not path:
        return default
    cur: Any = obj
    for part in path.split("."):
        if not isinstance(cur, dict) or part not in cur:
            return default
        cur = cur[part]
    return cur


def set_path(obj: dict, path: str, value: Any) -> None:
    parts = path.split(".")
    cur = obj
    for part in parts[:-1]:
        nxt = cur.get(part)
        if not isinstance(nxt, dict):
            nxt = {}
            cur[part] = nxt
        cur = nxt
    cur[parts[-1]] = value


def delete_path(obj: dict, path: str) -> None:
    parts = path.split(".")
    cur: Optional[dict] = obj
    for part in parts[:-1]:
        if not isinstance(cur, dict):
            return
        cur = cur.get(part)  # type: ignore[assignment]
    if isinstance(cur, dict):
        cur.pop(parts[-1], None)


def _copy_json_fast(obj):
    t = type(obj)
    if t is dict:
        return {k: _copy_json_fast(v) for k, v in obj.items()}
    if t is list:
        return [_copy_json_fast(v) for v in obj]
    if t in (str, int, float, bool, type(None)):
        return obj
    if t is tuple:
        return tuple(_copy_json_fast(v) for v in obj)
    return _copy.deepcopy(obj)  # non-JSON node: memo-based fallback


def _copy_json_py(obj):
    try:
        return _copy_json_fast(obj)
    except RecursionError:
        return _copy.deepcopy(obj)


_native_copy = None
_native_checked = False


def copy_json(obj):
    """Deep copy for JSON-shaped objects (immutable leaves shared, dict
    keys shared).  Uses the C extension (``native/fastcopy.cpp``, the
    JAX package's, about 8x the Python recursion there) when it builds;
    a non-JSON node or a cyclic structure makes the whole call fall back
    to copy.deepcopy, as the JAX package's C path does."""
    global _native_copy, _native_checked
    if not _native_checked:
        # Deferred: importing this module never waits for the build.
        from kubeadmiral_tpu_torch.native import load_fastcopy

        _native_copy = load_fastcopy()
        _native_checked = True
    if _native_copy is not None:
        try:
            return _native_copy(obj)
        except (TypeError, RecursionError):
            return _copy.deepcopy(obj)
    return _copy_json_py(obj)
