"""RFC 6902 JSON Patch application over unstructured objects.

A copy of ``kubeadmiral_tpu/utils/jsonpatch.py`` for the port's control
plane.

The override machinery stores per-cluster mutations as JSON patches
(reference: pkg/controllers/util/overrides.go:57-232 applying
evanphx/json-patch); this is a self-contained implementation of the op
set with JSON-pointer escaping (~0 -> ~, ~1 -> /) and array index
semantics ("-" appends).
"""

from __future__ import annotations


from kubeadmiral_tpu_torch.utils.unstructured import copy_json
from typing import Any


class PatchError(Exception):
    pass


def _unescape(token: str) -> str:
    return token.replace("~1", "/").replace("~0", "~")


def _tokens(pointer: str) -> list[str]:
    if pointer == "":
        return []
    if not pointer.startswith("/"):
        raise PatchError(f"invalid JSON pointer {pointer!r}")
    return [_unescape(t) for t in pointer[1:].split("/")]


def _walk(doc: Any, tokens: list[str]) -> Any:
    cur = doc
    for t in tokens:
        if isinstance(cur, dict):
            if t not in cur:
                raise PatchError(f"path segment {t!r} not found")
            cur = cur[t]
        elif isinstance(cur, list):
            cur = cur[_index(t, len(cur), append_ok=False)]
        else:
            raise PatchError(f"cannot traverse {type(cur).__name__} at {t!r}")
    return cur


def _index(token: str, length: int, append_ok: bool) -> int:
    if token == "-":
        if append_ok:
            return length
        raise PatchError("'-' not allowed here")
    try:
        i = int(token)
    except ValueError as e:
        raise PatchError(f"invalid array index {token!r}") from e
    if not (0 <= i <= (length if append_ok else length - 1)):
        raise PatchError(f"array index {i} out of range")
    return i


def _get(doc: Any, pointer: str) -> Any:
    return _walk(doc, _tokens(pointer))


def _add(doc: Any, pointer: str, value: Any) -> Any:
    tokens = _tokens(pointer)
    if not tokens:
        return value
    parent = _walk(doc, tokens[:-1])
    last = tokens[-1]
    if isinstance(parent, dict):
        parent[last] = value
    elif isinstance(parent, list):
        parent.insert(_index(last, len(parent), append_ok=True), value)
    else:
        raise PatchError(f"cannot add into {type(parent).__name__}")
    return doc


def _replace(doc: Any, pointer: str, value: Any) -> Any:
    """Overwrite in place (unlike add, which inserts into arrays)."""
    tokens = _tokens(pointer)
    if not tokens:
        return value
    parent = _walk(doc, tokens[:-1])
    last = tokens[-1]
    if isinstance(parent, dict):
        if last not in parent:
            raise PatchError(f"path {pointer!r} not found")
        parent[last] = value
    elif isinstance(parent, list):
        parent[_index(last, len(parent), append_ok=False)] = value
    else:
        raise PatchError(f"cannot replace in {type(parent).__name__}")
    return doc


def _remove(doc: Any, pointer: str) -> Any:
    tokens = _tokens(pointer)
    if not tokens:
        raise PatchError("cannot remove whole document")
    parent = _walk(doc, tokens[:-1])
    last = tokens[-1]
    if isinstance(parent, dict):
        if last not in parent:
            raise PatchError(f"path {pointer!r} not found")
        del parent[last]
    elif isinstance(parent, list):
        parent.pop(_index(last, len(parent), append_ok=False))
    else:
        raise PatchError(f"cannot remove from {type(parent).__name__}")
    return doc


def apply_patch(obj: dict, patches: list[dict]) -> dict:
    """Apply an RFC6902 patch list to a deep copy of ``obj``."""
    doc: Any = copy_json(obj)
    for p in patches:
        op = p.get("op")
        path = p.get("path", "")
        if op == "add":
            doc = _add(doc, path, copy_json(p.get("value")))
        elif op == "replace":
            doc = _replace(doc, path, copy_json(p.get("value")))
        elif op == "remove":
            doc = _remove(doc, path)
        elif op == "move":
            value = _get(doc, p["from"])
            doc = _remove(doc, p["from"])
            doc = _add(doc, path, value)
        elif op == "copy":
            value = copy_json(_get(doc, p["from"]))
            doc = _add(doc, path, value)
        elif op == "test":
            if _get(doc, path) != p.get("value"):
                raise PatchError(f"test failed at {path!r}")
        else:
            raise PatchError(f"unknown op {op!r}")
    return doc


def create_merge_patch(source: Any, target: Any) -> Any:
    """RFC 7386 JSON merge patch turning ``source`` into ``target``.

    The federate controller records this on the federated object so the
    template generator is reconstructible (reference:
    pkg/controllers/federate/util.go:330-349 CreateMergePatch).
    """
    if not isinstance(source, dict) or not isinstance(target, dict):
        return copy_json(target)
    patch: dict = {}
    for key, src_val in source.items():
        if key not in target:
            patch[key] = None
        elif src_val != target[key]:
            patch[key] = create_merge_patch(src_val, target[key])
    for key, tgt_val in target.items():
        if key not in source:
            patch[key] = copy_json(tgt_val)
    return patch


def apply_merge_patch(doc: Any, patch: Any) -> Any:
    """Apply an RFC 7386 merge patch (null deletes keys)."""
    if not isinstance(patch, dict):
        return copy_json(patch)
    result = copy_json(doc) if isinstance(doc, dict) else {}
    for key, val in patch.items():
        if val is None:
            result.pop(key, None)
        else:
            result[key] = apply_merge_patch(result.get(key), val)
    return result
