"""The pending-controllers pipeline annotation.

A copy of ``kubeadmiral_tpu/runtime/pending.py`` for the port's control
plane.

Controllers are choreographed through an ordered list of controller
groups on each federated object (reference: pkg/controllers/util/
pendingcontrollers/pendingcontrollers.go:29-147): a controller may act
only while it appears in the *first* pending group; when done it removes
itself from that group, and if it changed the object it re-arms every
group downstream of its own position so later controllers run again.
This is the control plane's pipeline: scheduler -> override -> sync.

The federate controller stamps the initial annotation when it creates
the federated object; a missing annotation is an error, as in the
reference.
"""

from __future__ import annotations

import json
from typing import Sequence

PENDING_CONTROLLERS = "kubeadmiral.io/pending-controllers"

ControllerGroups = list[list[str]]


def normalize(groups: Sequence[Sequence[str]]) -> ControllerGroups:
    return [list(g) for g in groups if len(g) > 0]


def get_pending(obj: dict) -> ControllerGroups:
    raw = obj.get("metadata", {}).get("annotations", {}).get(PENDING_CONTROLLERS)
    if raw is None:
        raise KeyError(f"annotation {PENDING_CONTROLLERS} does not exist")
    value = json.loads(raw)
    if not isinstance(value, list):
        raise ValueError(f"invalid pending controllers: {raw!r}")
    return normalize(value)


def set_pending(obj: dict, groups: Sequence[Sequence[str]]) -> bool:
    """Returns True when the annotation value changed."""
    encoded = json.dumps(normalize(groups), separators=(",", ":"))
    ann = obj.setdefault("metadata", {}).setdefault("annotations", {})
    if ann.get(PENDING_CONTROLLERS) == encoded:
        return False
    ann[PENDING_CONTROLLERS] = encoded
    return True


def dependencies_fulfilled(obj: dict, controller: str) -> bool:
    """True when the controller is in the first pending group (or none
    are pending)."""
    groups = get_pending(obj)
    if not groups:
        return True
    return controller in groups[0]


def _downstream(all_groups: Sequence[Sequence[str]], current: str) -> ControllerGroups:
    for i, group in enumerate(all_groups):
        if current in group:
            return [list(g) for g in all_groups[i + 1 :]]
    return []


def _next_groups(
    obj: dict,
    to_remove: str,
    set_downstream: bool,
    all_groups: Sequence[Sequence[str]],
) -> list:
    """The pending groups after one controller's pass — the ONE
    definition shared by the mutating update and the probe."""
    groups = get_pending(obj)
    current = list(groups[0]) if groups else []
    rest = groups[1:] if groups else []
    if to_remove in current:
        current.remove(to_remove)
    if set_downstream:
        rest = _downstream(all_groups, to_remove)
    return [current] + list(rest)


def would_update(
    obj: dict,
    to_remove: str,
    set_downstream: bool,
    all_groups: Sequence[Sequence[str]],
) -> bool:
    """Non-mutating probe of :func:`update_pending`: True when applying
    it would change the annotation — lets view-read reconciles skip the
    copy + write entirely in the steady state."""
    encoded = json.dumps(
        normalize(_next_groups(obj, to_remove, set_downstream, all_groups)),
        separators=(",", ":"),
    )
    ann = obj.get("metadata", {}).get("annotations", {})
    return ann.get(PENDING_CONTROLLERS) != encoded


def update_pending(
    obj: dict,
    to_remove: str,
    set_downstream: bool,
    all_groups: Sequence[Sequence[str]],
) -> bool:
    """Remove ``to_remove`` from the current group; when the controller
    changed the object (``set_downstream``), re-arm everything after its
    group in ``all_groups``.  Returns True when the annotation changed."""
    return set_pending(obj, _next_groups(obj, to_remove, set_downstream, all_groups))
