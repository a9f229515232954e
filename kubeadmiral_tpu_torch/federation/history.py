"""Revision history: ControllerRevisions for federated workloads.

A copy of ``kubeadmiral_tpu/federation/history.py`` for the port's control
plane.

When an FTC enables revisionHistory, the sync controller records each
distinct pod template of a federated workload as a ControllerRevision on
the host (reference: pkg/controllers/sync/history.go:36-304), giving
rollback targets.  Mechanics mirrored from the reference:

* the revision's data is an RFC6902 patch replacing
  ``/spec/template/spec/template`` (the pod template inside the
  federated object's embedded workload),
* revisions are deduplicated by data equality; the name is
  ``<fed-name>-<hash(data, collisionCount)>`` and a collision (same name,
  different data) bumps ``status.collisionCount`` on the federated
  object,
* a new template gets revision number ``max(old)+1``; re-observing an
  old template bumps that revision back to the newest number (rollback
  detection),
* history is truncated to ``spec.revisionHistoryLimit`` (oldest first),
* the federated object is annotated with the current revision name and
  the last (previous) revision name suffixed ``|<podTemplateHash>``,
  which the rollout planner uses to pair member objects with revisions.
"""

from __future__ import annotations

import threading
from typing import Optional

from kubeadmiral_tpu_torch.federation import common as C
from kubeadmiral_tpu_torch.federation.retain import CURRENT_REVISION_ANNOTATION
from kubeadmiral_tpu_torch.testing.fakekube import (
    AlreadyExists,
    Conflict,
    FakeKube,
    NotFound,
)
from kubeadmiral_tpu_torch.utils.hashing import fnv32a, stable_json_hash
from kubeadmiral_tpu_torch.utils.unstructured import copy_json, get_path

CONTROLLER_REVISIONS = "apps/v1/controllerrevisions"
LAST_REVISION_ANNOTATION = C.PREFIX + "last-revision"

# Revisions are bound to their owner by uid label (history.go:283-287).
UID_LABEL = "uid"

DEFAULT_HISTORY_LIMIT = 10


class RevisionSyncError(Exception):
    pass


def pod_template(fed_obj: dict) -> Optional[dict]:
    """spec.template.spec.template of the federated object
    (history.go getPatch)."""
    value = get_path(fed_obj, "spec.template.spec.template")
    return value if isinstance(value, dict) else None


def _revision_data(fed_obj: dict) -> list:
    tpl = pod_template(fed_obj)
    if tpl is None:
        raise RevisionSyncError("spec.template.spec.template is not found")
    return [
        {"op": "replace", "path": "/spec/template/spec/template", "value": tpl}
    ]


def _revision_name(fed_name: str, data: list, collision_count: int) -> str:
    payload = C.compact_json(data).encode() + str(collision_count).encode()
    return f"{fed_name}-{fnv32a(payload):08x}"


def _revision_labels(fed_obj: dict) -> dict[str, str]:
    """uid binding + the owner's labels (history.go
    revisionLabelsWithOriginalLabel).  The uid binding is written last so
    an owner label literally named "uid" cannot break ownership."""
    labels = dict(fed_obj["metadata"].get("labels", {}))
    labels[UID_LABEL] = str(fed_obj["metadata"].get("uid", ""))
    return labels


class RevisionManager:
    """Host-side ControllerRevision bookkeeping for one FTC.

    Revisions are indexed by owner uid from a watch (the informer-indexer
    pattern): without it every sync reconcile would scan the whole
    ControllerRevision store — O(objects^2) work per settled batch."""

    def __init__(self, host: FakeKube):
        self.host = host
        self._lock = threading.Lock()
        self._by_uid: dict[str, set[str]] = {}
        # ktlint: ignore[shard-intake-coverage] broadcast index: the revision cache is keyed by owner uid and only read from shard-owned sync reconciles; non-owned rows cost memory, never scheduling work
        host.watch(CONTROLLER_REVISIONS, self._on_revision_event, replay=True)

    def _on_revision_event(self, event: str, obj: dict) -> None:
        uid = obj.get("metadata", {}).get("labels", {}).get(UID_LABEL)
        if uid is None:
            return
        ns = obj["metadata"].get("namespace", "")
        name = obj["metadata"]["name"]
        key = f"{ns}/{name}" if ns else name
        with self._lock:
            if event == "DELETED":
                self._by_uid.get(uid, set()).discard(key)
            else:
                self._by_uid.setdefault(uid, set()).add(key)

    def _list_owned(self, fed_obj: dict) -> list[dict]:
        uid = str(fed_obj["metadata"].get("uid", ""))
        with self._lock:
            keys = sorted(self._by_uid.get(uid, ()))
        out = []
        for key in keys:
            obj = self.host.try_get(CONTROLLER_REVISIONS, key)
            if obj is not None:
                out.append(obj)
        return out

    def sync_revisions(self, fed_obj: dict) -> tuple[int, str, str]:
        """Record the current template; returns (collisionCount,
        lastRevisionNameWithHash, currentRevisionName)
        (history.go syncRevisions)."""
        collision_count = int(
            get_path(fed_obj, "status.collisionCount", 0) or 0
        )
        data = _revision_data(fed_obj)
        # An explicit limit of 0 keeps no old revisions; only an absent
        # field falls back to the default.
        raw_limit = get_path(fed_obj, "spec.revisionHistoryLimit")
        history_limit = DEFAULT_HISTORY_LIMIT if raw_limit is None else int(raw_limit)

        revisions = self._list_owned(fed_obj)
        current = [r for r in revisions if r.get("data") == data]
        old = [r for r in revisions if r.get("data") != data]
        next_number = max((r.get("revision", 0) for r in old), default=0) + 1

        if not current:
            collision_count, name = self._create_revision(
                fed_obj, data, next_number, collision_count
            )
        else:
            keep = self._dedup_current(current)
            name = keep["metadata"]["name"]
            if keep.get("revision", 0) < next_number:
                # An old template came back (rollback): renumber to newest.
                keep["revision"] = next_number
                self._update_revision(keep)
            else:
                self._ensure_labels(keep, _revision_labels(fed_obj))

        # Truncate oldest history beyond the limit (history.go:163-183).
        old.sort(key=lambda r: r.get("revision", 0))
        to_kill = len(old) - history_limit
        killed = 0
        for rev in old:
            if killed >= to_kill:
                break
            self._delete_revision(rev)
            killed += 1
        old = old[killed:]

        last_with_hash = ""
        if old and history_limit >= 1:
            last_with_hash = old[-1]["metadata"]["name"]
            prev_tpl = None
            for patch in old[-1].get("data", []):
                if patch.get("path") == "/spec/template/spec/template":
                    prev_tpl = patch.get("value")
            last_with_hash += f"|{stable_json_hash(prev_tpl):08x}"
            for rev in old:
                self._ensure_labels(rev, _revision_labels(fed_obj))

        return collision_count, last_with_hash, name

    # -- storage helpers -------------------------------------------------
    def _create_revision(
        self, fed_obj: dict, data: list, number: int, collision_count: int
    ) -> tuple[int, str]:
        """Create with collision-count retry (k8s
        history.CreateControllerRevision semantics): an existing revision
        with the same name but different data bumps the counter."""
        ns = fed_obj["metadata"].get("namespace", "")
        fed_name = fed_obj["metadata"]["name"]
        while True:
            name = _revision_name(fed_name, data, collision_count)
            key = f"{ns}/{name}" if ns else name
            existing = self.host.try_get(CONTROLLER_REVISIONS, key)
            if existing is not None:
                if existing.get("data") == data:
                    return collision_count, name
                collision_count += 1
                continue
            revision = {
                "apiVersion": "apps/v1",
                "kind": "ControllerRevision",
                "metadata": {
                    "name": name,
                    "labels": _revision_labels(fed_obj),
                },
                "data": copy_json(data),
                "revision": number,
            }
            if ns:
                revision["metadata"]["namespace"] = ns
            try:
                self.host.create(CONTROLLER_REVISIONS, revision)
            except AlreadyExists:
                continue  # raced; re-check data on the next pass
            return collision_count, name

    def _dedup_current(self, current: list[dict]) -> dict:
        """Keep the max-revision duplicate, delete the rest
        (history.go dedupCurRevisions)."""
        keep = max(current, key=lambda r: r.get("revision", 0))
        for rev in current:
            if rev["metadata"]["name"] != keep["metadata"]["name"]:
                self._delete_revision(rev)
        return keep

    def _update_revision(self, revision: dict) -> None:
        try:
            self.host.update(CONTROLLER_REVISIONS, revision)
        except (Conflict, NotFound):
            pass  # next reconcile converges

    def _delete_revision(self, revision: dict) -> None:
        ns = revision["metadata"].get("namespace", "")
        name = revision["metadata"]["name"]
        try:
            self.host.delete(CONTROLLER_REVISIONS, f"{ns}/{name}" if ns else name)
        except NotFound:
            pass

    def _ensure_labels(self, revision: dict, labels: dict[str, str]) -> None:
        current = revision["metadata"].get("labels", {})
        if all(current.get(k) == v for k, v in labels.items()):
            return
        revision["metadata"]["labels"] = {**current, **labels}
        self._update_revision(revision)
