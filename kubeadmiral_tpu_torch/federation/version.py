"""PropagatedVersion manager: skip no-op member-cluster writes.

A copy of ``kubeadmiral_tpu/federation/version.py`` for the port's control
plane.

Records, per federated object, the (template hash, override hash) it was
propagated at plus each member cluster's observed object version.  On
the next sync, an unchanged hash pair + matching member version means the
write can be skipped entirely — including across controller restarts,
since the record is a CR on the host (reference:
pkg/controllers/sync/version/manager.go:49-487,
pkg/apis/core/v1alpha1/types_propgatedversion.go).
"""

from __future__ import annotations

import threading
from typing import Optional

from kubeadmiral_tpu_torch.testing.fakekube import AlreadyExists, Conflict, FakeKube, NotFound

PROPAGATED_VERSIONS = "core.kubeadmiral.io/v1alpha1/propagatedversions"
CLUSTER_PROPAGATED_VERSIONS = "core.kubeadmiral.io/v1alpha1/clusterpropagatedversions"


def version_name(kind: str, resource_name: str) -> str:
    """``<lower kind>-<name>`` (manager.go:481-486)."""
    return f"{kind.lower()}-{resource_name}"


class VersionManager:
    """In-memory cache over PropagatedVersion CRs (manager.go:49-98).

    The reference primes its cache from a LIST at startup; here the cache
    loads lazily per key, which has the same restart-resume property."""

    def __init__(self, host: FakeKube, kind: str, namespaced: bool):
        self.host = host
        self.kind = kind
        self.resource = PROPAGATED_VERSIONS if namespaced else CLUSTER_PROPAGATED_VERSIONS
        self._lock = threading.Lock()
        self._cache: dict[str, dict] = {}  # fed key -> version CR

    def _cr_key(self, namespace: str, name: str) -> str:
        vname = version_name(self.kind, name)
        return f"{namespace}/{vname}" if namespace else vname

    def get(
        self, namespace: str, name: str, template_version: str, override_version: str
    ) -> dict[str, str]:
        """cluster -> recorded object version, or {} when the propagated
        hashes changed (manager.go:119-150)."""
        cr = self._load(namespace, name)
        if cr is None:
            return {}
        status = cr.get("status", {})
        if (
            status.get("templateVersion") != template_version
            or status.get("overrideVersion") != override_version
        ):
            return {}
        return {
            cv["clusterName"]: cv["version"]
            for cv in status.get("clusterVersions", [])
        }

    def update(
        self,
        namespace: str,
        name: str,
        template_version: str,
        override_version: str,
        selected_clusters: list[str],
        version_map: dict[str, str],
        batch=None,
    ) -> None:
        """Merge the dispatch round's versions and persist
        (manager.go:152-215, updateClusterVersions:448-463): versions for
        unselected clusters are dropped; clusters the round produced no
        version for keep their old record only if still selected.  With
        ``batch`` (a sync-tick host batch exposing ``stage(op, cb)``),
        the persist rides the tick's bulk host round trip; conflicts
        fall back to the direct write (recording is an optimization —
        failures are tolerated either way)."""
        with self._lock:
            cr = self._load_locked(namespace, name)
            old_versions: dict[str, str] = {}
            if cr is not None:
                status = cr.get("status", {})
                if (
                    status.get("templateVersion") == template_version
                    and status.get("overrideVersion") == override_version
                ):
                    old_versions = {
                        cv["clusterName"]: cv["version"]
                        for cv in status.get("clusterVersions", [])
                    }
            merged = {
                c: version_map.get(c, old_versions.get(c, ""))
                for c in selected_clusters
            }
            merged = {c: v for c, v in merged.items() if v}
            status = {
                "templateVersion": template_version,
                "overrideVersion": override_version,
                "clusterVersions": [
                    {"clusterName": c, "version": v}
                    for c, v in sorted(merged.items())
                ],
            }
            # Unchanged record: skip the write entirely — a restarted
            # controller re-syncing a converged world must be read-only
            # (manager.go's updatedVersionMap equality short-circuit).
            if cr is not None and cr.get("status") == status:
                return
            self._write(namespace, name, status, cr, batch)

    def delete(self, namespace: str, name: str) -> None:
        key = self._cr_key(namespace, name)
        with self._lock:
            self._cache.pop(key, None)
        try:
            self.host.delete(self.resource, key)
        except NotFound:
            pass

    # -- storage ---------------------------------------------------------
    def _load(self, namespace: str, name: str) -> Optional[dict]:
        with self._lock:
            return self._load_locked(namespace, name)

    def _load_locked(self, namespace: str, name: str) -> Optional[dict]:
        key = self._cr_key(namespace, name)
        if key in self._cache:
            return self._cache[key]
        cr = self.host.try_get(self.resource, key)
        if cr is not None:
            self._cache[key] = cr
        return cr

    def _write(
        self,
        namespace: str,
        name: str,
        status: dict,
        existing: Optional[dict],
        batch=None,
    ) -> None:
        key = self._cr_key(namespace, name)
        if existing is None:
            cr = {
                "apiVersion": "core.kubeadmiral.io/v1alpha1",
                "kind": "PropagatedVersion" if namespace else "ClusterPropagatedVersion",
                "metadata": {"name": version_name(self.kind, name)},
                "status": status,
            }
            if namespace:
                cr["metadata"]["namespace"] = namespace
            if batch is not None:

                def on_create(result: dict) -> None:
                    code = result.get("code")
                    if code == 201:
                        with self._lock:
                            self._cache[key] = result["object"]
                    elif code == 409:
                        # AlreadyExists: the cache was stale; re-load and
                        # settle through the update path.
                        self._retry_direct(namespace, name, status)
                    else:
                        # Transport trouble: recording is an optimization
                        # — drop the cache like the update path does;
                        # retrying N keys synchronously under the lock
                        # against a failing host would stall the tick.
                        with self._lock:
                            self._cache.pop(key, None)

                batch.stage(
                    {"verb": "create", "resource": self.resource, "object": cr},
                    on_create,
                )
                return
            try:
                self._cache[key] = self.host.create(self.resource, cr)
            except AlreadyExists:
                # Cache was stale (e.g. evicted after an earlier error):
                # re-load and write through the update path.
                current = self.host.try_get(self.resource, key)
                if current is not None:
                    self._cache[key] = current
                    self._write(namespace, name, status, current)
            return
        cr = dict(existing)
        cr["status"] = status
        if batch is not None:

            def on_update(result: dict) -> None:
                if result.get("code") == 200:
                    with self._lock:
                        self._cache[key] = result["object"]
                else:
                    with self._lock:
                        self._cache.pop(key, None)

            batch.stage(
                {"verb": "update_status", "resource": self.resource, "object": cr},
                on_update,
            )
            return
        try:
            # Status subresource: plain updates ignore .status.
            self._cache[key] = self.host.update_status(self.resource, cr)
        except (Conflict, NotFound):
            # Version recording is an optimization (manager.go callers
            # tolerate failure); drop the cache so the next get reloads.
            self._cache.pop(key, None)

    def _retry_direct(self, namespace: str, name: str, status: dict) -> None:
        """Batched create lost a race: settle through the direct path."""
        key = self._cr_key(namespace, name)
        with self._lock:
            self._cache.pop(key, None)
            current = self.host.try_get(self.resource, key)
            if current is not None:
                self._cache[key] = current
            self._write(namespace, name, status, current)
