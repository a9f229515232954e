"""Per-cluster pod informers with memory discipline.

A copy of ``kubeadmiral_tpu/runtime/podinformer.py`` for the port's
control plane.

The reference's FederatedClientFactory optionally maintains a pod
informer per member with two safeguards for 50k-pod clusters
(reference: pkg/controllers/util/federatedclient/podinformer.go:33-137,
flags --max-pod-listers / --enable-pod-pruning,
cmd/controller-manager/app/options/options.go):

* **pruning** — cached pods are stripped to exactly the fields the
  consumers read (auto-migration's unschedulable counting, the cluster
  controller's resource aggregation); everything else (env, volumes,
  probes — the bulk of a pod object) is dropped before it enters
  controller memory.
* **lister semaphore** — cold LISTs against member apiservers are
  bounded to ``max_pod_listers`` concurrent calls, so a restart with
  thousands of clusters doesn't stampede them.

After the cold LIST, per-member watches keep each cache incremental.
"""

from __future__ import annotations

import logging
import threading
from typing import Callable, Optional

from kubeadmiral_tpu_torch.testing.fakekube import DELETED, NotFound, obj_key

log = logging.getLogger("kubeadmiral.podinformer")

PODS = "v1/pods"

# spec fields the consumers read: node binding + resource requests.
_SPEC_KEYS = ("nodeName", "unschedulable", "overhead")


def prune_pod(pod: dict) -> dict:
    """podinformer.go's transform: keep scheduling-relevant fields only."""
    meta = pod.get("metadata", {})
    spec = pod.get("spec", {}) or {}
    status = pod.get("status", {}) or {}
    pruned_spec: dict = {k: spec[k] for k in _SPEC_KEYS if k in spec}
    for field in ("containers", "initContainers"):
        if field in spec:
            pruned_spec[field] = [
                {"resources": {"requests": dict(
                    (c.get("resources") or {}).get("requests") or {}
                )}}
                for c in spec[field] or []
            ]
    return {
        "metadata": {
            k: meta[k]
            for k in ("name", "namespace", "labels", "deletionTimestamp",
                      "resourceVersion")
            if k in meta
        },
        "spec": pruned_spec,
        "status": {
            k: status[k] for k in ("phase", "conditions") if k in status
        },
    }


class _WatchState:
    """One cluster's watch registration.  ``cache`` is staged privately
    during the cold LIST replay and only published into the informer's
    ``_caches`` once ``member.watch()`` returns — readers must never see
    a half-replayed snapshot (pods_for's None contract)."""

    __slots__ = ("member", "handler", "cache")

    def __init__(self, member):
        self.member = member
        self.handler: Optional[Callable] = None
        self.cache: dict[str, dict] = {}


class PodInformer:
    """Pruned per-cluster pod caches over a fleet."""

    def __init__(
        self,
        fleet,
        max_pod_listers: int = 4,
        enable_pruning: bool = True,
    ):
        self.fleet = fleet
        self.enable_pruning = enable_pruning
        self.max_pod_listers = max(1, max_pod_listers)
        self._lock = threading.Lock()
        # A cluster key EXISTS in _caches only once its cold LIST+WATCH
        # replay completed; consumers treat a missing key as "informer
        # not ready" (pods_for returns None) and fall back to a direct
        # member scan rather than trusting an empty snapshot.
        self._caches: dict[str, dict[str, dict]] = {}
        # cluster name -> _WatchState: a rejoined cluster gets a NEW
        # client/store, detected by identity, and is re-listed from
        # scratch; the old handler is unwatched so its stream stops.
        self._watched: dict[str, _WatchState] = {}

    def _transform(self, pod: dict) -> dict:
        return prune_pod(pod) if self.enable_pruning else pod

    # -- lifecycle --------------------------------------------------------
    def attach(self) -> None:
        """Start watching pods in every currently known member; call
        again on cluster lifecycle events (the FederatedInformer
        re-attach pattern).  Removed clusters are evicted; re-added
        ones (a new member object) are re-listed.  Cold LIST+WATCHes
        fan out across at most ``max_pod_listers`` threads — the
        --max-pod-listers stampede bound."""
        current = dict(getattr(self.fleet, "members", {}))
        # Resolve member clients OUTSIDE the lock: HttpFleet.member() can
        # block on a host apiserver round trip, and this lock is shared
        # with every pod-event handler across all clusters.  A member
        # that fails to resolve is simply retried on the next attach.
        members: dict[str, object] = {}
        for name in current:
            try:
                members[name] = self.fleet.member(name)
            except NotFound:
                continue
            except Exception:
                log.warning("resolving member client for %s failed", name, exc_info=True)
        to_watch: list[tuple[str, object]] = []
        to_unwatch: list[_WatchState] = []
        with self._lock:
            for name in list(self._watched):
                if name not in current:
                    to_unwatch.append(self._watched.pop(name))
                    self._caches.pop(name, None)
            for name, member in members.items():
                watched = self._watched.get(name)
                if watched is not None and watched.member is member:
                    continue  # already watching this exact client
                if watched is not None:
                    to_unwatch.append(watched)  # rejoin: stop the old stream
                # Drop (don't empty) the snapshot: a missing key means
                # "not ready", so readers fall back until the replay done.
                self._caches.pop(name, None)
                self._watched.pop(name, None)
                to_watch.append((name, member))
        for old in to_unwatch:
            try:
                old.member.unwatch(PODS, old.handler)
            except Exception:
                pass  # a dead transport can't deliver events anyway

        if not to_watch:
            return

        def start_watch(item):
            name, member = item
            state = _WatchState(member)

            def handler(event: str, pod: dict, _state=state, _cluster=name) -> None:
                with self._lock:
                    if self._watched.get(_cluster) is not _state:
                        return  # superseded by a rejoin
                    key = obj_key(pod)
                    if event == DELETED:
                        _state.cache.pop(key, None)
                    else:
                        _state.cache[key] = self._transform(pod)

            state.handler = handler
            with self._lock:
                self._watched[name] = state
            # The replay IS the cold LIST (LIST+WATCH); both transports
            # complete the replay before watch() returns.  Replay events
            # accumulate in state.cache (staged, invisible to readers)
            # and publish atomically below.  A down member must not
            # abort attach or the caller's event-dispatch context: drop
            # the registration and retry on the next attach.
            try:
                member.watch(PODS, handler, replay=True)
            except Exception:
                log.warning("pod watch for %s failed; will retry", name, exc_info=True)
                with self._lock:
                    if self._watched.get(name) is state:
                        del self._watched[name]
                try:
                    member.unwatch(PODS, handler)
                except Exception:
                    pass
                return
            with self._lock:
                if self._watched.get(name) is state:
                    self._caches[name] = state.cache  # ready (maybe podless)

        # The pool only reads: each thread replays one member's pods into
        # that cluster's own staged cache, and no store is written, so
        # the order the threads finish in changes no store and no
        # cache's contents.
        if len(to_watch) == 1:
            start_watch(to_watch[0])
        else:
            from concurrent.futures import ThreadPoolExecutor

            with ThreadPoolExecutor(
                max_workers=self.max_pod_listers,
                thread_name_prefix="pod-lister",
            ) as pool:
                list(pool.map(start_watch, to_watch))

    # -- reads ------------------------------------------------------------
    def pods_for(
        self,
        cluster: str,
        namespace: Optional[str] = None,
        selector: Optional[dict[str, str]] = None,
    ) -> Optional[list[dict]]:
        """None = informer not (yet) watching this cluster — the caller
        must fall back to a direct member scan, NOT treat it as 'no
        pods' (a wrong empty answer would clear auto-migration's
        estimatedCapacity)."""
        with self._lock:
            cache = self._caches.get(cluster)
            if cache is None:
                return None
            out = []
            for pod in cache.values():
                meta = pod.get("metadata", {})
                if namespace is not None and meta.get("namespace", "") != namespace:
                    continue
                if selector:
                    labels = meta.get("labels") or {}
                    if any(labels.get(k) != v for k, v in selector.items()):
                        continue
                out.append(pod)
            return out

    def cache_size(self, cluster: str) -> int:
        with self._lock:
            return len(self._caches.get(cluster, {}))
