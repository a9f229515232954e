"""Informer: cached LIST+WATCH over one resource of one apiserver.

A copy of ``kubeadmiral_tpu/runtime/informer.py`` for the port's
control plane.

The thin analogue of the reference's shared informers and
FederatedInformer (reference: pkg/controllers/util/federatedinformer.go):
a local object cache kept in sync by watch events, with handler fan-out
and a federated variant that multiplexes per-cluster stores
(FederatedReadOnlyStore semantics: GetFromAllClusters / ClustersSynced).
"""

from __future__ import annotations

import threading
from typing import Callable, Iterable, Optional

from kubeadmiral_tpu_torch.runtime import slo, trace
from kubeadmiral_tpu_torch.testing.fakekube import ADDED, DELETED, FakeKube, obj_key

Handler = Callable[[str, dict], None]


class Informer:
    """Cache entries are SHARED dicts (the same snapshot the store hands
    every watcher): handlers and ``get()``/``list()`` consumers must not
    mutate them — copy anything you modify or retain, exactly as with
    real informer caches."""

    def __init__(self, kube: FakeKube, resource: str):
        self.kube = kube
        self.resource = resource
        self._lock = threading.RLock()
        self._cache: dict[str, dict] = {}
        self._handlers: list[Handler] = []
        kube.watch(resource, self._on_event, replay=True)

    def close(self) -> None:
        """Detach from the apiserver; no further events are delivered."""
        self.kube.unwatch(self.resource, self._on_event)
        with self._lock:
            self._handlers.clear()
            self._cache.clear()

    def _on_event(self, event: str, obj: dict) -> None:
        key = obj_key(obj)
        with self._lock:
            if event == DELETED:
                self._cache.pop(key, None)
            else:
                self._cache[key] = obj
            handlers = list(self._handlers)
        # SLO provenance fallback ingress: stores whose own watch
        # fan-out already mints tokens (FakeKube, HttpKube) mark
        # themselves _slo_ingress; anything else gets its birth
        # timestamp here, once per event, before handler fan-out.
        if not getattr(self.kube, "_slo_ingress", False):
            slo.ingest(self.kube, self.resource, event, obj)
        # The root span of the reconcile path: handler work (enqueues,
        # trigger checks) nests under the event that caused it.  Sampled
        # (trace.SAMPLE_N): a 300k-event storm must not pay a span
        # record per event.
        with trace.hot_span(
            "informer.event", resource=self.resource, event=event, key=key
        ):
            for h in handlers:
                h(event, obj)

    def add_handler(self, handler: Handler, replay: bool = True) -> None:
        with self._lock:
            self._handlers.append(handler)
            snapshot = list(self._cache.values()) if replay else ()
        for obj in snapshot:
            handler(ADDED, obj)

    def get(self, key: str) -> Optional[dict]:
        with self._lock:
            return self._cache.get(key)

    def list(self) -> list[dict]:
        with self._lock:
            return list(self._cache.values())

    def keys(self) -> list[str]:
        with self._lock:
            return list(self._cache)


class MemberStore:
    """Per-cluster member-object caches fed by replayed member watches —
    the FederatedReadOnlyStore the status controllers read instead of
    issuing one member GET per (object x cluster) per reconcile
    (reference: pkg/controllers/util/federatedinformer.go:121-132; the
    status controller builds clusterStatus from cached informers,
    status/controller.go:291-450).

    Entries are store views (in-process fleets) or fresh watch-frame
    parses (HTTP): consumers must treat them as read-only and copy
    anything they retain and mutate.
    """

    def __init__(self, fleet, resource: str, on_event=None):
        self.fleet = fleet
        self.resource = resource
        self._lock = threading.Lock()
        self._objs: dict[str, dict[str, dict]] = {}  # cluster -> key -> obj
        # Set BEFORE the watch attaches: replayed initial-LIST events
        # arrive synchronously from inside watch_members.
        self._on_event = on_event
        self._attach = fleet.watch_members(
            resource, self._handle, named=True, replay=True
        )

    def _handle(self, cluster: str, event: str, obj: dict) -> None:
        key = obj_key(obj)
        with self._lock:
            if event == DELETED:
                held = self._objs.get(cluster)
                if held is not None:
                    held.pop(key, None)
            else:
                self._objs.setdefault(cluster, {})[key] = obj
        cb = self._on_event
        if cb is not None:
            cb(cluster, event, obj)

    def reattach(self) -> None:
        """Attach watches for clusters that joined after construction."""
        self._attach()

    def evict(self, cluster: str) -> None:
        """Drop a removed cluster's watch and cached objects (the
        FederatedInformer remove-cluster lifecycle): without this, the
        store would keep serving a deleted cluster's last-known objects
        as live.  Sticky: reattach() skips the cluster until
        readmit(cluster) lifts the eviction (a re-created cluster's
        lifecycle event does that)."""
        detach = getattr(self._attach, "detach", None)
        if detach is not None:
            detach(cluster)
        with self._lock:
            self._objs.pop(cluster, None)

    def readmit(self, cluster: str) -> None:
        """Lift an eviction after the cluster's object re-appeared."""
        readmit = getattr(self._attach, "readmit", None)
        if readmit is not None:
            readmit(cluster)

    @property
    def pending(self) -> set:
        """Clusters whose watch attach failed transiently (HTTP fleets:
        join secret not yet readable) — the retry channel."""
        return set(getattr(self._attach, "pending", None) or ())

    def attached(self, cluster: str) -> bool:
        att = getattr(self._attach, "attached", None)
        if att is not None:
            return cluster in att
        try:  # fleets predating the attached-set contract
            self.fleet.member(cluster)
            return True
        except Exception:
            return False

    def get(self, cluster: str, key: str) -> Optional[dict]:
        with self._lock:
            held = self._objs.get(cluster)
            return None if held is None else held.get(key)


class FederatedInformer:
    """Per-ready-cluster informers for one target resource."""

    def __init__(self, resource: str):
        self.resource = resource
        self._lock = threading.RLock()
        self._informers: dict[str, Informer] = {}
        self._handlers: list[Callable[[str, str, dict], None]] = []  # (cluster, event, obj)

    def add_cluster(self, name: str, kube: FakeKube) -> None:
        with self._lock:
            if name in self._informers:
                return
            informer = Informer(kube, self.resource)
            self._informers[name] = informer
            informer.add_handler(
                lambda event, obj, _n=name: self._fanout(_n, event, obj),
                replay=True,
            )

    def remove_cluster(self, name: str) -> None:
        with self._lock:
            informer = self._informers.pop(name, None)
        if informer is not None:
            informer.close()

    def _fanout(self, cluster: str, event: str, obj: dict) -> None:
        with self._lock:
            handlers = list(self._handlers)
        for h in handlers:
            h(cluster, event, obj)

    def add_handler(self, handler: Callable[[str, str, dict], None]) -> None:
        with self._lock:
            self._handlers.append(handler)

    def clusters(self) -> list[str]:
        with self._lock:
            return list(self._informers)

    def get(self, cluster: str, key: str) -> Optional[dict]:
        with self._lock:
            informer = self._informers.get(cluster)
        return informer.get(key) if informer else None

    def get_from_all(self, key: str) -> dict[str, dict]:
        out = {}
        with self._lock:
            items = list(self._informers.items())
        for name, informer in items:
            obj = informer.get(key)
            if obj is not None:
                out[name] = obj
        return out
