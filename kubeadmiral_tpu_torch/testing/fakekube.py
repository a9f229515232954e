"""In-memory apiserver with watch semantics — the test/bench cluster farm.

A copy of ``kubeadmiral_tpu/testing/fakekube.py`` for the port's control
plane.

Plays the role KWOK clusters play in the reference's e2e suite
(reference: test/e2e/framework/clusterprovider/kwokprovider.go): a cheap
stand-in for a real apiserver that preserves the semantics the control
plane depends on — optimistic concurrency via resourceVersion, finalizer-
gated deletion with deletionTimestamp, generation bumps on spec changes,
label-selector lists, and synchronous ADDED/MODIFIED/DELETED watch events.

Objects are unstructured dicts ({apiVersion, kind, metadata, spec, ...});
resources are addressed by a plural-ish resource key like
"apps/v1/deployments" (helpers in models.ftc derive these from type
configs).

Storage is **copy-on-write**: every write replaces the stored dict with
a fresh immutable *version node* (structural sharing with the previous
node — an update that only touches metadata shares the old node's spec
and status subtrees by reference), and the store NEVER mutates a node
after it is published.  That makes three things free that used to cost
a deep copy each:

* watch fan-out hands watchers the node itself instead of a per-event
  snapshot copy (handlers must not mutate delivered objects — now
  enforced by discipline AND by the fact that later writes never touch
  the dict they were handed);
* view reads (``try_get_view``/``list_view``/``scan``) are true
  immutable snapshots — retaining one is safe, mutating one is not;
* the bulk ``batch`` verb commits a whole chunk under ONE lock pass
  (columnar commit) and delivers watchers ONE coalesced notification
  per flush, with per-op results derived from the columnar outcome.

``FakeKube(coalesce=False)`` (``ClusterFleet(coalesce=False)`` for a
whole fleet; the JAX module's ``KT_STORE_COALESCE=0``) reverts ``batch``
to the per-op lock/apply/notify loop — the A/B baseline whose event
stream the coalesced path must reproduce bit-identically.  The port
reads no environment variable.
"""

from __future__ import annotations

import threading
from typing import Callable, Iterable, Optional

from kubeadmiral_tpu_torch.federation import common as C
from kubeadmiral_tpu_torch.runtime import lockcheck, slo as _slo
from kubeadmiral_tpu_torch.utils.unstructured import copy_json

ADDED = "ADDED"
MODIFIED = "MODIFIED"
DELETED = "DELETED"

Handler = Callable[[str, dict], None]


class Conflict(Exception):
    """resourceVersion mismatch on update (optimistic concurrency)."""


class NotFound(Exception):
    pass


class AlreadyExists(Exception):
    pass


def obj_key(obj: dict) -> str:
    meta = obj.get("metadata", {})
    ns = meta.get("namespace", "")
    return f"{ns}/{meta['name']}" if ns else meta["name"]


def split_key(key: str) -> tuple[str, str]:
    if "/" in key:
        ns, name = key.split("/", 1)
        return ns, name
    return "", key


def handler_owner(handler: Handler) -> Optional[object]:
    """The instance a handler is bound to (directly, or through a
    functools.partial of a bound method) — shared by every transport's
    unwatch_owner."""
    owner = getattr(handler, "__self__", None)
    if owner is not None:
        return owner
    return getattr(getattr(handler, "func", None), "__self__", None)


class _Watch:
    """One watch registration, with the handler's delivery capabilities
    resolved ONCE at registration instead of per event:

    * ``kt_predicate`` attribute — ``(event, obj) -> bool`` filter the
      store applies batch-wise before delivery;
    * ``kt_batch`` attribute — ``(events) -> None`` taking the ordered
      ``[(event, obj), ...]`` list of one committed flush, replacing N
      per-event calls with one coalesced notification."""

    __slots__ = ("handler", "predicate", "batch")

    def __init__(self, handler: Handler):
        self.handler = handler
        self.predicate = getattr(handler, "kt_predicate", None)
        self.batch = getattr(handler, "kt_batch", None)


class _NamedHandler:
    """functools.partial(handler, cluster) equivalent that can also
    advertise the batch-delivery protocol — ``handler_owner`` keeps
    working through ``func.__self__``."""

    __slots__ = ("func", "cluster", "kt_batch", "kt_predicate")

    def __init__(
        self,
        func: Callable,
        cluster: str,
        batch: Optional[Callable],
        predicate: Optional[Callable] = None,
    ):
        self.func = func
        self.cluster = cluster
        self.kt_predicate = predicate
        if batch is not None:
            self.kt_batch = lambda events: batch(cluster, events)
        else:
            self.kt_batch = None

    def __call__(self, event: str, obj: dict) -> None:
        self.func(self.cluster, event, obj)


class ShardIntake:
    """Watch-handler wrapper advertising the pre-delivery protocols a
    sharded (or flush-coalescing) controller intake needs — bound
    methods cannot carry ``kt_predicate``/``kt_batch`` attributes, so
    the wrapper does:

    * ``predicate`` — ``(event, obj) -> bool``, applied by the store
      batch-wise BEFORE delivery; a replica's shard filter here drops a
      non-owned event before it costs a handler call, a signature
      computation or an enqueue;
    * ``batch`` — ``(events) -> None`` coalesced-flush delivery (one
      call per committed flush instead of N per-event calls).

    ``handler_owner`` (and thus ``unwatch_owner``) keeps working
    through ``func.__self__``."""

    __slots__ = ("func", "kt_predicate", "kt_batch")

    def __init__(
        self,
        func: Callable,
        predicate: Optional[Callable] = None,
        batch: Optional[Callable] = None,
    ):
        self.func = func
        self.kt_predicate = predicate
        self.kt_batch = batch

    def __call__(self, event: str, obj: dict) -> None:
        self.func(event, obj)


_SCALARS = (str, int, float, bool, type(None))


@lockcheck.shared_field_guard
class FakeKube:
    """One apiserver (host or member cluster)."""

    # Tests flip this to simulate a failing /healthz probe.
    healthy: bool = True

    # In-process store: try_get_view point reads are lock-scoped dict
    # lookups, so O(placed) point reads beat one list scan.  Remote
    # clients (HttpKube) flip this off — there a LIST round trip beats
    # a GET per key.
    local_views = True

    # This store's watch fan-out mints SLO provenance tokens itself
    # (runtime/slo.py): informers layered on top must not double-mint.
    _slo_ingress = True

    # Producer threads (controllers, flush pools, HTTP handler threads)
    # all commit and fan out under the one store lock; _rv and the
    # container fields are only ever touched inside it (ktlint
    # lock-discipline is the static half, runtime/lockcheck.py the
    # dynamic half of the guard).
    _shared_fields_ = {
        "_objects": "_lock",
        "_watchers": "_lock",
        "_all_watchers": "_lock",
        "_rv": "_lock",
    }

    def __init__(self, name: str = "host", coalesce: bool = True):
        """``coalesce``: columnar batch commits + coalesced watch
        fan-out (default on); off reverts the bulk verb to one
        lock/apply/notify cycle per operation."""
        self.name = name
        self._lock = lockcheck.make_rlock("fakekube")
        self._objects: dict[str, dict[str, dict]] = {}  # resource -> key -> node
        self._watchers: dict[str, list[_Watch]] = {}
        self._all_watchers: list[tuple[Callable, Optional[Callable]]] = []
        self._rv = 0
        self._coalesce = bool(coalesce)

    # -- helpers ---------------------------------------------------------
    def _bump_locked(self) -> str:
        self._rv += 1
        return str(self._rv)

    def _store_locked(self, resource: str) -> dict[str, dict]:
        return self._objects.setdefault(resource, {})

    # -- notify ----------------------------------------------------------
    def _notify_locked(self, resource: str, event: str, node: dict) -> None:
        """Per-event fan-out (direct verbs + the ``coalesce=False``
        batch path): the delivered object is the immutable stored node —
        content-identical to the old per-event snapshot copy, minus the
        copy.  Handlers must not mutate delivered objects."""
        watches = list(self._watchers.get(resource, ())) + list(
            self._watchers.get("*", ())
        )
        if not watches and not self._all_watchers:
            return
        # SLO provenance: this is the single per-event point where a
        # watch event enters the in-process control plane — the birth
        # timestamp of the event→placement-written clock (runtime/slo.py;
        # untracked stores/resources early-out on one dict probe).
        _slo.ingest(self, resource, event, node)
        # One sig-memo scope per delivery: N watchers computing the
        # metadata-change trigger signature of this node hash it once.
        with C.sig_memo_scope():
            for w in watches:
                if w.predicate is not None and not w.predicate(event, node):
                    continue
                w.handler(event, node)
        for observer, _ in list(self._all_watchers):
            observer(resource, event, node, self._rv)

    def _deliver_flush_locked(self, flush: list) -> None:
        """Coalesced fan-out of one committed columnar flush
        (``[(resource, event, node, seq), ...]`` in commit order).

        Observers (the apiserver event-log feed) run FIRST over the
        whole flush in seq order: a nested write triggered mid-fan-out
        (SA token minting, a handler that writes) then appends strictly
        after this flush's lines, keeping per-resource log seqs sorted
        for watch-resume bisect.  Handlers then receive one coalesced
        notification each — the ordered per-resource event list, with
        predicates applied batch-wise and the metadata-change sig
        memoized once per object across every watcher."""
        if not flush:
            return
        observers = list(self._all_watchers)
        res_watch: dict[str, list[_Watch]] = {}
        consumers = bool(observers)
        for resource, _, _, _ in flush:
            if resource not in res_watch:
                ws = list(self._watchers.get(resource, ())) + list(
                    self._watchers.get("*", ())
                )
                res_watch[resource] = ws
                consumers = consumers or bool(ws)
        if not consumers:
            return
        # SLO token mint per event in stream order — the watch-ingress
        # stage decomposition is byte-for-byte the per-op path's.
        for resource, event, node, _ in flush:
            if res_watch[resource] or observers:
                _slo.ingest(self, resource, event, node)
        for observer, batch_all in observers:
            if batch_all is not None:
                batch_all(flush)
            else:
                for resource, event, node, seq in flush:
                    observer(resource, event, node, seq)
        with C.sig_memo_scope():
            per_res: dict[str, list] = {}
            for resource, event, node, _ in flush:
                per_res.setdefault(resource, []).append((event, node))
            for resource, events in per_res.items():
                for w in res_watch[resource]:
                    evs = events
                    if w.predicate is not None:
                        evs = [p for p in evs if w.predicate(p[0], p[1])]
                        if not evs:
                            continue
                    if w.batch is not None:
                        w.batch(evs)
                    else:
                        for event, node in evs:
                            w.handler(event, node)

    # -- copy-on-write appliers (all run under self._lock) ---------------
    def _create_locked(self, resource: str, obj: dict, adopt: bool) -> dict:
        meta_in = obj.get("metadata") or {}
        meta = copy_json(meta_in) if meta_in else {}
        name = meta["name"]
        ns = meta.get("namespace", "")
        key = f"{ns}/{name}" if ns else name
        store = self._store_locked(resource)
        if key in store:
            raise AlreadyExists(f"{resource} {key}")
        # Version-node construction: metadata is always a fresh copy
        # (the store stamps rv/uid/generation into it); other subtrees
        # are adopted by reference on the trusted bulk path (op objects
        # are fresh JSON parses over HTTP, staged-and-never-mutated
        # assemblies in process) and deep-copied for direct callers.
        node: dict = {}
        for k, v in obj.items():
            if k == "metadata":
                node[k] = meta
            else:
                node[k] = v if adopt or type(v) in _SCALARS else copy_json(v)
        if "metadata" not in node:
            node["metadata"] = meta
        meta["resourceVersion"] = self._bump_locked()
        # Like the real apiserver, only spec-bearing kinds carry a
        # generation; data-only kinds (ConfigMap, Secret) must fall
        # back to resourceVersion-based drift detection.
        if "spec" in node:
            meta.setdefault("generation", 1)
        meta.setdefault("uid", f"{self.name}-{resource}-{key}-{self._rv}")
        store[key] = node
        return node

    def _update_locked(
        self, resource: str, obj: dict, adopt: bool
    ) -> tuple[str, dict]:
        key = obj_key(obj)
        store = self._store_locked(resource)
        if key not in store:
            raise NotFound(f"{resource} {key} in {self.name}")
        old = store[key]
        old_meta = old["metadata"]
        meta_in = obj.get("metadata") or {}
        sent_rv = meta_in.get("resourceVersion")
        if sent_rv is not None and sent_rv != old_meta["resourceVersion"]:
            raise Conflict(
                f"{resource} {key}: {sent_rv} != {old_meta['resourceVersion']}"
            )
        meta = copy_json(meta_in) if meta_in else {}
        meta["uid"] = old_meta.get("uid")
        meta["resourceVersion"] = self._bump_locked()
        old_spec = old.get("spec")
        new_spec = obj.get("spec")
        spec_changed = new_spec != old_spec
        node: dict = {}
        for k, v in obj.items():
            if k == "metadata":
                node[k] = meta
            elif k == "status":
                # Status is a subresource: like a real apiserver, a
                # main-resource update ignores the request's .status and
                # keeps the stored one (only update_status writes it).
                # This is what lets sync push template updates without
                # clobbering member-owned status.
                if "status" in old:
                    node[k] = old["status"]
            elif k == "spec":
                # Structural sharing: an unchanged spec re-uses the old
                # node's subtree (the equality compare is needed for the
                # generation decision anyway), so metadata-only updates
                # cost one small metadata copy, not a whole-object one.
                if not spec_changed and "spec" in old:
                    node[k] = old_spec
                else:
                    node[k] = v if adopt or type(v) in _SCALARS else copy_json(v)
            else:
                node[k] = v if adopt or type(v) in _SCALARS else copy_json(v)
        if "metadata" not in node:
            node["metadata"] = meta
        if "status" in old and "status" not in node:
            node["status"] = old["status"]
        if "spec" in old or "spec" in obj:
            old_gen = old_meta.get("generation", 1)
            meta["generation"] = old_gen + 1 if spec_changed else old_gen
        else:
            meta.pop("generation", None)
        if old_meta.get("deletionTimestamp"):
            meta.setdefault("deletionTimestamp", old_meta["deletionTimestamp"])
            if not meta.get("finalizers"):
                del store[key]
                return DELETED, node
        store[key] = node
        return MODIFIED, node

    def _update_status_locked(
        self, resource: str, obj: dict, adopt: bool
    ) -> dict:
        key = obj_key(obj)
        store = self._store_locked(resource)
        if key not in store:
            raise NotFound(f"{resource} {key} in {self.name}")
        old = store[key]
        sent_rv = obj.get("metadata", {}).get("resourceVersion")
        if sent_rv is not None and sent_rv != old["metadata"]["resourceVersion"]:
            raise Conflict(
                f"{resource} {key}: {sent_rv} != {old['metadata']['resourceVersion']}"
            )
        # Only .status is applied: the node shares EVERY other subtree
        # with the old node (shallow copies re-point at immutable
        # children), so the hottest converged-control-plane write —
        # status feedback — costs two small dict copies.
        node = dict(old)
        node["metadata"] = dict(old["metadata"])
        node["metadata"]["resourceVersion"] = self._bump_locked()
        status_in = obj.get("status")
        node["status"] = (
            status_in
            if adopt or type(status_in) in _SCALARS
            else copy_json(status_in)
        )
        store[key] = node
        return node

    def _delete_locked(
        self, resource: str, key: str
    ) -> tuple[Optional[str], Optional[dict]]:
        store = self._store_locked(resource)
        if key not in store:
            raise NotFound(f"{resource} {key} in {self.name}")
        old = store[key]
        if old["metadata"].get("finalizers"):
            if not old["metadata"].get("deletionTimestamp"):
                # Replace, don't mutate in place: published nodes are
                # immutable (view readers and watchers hold them).
                node = dict(old)
                node["metadata"] = dict(old["metadata"])
                node["metadata"]["deletionTimestamp"] = "now"
                node["metadata"]["resourceVersion"] = self._bump_locked()
                store[key] = node
                return MODIFIED, node
            return None, None
        del store[key]
        # Like etcd, deletion advances the revision: the DELETED
        # event must carry a resourceVersion newer than any previous
        # event or watch-resume cursors would skip it.
        node = dict(old)
        node["metadata"] = dict(old["metadata"])
        node["metadata"]["resourceVersion"] = self._bump_locked()
        return DELETED, node

    def _get_locked(self, resource: str, key: str) -> dict:
        store = self._store_locked(resource)
        if key not in store:
            raise NotFound(f"{resource} {key} in {self.name}")
        return copy_json(store[key])

    # -- CRUD ------------------------------------------------------------
    def create(self, resource: str, obj: dict, _copy_result: bool = True) -> dict:
        with self._lock:
            node = self._create_locked(resource, obj, adopt=False)
            self._notify_locked(resource, ADDED, node)
            return copy_json(node) if _copy_result else node

    def get(self, resource: str, key: str) -> dict:
        with self._lock:
            return self._get_locked(resource, key)

    def try_get(self, resource: str, key: str) -> Optional[dict]:
        try:
            return self.get(resource, key)
        except NotFound:
            return None

    def try_get_view(self, resource: str, key: str) -> Optional[dict]:
        """Read WITHOUT deep-copying.  The returned dict is an immutable
        version node: retaining it is safe (later writes REPLACE the
        node, never mutate it), mutating it is not."""
        with self._lock:
            return self._store_locked(resource).get(key)

    def update(self, resource: str, obj: dict, _copy_result: bool = True) -> dict:
        """Full-object update with optimistic concurrency; removing the
        last finalizer of a deleting object completes the deletion."""
        with self._lock:
            event, node = self._update_locked(resource, obj, adopt=False)
            self._notify_locked(resource, event, node)
            return copy_json(node) if _copy_result else node

    def update_status(
        self, resource: str, obj: dict, _copy_result: bool = True
    ) -> dict:
        """Status-subresource style update: only .status is applied.
        Optimistic concurrency applies as on the main resource — without
        it, two controllers read-modify-writing different parts of the
        same status would silently lose each other's updates."""
        with self._lock:
            node = self._update_status_locked(resource, obj, adopt=False)
            self._notify_locked(resource, MODIFIED, node)
            return copy_json(node) if _copy_result else node

    def batch(self, operations: list) -> list[dict]:
        """Interface parity with HttpKube.batch: apply many operations,
        return one {"code", "object"|"status"} entry per operation, order
        preserved, each operation succeeding or failing independently.

        With coalescing on (``coalesce``, the default) the chunk
        commits COLUMNAR: one lock pass applies every operation, then
        watchers get one coalesced notification for the whole flush.
        Write-verb result objects are store version nodes, not copies,
        and op objects are adopted into the store by reference where
        safe — callers must not mutate op objects after submission nor
        the results they retain (over HTTP both sides are fresh JSON
        parses; in process the staged-op contract already forbids it).
        ``get`` results remain copies (they flow to general read
        consumers)."""
        if not self._coalesce:
            return self._batch_per_op(operations)
        results: list[dict] = []
        flush: list = []
        with self._lock:
            for op in operations:
                verb = op.get("verb")
                resource = op.get("resource", "")
                try:
                    if verb == "create":
                        node = self._create_locked(resource, op["object"], adopt=True)
                        flush.append((resource, ADDED, node, self._rv))
                        results.append({"code": 201, "object": node})
                    elif verb == "update":
                        event, node = self._update_locked(
                            resource, op["object"], adopt=True
                        )
                        flush.append((resource, event, node, self._rv))
                        results.append({"code": 200, "object": node})
                    elif verb == "update_status":
                        node = self._update_status_locked(
                            resource, op["object"], adopt=True
                        )
                        flush.append((resource, MODIFIED, node, self._rv))
                        results.append({"code": 200, "object": node})
                    elif verb == "delete":
                        event, node = self._delete_locked(resource, op["key"])
                        if event is not None:
                            flush.append((resource, event, node, self._rv))
                        results.append({"code": 200, "status": {"status": "Success"}})
                    elif verb == "get":
                        results.append(
                            {"code": 200, "object": self._get_locked(resource, op["key"])}
                        )
                    else:
                        results.append({"code": 400, "status": {"reason": "BadRequest", "message": f"unknown verb {verb!r}"}})
                except AlreadyExists as e:
                    results.append({"code": 409, "status": {"reason": "AlreadyExists", "message": str(e)}})
                except Conflict as e:
                    results.append({"code": 409, "status": {"reason": "Conflict", "message": str(e)}})
                except NotFound as e:
                    results.append({"code": 404, "status": {"reason": "NotFound", "message": str(e)}})
                except Exception as e:
                    results.append({"code": 400, "status": {"reason": "BadRequest", "message": str(e)}})
            self._deliver_flush_locked(flush)
        return results

    def _batch_per_op(self, operations: list) -> list[dict]:
        """``coalesce=False``: the per-op lock/apply/notify loop — the
        A/B baseline the columnar path must match event-for-event."""
        results = []
        for op in operations:
            verb = op.get("verb")
            resource = op.get("resource", "")
            try:
                if verb == "create":
                    results.append({"code": 201, "object": self.create(resource, op["object"], _copy_result=False)})
                elif verb == "update":
                    results.append({"code": 200, "object": self.update(resource, op["object"], _copy_result=False)})
                elif verb == "update_status":
                    results.append({"code": 200, "object": self.update_status(resource, op["object"], _copy_result=False)})
                elif verb == "delete":
                    self.delete(resource, op["key"])
                    results.append({"code": 200, "status": {"status": "Success"}})
                elif verb == "get":
                    results.append({"code": 200, "object": self.get(resource, op["key"])})
                else:
                    results.append({"code": 400, "status": {"reason": "BadRequest", "message": f"unknown verb {verb!r}"}})
            except AlreadyExists as e:
                results.append({"code": 409, "status": {"reason": "AlreadyExists", "message": str(e)}})
            except Conflict as e:
                results.append({"code": 409, "status": {"reason": "Conflict", "message": str(e)}})
            except NotFound as e:
                results.append({"code": 404, "status": {"reason": "NotFound", "message": str(e)}})
            except Exception as e:
                results.append({"code": 400, "status": {"reason": "BadRequest", "message": str(e)}})
        return results

    def delete(self, resource: str, key: str) -> None:
        with self._lock:
            event, node = self._delete_locked(resource, key)
            if event is not None:
                self._notify_locked(resource, event, node)

    def list(
        self,
        resource: str,
        namespace: Optional[str] = None,
        label_selector: Optional[dict[str, str]] = None,
    ) -> list[dict]:
        with self._lock:
            return [
                copy_json(obj)
                for obj in self.list_view(resource, namespace, label_selector)
            ]

    def list_view(
        self,
        resource: str,
        namespace: Optional[str] = None,
        label_selector: Optional[dict[str, str]] = None,
    ) -> list[dict]:
        """Like :meth:`list` but WITHOUT deep-copying — the cheap path
        for hot read-only fan-outs (cluster sets, policy matching).
        The returned dicts are immutable version nodes: retain freely,
        never mutate (the same contract as :meth:`scan`)."""
        with self._lock:
            out = []
            for obj in self._store_locked(resource).values():
                if namespace is not None:
                    if obj["metadata"].get("namespace", "") != namespace:
                        continue
                if label_selector:
                    labels = obj["metadata"].get("labels", {})
                    if any(labels.get(k) != v for k, v in label_selector.items()):
                        continue
                out.append(obj)
            return out

    def list_with_rv(
        self,
        resource: str,
        namespace: Optional[str] = None,
        label_selector: Optional[dict[str, str]] = None,
    ) -> tuple[list[dict], int]:
        """Atomic (items, resourceVersion) snapshot — what a LIST
        response needs so a subsequent watch can resume without a gap."""
        with self._lock:
            return self.list(resource, namespace, label_selector), self._rv

    def keys(self, resource: str) -> list[str]:
        with self._lock:
            return list(self._store_locked(resource))

    def scan(self, resource: str, fn: Callable[[dict], None]) -> None:
        """Read-only visit of every object WITHOUT deep-copying — the
        cheap path for large fan-out scans (e.g. policy -> bound objects).
        ``fn`` must not mutate the dicts it is handed."""
        with self._lock:
            for obj in self._store_locked(resource).values():
                fn(obj)

    # -- persistence ------------------------------------------------------
    def dump(self) -> dict:
        """JSON-serializable snapshot of the whole store (etcd's role in
        the reference: all control-plane state lives in the apiserver, so
        a controller restart resumes from LIST+WATCH alone)."""
        with self._lock:
            return {
                "name": self.name,
                "rv": self._rv,
                "objects": copy_json(self._objects),
            }

    @classmethod
    def restore(cls, snapshot: dict) -> "FakeKube":
        kube = cls(snapshot.get("name", "host"))
        with kube._lock:
            kube._rv = int(snapshot["rv"])
            kube._objects = copy_json(snapshot["objects"])
        return kube

    # -- watch -----------------------------------------------------------
    def watch(self, resource: str, handler: Handler, replay: bool = True) -> None:
        """Register a handler; with replay, existing objects are delivered
        as ADDED first (LIST+WATCH).  Handlers may advertise the batch
        protocol via a ``kt_batch`` attribute (one call per committed
        flush with the ordered event list) and a pre-delivery filter via
        ``kt_predicate`` — both resolved here, once."""
        w = _Watch(handler)
        with self._lock:
            self._watchers.setdefault(resource, []).append(w)
            if replay:
                nodes = list(self._store_locked(resource).values())
                if w.predicate is not None:
                    nodes = [n for n in nodes if w.predicate(ADDED, n)]
                if w.batch is not None:
                    if nodes:
                        w.batch([(ADDED, n) for n in nodes])
                else:
                    for node in nodes:
                        handler(ADDED, node)

    def watch_all(
        self,
        observer: Callable[[str, str, dict, int], None],
        batch: Optional[Callable[[list], None]] = None,
    ) -> None:
        """Register a cross-resource observer, called under the store
        lock as ``observer(resource, event, obj, seq)`` where ``seq`` is
        the event's resourceVersion.  ``batch``, when given, replaces
        the per-event calls for a coalesced flush with ONE
        ``batch([(resource, event, obj, seq), ...])`` call.  This is the
        apiserver's event-log feed; observers must be fast and must not
        mutate ``obj``."""
        with self._lock:
            self._all_watchers.append((observer, batch))

    def current_rv(self) -> int:
        with self._lock:
            return self._rv

    def unwatch(self, resource: str, handler: Handler) -> None:
        with self._lock:
            watches = self._watchers.get(resource, [])
            for i, w in enumerate(watches):
                if w.handler == handler:
                    del watches[i]
                    break

    def unwatch_owner(self, owner: object) -> None:
        """Remove every handler owned by ``owner`` — how a dynamically
        stopped controller detaches all its watches without having
        tracked each registration."""
        with self._lock:
            for watches in self._watchers.values():
                watches[:] = [
                    w for w in watches if handler_owner(w.handler) is not owner
                ]


class ClusterFleet:
    """Host + member apiservers — the FederatedClientFactory analogue
    (reference: pkg/controllers/util/federatedclient/client.go)."""

    def __init__(self, coalesce: bool = True):
        self.coalesce = bool(coalesce)
        self.host = FakeKube("host", coalesce=self.coalesce)
        self.members: dict[str, FakeKube] = {}

    def add_member(self, name: str) -> FakeKube:
        kube = FakeKube(name, coalesce=self.coalesce)
        self.members[name] = kube
        return kube

    def member(self, name: str) -> FakeKube:
        if name not in self.members:
            raise NotFound(f"cluster {name}")
        return self.members[name]

    def unwatch_owner(self, owner: object) -> None:
        """Detach a controller's handlers from the host and every member."""
        self.host.unwatch_owner(owner)
        for member in self.members.values():
            member.unwatch_owner(owner)

    def dump(self) -> dict:
        return {
            "host": self.host.dump(),
            "members": {n: m.dump() for n, m in self.members.items()},
        }

    @classmethod
    def restore(cls, snapshot: dict) -> "ClusterFleet":
        fleet = cls()
        fleet.host = FakeKube.restore(snapshot["host"])
        for name, member_snap in snapshot["members"].items():
            fleet.members[name] = FakeKube.restore(member_snap)
        return fleet

    def watch_members(
        self, resource: str, handler: Handler, named: bool = False,
        replay: bool = False, batch: Optional[Callable] = None,
        predicate: Optional[Callable] = None,
    ) -> Callable[[], None]:
        """Watch ``resource`` in every current member and return a
        re-attach callable for members added later — the
        FederatedInformer lifecycle (federatedinformer.go:151-250).
        With ``named``, the handler receives ``(cluster, event, obj)``;
        with ``replay``, existing objects stream through as ADDED (the
        informer's initial LIST); ``batch`` (named fleets only) is the
        coalesced-delivery variant ``(cluster, events)`` a store flushes
        one committed chunk through instead of per-event calls;
        ``predicate`` (named fleets only) is a pre-delivery
        ``(event, obj) -> bool`` filter the member store applies before
        either delivery path — a shard replica drops non-owned member
        events here, before they cost a handler call."""
        attached: set[str] = set()
        detached: set[str] = set()
        wrapped: dict[str, Handler] = {}

        def attach() -> None:
            for name, kube in list(self.members.items()):
                if name not in attached and name not in detached:
                    attached.add(name)
                    h = (
                        _NamedHandler(handler, name, batch, predicate)
                        if named
                        else handler
                    )
                    wrapped[name] = h
                    kube.watch(resource, h, replay=replay)

        def detach(name: str) -> None:
            """Tear down one cluster's watch (the FederatedInformer
            remove-cluster lifecycle, federatedinformer.go:151-250).
            Sticky: attach() skips the cluster until readmit(name) —
            the fleet keeps removed members' kube handles, so a plain
            re-attach would silently resurrect the watch."""
            attached.discard(name)
            detached.add(name)
            h = wrapped.pop(name, None)
            kube = self.members.get(name)
            if h is not None and kube is not None:
                kube.unwatch(resource, h)

        def readmit(name: str) -> None:
            """Lift a detach (the cluster's object re-appeared)."""
            detached.discard(name)

        attach.attached = attached
        attach.detach = detach
        attach.readmit = readmit
        attach()
        return attach
