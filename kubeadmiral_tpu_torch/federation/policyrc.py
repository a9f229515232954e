"""PolicyRC: reference counts of policy usage, persisted to status.

A copy of ``kubeadmiral_tpu/federation/policyrc.py`` for the port's
control plane.

Per-FTC controller (reference: pkg/controllers/policyrc/controller.go,
counter.go) that tracks how many federated objects bind each
Propagation/ClusterPropagation/Override/ClusterOverride policy and
persists the counts into the policy's ``status.refCount`` (sum over all
resource types) and ``status.typedRefCount[]`` (one entry per target
group/resource).

Two stages, as in the reference: a count worker reconciles federated
objects into in-memory Counters (diffing each object's previous policy
set against the new one), and per-policy persist workers flush dirty
counts to the policy status subresource.
"""

from __future__ import annotations

import threading
from typing import Callable, Optional

from kubeadmiral_tpu_torch.models import policy as P
from kubeadmiral_tpu_torch.models.ftc import FederatedTypeConfig
from kubeadmiral_tpu_torch.federation.overridectl import (
    CLUSTER_OVERRIDE_POLICY_NAME_LABEL,
    OVERRIDE_POLICY_NAME_LABEL,
)
from kubeadmiral_tpu_torch.runtime.metrics import Metrics
from kubeadmiral_tpu_torch.runtime.worker import Result, Worker
from kubeadmiral_tpu_torch.testing.fakekube import Conflict, FakeKube, NotFound, obj_key

# (namespace, name); namespace "" = cluster-scoped policy.
PolicyKey = tuple[str, str]


class Counter:
    """Reference counter with per-object policy-set diffing
    (counter.go:32-92)."""

    def __init__(self, flag_dirty: Callable[[list[PolicyKey]], None]):
        self._lock = threading.Lock()
        self._known: dict[str, tuple[PolicyKey, ...]] = {}  # object -> policies
        self._counts: dict[PolicyKey, int] = {}
        self._flag_dirty = flag_dirty

    def update(self, object_key: str, policies: tuple[PolicyKey, ...]) -> None:
        dirty: list[PolicyKey] = []
        with self._lock:
            previous = self._known.get(object_key, ())
            if policies == previous:
                return  # no count changes -> nothing to flag dirty
            if policies:
                self._known[object_key] = policies
            else:
                self._known.pop(object_key, None)
            for key in previous:
                self._counts[key] -= 1
                assert self._counts[key] >= 0, f"negative refcount for {key}"
                dirty.append(key)
            for key in policies:
                self._counts[key] = self._counts.get(key, 0) + 1
            dirty.extend(policies)
        # Flag outside the lock to reduce contention (counter.go:36-39).
        self._flag_dirty(dirty)

    def count(self, key: PolicyKey) -> int:
        with self._lock:
            return self._counts.get(key, 0)


def _persist_key(key: PolicyKey) -> str:
    ns, name = key
    return f"{ns}/{name}" if ns else name


class PolicyRCController:
    name = "policyrc-controller"

    def __init__(
        self,
        host: FakeKube,
        ftc: FederatedTypeConfig,
        metrics: Optional[Metrics] = None,
    ):
        self.host = host
        self.ftc = ftc
        self.metrics = metrics or Metrics()
        self._resource = ftc.federated.resource

        self.count_worker = Worker(
            f"policyrc-count-{ftc.name}", self._reconcile_count, metrics=self.metrics
        )
        self.pp_persist_worker = Worker(
            f"policyrc-persist-pp-{ftc.name}",
            self._reconcile_persist_pp,
            metrics=self.metrics,
        )
        self.op_persist_worker = Worker(
            f"policyrc-persist-op-{ftc.name}",
            self._reconcile_persist_op,
            metrics=self.metrics,
        )
        self.pp_counter = Counter(
            lambda keys: self.pp_persist_worker.enqueue_all(
                _persist_key(k) for k in keys
            )
        )
        self.op_counter = Counter(
            lambda keys: self.op_persist_worker.enqueue_all(
                _persist_key(k) for k in keys
            )
        )

        host.watch(self._resource, self._on_object_event, replay=True)
        # A policy created after its referrers must still get its counts
        # (controller.go: persist reconcile waits for creation, and the
        # create event triggers another reconcile).
        for resource in (
            P.PROPAGATION_POLICIES,
            P.CLUSTER_PROPAGATION_POLICIES,
        ):
            host.watch(resource, self._on_pp_event, replay=False)
        for resource in (P.OVERRIDE_POLICIES, P.CLUSTER_OVERRIDE_POLICIES):
            host.watch(resource, self._on_op_event, replay=False)

    @property
    def worker(self):
        """Primary worker handle for generic drivers (settle loops)."""
        return self.count_worker

    def step_all(self) -> bool:
        progressed = self.count_worker.step()
        progressed |= self.pp_persist_worker.step()
        progressed |= self.op_persist_worker.step()
        return progressed

    # -- events ----------------------------------------------------------
    def _on_object_event(self, event: str, obj: dict) -> None:
        self.count_worker.enqueue(obj_key(obj))

    def _on_pp_event(self, event: str, obj: dict) -> None:
        self.pp_persist_worker.enqueue(obj_key(obj))

    def _on_op_event(self, event: str, obj: dict) -> None:
        self.op_persist_worker.enqueue(obj_key(obj))

    # -- count stage (controller.go reconcileCount) ----------------------
    def _reconcile_count(self, key: str) -> Result:
        fed_obj = self.host.try_get(self._resource, key)

        pps: tuple[PolicyKey, ...] = ()
        ops: tuple[PolicyKey, ...] = ()
        if fed_obj is not None:
            matched = P.matched_policy_key(fed_obj)
            if matched is not None:
                pps = (matched,)
            labels = fed_obj["metadata"].get("labels", {})
            ns = fed_obj["metadata"].get("namespace", "")
            op_list: list[PolicyKey] = []
            # The namespaced label only binds namespaced objects (the same
            # guard overridectl and matched_policy_key apply); without it a
            # cluster-scoped object's label would masquerade as a
            # ClusterOverridePolicy reference.
            if OVERRIDE_POLICY_NAME_LABEL in labels and ns:
                op_list.append((ns, labels[OVERRIDE_POLICY_NAME_LABEL]))
            if CLUSTER_OVERRIDE_POLICY_NAME_LABEL in labels:
                op_list.append(("", labels[CLUSTER_OVERRIDE_POLICY_NAME_LABEL]))
            ops = tuple(op_list)
        # A deleted object still clears its cached counts.
        self.pp_counter.update(key, pps)
        self.op_counter.update(key, ops)
        return Result.ok()

    # -- persist stage (controller.go reconcilePersist) ------------------
    def _persist(self, resources: tuple[str, str], counter: Counter, key: str) -> Result:
        ns_resource, cluster_resource = resources
        ns, _, name = key.rpartition("/")
        resource = ns_resource if ns else cluster_resource
        policy = self.host.try_get(resource, key)
        if policy is None:
            # Wait for creation; the create event re-enqueues.
            return Result.ok()

        status = policy.setdefault("status", {})
        typed = status.setdefault("typedRefCount", [])
        group = self.ftc.source.group
        plural = self.ftc.source.plural
        entry = next(
            (t for t in typed if t.get("group", "") == group and t.get("resource") == plural),
            None,
        )
        if entry is None:
            entry = {"group": group, "resource": plural, "count": 0}
            typed.append(entry)

        changed = False
        new_count = counter.count((ns, name))
        if entry.get("count", 0) != new_count:
            entry["count"] = new_count
            changed = True
        total = sum(t.get("count", 0) for t in typed)
        if status.get("refCount", 0) != total:
            status["refCount"] = total
            changed = True
        if not changed:
            return Result.ok()
        try:
            self.host.update_status(resource, policy)
        except Conflict:
            return Result.retry()
        except NotFound:
            pass  # deleted underneath us; nothing left to persist
        return Result.ok()

    def _reconcile_persist_pp(self, key: str) -> Result:
        return self._persist(
            (P.PROPAGATION_POLICIES, P.CLUSTER_PROPAGATION_POLICIES),
            self.pp_counter,
            key,
        )

    def _reconcile_persist_op(self, key: str) -> Result:
        return self._persist(
            (P.OVERRIDE_POLICIES, P.CLUSTER_OVERRIDE_POLICIES),
            self.op_counter,
            key,
        )
