"""Namespace auto-propagation: every namespace, every cluster.

A copy of ``kubeadmiral_tpu/federation/nsautoprop.py`` for the port's
control plane.

FederatedNamespaces are propagated to all member clusters without
requiring a policy (reference: pkg/controllers/nsautoprop/controller.go:
126-381).  The controller

* writes an all-cluster placement under its own controller name,
* marks the federated namespace to adopt pre-existing member namespaces
  (internal conflict-resolution annotation = adopt) and to orphan the
  adopted ones on deletion (internal orphan annotation = adopted),
* skips system namespaces ("kube-" prefix + the federation system
  namespace), names matched by the exclusion regexp, and namespaces
  annotated kubeadmiral.io/no-auto-propagation=true — still advancing
  the pending-controllers pipeline so downstream controllers run.

Running both this controller and the global scheduler on namespaces
makes them fight over placements, as the reference warns
(controller.go:66-72); the namespaces FTC pipeline therefore starts with
nsautoprop instead of the scheduler.
"""

from __future__ import annotations

import re
from typing import Optional

from kubeadmiral_tpu_torch.federation import common as C
from kubeadmiral_tpu_torch.models.ftc import FederatedTypeConfig
from kubeadmiral_tpu_torch.runtime import pending
from kubeadmiral_tpu_torch.runtime.metrics import Metrics
from kubeadmiral_tpu_torch.runtime.worker import Result, Worker
from kubeadmiral_tpu_torch.testing.fakekube import Conflict, FakeKube, NotFound, obj_key

FED_SYSTEM_NAMESPACE = "kube-admiral-system"


class NamespaceAutoPropagationController:
    name = C.PREFIX + "nsautoprop-controller"

    def __init__(
        self,
        host: FakeKube,
        ftc: FederatedTypeConfig,
        exclude_regexp: Optional[str] = None,
        fed_system_namespace: str = FED_SYSTEM_NAMESPACE,
        metrics: Optional[Metrics] = None,
    ):
        self.host = host
        self.ftc = ftc
        self.exclude = re.compile(exclude_regexp) if exclude_regexp else None
        self.fed_system_namespace = fed_system_namespace
        self.metrics = metrics or Metrics()
        self.worker = Worker("nsautoprop", self.reconcile, metrics=self.metrics)
        self._resource = ftc.federated.resource

        host.watch(self._resource, self._on_object_event, replay=True)
        self._cluster_sigs: dict[str, tuple] = {}
        host.watch(C.FEDERATED_CLUSTERS, self._on_cluster_event, replay=False)

    def _on_object_event(self, event: str, obj: dict) -> None:
        self.worker.enqueue(obj_key(obj))

    def _on_cluster_event(self, event: str, obj: dict) -> None:
        # Cluster membership changes re-place every namespace
        # (controller.go reconcileAll on cluster add/delete) — gated on
        # lifecycle transitions so heartbeats don't re-place the world.
        sig = C.cluster_lifecycle_sig(obj)
        name = obj["metadata"]["name"]
        if event == "DELETED":
            self._cluster_sigs.pop(name, None)
        elif self._cluster_sigs.get(name) == sig:
            return
        else:
            self._cluster_sigs[name] = sig
        self.worker.enqueue_all(self.host.keys(self._resource))

    def _should_propagate(self, fed_ns: dict) -> bool:
        """controller.go shouldBeAutoPropagated."""
        name = fed_ns["metadata"]["name"]
        if name.startswith("kube-"):
            return False
        if name == self.fed_system_namespace:
            return False
        if self.exclude is not None and self.exclude.search(name):
            return False
        ann = fed_ns["metadata"].get("annotations", {})
        return ann.get(C.NO_AUTO_PROPAGATION) != "true"

    def reconcile(self, key: str) -> Result:
        fed_ns = self.host.try_get(self._resource, key)
        if fed_ns is None or fed_ns["metadata"].get("deletionTimestamp"):
            return Result.ok()
        try:
            if not pending.dependencies_fulfilled(fed_ns, self.name):
                return Result.ok()
        except KeyError:
            return Result.ok()  # not yet initialized by federate

        modified = False
        if self._should_propagate(fed_ns):
            # All registered clusters, joined or not (controller.go:241-249
            # lists everything) — sync itself intersects with joined.
            names = {
                obj["metadata"]["name"]
                for obj in self.host.list(C.FEDERATED_CLUSTERS)
            }
            modified |= C.set_placement(fed_ns, self.name, names)
            ann = fed_ns["metadata"].setdefault("annotations", {})
            for key_, value in (
                (C.CONFLICT_RESOLUTION_INTERNAL, "adopt"),
                (C.ORPHAN_MODE_INTERNAL, "adopted"),
            ):
                if ann.get(key_) != value:
                    ann[key_] = value
                    modified = True
        pend = pending.update_pending(
            fed_ns, self.name, modified, self.ftc.controller_groups
        )
        if not (modified or pend):
            return Result.ok()
        try:
            self.host.update(self._resource, fed_ns)
        except Conflict:
            return Result.retry()
        except NotFound:
            pass
        return Result.ok()
