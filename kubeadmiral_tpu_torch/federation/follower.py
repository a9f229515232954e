"""The follower controller: leader workloads drag their dependencies.

A copy of ``kubeadmiral_tpu/federation/follower.py`` for the port's
control plane.

Leader federated workloads (Deployment/StatefulSet/DaemonSet/Job/CronJob/
Pod) reference follower resources (ConfigMap/Secret/PVC/ServiceAccount/
Service/Ingress) through their pod templates and the followers
annotation.  This controller maintains a bidirectional in-memory cache of
(leader ↔ follower) edges, writes each follower's ``spec.follows`` list,
and sets the follower's placement to the union of its leaders' placements
so dependencies land wherever the workloads do (reference:
pkg/controllers/follower/controller.go:40-552, util.go:46-150).
"""

from __future__ import annotations

import functools
import threading
from typing import Iterable, Optional

from kubeadmiral_tpu_torch.federation import common as C
from kubeadmiral_tpu_torch.models.ftc import FederatedTypeConfig
from kubeadmiral_tpu_torch.runtime import pending
from kubeadmiral_tpu_torch.runtime.metrics import Metrics
from kubeadmiral_tpu_torch.runtime.worker import Result, Worker
from kubeadmiral_tpu_torch.testing.fakekube import Conflict, FakeKube, NotFound, obj_key
from kubeadmiral_tpu_torch.utils.unstructured import get_path

ENABLE_FOLLOWER_SCHEDULING = C.PREFIX + "enable-follower-scheduling"
FOLLOWERS_ANNOTATION = C.PREFIX + "followers"

# Leader source kind -> dotted path of the pod template inside the
# *template* of the federated object (follower/controller.go:71-80).
LEADER_POD_TEMPLATE_PATHS = {
    "apps/Deployment": "spec.template",
    "apps/StatefulSet": "spec.template",
    "apps/DaemonSet": "spec.template",
    "batch/Job": "spec.template",
    "batch/CronJob": "spec.jobTemplate.spec.template",
    "/Pod": "",  # the template itself is the pod
}

SUPPORTED_FOLLOWER_KINDS = frozenset(
    {
        "/ConfigMap",
        "/Secret",
        "/PersistentVolumeClaim",
        "/ServiceAccount",
        "/Service",
        "networking.k8s.io/Ingress",
    }
)


def group_kind(ftc: FederatedTypeConfig) -> str:
    return f"{ftc.source.group}/{ftc.source.kind}"


# A follower/leader reference is (group_kind, namespace, name).
Ref = tuple[str, str, str]


def visit_pod_secret_names(pod_spec: dict) -> set[str]:
    """Secrets a pod references (lifted podutil.VisitPodSecretNames
    semantics: volumes, projected sources, env/envFrom, imagePullSecrets)."""
    names: set[str] = set()
    for s in pod_spec.get("imagePullSecrets", []) or []:
        if s.get("name"):
            names.add(s["name"])
    for vol in pod_spec.get("volumes", []) or []:
        secret = vol.get("secret")
        if secret and secret.get("secretName"):
            names.add(secret["secretName"])
        for src in (vol.get("projected", {}) or {}).get("sources", []) or []:
            if src.get("secret", {}).get("name"):
                names.add(src["secret"]["name"])
    for container in _all_containers(pod_spec):
        for ef in container.get("envFrom", []) or []:
            if ef.get("secretRef", {}).get("name"):
                names.add(ef["secretRef"]["name"])
        for env in container.get("env", []) or []:
            ref = (env.get("valueFrom", {}) or {}).get("secretKeyRef", {})
            if ref.get("name"):
                names.add(ref["name"])
    return names


def visit_pod_configmap_names(pod_spec: dict) -> set[str]:
    names: set[str] = set()
    for vol in pod_spec.get("volumes", []) or []:
        cm = vol.get("configMap")
        if cm and cm.get("name"):
            names.add(cm["name"])
        for src in (vol.get("projected", {}) or {}).get("sources", []) or []:
            if src.get("configMap", {}).get("name"):
                names.add(src["configMap"]["name"])
    for container in _all_containers(pod_spec):
        for ef in container.get("envFrom", []) or []:
            if ef.get("configMapRef", {}).get("name"):
                names.add(ef["configMapRef"]["name"])
        for env in container.get("env", []) or []:
            ref = (env.get("valueFrom", {}) or {}).get("configMapKeyRef", {})
            if ref.get("name"):
                names.add(ref["name"])
    return names


def _all_containers(pod_spec: dict) -> Iterable[dict]:
    for field in ("containers", "initContainers", "ephemeralContainers"):
        yield from pod_spec.get(field, []) or []


def followers_from_pod_spec(pod_spec: dict, namespace: str) -> set[Ref]:
    """(follower/util.go:98-150 getFollowersFromPod)."""
    refs: set[Ref] = set()
    for name in visit_pod_secret_names(pod_spec):
        refs.add(("/Secret", namespace, name))
    for name in visit_pod_configmap_names(pod_spec):
        refs.add(("/ConfigMap", namespace, name))
    for vol in pod_spec.get("volumes", []) or []:
        pvc = vol.get("persistentVolumeClaim")
        if pvc and pvc.get("claimName"):
            refs.add(("/PersistentVolumeClaim", namespace, pvc["claimName"]))
    sa = pod_spec.get("serviceAccountName")
    if sa:
        refs.add(("/ServiceAccount", namespace, sa))
    return refs


class _BidirectionalCache:
    """leader ↔ follower edge cache (follower/bidirectional_cache.go)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._forward: dict[Ref, set[Ref]] = {}
        self._reverse: dict[Ref, set[Ref]] = {}

    def update(self, key: Ref, values: set[Ref]) -> None:
        with self._lock:
            old = self._forward.get(key, set())
            for gone in old - values:
                peers = self._reverse.get(gone)
                if peers is not None:
                    peers.discard(key)
                    if not peers:
                        del self._reverse[gone]
            for new in values - old:
                self._reverse.setdefault(new, set()).add(key)
            if values:
                self._forward[key] = set(values)
            else:
                self._forward.pop(key, None)

    def reverse_lookup(self, value: Ref) -> set[Ref]:
        with self._lock:
            return set(self._reverse.get(value, set()))


class FollowerController:
    """Always-on controller spanning all leader + follower FTCs."""

    name = C.FOLLOWER_CONTROLLER

    def __init__(
        self,
        host: FakeKube,
        ftcs: list[FederatedTypeConfig],
        metrics: Optional[Metrics] = None,
        clock=None,
    ):
        self.host = host
        self.metrics = metrics or Metrics()
        self.leader_ftcs: dict[str, FederatedTypeConfig] = {}
        self.follower_ftcs: dict[str, FederatedTypeConfig] = {}
        for ftc in ftcs:
            gk = group_kind(ftc)
            if gk in LEADER_POD_TEMPLATE_PATHS:
                self.leader_ftcs[gk] = ftc
            if gk in SUPPORTED_FOLLOWER_KINDS:
                self.follower_ftcs[gk] = ftc

        # Edges: leaders declare followers; followers record spec.follows.
        self.observed_from_leaders = _BidirectionalCache()
        self.observed_from_followers = _BidirectionalCache()

        self.worker = Worker(
            "follower-controller", self.reconcile, metrics=self.metrics, clock=clock
        )
        # Partials of a bound method, not lambdas: owner-based unwatch
        # (dynamic FTC lifecycle) identifies handlers by their owner.
        for gk, ftc in self.leader_ftcs.items():
            host.watch(
                ftc.federated.resource,
                functools.partial(self._on_object_event, "leader", gk),
                replay=True,
            )
        for gk, ftc in self.follower_ftcs.items():
            host.watch(
                ftc.federated.resource,
                functools.partial(self._on_object_event, "follower", gk),
                replay=True,
            )

    def _on_object_event(self, role: str, gk: str, event: str, obj: dict) -> None:
        self.worker.enqueue(f"{role}|{gk}|{obj_key(obj)}")

    def run_until_idle(self) -> None:
        while self.worker.step():
            pass

    def reconcile(self, key: str) -> Result:
        role, gk, okey = key.split("|", 2)
        if role == "leader":
            return self._reconcile_leader(gk, okey)
        return self._reconcile_follower(gk, okey)

    # -- leaders (controller.go:257-352) ---------------------------------
    def _reconcile_leader(self, gk: str, key: str) -> Result:
        self.metrics.counter("follower.throughput")
        ftc = self.leader_ftcs[gk]
        ns, _, name = key.rpartition("/")
        leader: Ref = (gk, ns, name)
        fed_obj = self.host.try_get(ftc.federated.resource, key)

        desired: set[Ref] = set()
        if fed_obj is not None and not fed_obj["metadata"].get("deletionTimestamp"):
            try:
                if not pending.dependencies_fulfilled(fed_obj, self.name):
                    return Result.ok()
            except KeyError:
                return Result.ok()
            desired = self._infer_followers(gk, fed_obj)

        self.observed_from_leaders.update(leader, desired)
        current = self.observed_from_followers.reverse_lookup(leader)

        for follower in desired | current:
            fgk = follower[0]
            if fgk in self.follower_ftcs:
                fkey = f"{follower[1]}/{follower[2]}" if follower[1] else follower[2]
                self.worker.enqueue(f"follower|{fgk}|{fkey}")

        if fed_obj is not None:
            if pending.update_pending(
                fed_obj, self.name, False, ftc.controller_groups
            ):
                try:
                    self.host.update(ftc.federated.resource, fed_obj)
                except Conflict:
                    return Result.retry()
                except NotFound:
                    pass
        return Result.ok()

    def _infer_followers(self, gk: str, fed_obj: dict) -> set[Ref]:
        """(controller.go:354-378 + util.go getFollowersFromAnnotation)."""
        ann = fed_obj["metadata"].get("annotations", {}) or {}
        if ann.get(ENABLE_FOLLOWER_SCHEDULING) != "true":
            return set()
        ns = fed_obj["metadata"].get("namespace", "")
        refs: set[Ref] = set()

        raw = ann.get(FOLLOWERS_ANNOTATION)
        if raw:
            import json

            try:
                for el in json.loads(raw):
                    fgk = f"{el.get('group', '')}/{el['kind']}"
                    # Followers only from the leader's own namespace.
                    refs.add((fgk, ns, el["name"]))
            except (ValueError, KeyError):
                pass

        template = C.template(fed_obj)
        path = LEADER_POD_TEMPLATE_PATHS[gk]
        pod = get_path(template, path) if path else template
        pod_spec = (pod or {}).get("spec") or {}
        refs |= followers_from_pod_spec(pod_spec, ns)
        return {r for r in refs if r[0] in SUPPORTED_FOLLOWER_KINDS}

    # -- followers (controller.go:426-502) -------------------------------
    def _reconcile_follower(self, gk: str, key: str) -> Result:
        self.metrics.counter("follower.throughput")
        ftc = self.follower_ftcs[gk]
        ns, _, name = key.rpartition("/")
        follower: Ref = (gk, ns, name)
        fed_obj = self.host.try_get(ftc.federated.resource, key)

        if fed_obj is None:
            self.observed_from_followers.update(follower, set())
            return Result.ok()

        current_leaders = {
            (f"{f.get('group', '')}/{f.get('kind', '')}", ns, f.get("name", ""))
            for f in fed_obj.get("spec", {}).get("follows", []) or []
        }
        self.observed_from_followers.update(follower, current_leaders)
        desired_leaders = self.observed_from_leaders.reverse_lookup(follower)

        changed = desired_leaders != current_leaders
        if changed:
            fed_obj["spec"]["follows"] = [
                {"group": g.split("/", 1)[0], "kind": g.split("/", 1)[1], "name": n}
                for g, _, n in sorted(desired_leaders)
            ]

        clusters = self._leader_placement_union(desired_leaders)
        placement_changed = C.set_placement(fed_obj, self.name, clusters)

        if changed or placement_changed:
            try:
                self.host.update(ftc.federated.resource, fed_obj)
            except Conflict:
                return Result.retry()
            except NotFound:
                pass
        return Result.ok()

    def _leader_placement_union(self, leaders: set[Ref]) -> set[str]:
        """(controller.go:532-552)."""
        clusters: set[str] = set()
        for gk, ns, name in leaders:
            ftc = self.leader_ftcs.get(gk)
            if ftc is None:
                continue
            key = f"{ns}/{name}" if ns else name
            leader_obj = self.host.try_get(ftc.federated.resource, key)
            if leader_obj is None:
                continue
            clusters |= C.all_placement_clusters(leader_obj)
        return clusters
