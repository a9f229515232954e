"""The FederatedCluster controller: join handshake + status heartbeat.

A copy of ``kubeadmiral_tpu/federation/clusterctl.py`` for the port's control
plane.

Lifecycle of a member cluster (reference:
pkg/controllers/federatedcluster/controller.go, clusterjoin.go,
clusterstatus.go, util.go):

* join — create the federation system namespace in the member (annotated
  with the FederatedCluster UID so a cluster already owned by another
  control plane is detected as unjoinable), an authorized service
  account + token secret, and save the token into the host-side cluster
  secret; then flip the Joined condition.
* heartbeat — per-cluster periodic status collection: a /healthz-style
  reachability probe drives Offline/Ready conditions; when ready, node +
  pod listings aggregate into allocatable/available resource totals and
  a discovery pass records the cluster's API resource types.
* removal — on deletion, joined clusters get their member-side system
  namespace cleaned up once every per-FTC sync finalizer has let go.
"""

from __future__ import annotations

import time
from typing import Optional

from kubeadmiral_tpu_torch.federation import common as C
from kubeadmiral_tpu_torch.runtime.metrics import Metrics
from kubeadmiral_tpu_torch.runtime.worker import Result, Worker
from kubeadmiral_tpu_torch.transport import breaker as B
from kubeadmiral_tpu_torch.testing.fakekube import (
    AlreadyExists,
    ClusterFleet,
    Conflict,
    FakeKube,
    NotFound,
)
from kubeadmiral_tpu_torch.utils.quantity import cpu_to_millis, to_int_value

FEDERATED_CLUSTERS = C.FEDERATED_CLUSTERS
FED_SYSTEM_NAMESPACE = "kube-admiral-system"

# Member-side namespace annotation marking ownership
# (clusterjoin.go FederatedClusterUID).
CLUSTER_UID_ANNOTATION = C.PREFIX + "federated-cluster-uid"

# Condition types (types_federatedcluster.go).
JOINED = "Joined"
READY = "Ready"
OFFLINE = "Offline"

# Condition reasons (clusterjoin.go / clusterstatus.go).
JOIN_SUCCEEDED = "JoinSucceeded"
TOKEN_NOT_OBTAINED = "TokenNotObtained"
CLUSTER_UNJOINABLE = "ClusterUnjoinable"
JOIN_TIMEOUT_EXCEEDED = "JoinTimeoutExceeded"
CLUSTER_READY = "ClusterReady"
CLUSTER_NOT_REACHABLE = "ClusterNotReachable"
CLUSTER_HEALTHZ_NOT_OK = "HealthzNotOk"
RESOURCE_COLLECTION_FAILED = "ClusterResourceCollectionFailed"
# The member answers healthz but its write/read path tripped the
# per-member circuit breaker (transport/breaker.py): the scheduler's
# filter stage must see it unhealthy the same tick the breaker opens.
MEMBER_BREAKER_OPEN = "MemberBreakerOpen"

# Annotation on the FederatedCluster recording that join steps ran and
# member-side cleanup is owed on removal (controller.go joinPerformed).
JOIN_PERFORMED = C.PREFIX + "join-performed"

NODES = "v1/nodes"
PODS = "v1/pods"
NAMESPACES = "v1/namespaces"
SERVICE_ACCOUNTS = "v1/serviceaccounts"
SECRETS = "v1/secrets"


def get_condition(cluster: dict, ctype: str) -> Optional[dict]:
    for cond in cluster.get("status", {}).get("conditions", []):
        if cond.get("type") == ctype:
            return cond
    return None


def set_condition(cluster: dict, ctype: str, status: str, reason: str = "") -> bool:
    """Idempotent condition write; returns True when it changed."""
    conds = cluster.setdefault("status", {}).setdefault("conditions", [])
    for cond in conds:
        if cond.get("type") == ctype:
            if cond.get("status") == status and cond.get("reason") == reason:
                return False
            cond["status"] = status
            cond["reason"] = reason
            return True
    conds.append({"type": ctype, "status": status, "reason": reason})
    return True


def is_node_schedulable(node: dict) -> bool:
    """(util.go:114-131 isNodeSchedulable)."""
    spec = node.get("spec", {})
    if spec.get("unschedulable"):
        return False
    for taint in spec.get("taints", []) or []:
        if taint.get("effect") in ("NoSchedule", "NoExecute"):
            return False
    for cond in node.get("status", {}).get("conditions", []) or []:
        if cond.get("type") == "Ready" and cond.get("status") != "True":
            return False
    return True


def _parse_req(raw: dict) -> dict[str, int]:
    out = {}
    for name, q in (raw or {}).items():
        out[name] = cpu_to_millis(q) if name == "cpu" else to_int_value(q)
    return out


def pod_resource_requests(pod: dict) -> dict[str, int]:
    """max(sum(containers), initContainers...) + overhead
    (util.go:155-175 getPodResourceRequests)."""
    reqs: dict[str, int] = {}
    spec = pod.get("spec", {})
    for container in spec.get("containers", []) or []:
        for name, v in _parse_req(
            container.get("resources", {}).get("requests", {})
        ).items():
            reqs[name] = reqs.get(name, 0) + v
    for container in spec.get("initContainers", []) or []:
        for name, v in _parse_req(
            container.get("resources", {}).get("requests", {})
        ).items():
            if v > reqs.get(name, 0):
                reqs[name] = v
    for name, v in _parse_req(spec.get("overhead", {})).items():
        reqs[name] = reqs.get(name, 0) + v
    return reqs


def aggregate_resources(
    nodes: list[dict], pods: list[dict]
) -> tuple[dict[str, int], dict[str, int], int]:
    """(allocatable, available, schedulable_node_count) in canonical ints
    (cpu milli-units) — util.go:177-213 aggregateResources."""
    allocatable: dict[str, int] = {}
    schedulable = 0
    for node in nodes:
        if not is_node_schedulable(node):
            continue
        schedulable += 1
        for name, v in _parse_req(node.get("status", {}).get("allocatable", {})).items():
            if name == "pods":
                continue
            allocatable[name] = allocatable.get(name, 0) + v

    available = dict(allocatable)
    for pod in pods:
        if pod.get("status", {}).get("phase") in ("Succeeded", "Failed"):
            continue
        for name, v in pod_resource_requests(pod).items():
            if name in available:
                available[name] -= v
    return allocatable, available, schedulable


def format_resources(res: dict[str, int]) -> dict[str, str]:
    """Canonical ints back to quantity strings (cpu millis -> 'Nm')."""
    out = {}
    for name, v in res.items():
        out[name] = f"{v}m" if name == "cpu" else str(v)
    return out


class FederatedClusterController:
    """Always-on controller owning FederatedCluster lifecycle."""

    name = "cluster-controller"

    def __init__(
        self,
        fleet: ClusterFleet,
        metrics: Optional[Metrics] = None,
        resync_seconds: float = 10.0,
        join_timeout: float = 600.0,
        clock=None,
        api_resource_probe: Optional[list[str]] = None,
    ):
        self.fleet = fleet
        self.host = fleet.host
        self.metrics = metrics or Metrics()
        self.resync_seconds = resync_seconds
        self.join_timeout = join_timeout
        # GVK strings advertised when the member serves the resource; in a
        # real deployment this comes from discovery documents.
        self.api_resource_probe = api_resource_probe
        self._clock = clock or time.monotonic
        # member client id -> (probe time, advertised GVKs); see
        # _discover_api_types.
        self._api_discovery_cache: dict[int, tuple[float, list[str]]] = {}
        self._discovery_ttl = max(resync_seconds * 6, 60.0)
        # First join-failure time per cluster, for the join timeout
        # (clusterjoin.go:99-115 checks the Joined condition's
        # lastTransitionTime; conditions here don't carry timestamps, so
        # the controller tracks it in memory — state is lost on restart,
        # which only extends the timeout window).
        self._join_failed_at: dict[str, float] = {}
        # Per-member circuit breakers shared across this fleet's
        # controllers: the heartbeat's healthz probe doubles as the
        # breaker's half-open probe, and breaker transitions re-enqueue
        # the cluster so its Ready condition flips the SAME tick the
        # dispatch path discovers a sick member.
        self.breakers = B.for_fleet(fleet, metrics=self.metrics)
        self.worker = Worker(
            "cluster-controller", self.reconcile, metrics=self.metrics, clock=clock
        )
        self.breakers.on_transition(self._on_breaker_transition)
        self.host.watch(FEDERATED_CLUSTERS, self._on_event, replay=True)

    def _on_event(self, event: str, obj: dict) -> None:
        self.worker.enqueue(obj["metadata"]["name"])

    def _on_breaker_transition(self, name: str, old: str, new: str) -> None:
        self.worker.enqueue(name)

    def run_until_idle(self) -> None:
        while self.worker.step():
            pass

    def _member(self, name: str) -> Optional[FakeKube]:
        try:
            return self.fleet.member(name)
        except NotFound:
            return None

    # -- reconcile (controller.go:183-351) -------------------------------
    def reconcile(self, key: str) -> Result:
        self.metrics.counter("cluster-controller.throughput")
        cluster = self.host.try_get(FEDERATED_CLUSTERS, key)
        if cluster is None:
            return Result.ok()

        if cluster["metadata"].get("deletionTimestamp"):
            return self._handle_terminating(cluster)

        if C.CLUSTER_FINALIZER not in cluster["metadata"].get("finalizers", []):
            cluster["metadata"].setdefault("finalizers", []).append(
                C.CLUSTER_FINALIZER
            )
            try:
                cluster = self.host.update(FEDERATED_CLUSTERS, cluster)
            except (Conflict, NotFound):
                return Result.retry()

        joined = get_condition(cluster, JOINED)
        if joined is None or joined.get("status") != "True":
            if joined is not None and joined.get("reason") in (
                CLUSTER_UNJOINABLE,
                JOIN_TIMEOUT_EXCEEDED,
            ):
                return Result.ok()  # terminal state (controller.go:226-232)
            name = cluster["metadata"]["name"]
            started = self._join_failed_at.get(name)
            if started is not None and self._clock() - started > self.join_timeout:
                # Join timed out: terminal failure (clusterjoin.go:99-115).
                self._join_failed_at.pop(name, None)
                return self._set_joined(
                    cluster, "False", JOIN_TIMEOUT_EXCEEDED, retry=False
                )
            try:
                result = self._join(cluster)
            except Exception:
                # A member dropping mid-handshake (partition, injected
                # fault) is a retryable join failure, not a controller
                # panic.
                self.breakers.for_member(name).record_failure()
                result = self._set_joined(
                    cluster, "False", TOKEN_NOT_OBTAINED, retry=True
                )
            if not result.success:
                self._join_failed_at.setdefault(name, self._clock())
                return result
            self._join_failed_at.pop(name, None)

        return self._collect_status(cluster["metadata"]["name"])

    # -- join handshake (clusterjoin.go:83-580) --------------------------
    def _join(self, cluster: dict) -> Result:
        name = cluster["metadata"]["name"]
        uid = cluster["metadata"].get("uid", "")
        member = self._member(name)
        if member is None:
            return self._set_joined(
                cluster, "False", TOKEN_NOT_OBTAINED, retry=True
            )

        # System namespace: create or verify ownership.
        ns = member.try_get(NAMESPACES, FED_SYSTEM_NAMESPACE)
        if ns is None:
            try:
                member.create(
                    NAMESPACES,
                    {
                        "apiVersion": "v1",
                        "kind": "Namespace",
                        "metadata": {
                            "name": FED_SYSTEM_NAMESPACE,
                            "annotations": {CLUSTER_UID_ANNOTATION: uid},
                        },
                    },
                )
            except AlreadyExists:
                pass
        elif ns["metadata"].get("annotations", {}).get(CLUSTER_UID_ANNOTATION) != uid:
            # Owned by another control plane: terminal unjoinable state.
            return self._set_joined(cluster, "False", CLUSTER_UNJOINABLE, retry=False)

        # Authorized service account + token, saved into the host secret
        # (clusterjoin.go:241-580 getAndSaveClusterToken).
        sa_name = f"kubeadmiral-{name}"
        if member.try_get(SERVICE_ACCOUNTS, f"{FED_SYSTEM_NAMESPACE}/{sa_name}") is None:
            try:
                member.create(
                    SERVICE_ACCOUNTS,
                    {
                        "apiVersion": "v1",
                        "kind": "ServiceAccount",
                        "metadata": {
                            "name": sa_name,
                            "namespace": FED_SYSTEM_NAMESPACE,
                        },
                    },
                )
            except AlreadyExists:
                pass
        # Real members (kwok-lite HTTP apiservers) mint a token secret
        # for the new service account — prefer it, as the reference does
        # (clusterjoin.go:449-529 waits for the SA token secret).  Bare
        # FakeKube members have no token controller; fall back to a
        # deterministic synthetic token.
        sa_token_secret = member.try_get(
            SECRETS, f"{FED_SYSTEM_NAMESPACE}/{sa_name}-token"
        )
        token = (sa_token_secret or {}).get("data", {}).get(
            "token"
        ) or f"token-{name}-{uid}"
        secret_name = cluster.get("spec", {}).get("secretRef", {}).get(
            "name"
        ) or f"{name}-secret"
        host_key = f"{FED_SYSTEM_NAMESPACE}/{secret_name}"
        secret = self.host.try_get(SECRETS, host_key)
        if secret is None:
            try:
                self.host.create(
                    SECRETS,
                    {
                        "apiVersion": "v1",
                        "kind": "Secret",
                        "metadata": {
                            "name": secret_name,
                            "namespace": FED_SYSTEM_NAMESPACE,
                        },
                        "data": {"token": token, "service-account": sa_name},
                    },
                )
            except AlreadyExists:
                pass
        else:
            if secret.get("data", {}).get("token") != token:
                secret.setdefault("data", {})["token"] = token
                try:
                    self.host.update(SECRETS, secret)
                except (Conflict, NotFound):
                    return Result.retry()

        cluster["metadata"].setdefault("annotations", {})[JOIN_PERFORMED] = "true"
        try:
            cluster = self.host.update(FEDERATED_CLUSTERS, cluster)
        except (Conflict, NotFound):
            return Result.retry()
        return self._set_joined(cluster, "True", JOIN_SUCCEEDED, retry=False)

    def _set_joined(
        self, cluster: dict, status: str, reason: str, retry: bool
    ) -> Result:
        if set_condition(cluster, JOINED, status, reason):
            try:
                self.host.update_status(FEDERATED_CLUSTERS, cluster)
            except (Conflict, NotFound):
                return Result.retry()
        if status == "True":
            return Result.ok()
        return Result.retry() if retry else Result.ok()

    # -- status heartbeat (clusterstatus.go:64-278) ----------------------
    def _collect_status(self, name: str) -> Result:
        cluster = self.host.try_get(FEDERATED_CLUSTERS, name)
        if cluster is None:
            return Result.ok()
        member = self._member(name)

        if member is None:
            # Unreachable: Offline=True, Ready=Unknown.
            changed = set_condition(cluster, OFFLINE, "True", CLUSTER_NOT_REACHABLE)
            changed |= set_condition(cluster, READY, "Unknown", CLUSTER_NOT_REACHABLE)
        else:
            # The healthz probe is also the breaker's out-of-band probe:
            # its latency feeds member_probe_latency, its success closes
            # a cooled-down breaker (the half-open contract), its
            # failure is breaker evidence like any other round trip.
            breaker = self.breakers.for_member(name)
            if not breaker.allow(consume_probe=False):
                # Open window still cooling: a probe CANNOT close the
                # breaker yet (record_success(probe=True) honors the
                # cool-down), so don't park the heartbeat worker on a
                # dead socket for nothing — once the window elapses,
                # allow() flips half-open and the next heartbeat probes
                # for real.
                changed = set_condition(cluster, OFFLINE, "False", "")
                changed |= set_condition(
                    cluster, READY, "False", MEMBER_BREAKER_OPEN
                )
                if changed:
                    try:
                        self.host.update_status(FEDERATED_CLUSTERS, cluster)
                    except Conflict:
                        return Result.retry()
                    except NotFound:
                        return Result.ok()
                return Result.after(
                    min(self.resync_seconds, self.breakers.config.open_seconds)
                )
            start = time.perf_counter()
            try:
                healthy = bool(member.healthy)
            except Exception:
                healthy = False
            latency = time.perf_counter() - start
            self.metrics.histogram("member_probe_latency", latency, cluster=name)
            if healthy:
                breaker.record_success(latency, probe=True)
            else:
                breaker.record_failure(latency_s=latency)
            if not healthy:
                changed = set_condition(cluster, OFFLINE, "False", "")
                changed |= set_condition(
                    cluster, READY, "False", CLUSTER_HEALTHZ_NOT_OK
                )
            elif not breaker.allow(consume_probe=False):
                # healthz answers but the read/write path tripped the
                # breaker (erroring or stalling member): not schedulable
                # until the breaker closes.
                changed = set_condition(cluster, OFFLINE, "False", "")
                changed |= set_condition(
                    cluster, READY, "False", MEMBER_BREAKER_OPEN
                )
            else:
                changed = set_condition(cluster, OFFLINE, "False", "")
                try:
                    resources_changed = self._update_resources(cluster, member)
                except Exception:
                    # healthz passed but the listings failed (member
                    # dropped between probes): collection failure, not a
                    # worker panic (clusterstatus.go:204-278).
                    breaker.record_failure()
                    changed |= set_condition(
                        cluster, READY, "False", RESOURCE_COLLECTION_FAILED
                    )
                else:
                    changed |= set_condition(cluster, READY, "True", CLUSTER_READY)
                    changed |= resources_changed

        if changed:
            try:
                self.host.update_status(FEDERATED_CLUSTERS, cluster)
            except Conflict:
                return Result.retry()
            except NotFound:
                return Result.ok()
        return Result.after(self.resync_seconds)

    def _update_resources(self, cluster: dict, member: FakeKube) -> bool:
        # View reads: aggregation only sums parsed quantities.
        nodes = member.list_view(NODES)
        pods = member.list_view(PODS)
        allocatable, available, schedulable = aggregate_resources(nodes, pods)
        status = cluster.setdefault("status", {})
        desired = {
            "schedulableNodes": schedulable,
            "allocatable": format_resources(allocatable),
            "available": format_resources(available),
        }
        changed = False
        if status.get("resources") != desired:
            status["resources"] = desired
            changed = True
        api_types = self.api_resource_probe
        if api_types is None:
            # Discovery fallback (the reference reads the member's
            # discovery documents, clusterstatus.go:204-268): probe the
            # member with a LIST per FTC-registered source type; a type
            # it serves is advertised in apiResourceTypes, which gates
            # scheduling per GVK (ops/filters APIResources).
            api_types = self._discover_api_types(member)
        if api_types is not None and status.get("apiResourceTypes") != api_types:
            status["apiResourceTypes"] = list(api_types)
            changed = True
        return changed

    def _discover_api_types(self, member: FakeKube) -> Optional[list[str]]:
        from kubeadmiral_tpu_torch.models.ftc import FEDERATED_TYPE_CONFIGS, parse_ftc
        from kubeadmiral_tpu_torch.testing.fakekube import NotFound

        # A fresh probe round trips once per FTC type; cache per member
        # client with a TTL so steady-state heartbeats don't re-probe
        # (the reference reads cheap discovery documents; our transport
        # has no discovery endpoint, so LIST-probing stands in).
        now = self._clock()
        cached = self._api_discovery_cache.get(id(member))
        if cached is not None and now - cached[0] < self._discovery_ttl:
            return cached[1]
        try:
            ftc_objs = self.host.list_view(FEDERATED_TYPE_CONFIGS)
        except AttributeError:
            ftc_objs = self.host.list(FEDERATED_TYPE_CONFIGS)
        except Exception:
            return None
        advertised = []
        for obj in ftc_objs:
            try:
                ftc = parse_ftc(obj)
            except Exception:
                continue  # malformed FTC: not a member problem
            try:
                probe = getattr(member, "keys", None) or (
                    member.list_view
                    if hasattr(member, "list_view")
                    else member.list
                )
                probe(ftc.source.resource)
            except NotFound:
                continue  # the member genuinely doesn't serve this type
            except Exception:
                # Transient member error: do NOT shrink the advertised
                # set (a dropped GVK would filter a healthy cluster out
                # of scheduling); keep whatever was last known.
                return cached[1] if cached is not None else None
            advertised.append(ftc.source.gvk)
        result = sorted(advertised)
        self._api_discovery_cache[id(member)] = (now, result)
        return result

    # -- removal (controller.go:353-445) ---------------------------------
    def _handle_terminating(self, cluster: dict) -> Result:
        name = cluster["metadata"]["name"]
        fins = cluster["metadata"].get("finalizers", [])
        if C.CLUSTER_FINALIZER not in fins:
            return Result.ok()

        # Per-FTC sync controllers hold their own finalizers until member
        # objects are cleaned up; wait for them to let go first.
        others = [f for f in fins if f != C.CLUSTER_FINALIZER]
        if others:
            return Result.after(1.0)

        joined = get_condition(cluster, JOINED)
        performed = (
            cluster["metadata"].get("annotations", {}).get(JOIN_PERFORMED) == "true"
        )
        if joined is not None and joined.get("status") == "True" and performed:
            member = self._member(name)
            if member is not None and member.healthy:
                # Deletion order keeps our own credential alive until the
                # last call: plain secrets first, then the namespace,
                # then ServiceAccounts LAST — deleting the SA revokes the
                # token this very client authenticates with (the member's
                # token controller also GCs the "<sa>-token" secret, so
                # nothing must come after).
                prefix = FED_SYSTEM_NAMESPACE + "/"

                def member_delete(res: str, key: str) -> bool:
                    """False = our credential is gone (expected once our
                    own SA is deleted); transient member errors RAISE so
                    the Worker retries with the finalizer still held —
                    cleanup must never silently half-finish."""
                    try:
                        member.delete(res, key)
                    except NotFound:
                        pass
                    except Exception as e:
                        msg = str(e)
                        if "401" in msg or "Unauthorized" in msg:
                            return False
                        raise
                    return True

                own_sa = prefix + f"kubeadmiral-{name}"
                # Our own SA goes LAST: deleting it revokes the very
                # token this client authenticates with.
                sa_keys = sorted(
                    (k for k in member.keys(SERVICE_ACCOUNTS) if k.startswith(prefix)),
                    key=lambda k: (k == own_sa, k),
                )
                token_names = {k.split("/", 1)[1] + "-token" for k in sa_keys}
                for key in member.keys(SECRETS):
                    if key.startswith(prefix) and key.split("/", 1)[1] not in token_names:
                        member_delete(SECRETS, key)
                member_delete(NAMESPACES, FED_SYSTEM_NAMESPACE)
                revoked = False
                for key in sa_keys:
                    if not member_delete(SERVICE_ACCOUNTS, key):
                        revoked = True
                        break
                if not revoked:
                    # Bare-store members (no token controller GC) still
                    # need the token secrets gone; over HTTP our own
                    # token secret went with our SA above.
                    for tname in token_names:
                        if not member_delete(SECRETS, prefix + tname):
                            break

        cluster["metadata"]["finalizers"] = []
        try:
            self.host.update(FEDERATED_CLUSTERS, cluster)
        except Conflict:
            return Result.retry()
        except NotFound:
            pass
        return Result.ok()
