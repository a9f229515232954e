"""Member-cluster deployment-controller simulator for rollout tests.

A copy of ``kubeadmiral_tpu/testing/membersim.py`` for the port's control
plane.

Plays the role a real kube-controller-manager + kubelet play in the
reference's e2e environment (and KWOK plays in its scale tests): for each
member Deployment it advances ReplicaSets step by step under the
member-local maxSurge/maxUnavailable constraints, and maintains the
observed state the rollout planner consumes —

* ``status.replicas`` / ``status.availableReplicas``
* the ``latestreplicaset.kubeadmiral.io/{name,replicas,available-replicas}``
  annotations describing the ReplicaSet of the CURRENT pod template
  (reference: pkg/controllers/util/rolloutplan.go retrieveNewReplicaSetInfo).

Pods created in one step become available in the next, so a rollout takes
multiple ticks and the federation-wide invariants are observable.
"""

from __future__ import annotations

from dataclasses import dataclass, field

from kubeadmiral_tpu_torch.federation.rollout import (
    LATEST_RS_AVAILABLE,
    LATEST_RS_NAME,
    LATEST_RS_REPLICAS,
    resolve_fenceposts,
)
from kubeadmiral_tpu_torch.testing.fakekube import ClusterFleet, Conflict, obj_key
from kubeadmiral_tpu_torch.utils.hashing import stable_json_hash
from kubeadmiral_tpu_torch.utils.unstructured import get_path

DEPLOYMENTS = "apps/v1/deployments"


@dataclass
class _ReplicaSet:
    replicas: int = 0
    available: int = 0


@dataclass
class _DeploymentState:
    replica_sets: dict[str, _ReplicaSet] = field(default_factory=dict)


class MemberDeploymentSimulator:
    def __init__(self, fleet: ClusterFleet, resource: str = DEPLOYMENTS):
        self.fleet = fleet
        self.resource = resource
        self._state: dict[tuple[str, str], _DeploymentState] = {}

    def _rs_name(self, dep: dict) -> str:
        tpl = get_path(dep, "spec.template", {})
        return f"{dep['metadata']['name']}-{stable_json_hash(tpl):08x}"

    def step(self) -> bool:
        """One controller round in every member; returns True when any
        deployment's observed state changed."""
        progressed = False
        for member_name, member in self.fleet.members.items():
            for key in member.keys(self.resource):
                dep = member.try_get(self.resource, key)
                if dep is None:
                    continue
                if self._step_one(member_name, dep):
                    try:
                        # Like the real deployment controller: replica-set
                        # bookkeeping annotations go through a main update
                        # (which ignores .status), observed counts through
                        # the status subresource.
                        updated = member.update(self.resource, dep)
                        dep["metadata"]["resourceVersion"] = updated[
                            "metadata"
                        ]["resourceVersion"]
                        member.update_status(self.resource, dep)
                    except Conflict:
                        pass  # raced with sync; next step retries
                    progressed = True
        return progressed

    def settle(self, max_steps: int = 100) -> None:
        for _ in range(max_steps):
            if not self.step():
                return

    # -- the simulated deployment controller ------------------------------
    def _step_one(self, member_name: str, dep: dict) -> bool:
        """Advance one deployment one round; mutates ``dep`` in place and
        returns True when its observed state changed."""
        state = self._state.setdefault(
            (member_name, obj_key(dep)), _DeploymentState()
        )
        spec_replicas = int(get_path(dep, "spec.replicas", 0) or 0)
        max_surge, max_unavailable = resolve_fenceposts(
            get_path(dep, "spec.strategy.rollingUpdate.maxSurge"),
            get_path(dep, "spec.strategy.rollingUpdate.maxUnavailable"),
            spec_replicas,
        )
        new_rs_name = self._rs_name(dep)
        sets = state.replica_sets
        new_rs = sets.setdefault(new_rs_name, _ReplicaSet())
        before = {n: (rs.replicas, rs.available) for n, rs in sets.items()}

        # 1. Pods created in earlier rounds become available.
        for rs in sets.values():
            rs.available = rs.replicas

        # 2. Scale down: old ReplicaSets drain to zero and a shrunk spec
        # reduces the new one, never dropping federation-visible
        # availability below spec - maxUnavailable.
        total_available = sum(rs.available for rs in sets.values())
        removable = max(0, total_available - (spec_replicas - max_unavailable))
        for name in [n for n in sets if n != new_rs_name]:
            rs = sets[name]
            take = min(rs.replicas, removable)
            rs.replicas -= take
            rs.available = rs.replicas
            removable -= take
        if new_rs.replicas > spec_replicas:
            take = min(new_rs.replicas - spec_replicas, removable)
            new_rs.replicas -= take
            new_rs.available = min(new_rs.available, new_rs.replicas)

        # 3. Scale up the new ReplicaSet within the surge budget; new pods
        # stay unavailable until the next round.
        total = sum(rs.replicas for rs in sets.values())
        room = spec_replicas + max_surge - total
        grow = max(0, min(room, spec_replicas - new_rs.replicas))
        new_rs.replicas += grow

        for name in list(sets):
            if name != new_rs_name and sets[name].replicas == 0:
                del sets[name]

        # 4. Publish observed state onto the deployment object.
        status = dep.setdefault("status", {})
        ann = dep["metadata"].setdefault("annotations", {})
        observed_before = (
            dict(status),
            {k: ann.get(k) for k in (LATEST_RS_NAME, LATEST_RS_REPLICAS, LATEST_RS_AVAILABLE)},
        )
        status["replicas"] = sum(rs.replicas for rs in sets.values())
        status["availableReplicas"] = sum(rs.available for rs in sets.values())
        status["updatedReplicas"] = new_rs.replicas
        ann[LATEST_RS_NAME] = new_rs_name
        ann[LATEST_RS_REPLICAS] = str(new_rs.replicas)
        ann[LATEST_RS_AVAILABLE] = str(new_rs.available)
        observed_after = (
            dict(status),
            {k: ann.get(k) for k in (LATEST_RS_NAME, LATEST_RS_REPLICAS, LATEST_RS_AVAILABLE)},
        )

        after = {n: (rs.replicas, rs.available) for n, rs in sets.items()}
        return before != after or observed_before != observed_after

    # -- observability for assertions -------------------------------------
    def total_unavailable(self, desired_total: int) -> int:
        """Federation-wide unavailability: desired total minus what is
        actually available across members."""
        avail = 0
        for member in self.fleet.members.values():
            for key in member.keys(self.resource):
                dep = member.try_get(self.resource, key)
                if dep is not None:
                    avail += int(get_path(dep, "status.availableReplicas", 0) or 0)
        return max(0, desired_total - avail)

    def total_surge(self, desired_total: int) -> int:
        total = 0
        for member in self.fleet.members.values():
            for key in member.keys(self.resource):
                dep = member.try_get(self.resource, key)
                if dep is not None:
                    total += int(get_path(dep, "status.replicas", 0) or 0)
        return max(0, total - desired_total)
