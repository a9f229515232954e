"""Cross-cluster rollout planning for federated Deployments.

A copy of ``kubeadmiral_tpu/federation/rollout.py`` for the port's control
plane.

When an FTC enables rolloutPlan, the sync dispatcher coordinates member
clusters through a rolling update so that the FEDERATION-WIDE maxSurge /
maxUnavailable invariants hold even though each member's deployment
controller acts independently (reference:
pkg/controllers/util/rolloutplan.go:58-867, applied from
pkg/controllers/sync/dispatch/managed.go:204-323).

Each tick produces a per-cluster ``RolloutPlan {replicas, maxSurge,
maxUnavailable, onlyPatchReplicas}``; a cluster with NO plan keeps its
current template ("wait for your turn").  The planner reads the member
deployments' observed state: spec.replicas, status availability, the
current-revision annotation stamped by sync, and the
``latestreplicaset.kubeadmiral.io/*`` annotations describing the member's
newest ReplicaSet.

The budget accounting: each cluster's already-unavailable /
already-surged replicas count against the global budget first
(LeastUnavailable/LeastSurge); the remainder is handed out in the
reference's fixed execution order — upgrade scale-outs, shrink
scale-ins, upgrade in-placers, grow scale-outs, upgrade scale-ins —
so shrinking funds growing within one tick.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Optional

from kubeadmiral_tpu_torch.federation.retain import (
    CURRENT_REVISION_ANNOTATION,
    LAST_REPLICASET_NAME,
)
from kubeadmiral_tpu_torch.utils.unstructured import get_path

REPLICAS_PATH = "/spec/replicas"
MAX_SURGE_PATH = "/spec/strategy/rollingUpdate/maxSurge"
MAX_UNAVAILABLE_PATH = "/spec/strategy/rollingUpdate/maxUnavailable"

# Member-side annotations describing the newest ReplicaSet
# (reference: util/federatedstatus.go:35-39, common/constants.go:113).
LATEST_RS_NAME = "latestreplicaset.kubeadmiral.io/name"
LATEST_RS_REPLICAS = "latestreplicaset.kubeadmiral.io/replicas"
LATEST_RS_AVAILABLE = "latestreplicaset.kubeadmiral.io/available-replicas"
LAST_RS_NAME = LAST_REPLICASET_NAME


class RolloutPlanError(Exception):
    pass


@dataclass
class RolloutPlan:
    """What one cluster may do this tick (rolloutplan.go:58-92).
    None means "don't override; use the original value"."""

    replicas: Optional[int] = None
    max_surge: Optional[int] = None
    max_unavailable: Optional[int] = None
    only_patch_replicas: bool = False

    def to_overrides(self) -> list[dict]:
        patches = []
        if self.replicas is not None:
            patches.append(
                {"op": "replace", "path": REPLICAS_PATH, "value": self.replicas}
            )
        if self.max_surge is not None:
            patches.append(
                {"op": "replace", "path": MAX_SURGE_PATH, "value": self.max_surge}
            )
        if self.max_unavailable is not None:
            patches.append(
                {
                    "op": "replace",
                    "path": MAX_UNAVAILABLE_PATH,
                    "value": self.max_unavailable,
                }
            )
        return patches


def resolve_fenceposts(
    max_surge, max_unavailable, desired: int
) -> tuple[int, int]:
    """Int-or-percent resolution (rolloutplan.go resolveFenceposts via
    k8s intstr): surge rounds up, unavailable rounds down; both-zero
    degenerates to unavailable=1."""

    def value(raw, round_up: bool) -> int:
        if raw is None:
            return 0
        if isinstance(raw, str):
            if not raw.endswith("%"):
                return int(raw)
            pct = int(raw[:-1])
            exact = pct * desired / 100.0
            return int(math.ceil(exact) if round_up else math.floor(exact))
        return int(raw)

    surge = max(0, value(max_surge, True))
    unavailable = max(0, value(max_unavailable, False))
    if surge == 0 and unavailable == 0:
        unavailable = 1
    return surge, unavailable


def retrieve_fenceposts(obj: dict, prefix: str, replicas: int) -> tuple[int, int]:
    """Read maxSurge/maxUnavailable at ``prefix`` ("" for a member
    deployment, "spec.template." for the federated object)."""
    surge = get_path(obj, prefix + "spec.strategy.rollingUpdate.maxSurge")
    unavailable = get_path(obj, prefix + "spec.strategy.rollingUpdate.maxUnavailable")
    return resolve_fenceposts(surge, unavailable, replicas)


@dataclass
class TargetStatus:
    """Observed member-deployment state (rolloutplan.go:166-177)."""

    replicas: int = 0  # member spec.replicas
    actual_replicas: int = 0  # member status.replicas
    available_replicas: int = 0  # member status.availableReplicas
    updated_replicas: int = 0  # latest-RS replicas, 0 unless template is current
    updated_available_replicas: int = 0
    current_new_replicas: int = 0  # latest-RS replicas of the member's own newest template
    current_new_available_replicas: int = 0
    updated: bool = False  # member template == desired revision
    max_surge: int = 0  # member's own current fenceposts
    max_unavailable: int = 0


@dataclass
class Target:
    """One member cluster in the planning problem
    (rolloutplan.go:179-184 + the budget arithmetic methods)."""

    cluster: str
    status: TargetStatus = field(default_factory=TargetStatus)
    desired_replicas: int = 0

    # -- remaining work ---------------------------------------------------
    def replicas_to_update(self) -> int:
        return max(0, self.status.replicas - self.status.updated_replicas)

    def replicas_to_updated_available(self) -> int:
        return max(0, self.status.replicas - self.status.updated_available_replicas)

    def replicas_to_update_currently(self) -> int:
        return max(0, self.status.replicas - self.status.current_new_replicas)

    def replicas_to_updated_available_currently(self) -> int:
        return max(
            0, self.status.replicas - self.status.current_new_available_replicas
        )

    def during_updating(self) -> bool:
        """(rolloutplan.go:514-524)"""
        if self.status.current_new_replicas < self.status.replicas:
            return True
        return self.status.updated and self.replicas_to_update() > 0

    def update_completed(self) -> bool:
        return self.replicas_to_update() == 0

    def is_surge(self) -> bool:
        return self.status.max_surge != 0 and self.status.max_unavailable == 0

    def flip(self, default_is_surge: bool) -> bool:
        """Surge-mode member under an unavailability-mode federation
        (rolloutplan.go:327-332)."""
        return (
            self.is_surge()
            and not default_is_surge
            and self.replicas_to_updated_available() > 0
        )

    # -- budget already held by this cluster ------------------------------
    def least_surge(self) -> int:
        res = max(0, self.status.actual_replicas - self.status.replicas)
        if not self.during_updating():
            return res
        return max(
            res, min(self.status.max_surge, res + self.replicas_to_update_currently())
        )

    def least_unavailable(self) -> int:
        res = max(0, self.status.replicas - self.status.available_replicas)
        if not self.during_updating():
            return res
        return max(
            res,
            min(
                self.status.max_unavailable,
                self.replicas_to_updated_available_currently(),
            ),
        )

    # -- budget grants (return (granted, spent-from-shared-pool)) ---------
    def grant_surge(self, max_surge: int, least_surge: int) -> tuple[int, int]:
        res = min(max_surge + least_surge, self.replicas_to_update())
        res = max(0, res)
        more = max(0, res - least_surge)
        if max_surge < 0 and least_surge > self.status.max_surge and res > self.status.max_surge:
            res = self.status.max_surge
        return res, more

    def grant_unavailable(
        self, max_unavailable: int, least_unavailable: int
    ) -> tuple[int, int]:
        res = min(max_unavailable + least_unavailable, self.replicas_to_updated_available())
        res = max(0, res)
        more = max(0, res - least_unavailable)
        if (
            max_unavailable < 0
            and least_unavailable > self.status.max_unavailable
            and res > self.status.max_unavailable
        ):
            res = self.status.max_unavailable
        return res, more

    def grant_scale_out(self, max_scale_out: int, least_surge: int) -> tuple[int, int]:
        res = min(max_scale_out + least_surge, self.desired_replicas - self.status.replicas)
        res = max(0, res)
        more = max(0, res - least_surge)
        return res, more

    def grant_scale_in(
        self, max_scale_in: int, least_unavailable: int
    ) -> tuple[int, int]:
        res = min(
            max_scale_in + least_unavailable,
            self.status.replicas - self.desired_replicas,
        )
        res = min(res, self.status.replicas)
        res = max(0, res)
        more = max(0, res - least_unavailable)
        return res, more

    # -- skip predicates (rolloutplan.go:334-362) -------------------------
    def skip_plan_for_update(self, max_surge: int, max_unavailable: int) -> bool:
        return (
            max_surge <= 0
            and max_unavailable <= 0
            and not self.status.updated
            and not self.during_updating()
            and self.least_surge() <= 0
            and self.least_unavailable() <= 0
        )

    def skip_plan_for_update_when_scaling_in(
        self, max_surge: int, max_unavailable: int, least_unavailable: int
    ) -> bool:
        if (
            max_surge <= 0
            and max_unavailable <= 0
            and not self.status.updated
            and not self.during_updating()
        ):
            if least_unavailable > 0:
                return False
            least_surge = self.least_surge()
            if self.desired_replicas < self.status.replicas:
                least_surge = 0
            return least_surge <= 0
        return False

    def skip_plan_for_scale_in(self, max_unavailable: int) -> bool:
        return max_unavailable <= 0 and self.least_unavailable() <= 0

    def skip_plan_for_scale_out(self, max_surge: int) -> bool:
        return max_surge <= 0 and self.least_surge() <= 0


def target_from_cluster_object(
    cluster: str,
    cluster_obj: Optional[dict],
    desired_replicas: int,
    desired_revision: str,
    replicas_spec_path: str,
    available_replicas_status_path: str,
) -> Target:
    """Member deployment -> Target (rolloutplan.go
    unstructuredObjToTargetInfo).  Raises RolloutPlanError when required
    observed state is missing — the caller falls back to a no-plan tick."""
    if cluster_obj is None:
        return Target(cluster=cluster, desired_replicas=desired_replicas)

    replicas = get_path(cluster_obj, replicas_spec_path)
    if replicas is None:
        raise RolloutPlanError(f"{cluster}: missing {replicas_spec_path}")
    try:
        replicas = int(replicas)
    except (TypeError, ValueError) as e:
        raise RolloutPlanError(f"{cluster}: malformed {replicas_spec_path}") from e
    max_surge, max_unavailable = retrieve_fenceposts(cluster_obj, "", replicas)

    ann = cluster_obj.get("metadata", {}).get("annotations", {})
    revision = ann.get(CURRENT_REVISION_ANNOTATION)
    if revision is None:
        raise RolloutPlanError(f"{cluster}: missing {CURRENT_REVISION_ANNOTATION}")
    # The template counts as updated as soon as it's dispatched; waiting
    # for the member's async annotation refresh would stall the plan
    # (rolloutplan.go:392-394).
    updated = revision == desired_revision

    if LATEST_RS_REPLICAS not in ann or LATEST_RS_AVAILABLE not in ann:
        raise RolloutPlanError(f"{cluster}: missing latest-replicaset annotations")
    if LATEST_RS_NAME not in ann:
        raise RolloutPlanError(f"{cluster}: missing {LATEST_RS_NAME}")
    try:
        current_new = int(ann[LATEST_RS_REPLICAS])
        current_new_available = int(ann[LATEST_RS_AVAILABLE])
    except ValueError as e:
        raise RolloutPlanError(
            f"{cluster}: malformed latest-replicaset annotations: {e}"
        ) from e
    # If the newest-RS annotations still describe the replicaset of the
    # PREVIOUS dispatched template, they say nothing about the new one
    # (rolloutplan.go:817-824).
    if ann.get(LAST_RS_NAME) is not None and ann.get(LAST_RS_NAME) == ann.get(LATEST_RS_NAME):
        current_new = current_new_available = 0

    updated_replicas = current_new if updated else 0
    updated_available = current_new_available if updated else 0

    available = get_path(cluster_obj, available_replicas_status_path)

    return Target(
        cluster=cluster,
        desired_replicas=desired_replicas,
        status=TargetStatus(
            replicas=replicas,
            actual_replicas=int(get_path(cluster_obj, "status.replicas", 0) or 0),
            available_replicas=int(available or 0),
            updated_replicas=updated_replicas,
            updated_available_replicas=updated_available,
            current_new_replicas=current_new,
            current_new_available_replicas=current_new_available,
            updated=updated,
            max_surge=max_surge,
            max_unavailable=max_unavailable,
        ),
    )


class RolloutPlanner:
    """(rolloutplan.go:452-568 + Plan())"""

    def __init__(self, key: str, fed_obj: dict, replicas: int):
        self.key = key
        self.replicas = replicas
        self.max_surge, self.max_unavailable = retrieve_fenceposts(
            fed_obj, "spec.template.", replicas
        )
        revision = fed_obj.get("metadata", {}).get("annotations", {}).get(
            CURRENT_REVISION_ANNOTATION
        )
        if revision is None:
            raise RolloutPlanError(
                f"{key}: federated object missing {CURRENT_REVISION_ANNOTATION}"
            )
        self.revision = revision
        self.targets: list[Target] = []

    @classmethod
    def from_params(
        cls, replicas: int, max_surge: int, max_unavailable: int
    ) -> "RolloutPlanner":
        """Direct construction from the planning parameters — the shape
        the reference's table tests build (`&RolloutPlanner{Targets,
        MaxSurge, MaxUnavailable, Replicas}`, rolloutplan_test.go);
        production goes through __init__, which derives the fenceposts
        from the federated object."""
        planner = cls.__new__(cls)
        planner.key = "golden"
        planner.replicas = replicas
        planner.max_surge = max_surge
        planner.max_unavailable = max_unavailable
        planner.revision = "golden-revision"
        planner.targets = []
        return planner

    def register(self, target: Target) -> None:
        self.targets.append(target)

    def is_surge(self) -> bool:
        return self.max_surge != 0 and self.max_unavailable == 0

    def _sorted_groups(self) -> tuple[list[Target], list[Target], list[Target]]:
        """(to_update, to_scale_out, to_scale_in), cluster-name ordered
        (rolloutplan.go sortTargets)."""
        targets = sorted(self.targets, key=lambda t: t.cluster)
        to_update, to_scale_out, to_scale_in = [], [], []
        for t in targets:
            change = t.desired_replicas - t.status.replicas
            if change < 0:
                to_scale_in.append(t)
            elif change > 0:
                to_scale_out.append(t)
            else:
                to_update.append(t)
        return to_update, to_scale_out, to_scale_in

    def is_scaling_event(self) -> bool:
        """Pure scaling (no template change anywhere): plans are empty —
        every cluster just takes its scheduled replicas
        (rolloutplan.go:507-527)."""
        _, to_scale_out, to_scale_in = self._sorted_groups()
        if to_scale_out and to_scale_in:
            return False
        if not to_scale_out and not to_scale_in:
            return False
        return all(
            t.update_completed() and not t.flip(self.is_surge())
            for t in self.targets
        )

    def remaining_max_surge(self) -> int:
        replicas = sum(t.status.replicas for t in self.targets)
        occupied = sum(t.least_surge() for t in self.targets)
        return self.max_surge - (replicas - self.replicas) - occupied

    def remaining_max_unavailable(self) -> int:
        replicas = sum(t.status.replicas for t in self.targets)
        occupied = sum(t.least_unavailable() for t in self.targets)
        return self.max_unavailable - (self.replicas - replicas) - occupied

    def _correct_fencepost(self, plan: RolloutPlan, t: Target) -> None:
        """(rolloutplan.go:94-113)"""
        if t.update_completed() and not t.flip(self.is_surge()):
            plan.max_surge = None
            plan.max_unavailable = None
        elif plan.max_surge == 0 and plan.max_unavailable == 0:
            if t.is_surge():
                plan.max_surge = 1
            else:
                plan.max_unavailable = 1

    def plan(self) -> dict[str, RolloutPlan]:
        """The five-pass budget walk (rolloutplan.go:568-692)."""
        to_update, to_scale_out, to_scale_in = self._sorted_groups()
        plans: dict[str, RolloutPlan] = {}

        if self.is_scaling_event():
            return {t.cluster: RolloutPlan() for t in self.targets}

        max_surge = self.remaining_max_surge()
        max_unavailable = self.remaining_max_unavailable()

        # 1. Upgrade targets waiting to scale out (at current size).
        for t in to_scale_out:
            if t.skip_plan_for_update(max_surge, max_unavailable):
                continue
            s, sm = t.grant_surge(max_surge, t.least_surge())
            u, um = t.grant_unavailable(max_unavailable, t.least_unavailable())
            max_surge -= sm
            max_unavailable -= um
            plan = RolloutPlan(
                replicas=t.status.replicas, max_surge=s, max_unavailable=u
            )
            self._correct_fencepost(plan, t)
            plans[t.cluster] = plan

        # 2. Shrink targets waiting to scale in (preferring the already-
        # unavailable replicas).
        for t in to_scale_in:
            if t.skip_plan_for_scale_in(max_unavailable):
                continue
            least_unavailable = 0 if t.during_updating() else t.least_unavailable()
            scale, more = t.grant_scale_in(max_unavailable, least_unavailable)
            max_unavailable -= more
            plans[t.cluster] = RolloutPlan(
                replicas=t.status.replicas - scale, only_patch_replicas=True
            )

        # 3. Upgrade in-place targets.
        for t in to_update:
            if t.skip_plan_for_update(max_surge, max_unavailable):
                continue
            s, sm = t.grant_surge(max_surge, t.least_surge())
            u, um = t.grant_unavailable(max_unavailable, t.least_unavailable())
            max_surge -= sm
            max_unavailable -= um
            plan = RolloutPlan(max_surge=s, max_unavailable=u)
            self._correct_fencepost(plan, t)
            plans[t.cluster] = plan

        # 4. Grow the scale-outs (only once their new RS exists).
        for t in to_scale_out:
            if t.skip_plan_for_scale_out(max_surge):
                continue
            if not t.status.updated and t.status.replicas != 0:
                continue
            least_surge = 0 if t.during_updating() else t.least_surge()
            scale, more = t.grant_scale_out(max_surge, least_surge)
            max_surge -= more
            plan = plans.get(t.cluster) or RolloutPlan()
            plan.replicas = t.status.replicas + scale
            plans[t.cluster] = plan

        # 5. Upgrade the scale-ins (their shrink may have freed budget).
        for t in to_scale_in:
            plan = plans.get(t.cluster) or RolloutPlan(replicas=t.status.replicas)
            least_unavailable = t.least_unavailable()
            if not t.during_updating():
                # Unavailable replicas already removed by the pass-2
                # shrink don't count against this cluster again.
                already_shrunk = t.status.replicas - (
                    plan.replicas if plan.replicas is not None else t.status.replicas
                )
                least_unavailable = max(0, least_unavailable - already_shrunk)
            if t.skip_plan_for_update_when_scaling_in(
                max_surge, max_unavailable, least_unavailable
            ):
                continue
            plan.only_patch_replicas = False
            s, sm = t.grant_surge(max_surge, t.least_surge())
            u, um = t.grant_unavailable(max_unavailable, least_unavailable)
            max_surge -= sm
            max_unavailable -= um
            plan.max_surge = s
            plan.max_unavailable = u
            self._correct_fencepost(plan, t)
            plans[t.cluster] = plan

        if not self._validate(plans):
            # An invalid plan dispatches nothing rather than something
            # that violates the federation-wide invariants.
            return {}
        return plans

    def _validate(self, plans: dict[str, RolloutPlan]) -> bool:
        """(rolloutplan.go validatePlans)"""
        planned = desired = current = 0
        for t in self.targets:
            desired += t.desired_replicas
            current += t.status.replicas
            plan = plans.get(t.cluster)
            if plan is None:
                # An unplanned cluster keeps its current size this tick.
                planned += t.status.replicas
            elif plan.replicas is not None:
                planned += plan.replicas
            else:
                planned += t.desired_replicas
        if self.replicas - desired > self.max_unavailable:
            return False
        low, high = min(desired, current), max(desired, current)
        if low - planned > self.max_unavailable or planned - high > self.max_surge:
            return False
        return True
