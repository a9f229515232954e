"""Deterministic all-stressors-at-once soak harness.

A copy of ``kubeadmiral_tpu/testing/soakharness.py`` for the port's control
plane.

Drives the full federate → batch-schedule → sync pipeline over an
in-process fleet through a DETERMINISTIC round schedule — seeded object
arrivals and churn across tenant namespaces, periodic capacity drift,
one flapping member, one hard-down member — so two runs of the same
:class:`SoakSchedule` produce bit-identical placements regardless of
faults or a mid-run kill/failover:

* placements depend only on host-side state (federated objects, the
  FederatedCluster capacity the drift writes) and the scheduler is
  deterministic over it;
* member faults touch ONLY the write path (sheds, breaker opens, SLO
  burn) — all of which the telemetry timeline records, none of which
  feeds back into scheduling (cluster_state_from_object gates on the
  Joined condition alone; heartbeats are frozen after the initial join
  settle so drift writes are never overwritten).

Every round's world is a PURE function of (schedule, round): a restarted
control plane (bench.py --scenario soak's successor) resumes from a
fleet dump at round k and replays rounds k+1.. without any carried
generator state.

Fault-injection windows are recorded in the harness clock (the same
clock the Timeline samples with), and a window is only CLOSED after the
post-clearance recovery settle confirms the shed writes landed and the
burn-rate evaluator is green again — so "evaluator red outside a
declared window" is a genuine finding, not a recovery-lag artifact.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Optional

from kubeadmiral_tpu_torch.utils.hashing import stable_json_hash

GVK = "apps/v1/Deployment"


def _mix(*parts) -> int:
    """FNV-1a over the stringified parts — the deterministic seed every
    per-round decision derives from (stable across platforms/versions,
    unlike hash())."""
    h = 2166136261
    for part in parts:
        for b in str(part).encode():
            h = ((h ^ b) * 16777619) & 0xFFFFFFFF
    return h


@dataclasses.dataclass(frozen=True)
class SoakSchedule:
    """The soak's deterministic script.  Window bounds are round
    numbers [start, end); kill_round is consumed by the bench scenario
    (the harness itself never kills anything)."""

    rounds: int = 10
    arrivals_per_round: int = 6
    churn_per_round: int = 4
    tenants: tuple = ("team-a", "team-b", "team-c")
    members: int = 4
    drift_every: int = 3
    flap_member_idx: int = 1
    flap_window: tuple = (2, 8)
    down_member_idx: int = 2
    down_window: tuple = (3, 7)
    kill_round: int = 5
    seed: int = 20260806

    def member_names(self) -> list[str]:
        return [f"soak-m{j}" for j in range(self.members)]

    # -- pure per-round world generation ---------------------------------
    def arrivals(self, r: int) -> list[dict]:
        """The deployments created in round r."""
        out = []
        for i in range(self.arrivals_per_round):
            tenant = self.tenants[(r + i) % len(self.tenants)]
            rnd = _mix(self.seed, "arrival", r, i)
            out.append(_make_deployment(
                tenant, f"soak-{r:03d}-{i:03d}",
                replicas=1 + rnd % 16,
                cpu_m=(rnd // 16 % 8) * 100,
            ))
        return out

    def keys_before(self, r: int) -> list[str]:
        """Every arrival key from rounds < r, in creation order."""
        keys = []
        for rr in range(r):
            for i in range(self.arrivals_per_round):
                tenant = self.tenants[(rr + i) % len(self.tenants)]
                keys.append(f"{tenant}/soak-{rr:03d}-{i:03d}")
        return keys

    def churn(self, r: int) -> list[tuple[str, int]]:
        """(key, new_replicas) updates applied in round r."""
        keys = self.keys_before(r)
        if not keys:
            return []
        out = []
        for i in range(self.churn_per_round):
            rnd = _mix(self.seed, "churn", r, i)
            out.append((keys[rnd % len(keys)], 1 + (rnd // 7) % 20))
        return out

    def drift(self, r: int) -> Optional[dict[str, float]]:
        """member name -> available-capacity fraction for round r, or
        None on non-drift rounds."""
        if self.drift_every <= 0 or r == 0 or r % self.drift_every:
            return None
        return {
            name: 0.3 + 0.6 * ((_mix(self.seed, "drift", r, name) % 100) / 100.0)
            for name in self.member_names()
        }

    def member_cpu_m(self, j: int) -> int:
        return (32 + 16 * j) * 1000

    def member_mem_gi(self, j: int) -> int:
        return 128

    def fault_state(self, r: int) -> dict[str, bool]:
        names = self.member_names()
        return {
            "flap": self.flap_window[0] <= r < self.flap_window[1],
            "down": self.down_window[0] <= r < self.down_window[1],
            "flap_member": names[self.flap_member_idx],
            "down_member": names[self.down_member_idx],
        }


def _make_deployment(namespace: str, name: str, replicas: int, cpu_m: int) -> dict:
    return {
        "apiVersion": "apps/v1",
        "kind": "Deployment",
        "metadata": {
            "name": name,
            "namespace": namespace,
            "labels": {"kubeadmiral.io/propagation-policy-name": "pp"},
        },
        "spec": {
            "replicas": replicas,
            "selector": {"matchLabels": {"app": name}},
            "template": {
                "metadata": {"labels": {"app": name}},
                "spec": {
                    "containers": [
                        {
                            "name": "c",
                            "image": "nginx",
                            "resources": {"requests": {"cpu": f"{cpu_m}m"}},
                        }
                    ]
                },
            },
        },
    }


class SoakHarness:
    """One control plane running a :class:`SoakSchedule` (see module
    docstring).  Pass a restored ``fleet`` (ClusterFleet.restore of a
    prior dump) to resume as a failover successor — members, policies,
    and Joined conditions ride the dump, so the successor skips world
    construction and the join settle entirely.  ``engine`` is the
    scheduler's (None: its default engine, on the card)."""

    def __init__(self, schedule: SoakSchedule, metrics=None, fleet=None,
                 clock=time.monotonic, engine=None):
        from kubeadmiral_tpu_torch.federation.federate import FederateController
        from kubeadmiral_tpu_torch.federation.schedulerctl import SchedulerController
        from kubeadmiral_tpu_torch.federation.sync import SyncController
        from kubeadmiral_tpu_torch.models.ftc import default_ftcs
        from kubeadmiral_tpu_torch.runtime.metrics import Metrics
        from kubeadmiral_tpu_torch.testing.fakekube import ClusterFleet

        self.schedule = schedule
        self.metrics = metrics if metrics is not None else Metrics()
        self.clock = clock
        self.timeline = None  # installed via attach_timeline()
        ftc = next(f for f in default_ftcs() if f.name == "deployments.apps")
        self.ftc = dataclasses.replace(
            ftc, controllers=(("kubeadmiral.io/global-scheduler",),)
        )
        resumed = fleet is not None
        self.fleet = fleet if resumed else ClusterFleet()
        if not resumed:
            self._build_world()
        self.controllers = [
            ("federate", FederateController(self.fleet.host, self.ftc,
                                            metrics=self.metrics)),
            ("schedule", SchedulerController(self.fleet.host, self.ftc,
                                             engine=engine,
                                             metrics=self.metrics)),
            ("sync", SyncController(self.fleet, self.ftc,
                                    metrics=self.metrics)),
        ]
        self.scheduler = self.controllers[1][1]
        self._injector = None
        self._wrapped: dict[str, object] = {}
        # Injection windows: [{"member", "kind", "round0", "t0", "t1"}]
        # in the harness clock; t1 None = still open (or killed mid-
        # window) — the red-outside-window gate treats open as +inf.
        self.windows: list[dict] = []
        if not resumed:
            self._join_members()
        # A resumed fleet is NOT settled here: the successor wires the
        # engine snapshot restore + timeline first, and the next
        # run_round's settle drains the watch-replay resync backlog.

    # -- world construction ------------------------------------------------
    def _build_world(self) -> None:
        from kubeadmiral_tpu_torch.federation.clusterctl import (
            FEDERATED_CLUSTERS,
            NODES,
        )
        from kubeadmiral_tpu_torch.models.policy import PROPAGATION_POLICIES

        sched = self.schedule
        for j, name in enumerate(sched.member_names()):
            member = self.fleet.add_member(name)
            member.create(
                NODES,
                {
                    "apiVersion": "v1",
                    "kind": "Node",
                    "metadata": {"name": "n1"},
                    "spec": {},
                    "status": {
                        "allocatable": {
                            "cpu": f"{sched.member_cpu_m(j)}m",
                            "memory": f"{sched.member_mem_gi(j)}Gi",
                        },
                        "conditions": [{"type": "Ready", "status": "True"}],
                    },
                },
            )
            self.fleet.host.create(
                FEDERATED_CLUSTERS,
                {
                    "apiVersion": "core.kubeadmiral.io/v1alpha1",
                    "kind": "FederatedCluster",
                    "metadata": {"name": name},
                    "spec": {},
                },
            )
        for tenant in sched.tenants:
            self.fleet.host.create(
                PROPAGATION_POLICIES,
                {
                    "apiVersion": "core.kubeadmiral.io/v1alpha1",
                    "kind": "PropagationPolicy",
                    "metadata": {"name": "pp", "namespace": tenant},
                    "spec": {"schedulingMode": "Divide"},
                },
            )

    def _join_members(self) -> None:
        """Join clusters via the cluster controller, then FREEZE it: its
        heartbeat would overwrite the drift-written status.resources
        with re-aggregated member state at nondeterministic times.  The
        Joined condition and the initial capacity aggregation persist on
        the host objects."""
        from kubeadmiral_tpu_torch.federation import shardmap
        from kubeadmiral_tpu_torch.federation.clusterctl import (
            FederatedClusterController,
        )

        # The join controller is control-plane-GLOBAL even when the
        # harness itself is built under a shard scope (the sharded
        # soak): its worker keys are raw cluster names, and a scoped
        # replica would silently join only the clusters hashing to its
        # own shard — every replica must see every cluster Joined.
        with shardmap.scoped(shardmap.ShardMap(1, 0)):
            clusterctl = FederatedClusterController(
                self.fleet, api_resource_probe=[GVK], metrics=self.metrics
            )
        for _ in range(200):
            progressed = False
            while clusterctl.worker.step():
                progressed = True
            for _, ctl in self.controllers:
                while ctl.worker.step():
                    progressed = True
            if not progressed:
                break

    # -- observatory wiring ------------------------------------------------
    def attach_timeline(self, timeline) -> None:
        """Wire the timeline's runtime providers to THIS control plane's
        SLO recorder / breaker registry and remember it for per-round
        samples."""
        from kubeadmiral_tpu_torch.runtime import slo as slo_mod

        self.timeline = timeline
        timeline.attach_runtime(
            slo=slo_mod.get_default(),
            breakers=getattr(self.fleet, "_member_breakers", None),
        )

    # -- stepping ----------------------------------------------------------
    def settle(self, max_rounds: int = 2000) -> None:
        """Drain every controller to quiescence (the bench_e2e settle
        shape): each controller drains fully per pass; short-fuse
        requeues (admission delays) are waited out, long-fuse backoff
        requeues (a down member's retries) read as idle."""
        for _ in range(max_rounds):
            progressed = False
            for _, ctl in self.controllers:
                while ctl.worker.step():
                    progressed = True
            if not progressed:
                dues = [
                    d
                    for _, ctl in self.controllers
                    for d in (ctl.worker.queue.next_due_in(),)
                    if d is not None and d <= 0.25
                ]
                if not dues:
                    return
                time.sleep(min(dues) + 0.002)

    # -- fault transitions -------------------------------------------------
    def _apply_faults(self, r: int, faults: bool) -> None:
        from kubeadmiral_tpu_torch.transport.faults import (
            FaultInjector,
            FaultPolicy,
            FaultyKube,
        )

        state = self.schedule.fault_state(r)
        want = {
            state["down_member"]: (
                "down", faults and state["down"], FaultPolicy(partition=True)
            ),
            state["flap_member"]: (
                "flap",
                faults and state["flap"],
                FaultPolicy(partition=True, flap_period_s=0.4, flap_duty=0.5),
            ),
        }
        for name, (kind, active, policy) in want.items():
            wrapped = name in self._wrapped
            if active and not wrapped:
                if self._injector is None:
                    self._injector = FaultInjector()
                proxy = FaultyKube(
                    self.fleet.members[name], name, self._injector,
                    timeout=0.2,
                )
                self._wrapped[name] = self.fleet.members[name]
                self.fleet.members[name] = proxy
                self._injector.set_fault(name, policy)
                self.windows.append({
                    "member": name, "kind": kind, "round0": r,
                    "t0": self.clock(), "t1": None,
                })
            elif not active and wrapped:
                self._clear_fault(name)

    def _clear_fault(self, name: str) -> None:
        self._injector.clear(name)
        proxy = self.fleet.members[name]
        self.fleet.members[name] = self._wrapped.pop(name)
        proxy.drain_stalled()
        self._recover()
        for w in self.windows:
            if w["member"] == name and w["t1"] is None:
                w["t1"] = self.clock()

    def _recover(self, deadline_s: float = 30.0) -> None:
        """Settle until shed writes landed and the evaluator is green —
        the recovery tail belongs INSIDE the injection window (the fault
        caused it), so the window stays open until here."""
        from kubeadmiral_tpu_torch.runtime import slo as slo_mod

        rec = slo_mod.get_default()
        deadline = time.monotonic() + deadline_s
        while time.monotonic() < deadline:
            self.settle()
            if rec is None or not rec.enabled:
                return
            unwritten = rec.unwritten_placements()
            status = rec.evaluate()
            if unwritten == 0 and not any(
                e.get("red") for e in status.values()
            ):
                return
            time.sleep(0.2)

    # -- the round loop ----------------------------------------------------
    def run_round(self, r: int, faults: bool = True) -> dict:
        from kubeadmiral_tpu_torch.federation.clusterctl import FEDERATED_CLUSTERS

        sched = self.schedule
        self._apply_faults(r, faults)
        for dep in sched.arrivals(r):
            self.fleet.host.create(self.ftc.source.resource, dep)
        for key, replicas in sched.churn(r):
            obj = self.fleet.host.try_get(self.ftc.source.resource, key)
            if obj is not None:
                obj["spec"]["replicas"] = replicas
                self.fleet.host.update(self.ftc.source.resource, obj)
        drift = sched.drift(r)
        if drift:
            for j, name in enumerate(sched.member_names()):
                frac = drift[name]
                obj = self.fleet.host.get(FEDERATED_CLUSTERS, name)
                res = obj.setdefault("status", {}).setdefault("resources", {})
                res["available"] = {
                    "cpu": f"{int(sched.member_cpu_m(j) * frac)}m",
                    "memory": f"{int(sched.member_mem_gi(j) * frac)}Gi",
                }
                self.fleet.host.update_status(FEDERATED_CLUSTERS, obj)
        self.settle()
        if self.timeline is not None:
            self.timeline.sample_now()
        return {
            "round": r,
            "drift": bool(drift),
            "faults": {
                k: v for k, v in sched.fault_state(r).items()
                if isinstance(v, bool)
            } if faults else {},
        }

    def finish(self) -> None:
        """Clear any still-active fault (closing its window through the
        recovery settle) and converge the world."""
        for name in list(self._wrapped):
            self._clear_fault(name)
        self.settle()
        if self.timeline is not None:
            self.timeline.sample_now()

    # -- read side ---------------------------------------------------------
    def fingerprint(self) -> dict:
        """Bit-comparable placement state: per federated object, the
        scheduler-written placements + overrides (deterministic by
        construction; annotations/status are excluded — they may carry
        timestamps)."""
        placements = {}
        for key in sorted(self.fleet.host.keys(self.ftc.federated.resource)):
            fed = self.fleet.host.get(self.ftc.federated.resource, key)
            spec = fed.get("spec", {})
            placements[key] = {
                "placements": spec.get("placements", []),
                "overrides": spec.get("overrides", []),
            }
        return {
            "objects": len(placements),
            "hash": stable_json_hash(placements),
            "placements": placements,
        }

    def member_object_counts(self) -> dict[str, int]:
        return {
            name: len(kube.keys(self.ftc.source.resource))
            for name, kube in sorted(self.fleet.members.items())
        }
