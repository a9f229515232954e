"""Monitor controller: federation-health gauges per FTC.

A copy of ``kubeadmiral_tpu/federation/monitor.py`` for the port's
control plane.

Off by default, as in the reference (reference:
pkg/controllers/monitor/monitor_controller.go:85-258,
monitor_subcontroller.go, report.go): per federated type it meters

* ``monitor.<ftc>.total`` / ``.propagated`` / ``.unpropagated`` — how
  many federated objects exist and how many have a True Propagation
  condition with every placed cluster reporting OK,
* ``monitor.<ftc>.sync_latency`` — per object generation, the time from
  first observation to successful propagation (the BaseMeter
  sync-latency equivalent),
* ``monitor.<ftc>.out_of_sync_seconds`` — the current age of the oldest
  unpropagated generation,
* ``monitor.clusters.ready`` / ``.total`` — member-cluster health.

Gauges land in the shared :class:`Metrics` store on a periodic tick
(report.go DoReport's interval loop).

Placement drift detection (``fleet`` given): per object it diffs the
scheduler's desired placement — the persisted placement on the
federated object, cross-checked against the engine's flight-recorder
decision — against the dispatched/observed member state, and exposes

* ``placement_drift_objects{ftc,kind}`` gauges per drift kind
  (``missing`` / ``orphan`` / ``replicas`` / ``decision``), and
* a bounded listing served at ``GET /debug/drift`` (the detector
  registers itself as a flightrec drift provider).

Drift includes in-flight propagation: an object scheduled but not yet
synced shows as ``missing`` until the dispatch lands, so the gauge's
steady-state baseline is the sync-latency window, and a persistent
non-zero value is the page.
"""

from __future__ import annotations

import time
from collections import Counter
from typing import Optional

import numpy as np

from kubeadmiral_tpu_torch.federation import common as C
from kubeadmiral_tpu_torch.models.ftc import FederatedTypeConfig
from kubeadmiral_tpu_torch.runtime import flightrec as FR
from kubeadmiral_tpu_torch.runtime import pending
from kubeadmiral_tpu_torch.runtime import slo as SLO
from kubeadmiral_tpu_torch.runtime.metrics import Metrics
from kubeadmiral_tpu_torch.runtime.worker import Result, Worker
from kubeadmiral_tpu_torch.testing.fakekube import FakeKube
from kubeadmiral_tpu_torch.utils.unstructured import get_path

_TICK = "tick"

DEFAULT_INTERVAL_SECONDS = 30.0

# Drift kinds (the placement_drift_objects label vocabulary).
DRIFT_MISSING = "missing"      # desired cluster lacks the member object
DRIFT_ORPHAN = "orphan"        # member object exists off the desired set
DRIFT_REPLICAS = "replicas"    # member replicas != scheduler's override
DRIFT_DECISION = "decision"    # persisted placement != flight-recorder decision
DRIFT_KINDS = (DRIFT_MISSING, DRIFT_ORPHAN, DRIFT_REPLICAS, DRIFT_DECISION)

# Bound on the /debug/drift listing (gauges stay exact).
_DRIFT_LIST_CAP = 1000


def _is_propagated(fed_obj: dict) -> bool:
    status = fed_obj.get("status", {})
    conditions = {
        c.get("type"): c.get("status") for c in status.get("conditions", [])
    }
    if conditions.get("Propagation") != "True":
        return False
    clusters = status.get("clusters", [])
    placed = C.all_placement_clusters(fed_obj)
    reported = {c.get("cluster") for c in clusters if c.get("status") == "OK"}
    return placed <= reported


class MonitorController:
    name = "monitor"

    def __init__(
        self,
        host: FakeKube,
        ftc: FederatedTypeConfig,
        metrics: Optional[Metrics] = None,
        interval: float = DEFAULT_INTERVAL_SECONDS,
        clock=time.monotonic,
        fleet=None,
        flight_recorder="default",
    ):
        self.host = host
        self.ftc = ftc
        self.metrics = metrics or Metrics()
        self.interval = interval
        self.clock = clock
        self._resource = ftc.federated.resource
        # Placement drift detection needs the member stores; a host-only
        # monitor (the reference's shape) skips it.
        self.fleet = fleet
        self.flightrec = (
            FR.get_default() if flight_recorder == "default" else flight_recorder
        )
        self._drift: list[dict] = []
        self._drift_checked = 0
        self._drift_at: Optional[float] = None
        if fleet is not None:
            FR.register_drift_provider(
                f"monitor-{ftc.name}", self.drift_snapshot
            )
        # (key, generation) -> first-seen timestamp, dropped once synced.
        self._pending_since: dict[tuple[str, int], float] = {}
        # The same clock drives latency math AND the requeue timer, so a
        # fake clock steps the whole controller deterministically.
        self.worker = Worker(
            f"monitor-{ftc.name}", self.reconcile, metrics=self.metrics, clock=clock
        )
        self.worker.enqueue(_TICK)

    def reconcile(self, key: str) -> Result:
        if key != _TICK:
            return Result.ok()
        self._report()
        return Result.after(self.interval)

    def _report(self) -> None:
        prefix = f"monitor.{self.ftc.name}"
        now = self.clock()
        total = propagated = 0
        live: set[tuple[str, int]] = set()
        # Objects per controller in the FIRST pending group: the depth of
        # each pipeline stage's backlog (runtime/pending.py semantics —
        # only first-group controllers may act, so this is the real
        # "waiting on" gauge).
        first_group: Counter = Counter()

        def visit(fed_obj: dict) -> None:
            nonlocal total, propagated
            total += 1
            meta = fed_obj.get("metadata", {})
            obj_key = f"{meta.get('namespace', '')}/{meta.get('name', '')}".lstrip("/")
            generation = meta.get("generation", 1)
            pending_key = (obj_key, generation)
            try:
                groups = pending.get_pending(fed_obj)
            except Exception:
                groups = []
            if groups:
                first_group.update(groups[0])
            if _is_propagated(fed_obj):
                propagated += 1
                started = self._pending_since.pop(pending_key, None)
                if started is not None:
                    self.metrics.duration(f"{prefix}.sync_latency", now - started)
            else:
                live.add(pending_key)
                self._pending_since.setdefault(pending_key, now)

        self.host.scan(self._resource, visit)
        for controller, depth in first_group.items():
            self.metrics.store(
                "pending_controllers_depth",
                depth,
                ftc=self.ftc.name,
                controller=controller,
            )
        # Real controller error rates for this FTC, aggregated from the
        # labeled worker series (runtime/worker.py names workers
        # "<kind>-<ftc>"): what the stub metrics silently discarded.
        suffix = f"-{self.ftc.name}"

        def family_total(family: str) -> float:
            return sum(
                value
                for labels, value in self.metrics.counter_family(family).items()
                if dict(labels).get("controller", "").endswith(suffix)
            )

        self.metrics.store(
            f"{prefix}.worker_exceptions", family_total("worker_exceptions_total")
        )
        self.metrics.store(
            f"{prefix}.worker_retries", family_total("worker_retries_total")
        )
        # Drop meters for deleted objects / superseded generations.
        for stale in [k for k in self._pending_since if k not in live]:
            del self._pending_since[stale]

        self.metrics.store(f"{prefix}.total", total)
        self.metrics.store(f"{prefix}.propagated", propagated)
        self.metrics.store(f"{prefix}.unpropagated", total - propagated)
        oldest = min(self._pending_since.values(), default=None)
        self.metrics.store(
            f"{prefix}.out_of_sync_seconds",
            (now - oldest) if oldest is not None else 0.0,
        )

        ready = total_clusters = 0
        for cluster in self.host.list(C.FEDERATED_CLUSTERS):
            total_clusters += 1
            conditions = {
                c.get("type"): c.get("status")
                for c in cluster.get("status", {}).get("conditions", [])
            }
            if conditions.get("Ready") == "True":
                ready += 1
        self.metrics.store("monitor.clusters.total", total_clusters)
        self.metrics.store("monitor.clusters.ready", ready)
        # End-to-end SLO sampling (runtime/slo.py): publish the
        # freshness gauge pair and run one burn-rate evaluation pass —
        # on THIS periodic tick precisely so a silently-wedged dispatch
        # path stays visible when no new events flow to trigger anything
        # else.
        rec = SLO.get_default()
        if rec.enabled:
            rec.evaluate(extra=self.metrics)
        # Member circuit-breaker health (transport/breaker.py): how many
        # members the fleet's shared registry currently short-circuits.
        registry = getattr(self.fleet, "_member_breakers", None)
        self.metrics.store(
            "monitor.clusters.breaker_open",
            len(registry.open_members()) if registry is not None else 0,
        )
        self._detect_drift()

    # -- placement drift --------------------------------------------------
    def _detect_drift(self) -> None:
        """Diff the scheduler's desired placements against observed
        member state; gauges per drift kind + a bounded listing for
        GET /debug/drift.

        Vectorized over (object, member) incidence matrices: one host
        scan collects desired placements, one bulk key listing per
        member builds the observed matrix (a row index), and missing/orphan
        drift falls out of boolean plane arithmetic — no per-(object,
        member) Python loop.  Only replicas checks (bounded by the
        override count, not N x M) and the flight-recorder cross-check
        (a dict lookup per object) stay per-object."""
        if self.fleet is None:
            return
        source = self.ftc.source.resource
        replicas_path = self.ftc.path.replicas_spec
        override_path = (
            "/" + replicas_path.replace(".", "/") if replicas_path else None
        )
        members = dict(self.fleet.members)
        member_names = list(members)
        col = {name: j for j, name in enumerate(member_names)}
        counts: Counter = Counter()
        drifted: list[dict] = []

        def note(kind: str, key: str, cluster: str, detail: str) -> None:
            counts[kind] += 1
            if len(drifted) < _DRIFT_LIST_CAP:
                drifted.append(
                    {"key": key, "cluster": cluster, "kind": kind,
                     "detail": detail}
                )

        keys: list[str] = []
        desired_sets: list[set] = []
        overrides: list[tuple[int, str, int]] = []  # (row, cluster, want)

        def visit(fed: dict) -> None:
            meta = fed.get("metadata", {})
            ns = meta.get("namespace", "")
            key = f"{ns}/{meta.get('name', '')}".lstrip("/")
            desired = C.get_placement(fed, C.SCHEDULER)
            if desired is None:
                return  # never scheduled: nothing to drift against
            row = len(keys)
            keys.append(key)
            desired_sets.append(desired)
            if override_path:
                for cl, patches in C.get_overrides(fed, C.SCHEDULER).items():
                    for p in patches:
                        if (
                            p.get("path") == override_path
                            and p.get("op", "replace") == "replace"
                        ):
                            overrides.append((row, cl, int(p["value"])))
            # Cross-check against the engine's recorded decision: the
            # persisted placement should be the flight recorder's chosen
            # set (a mismatch means a decision was recorded but never
            # persisted, or overwritten outside the scheduler).
            rec = (
                self.flightrec.lookup(key)
                if self.flightrec is not None and self.flightrec.enabled
                else None
            )
            if rec is not None and set(rec.placements) != desired:
                note(
                    DRIFT_DECISION, key, "",
                    f"flight recorder chose {sorted(rec.placements)} vs "
                    f"persisted {sorted(desired)}",
                )

        self.host.scan(self._resource, visit)
        checked = len(keys)

        n, m = len(keys), len(member_names)
        if n and m:
            desired_m = np.zeros((n, m), bool)
            for i, ds in enumerate(desired_sets):
                for cl in ds:
                    j = col.get(cl)
                    if j is not None:
                        desired_m[i, j] = True
            observed_m = np.zeros((n, m), bool)
            # A row index per key instead of the JAX module's np.isin
            # over object arrays: the same matrix, without sorting every
            # member's keys as Python strings.
            row_of = {key: i for i, key in enumerate(keys)}
            for j, name in enumerate(member_names):
                rows = [i for i in map(row_of.get, members[name].keys(source))
                        if i is not None]
                if rows:
                    observed_m[rows, j] = True
            missing = desired_m & ~observed_m
            orphan = observed_m & ~desired_m
            for i, j in np.argwhere(missing):
                note(DRIFT_MISSING, keys[i], member_names[j],
                     "desired placement not present in member")
            for i, j in np.argwhere(orphan):
                note(DRIFT_ORPHAN, keys[i], member_names[j],
                     "member object outside the desired placement")
            for row, cl, want in overrides:
                j = col.get(cl)
                if j is None or not observed_m[row, j]:
                    continue
                obs = members[cl].try_get_view(source, keys[row])
                got = get_path(obs, replicas_path) if obs is not None else None
                if got != want:
                    note(
                        DRIFT_REPLICAS, keys[row], cl,
                        f"member replicas {got} != desired {want}",
                    )
        for kind in DRIFT_KINDS:
            self.metrics.store(
                "placement_drift_objects", counts.get(kind, 0),
                ftc=self.ftc.name, kind=kind,
            )
        self._drift = drifted
        self._drift_checked = checked
        self._drift_at = time.time()

    def drift_snapshot(self) -> dict:
        """The /debug/drift payload (registered as a flightrec drift
        provider when the monitor has member access)."""
        return {
            "ftc": self.ftc.name,
            "checked": self._drift_checked,
            "generated_at": self._drift_at,
            "drifted": list(self._drift),
        }
