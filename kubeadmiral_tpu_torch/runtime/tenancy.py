"""Per-tenant attribution: the bounded-cardinality tenant dimension.

A copy of ``kubeadmiral_tpu/runtime/tenancy.py`` for the port's control
plane.

ROADMAP item 4's weighted fair admission needs per-tenant data — which
tenant is burning the latency budget, shedding writes, triggering
admission backpressure — and before this module nothing in the pipeline
carried a tenant identity.  Tenancy here is namespace-derived:

* default: tenant == the object's namespace ("~cluster" for
  cluster-scoped objects);
* TENANT_LABEL names a metadata label whose value overrides the
  namespace when present (call sites that only know a "ns/name" key
  fall back to the namespace — labels aren't carried that deep); empty
  by default, as the JAX module's ``KT_TENANT_LABEL``;
* cardinality is bounded by MAX_TENANTS (64, the JAX module's
  ``KT_TENANT_MAX`` default): the first MAX_TENANTS distinct tenants
  keep their names, later arrivals collapse into the "~other" bucket —
  so the tenant label can never blow up the metric registry, whatever
  the workload does.

:class:`TenantLedger` accumulates per-tenant: finalized SLO events and
their per-stage latencies, threshold breaches (and the derived
error-budget burn for the event_to_written_p99 objective), member-write
latency and op counts, shed writes, admission deferrals, and flushed
stream rows.  Emissions go to the shared Metrics registry under the
``tenant_*`` families (runtime/metric_catalog.py); the full report is
is :meth:`TenantLedger.summary` (JAX serves it at GET /debug/tenants).

Module-level hooks mirror runtime/slo.py: every call early-outs on one
attribute read when no ledger is installed, so the hot paths
(dispatch success tail, worker enqueue, stream flush) pay nothing by
default.
"""

from __future__ import annotations

import threading
import time
from typing import Optional

from kubeadmiral_tpu_torch.runtime import lockcheck
from kubeadmiral_tpu_torch.runtime.metric_catalog import SLO_OBJECTIVES
from kubeadmiral_tpu_torch.runtime.metrics import Metrics

__all__ = [
    "tenant_of",
    "tenant_of_key",
    "TenantLedger",
    "get_default",
    "set_default",
    "reset_default",
    "active",
    "note_event",
    "note_write",
    "note_shed",
    "note_admission",
    "note_flush",
    "note_scheduled",
]

OTHER = "~other"
CLUSTER_SCOPED = "~cluster"

# The metadata label that names an object's tenant ("" = the namespace)
# and the named tenants a ledger keeps: the JAX module's KT_TENANT_LABEL
# and KT_TENANT_MAX defaults.
TENANT_LABEL = ""
MAX_TENANTS = 64


def tenant_of(namespace: str, labels: Optional[dict] = None) -> str:
    """Tenant identity for an object: the TENANT_LABEL label value
    when configured and present, else the namespace (cluster-scoped
    objects share the "~cluster" tenant)."""
    label = TENANT_LABEL
    if label and labels:
        value = labels.get(label)
        if value:
            return str(value)
    return namespace if namespace else CLUSTER_SCOPED


def tenant_of_key(key: str) -> str:
    """Tenant for a "ns/name" worker/stream key (no labels that deep)."""
    ns, _, rest = key.partition("/")
    return ns if (rest and ns) else CLUSTER_SCOPED


class _TenantStats:
    __slots__ = (
        "events", "breaches", "total_s", "stage_s", "write_ops",
        "write_s", "sheds", "admissions", "rows_flushed", "scheduled",
    )

    def __init__(self):
        self.events = 0
        self.breaches = 0
        self.total_s = 0.0
        self.stage_s: dict[str, float] = {}
        self.write_ops = 0
        self.write_s = 0.0
        self.sheds = 0
        self.admissions = 0
        self.rows_flushed = 0
        self.scheduled = 0


@lockcheck.shared_field_guard
class TenantLedger:
    """Bounded per-tenant accounting (see module docstring)."""

    _shared_fields_ = {"_tenants": "_lock"}

    def __init__(self, metrics: Optional[Metrics] = None,
                 max_tenants: Optional[int] = None):
        self.metrics = metrics if metrics is not None else Metrics()
        self.max_tenants = (
            MAX_TENANTS if max_tenants is None else int(max_tenants)
        )
        spec = SLO_OBJECTIVES["event_to_written_p99"]
        self.e2e_threshold_s = spec.threshold_s
        self.e2e_target = spec.target
        self._lock = lockcheck.make_lock("tenancy")
        self._tenants: dict[str, _TenantStats] = {}

    def attach(self, metrics: Metrics) -> None:
        self.metrics = metrics

    @lockcheck.assumes_held("_lock")
    def _slot_locked(self, tenant: str) -> tuple[str, _TenantStats]:
        """The canonical (possibly "~other"-collapsed) tenant and its
        stats — the single cardinality gate every note_* goes through."""
        stats = self._tenants.get(tenant)
        if stats is None:
            if len(self._tenants) >= self.max_tenants and tenant != OTHER:
                tenant = OTHER
                stats = self._tenants.get(OTHER)
            if stats is None:
                stats = _TenantStats()
                self._tenants[tenant] = stats
        return tenant, stats

    # -- accounting --------------------------------------------------------
    def note_event(self, tenant: str, total_s: float,
                   stages: Optional[dict] = None) -> None:
        """One finalized provenance token (slo.SLORecorder._finalize)."""
        with self._lock:
            tenant, stats = self._slot_locked(tenant)
            stats.events += 1
            stats.total_s += total_s
            breached = total_s > self.e2e_threshold_s
            if breached:
                stats.breaches += 1
            if stages:
                for stage, dur in stages.items():
                    stats.stage_s[stage] = stats.stage_s.get(stage, 0.0) + dur
            burn = self._burn_locked(stats)
        m = self.metrics
        m.counter("tenant_events_total",
                  tenant=tenant, result="bad" if breached else "good")
        m.store("tenant_slo_burn", burn, tenant=tenant)
        if stages:
            for stage, dur in stages.items():
                m.histogram("tenant_stage_seconds", dur,
                            tenant=tenant, stage=stage)

    def note_write(self, tenant: str, seconds: float, ops: int = 1) -> None:
        """Member-write latency attributed to the ops' tenant (the
        dispatch success tail; retries included in ``seconds``)."""
        with self._lock:
            tenant, stats = self._slot_locked(tenant)
            stats.write_ops += ops
            stats.write_s += seconds
        self.metrics.histogram("tenant_write_seconds", seconds, tenant=tenant)

    def note_shed(self, tenant: str, n: int = 1) -> None:
        if n <= 0:
            return
        with self._lock:
            tenant, stats = self._slot_locked(tenant)
            stats.sheds += n
        self.metrics.counter("tenant_shed_writes_total", n, tenant=tenant)

    def note_admission(self, tenant: str, n: int = 1) -> None:
        with self._lock:
            tenant, stats = self._slot_locked(tenant)
            stats.admissions += n
        self.metrics.counter(
            "tenant_admission_deferrals_total", n, tenant=tenant)

    def note_flush(self, tenant: str, rows: int = 1) -> None:
        with self._lock:
            tenant, stats = self._slot_locked(tenant)
            stats.rows_flushed += rows
        self.metrics.counter("tenant_rows_flushed_total", rows, tenant=tenant)

    def note_scheduled(self, tenant: str, n: int = 1) -> None:
        """Objects pushed through the scheduler for this tenant — the
        demand side of the fair-admission picture."""
        with self._lock:
            tenant, stats = self._slot_locked(tenant)
            stats.scheduled += n
        self.metrics.counter("tenant_scheduled_total", n, tenant=tenant)

    # -- read side ---------------------------------------------------------
    @lockcheck.assumes_held("_lock")
    def _burn_locked(self, stats: _TenantStats) -> float:
        """Whole-run error-budget burn of event_to_written_p99 for one
        tenant: (bad fraction) / (allowed bad fraction); 1.0 = spending
        the budget exactly as fast as allowed."""
        if stats.events == 0:
            return 0.0
        budget = max(1e-9, 1.0 - self.e2e_target)
        return (stats.breaches / stats.events) / budget

    def summary(self) -> dict:
        """The GET /debug/tenants payload."""
        with self._lock:
            tenants = {}
            for name, s in sorted(self._tenants.items()):
                tenants[name] = {
                    "events": s.events,
                    "breaches": s.breaches,
                    "slo_burn": round(self._burn_locked(s), 4),
                    "event_total_s": round(s.total_s, 6),
                    "event_mean_s": round(s.total_s / s.events, 6)
                    if s.events else None,
                    "stage_s": {k: round(v, 6)
                                for k, v in sorted(s.stage_s.items())},
                    "write_ops": s.write_ops,
                    "write_s": round(s.write_s, 6),
                    "shed_writes": s.sheds,
                    "admission_deferrals": s.admissions,
                    "rows_flushed": s.rows_flushed,
                    "scheduled": s.scheduled,
                }
            return {
                "generated_at": time.time(),
                "tenant_label": TENANT_LABEL,
                "max_tenants": self.max_tenants,
                "e2e_threshold_s": self.e2e_threshold_s,
                "tenants": tenants,
                "overflowed": OTHER in self._tenants,
            }


# -- process default --------------------------------------------------------
_default: Optional[TenantLedger] = None
_default_lock = threading.Lock()


def get_default() -> Optional[TenantLedger]:
    """The installed ledger or None — attribution is opt-in (the soak
    harness, benches, and tests install one; production embedders may),
    so the default hot-path cost is one module-global read."""
    return _default


def set_default(ledger: Optional[TenantLedger]) -> Optional[TenantLedger]:
    global _default
    with _default_lock:
        prev = _default
        _default = ledger
    return prev


def reset_default() -> None:
    set_default(None)


def active() -> bool:
    return _default is not None


# -- module-level hooks (early-out when no ledger is installed) -------------

def note_event(tenant: str, total_s: float,
               stages: Optional[dict] = None) -> None:
    ledger = _default
    if ledger is not None:
        ledger.note_event(tenant, total_s, stages)


def note_write(tenant: str, seconds: float, ops: int = 1) -> None:
    ledger = _default
    if ledger is not None:
        ledger.note_write(tenant, seconds, ops)


def note_shed(tenant: str, n: int = 1) -> None:
    ledger = _default
    if ledger is not None:
        ledger.note_shed(tenant, n)


def note_admission(tenant: str, n: int = 1) -> None:
    ledger = _default
    if ledger is not None:
        ledger.note_admission(tenant, n)


def note_flush(tenant: str, rows: int = 1) -> None:
    ledger = _default
    if ledger is not None:
        ledger.note_flush(tenant, rows)


def note_scheduled(tenant: str, n: int = 1) -> None:
    ledger = _default
    if ledger is not None:
        ledger.note_scheduled(tenant, n)
