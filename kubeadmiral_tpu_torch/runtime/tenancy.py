"""Per-tenant attribution: the bounded-cardinality tenant dimension.

The part of ``kubeadmiral_tpu/runtime/tenancy.py`` that the worker and
the scheduler controller call.  Tenancy is namespace-derived: a
"ns/name" key's tenant is its namespace ("~cluster" for cluster-scoped
objects).  An installed :class:`TenantLedger` counts, per tenant,
admission deferrals (the worker) and objects scheduled (the scheduler
controller), with at most MAX_TENANTS named tenants: later arrivals
collapse into the "~other" bucket, so the tenant label can never blow
up the metric registry.

Left out until the member half is ported, since nothing on the
scheduling path reaches them: the tenant label (``KT_TENANT_LABEL``;
keys carry no labels, so it plays no part in :func:`tenant_of_key`),
the SLO event, member-write, shed and flush accounting, and the
``/debug/tenants`` summary.  ``KT_TENANT_MAX`` is MAX_TENANTS, JAX's
default.

Module-level hooks early-out on one attribute read when no ledger is
installed (the default), so the hot paths pay nothing.
"""

from __future__ import annotations

import threading
from typing import Optional

from kubeadmiral_tpu_torch.runtime import lockcheck
from kubeadmiral_tpu_torch.runtime.metrics import Metrics

OTHER = "~other"
CLUSTER_SCOPED = "~cluster"

# Named tenants a ledger keeps (the JAX module's KT_TENANT_MAX default).
MAX_TENANTS = 64


def tenant_of_key(key: str) -> str:
    """Tenant for a "ns/name" worker/stream key."""
    ns, _, rest = key.partition("/")
    return ns if (rest and ns) else CLUSTER_SCOPED


class _TenantStats:
    __slots__ = ("admissions", "scheduled")

    def __init__(self):
        self.admissions = 0
        self.scheduled = 0


@lockcheck.shared_field_guard
class TenantLedger:
    """Bounded per-tenant accounting (see module docstring)."""

    _shared_fields_ = {"_tenants": "_lock"}

    def __init__(self, metrics: Optional[Metrics] = None):
        self.metrics = metrics if metrics is not None else Metrics()
        self._lock = lockcheck.make_lock("tenancy")
        self._tenants: dict[str, _TenantStats] = {}

    @lockcheck.assumes_held("_lock")
    def _slot_locked(self, tenant: str) -> tuple[str, _TenantStats]:
        """The canonical (possibly "~other"-collapsed) tenant and its
        stats — the single cardinality gate every note_* goes through."""
        stats = self._tenants.get(tenant)
        if stats is None:
            if len(self._tenants) >= MAX_TENANTS and tenant != OTHER:
                tenant = OTHER
                stats = self._tenants.get(OTHER)
            if stats is None:
                stats = _TenantStats()
                self._tenants[tenant] = stats
        return tenant, stats

    def note_admission(self, tenant: str, n: int = 1) -> None:
        with self._lock:
            tenant, stats = self._slot_locked(tenant)
            stats.admissions += n
        self.metrics.counter(
            "tenant_admission_deferrals_total", n, tenant=tenant)

    def note_scheduled(self, tenant: str, n: int = 1) -> None:
        """Objects pushed through the scheduler for this tenant — the
        demand side of the fair-admission picture."""
        with self._lock:
            tenant, stats = self._slot_locked(tenant)
            stats.scheduled += n
        self.metrics.counter("tenant_scheduled_total", n, tenant=tenant)


# -- process default --------------------------------------------------------
_default: Optional[TenantLedger] = None
_default_lock = threading.Lock()


def get_default() -> Optional[TenantLedger]:
    """The installed ledger or None — attribution is opt-in, so the
    default hot-path cost is one module-global read."""
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

def note_admission(tenant: str, n: int = 1) -> None:
    ledger = _default
    if ledger is not None:
        ledger.note_admission(tenant, n)


def note_scheduled(tenant: str, n: int = 1) -> None:
    ledger = _default
    if ledger is not None:
        ledger.note_scheduled(tenant, n)
