"""Leader election over a lease object in the host store.

The reference elects one controller-manager replica through a
resourcelock lease in the federation system namespace; losing the lease
is fatal to the process (reference:
pkg/controllermanager/leaderelection/leaderelection.go).  Here the lock
is a plain object in the host store updated under optimistic
concurrency: acquire when absent or expired, renew while held, and
report loss when another identity overwrites an expired lease.
"""

from __future__ import annotations

import time
from typing import Callable, Optional

from kubeadmiral_tpu_torch.testing.fakekube import AlreadyExists, Conflict, FakeKube, NotFound

LEASES = "coordination.k8s.io/v1/leases"

DEFAULT_LEASE_SECONDS = 15.0


def shard_lease_name(shard_index: int) -> str:
    """Lease object name for one shard of the sharded control plane.
    N replicas each run an elector against their own ``kt-shard-<i>``
    lease, so shard ownership is disjoint by construction: the jump-hash
    router decides WHICH keys a shard owns, the per-shard lease decides
    WHICH replica owns the shard."""
    return f"kt-shard-{shard_index}"


def shard_elector(
    host: FakeKube,
    identity: str,
    shard_index: int,
    **kw,
) -> LeaderElector:
    """A LeaderElector over the shard's ``kt-shard-<i>`` lease."""
    return LeaderElector(
        host, identity, name=shard_lease_name(shard_index), **kw
    )


def shard_lease_status(
    host: FakeKube,
    shard_count: int,
    namespace: str = "kube-admiral-system",
    clock: Callable[[], float] = time.monotonic,
) -> list:
    """Ownership/freshness of every shard lease, for /debug/shards.

    One row per shard: ``{shard, lease, holder, age_s, fresh}`` where
    ``holder`` is None when the lease is absent or released and
    ``fresh`` means the holder renewed within its lease duration (a
    stale row is a shard whose replica died and whose standby has not
    taken over yet — exactly the failover gap the soak gate bounds)."""
    rows = []
    now = clock()
    for i in range(shard_count):
        name = shard_lease_name(i)
        lease = host.try_get(LEASES, f"{namespace}/{name}") or {}
        spec = lease.get("spec", {})
        holder = spec.get("holderIdentity") or None
        renewed = float(spec.get("renewTime", 0.0))
        duration = float(spec.get("leaseDurationSeconds", DEFAULT_LEASE_SECONDS))
        age = now - renewed if holder is not None else None
        rows.append(
            {
                "shard": i,
                "lease": name,
                "holder": holder,
                "age_s": round(age, 3) if age is not None else None,
                "fresh": holder is not None and age is not None and age <= duration,
            }
        )
    return rows


class LeaderElector:
    def __init__(
        self,
        host: FakeKube,
        identity: str,
        name: str = "kubeadmiral-controller-manager",
        namespace: str = "kube-admiral-system",
        lease_seconds: float = DEFAULT_LEASE_SECONDS,
        on_stopped_leading: Optional[Callable[[], None]] = None,
        clock: Callable[[], float] = time.monotonic,
    ):
        self.host = host
        self.identity = identity
        self.name = name
        self.namespace = namespace
        self.lease_seconds = lease_seconds
        self.on_stopped_leading = on_stopped_leading
        self.clock = clock
        self.is_leader = False

    @property
    def _key(self) -> str:
        return f"{self.namespace}/{self.name}"

    def _lease_expired(self, lease: dict) -> bool:
        renewed = float(lease.get("spec", {}).get("renewTime", 0.0))
        duration = float(
            lease.get("spec", {}).get("leaseDurationSeconds", self.lease_seconds)
        )
        return self.clock() - renewed > duration

    def try_acquire_or_renew(self) -> bool:
        """One election round; call periodically (≲ lease_seconds/3).
        Returns True while this identity holds the lease."""
        now = self.clock()
        desired_spec = {
            "holderIdentity": self.identity,
            "leaseDurationSeconds": self.lease_seconds,
            "renewTime": now,
        }
        lease = self.host.try_get(LEASES, self._key)
        try:
            if lease is None:
                self.host.create(
                    LEASES,
                    {
                        "apiVersion": "coordination.k8s.io/v1",
                        "kind": "Lease",
                        "metadata": {"name": self.name, "namespace": self.namespace},
                        "spec": desired_spec,
                    },
                )
                self._became(True)
                return True
            holder = lease.get("spec", {}).get("holderIdentity")
            if holder != self.identity and not self._lease_expired(lease):
                self._became(False)
                return False
            lease["spec"] = desired_spec
            self.host.update(LEASES, lease)
            self._became(True)
            return True
        except (Conflict, AlreadyExists, NotFound):
            # Someone else won the race this round.
            self._became(False)
            return False

    def release(self) -> bool:
        """Graceful handoff (the SIGTERM path): zero the lease's
        renewTime so a standby's next election round acquires
        immediately instead of waiting out the full lease duration —
        the k8s resourcelock ReleaseOnCancel behavior.  Best-effort:
        returns False when the lease is not ours (or already gone),
        which is fine — the successor then waits out the expiry."""
        if not self.is_leader:
            return False
        try:
            lease = self.host.try_get(LEASES, self._key)
            if (
                lease is None
                or lease.get("spec", {}).get("holderIdentity") != self.identity
            ):
                self._became(False)
                return False
            lease["spec"] = {
                "holderIdentity": "",
                "leaseDurationSeconds": self.lease_seconds,
                "renewTime": 0.0,
            }
            self.host.update(LEASES, lease)
        except (Conflict, AlreadyExists, NotFound):
            self._became(False)
            return False
        self._became(False)
        return True

    def _became(self, leading: bool) -> None:
        if self.is_leader and not leading and self.on_stopped_leading is not None:
            self.on_stopped_leading()
        self.is_leader = leading
