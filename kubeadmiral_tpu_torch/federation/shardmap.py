"""Consistent-hash key→shard routing — the shard-router seam.

A copy of ``kubeadmiral_tpu/federation/shardmap.py`` for the port's
control plane.  Sharding the object space across N engine replicas
needs this seam, shipped with ``shard_count=1`` wired in at the
informer/worker boundary (``runtime/worker.py`` consults
:func:`get_default` on every enqueue).

Routing must be

* **stable across process restarts** — a replica that restarts must
  route every key exactly where its predecessor did, or two replicas
  would both (or neither) own an object mid-failover.  Python's builtin
  ``hash()`` is salted per process, so keys are digested with BLAKE2b;
* **consistent under resharding** — growing ``shard_count`` from N to
  N+1 should move ~1/(N+1) of the keys, not reshuffle the world (every
  moved key costs a relist + re-reconcile on its new owner).  The
  64-bit digest feeds Lamping–Veach jump consistent hashing, which has
  exactly that property with zero routing state.

Arguments (the JAX module's ``KT_SHARD_COUNT`` / ``KT_SHARD_INDEX``;
the port reads no environment variable):

* ``shard_count`` — total engine replicas (default 1: this process
  owns everything and routing is identity);
* ``shard_index`` — this replica's shard (default 0).
"""

from __future__ import annotations

import contextlib
import hashlib
import threading
from typing import Iterator, Optional

_MASK64 = (1 << 64) - 1

# Control-plane broadcast keys: pseudo-keys every replica must process
# regardless of routing (cluster lifecycle is global state — a replica
# that never sees "cluster::pool-a" would keep planning against a
# member that left the fleet).  Prefix-matched, not hashed.
BROADCAST_PREFIXES = ("cluster::",)


def jump_hash(key64: int, buckets: int) -> int:
    """Lamping–Veach jump consistent hash: 64-bit key → bucket in
    [0, buckets).  Growing ``buckets`` by one moves only ~1/buckets of
    the keyspace, always onto the NEW bucket."""
    if buckets <= 1:
        return 0
    b, j = -1, 0
    while j < buckets:
        b = j
        key64 = (key64 * 2862933555777941757 + 1) & _MASK64
        j = int((b + 1) * (float(1 << 31) / float((key64 >> 33) + 1)))
    return b


def key_digest(key: str) -> int:
    """Process-stable 64-bit digest of an object key (BLAKE2b, not the
    per-process-salted builtin ``hash``)."""
    return int.from_bytes(
        hashlib.blake2b(key.encode("utf-8"), digest_size=8).digest(), "big"
    )


class ShardMap:
    """key → shard routing for one replica.

    ``epoch`` is the resize generation: a live resize (``resize()``)
    bumps it, and per-shard snapshot artifacts carry it so a standby
    never restores placements routed under a different shard layout.
    """

    def __init__(
        self,
        shard_count: Optional[int] = None,
        shard_index: Optional[int] = None,
        epoch: int = 0,
    ):
        count = 1 if shard_count is None else shard_count
        index = 0 if shard_index is None else shard_index
        self.shard_count = max(1, count)
        self.shard_index = min(max(0, index), self.shard_count - 1)
        self.epoch = int(epoch)

    def shard_of(self, key: str) -> int:
        if self.shard_count == 1:
            return 0
        if key.startswith(BROADCAST_PREFIXES):
            return self.shard_index
        return jump_hash(key_digest(key), self.shard_count)

    def owns(self, key: str) -> bool:
        """Does THIS replica reconcile ``key``?  The single check the
        informer/worker boundary makes per enqueue; with shard_count=1
        it is one attribute compare (identity routing).  Broadcast
        control keys (``cluster::*``) are owned by every replica."""
        if self.shard_count == 1:
            return True
        if key.startswith(BROADCAST_PREFIXES):
            return True
        return self.shard_of(key) == self.shard_index

    def resize(self, shard_count: int, shard_index: Optional[int] = None) -> "ShardMap":
        """The live-resize step: a NEW map at the next epoch.  Jump
        hashing guarantees N→N+1 moves only ~1/(N+1) of the keyspace
        (always onto the new shard); callers swap the returned map in
        atomically (``set_default``) so no key is double-owned — a key
        is routed by exactly one installed map at any instant."""
        return ShardMap(
            shard_count,
            self.shard_index if shard_index is None else shard_index,
            epoch=self.epoch + 1,
        )

    def moved_keys(self, keys, new: "ShardMap") -> list[str]:
        """Keys of ``keys`` owned HERE under self but not under ``new``
        — the handoff set a resize must re-enqueue on the new owners."""
        return [
            k for k in keys
            if self.owns(k) and not new.owns(k)
            and not k.startswith(BROADCAST_PREFIXES)
        ]

    def describe(self) -> dict:
        """The /debug/shards ownership block for this replica."""
        return {
            "shard_count": self.shard_count,
            "shard_index": self.shard_index,
            "epoch": self.epoch,
            "identity": self.shard_count == 1,
        }


# -- process default -------------------------------------------------------
_default: Optional[ShardMap] = None
_default_lock = threading.Lock()


def get_default() -> ShardMap:
    global _default
    m = _default
    if m is None:
        with _default_lock:
            m = _default
            if m is None:
                m = _default = ShardMap()
    return m


def set_default(shardmap: ShardMap) -> Optional[ShardMap]:
    """Install a map as the process default (tests, embedders);
    returns the previous one."""
    global _default
    with _default_lock:
        prev = _default
        _default = shardmap
    return prev


def reset_default() -> ShardMap:
    """Fresh default map (identity routing)."""
    set_default(ShardMap())
    return get_default()


@contextlib.contextmanager
def scoped(shardmap: ShardMap) -> Iterator[ShardMap]:
    """Install ``shardmap`` as the process default for the duration of
    the block, restoring the previous default on exit.

    This is the in-process replica-set construction seam: workers
    resolve :func:`get_default` ONCE at construction, so building a
    replica's whole controller stack inside ``scoped(ShardMap(n, i))``
    shards every one of its intake boundaries without threading a map
    through each constructor.  NOT safe for concurrent construction of
    two replicas on different threads — construct sequentially (they
    can then RUN concurrently; each holds its own resolved map).
    """
    prev = set_default(shardmap)
    try:
        yield shardmap
    finally:
        set_default(prev if prev is not None else ShardMap())
