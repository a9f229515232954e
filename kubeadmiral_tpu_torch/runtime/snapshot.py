"""Durable engine snapshots: crash-safe engine state.

A copy of ``SnapshotStore`` and ``SnapshotManager`` from
``kubeadmiral_tpu/runtime/snapshot.py`` for the port's engine.  What the
apiserver does not hold is the engine's device-side working set: the
per-chunk prev planes (placements / scores / feasibility / reasons), the
adaptive pack-K hints and the flight recorder — everything that lets a
tick ride the no-op / drift-gate / sub-batch fast paths instead of a cold
full solve.  This module persists exactly that:

* :class:`SnapshotStore` — one file per snapshot, written write-temp +
  fsync + rename (atomic on POSIX), CRC-guarded, monotonic tick id in
  the name and header.  Load walks newest-first; a torn, truncated or
  CRC-failing file is **quarantined** (renamed ``*.quarantined``) and
  never loaded — the loader falls back to the next older snapshot, or
  to cold.  A version mismatch quarantines too: a snapshot is never
  trusted blindly.  The payload write (``_write_payload``) and the
  rename (``_publish``) are methods of their own, the two points a
  crash test cuts (``testing/restart_driver.py``).

* :class:`SnapshotManager` — wires a ``SchedulerEngine`` to a store:
  after each converged tick (every ``every``-th state-changing tick) it
  captures the engine's host-side image plus the flight recorder state
  and persists them; on boot, :meth:`restore` stages the newest valid
  snapshot into the engine (consumed at the first ``schedule()`` call)
  and restores the recorder immediately.

Restore semantics (enforced inside the engine,
``SchedulerEngine._consume_restore``): a snapshot whose cluster tensors
are bit-identical to the relist resumes through the per-row signature
walk onto the no-op replay (no kernel launch); a stale-but-recent
snapshot keeps the restored planes as ``prev`` state and the first tick
re-solves only changed rows (sub-batch) and drifted columns (drift
gate); any structural mismatch — topology, geometry, engine config —
falls back to cold for the affected chunks.  Every outcome lands in
``engine_snapshot_total{result}``.

The JAX module's knobs are arguments here with its defaults: the
directory (no default: snapshots are opt-in), ``every`` (1) and ``keep``
(2); the port reads no environment variable.  ``breakers`` is an
optional registry with ``export_state`` / ``restore_state``
(``transport/breaker.py``'s ``BreakerRegistry``).
"""

from __future__ import annotations

import logging
import os
import pickle
import struct
import threading
import time
import zlib
from typing import Callable, Optional

log = logging.getLogger("kubeadmiral.snapshot")

MAGIC = b"KTSNAP01"
SNAPSHOT_VERSION = 1
_HEADER_FMT = "<Q"  # header-json byte length


def shard_snapshot_store(
    base_dir: str, shard, keep: int = 2, metrics=None
) -> "SnapshotStore":
    """A :class:`SnapshotStore` scoped to one shard of the sharded
    control plane: ``<base_dir>/shard-<i>/``.  Each replica persists
    only its own keys' working set, so a standby taking over shard i
    restores shard i's artifact without ever seeing (or trusting)
    another shard's planes.  The shard identity also rides in the
    payload (see SnapshotManager ``shard=``) and is validated at
    restore — directory layout is convenience, the payload guard is
    the contract."""
    return SnapshotStore(
        os.path.join(base_dir, f"shard-{shard.shard_index}"),
        keep=keep,
        metrics=metrics,
    )


class SnapshotStore:
    """Atomic, CRC-guarded snapshot files in one directory."""

    def __init__(self, directory: str, keep: int = 2, metrics=None):
        self.dir = directory
        self.keep = max(1, keep)
        self.metrics = metrics
        self._lock = threading.Lock()
        self.last_write_s = 0.0
        self.last_bytes = 0

    def _count(self, result: str) -> None:
        if self.metrics is not None:
            self.metrics.counter("engine_snapshot_total", result=result)

    @staticmethod
    def _name(tick: int) -> str:
        return f"snap-{tick:012d}.ktsnap"

    # -- write ------------------------------------------------------------
    def save(self, tick: int, payload: dict) -> str:
        """Persist one snapshot: MAGIC + header(tick, crc, length) +
        pickled payload, written to a temp file, fsynced, renamed.  A
        reader can never observe a half-written snapshot under POSIX
        rename atomicity; a crash before the rename leaves only a temp
        file the loader ignores."""
        t0 = time.perf_counter()
        blob = pickle.dumps(payload, protocol=4)
        header = {
            "version": SNAPSHOT_VERSION,
            "tick": int(tick),
            "crc": zlib.crc32(blob),
            "payload_len": len(blob),
            "wall": time.time(),
        }
        hjson = pickle.dumps(header, protocol=4)
        with self._lock:
            os.makedirs(self.dir, exist_ok=True)
            final = os.path.join(self.dir, self._name(tick))
            tmp = os.path.join(self.dir, f".snap-{tick}.tmp.{os.getpid()}")
            with open(tmp, "wb") as fh:
                fh.write(MAGIC)
                fh.write(struct.pack(_HEADER_FMT, len(hjson)))
                fh.write(hjson)
                self._write_payload(fh, blob)
            self._publish(tmp, final)
            self._fsync_dir()
            self._prune_locked()
        self.last_write_s = time.perf_counter() - t0
        self.last_bytes = len(blob)
        if self.metrics is not None:
            self.metrics.histogram(
                "engine_snapshot_write_seconds", self.last_write_s
            )
            self.metrics.store("engine_snapshot_bytes", self.last_bytes)
        self._count("written")
        log.debug(
            "snapshot written: tick=%d bytes=%d write_ms=%.1f",
            tick, self.last_bytes, self.last_write_s * 1e3,
        )
        return final

    @staticmethod
    def _write_payload(fh, blob: bytes) -> None:
        """The payload bytes, flushed and fsynced before the rename."""
        fh.write(blob)
        fh.flush()
        os.fsync(fh.fileno())

    @staticmethod
    def _publish(tmp: str, final: str) -> None:
        """The atomic rename that makes a written snapshot loadable."""
        os.replace(tmp, final)

    def _fsync_dir(self) -> None:
        try:
            fd = os.open(self.dir, os.O_RDONLY)
            try:
                os.fsync(fd)
            finally:
                os.close(fd)
        except OSError:
            pass  # non-POSIX-durable dir: the rename still happened

    def _prune_locked(self) -> None:
        snaps = sorted(self._list())
        for _, path in snaps[: -self.keep]:
            try:
                os.unlink(path)
            except OSError:
                pass
        # Stale temp files from crashed writers.
        try:
            for de in os.scandir(self.dir):
                if de.name.startswith(".snap-") and ".tmp." in de.name:
                    try:
                        os.unlink(de.path)
                    except OSError:
                        pass
        except OSError:
            pass

    # -- read -------------------------------------------------------------
    def _list(self) -> list[tuple[int, str]]:
        out = []
        try:
            for de in os.scandir(self.dir):
                name = de.name
                if name.startswith("snap-") and name.endswith(".ktsnap"):
                    try:
                        out.append((int(name[5:-7]), de.path))
                    except ValueError:
                        continue
        except OSError:
            pass
        return out

    def quarantine(self, path: str, why: str) -> None:
        """A snapshot that failed validation is renamed aside — kept for
        forensics, never loadable again — and counted."""
        qpath = path + ".quarantined"
        try:
            os.replace(path, qpath)
        except OSError:
            qpath = "(unlinkable)"
        log.warning("snapshot quarantined: %s -> %s (%s)", path, qpath, why)
        self._count("quarantined")

    def load_latest(self) -> Optional[tuple[dict, dict]]:
        """(header, payload) of the newest VALID snapshot, quarantining
        any corrupt/mismatched file found on the way; None = cold."""
        for tick, path in sorted(self._list(), reverse=True):
            try:
                with open(path, "rb") as fh:
                    magic = fh.read(len(MAGIC))
                    if magic != MAGIC:
                        raise ValueError("bad magic")
                    (hlen,) = struct.unpack(
                        _HEADER_FMT, fh.read(struct.calcsize(_HEADER_FMT))
                    )
                    if hlen > 1 << 20:
                        raise ValueError("implausible header length")
                    header = pickle.loads(fh.read(hlen))
                    if header.get("version") != SNAPSHOT_VERSION:
                        raise ValueError(
                            f"version {header.get('version')} != "
                            f"{SNAPSHOT_VERSION}"
                        )
                    blob = fh.read(header["payload_len"])
                    if len(blob) != header["payload_len"]:
                        raise ValueError("truncated payload")
                    if zlib.crc32(blob) != header["crc"]:
                        raise ValueError("payload CRC mismatch")
                    payload = pickle.loads(blob)
            except Exception as e:
                self.quarantine(path, repr(e))
                continue
            return header, payload
        return None


class SnapshotManager:
    """Engine <-> store glue: periodic capture after converged ticks,
    staged restore on boot.  ``breakers`` (a registry with
    ``export_state`` / ``restore_state``) and ``flightrec`` (a
    FlightRecorder; "engine" takes the engine's own) ride along when
    provided; the ``watermark_fn`` callable supplies the per-kind
    resourceVersion watermarks recorded with each snapshot (and compared
    at restore)."""

    def __init__(
        self,
        engine,
        store: SnapshotStore,
        every: int = 1,
        breakers=None,
        flightrec="engine",
        watermark_fn: Optional[Callable[[], dict]] = None,
        shard=None,
    ):
        self.engine = engine
        self.store = store
        # Sharded control plane: when a ShardMap is supplied, every
        # snapshot is keyed by (shard_count, shard_index, epoch) and
        # restore REFUSES a mismatched artifact (cold boot instead) —
        # a resize bumps the epoch, so planes captured under the old
        # key→shard routing are never replayed into the new one.
        self.shard = shard
        self.every = max(1, every)
        self.breakers = breakers
        self.flightrec = (
            getattr(engine, "flightrec", None) if flightrec == "engine" else flightrec
        )
        self.watermark_fn = watermark_fn
        self._last_snap_tick = 0
        self._ticks_since = 0
        self.last_result: Optional[str] = None
        # Engine hook: called at the end of every schedule() while the
        # schedule lock is still held, so the captured planes are the
        # converged tick's, not a racing successor's.
        engine.post_tick = self.maybe_snapshot

    # -- capture ----------------------------------------------------------
    def maybe_snapshot(self, engine) -> None:
        changed = engine.last_changed is None or bool(engine.last_changed)
        if not changed and self._last_snap_tick:
            return  # a no-op tick over already-persisted state
        self._ticks_since += 1
        if self._ticks_since < self.every and self._last_snap_tick:
            return
        self.snapshot()

    def snapshot(self) -> Optional[str]:
        state = self.engine.snapshot_state()
        if state is None:
            self.store._count("skipped")
            self.last_result = "skipped"
            return None
        payload = {
            "version": SNAPSHOT_VERSION,
            "engine": state,
            "shard": self._shard_key(),
            "watermarks": self.watermark_fn() if self.watermark_fn else None,
            "breakers": (
                self.breakers.export_state() if self.breakers is not None else None
            ),
            "flightrec": (
                self.flightrec.export_state()
                if self.flightrec is not None and self.flightrec.enabled
                else None
            ),
        }
        path = self.store.save(self.engine.tick_seq, payload)
        self._last_snap_tick = self.engine.tick_seq
        self._ticks_since = 0
        self.last_result = "written"
        return path

    def _shard_key(self) -> Optional[dict]:
        if self.shard is None:
            return None
        return {
            "shard_count": self.shard.shard_count,
            "shard_index": self.shard.shard_index,
            "epoch": self.shard.epoch,
        }

    # -- restore ----------------------------------------------------------
    def restore(self, watermarks: Optional[dict] = None) -> str:
        """Stage the newest valid snapshot into the engine (consumed at
        its next tick) and restore the flight recorder (and breakers)
        now.  Returns "staged" | "cold" (nothing valid on disk)."""
        loaded = self.store.load_latest()
        if loaded is None:
            self.last_result = "cold"
            return "cold"
        header, payload = loaded
        want = self._shard_key()
        if want is not None and payload.get("shard") != want:
            # Wrong shard identity or a pre-resize epoch: the artifact's
            # planes were captured under a different key→shard routing.
            # Never stage it — cold boot.
            self.store._count("shard_mismatch")
            self.last_result = "cold"
            log.warning(
                "snapshot shard mismatch: artifact=%s replica=%s (cold boot)",
                payload.get("shard"), want,
            )
            return "cold"
        if watermarks is None and self.watermark_fn is not None:
            watermarks = self.watermark_fn()
        snap_marks = payload.get("watermarks")
        fresh_marks = (
            watermarks is not None
            and snap_marks is not None
            and watermarks == snap_marks
        )
        self.engine.stage_restore(
            payload.get("engine"), assume_fresh=fresh_marks
        )
        if self.breakers is not None and payload.get("breakers"):
            self.breakers.restore_state(payload["breakers"])
        if self.flightrec is not None and payload.get("flightrec"):
            try:
                self.flightrec.restore_state(payload["flightrec"])
            except Exception:
                log.warning("flight-recorder restore failed", exc_info=True)
        self.last_result = "staged"
        log.info(
            "snapshot staged for restore: tick=%d watermarks=%s",
            header.get("tick", 0),
            "match" if fresh_marks else "stale-or-unknown",
        )
        return "staged"
