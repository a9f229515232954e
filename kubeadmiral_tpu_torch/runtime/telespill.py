"""Crash-durable telemetry spill — the observatory's black box.

Every telemetry surface in this process (the span ring, the timeline,
the flight recorder) lives in memory and dies with the process: a
SIGKILL'd soak victim takes its last seconds to the grave.  This module
periodically persists those surfaces to an append-only segment log in
``TELEMETRY_DIR`` (or the directory a spiller is given), so a successor (or the soak gate, or
``tools/trace_assemble.py``) can recover everything the victim had
fully framed at the instant of death.

Segment format (mirroring ``runtime/snapshot.py`` durability
semantics — CRC-guarded, quarantine on damage, never trust blindly):

* each segment file starts with MAGIC ``KTSPILL1``;
* each record is ``<u32 length><u32 crc32>`` + a JSON payload; records
  are appended and flushed (a SIGKILL loses at most the torn tail of
  the final record — page cache survives process death);
* a reader salvages the longest fully-framed prefix of a damaged
  segment, then renames the file ``*.quarantined`` (kept for
  forensics, never re-read);
* rotation: a segment exceeding its share closes and a new one opens;
  oldest segments are deleted while the directory exceeds
  ``SPILL_BYTES`` (per instance).

Every record envelope carries ``wall`` + ``mono`` clock readings and
the process's trace ``wall_epoch``, so monotonic timeline timestamps
and perf_counter span timestamps can both be mapped onto the shared
wall clock when processes merge.

``ENABLED = False`` disables the module entirely: no files, no thread.
Spilling is opt-in by directory, like the manager's ``snapshot_dir``.
The JAX module reads these knobs from ``KT_*`` variables; the port reads
no environment variable.  See docs/observability.md § Fleet observatory.
"""

from __future__ import annotations

import json
import os
import struct
import threading
import time
import zlib
from typing import Optional

MAGIC = b"KTSPILL1"
_FRAME = struct.Struct("<II")  # payload length, payload crc32

__all__ = [
    "MAGIC",
    "SpillWriter",
    "TelemetrySpiller",
    "spill_enabled",
    "telemetry_dir",
    "read_segment",
    "load_dir",
]


# The JAX module's knobs, as constants with its defaults: the master
# switch (KT_SPILL), the spill directory (KT_TELEMETRY_DIR; None: no
# spilling), the per-instance byte budget (KT_SPILL_BYTES) and the spill
# interval (KT_SPILL_INTERVAL_S).  Constructor arguments override the
# directory, the budget and the interval.
ENABLED = True
TELEMETRY_DIR: Optional[str] = None
SPILL_BYTES = 8 << 20
SPILL_INTERVAL_S = 1.0


def spill_enabled() -> bool:
    """ENABLED: master switch (default on; spilling still requires a
    directory).  Off means zero files and no spiller thread."""
    return bool(ENABLED)


def telemetry_dir() -> Optional[str]:
    return TELEMETRY_DIR or None


def _sanitize(instance: str) -> str:
    return "".join(
        c if c.isalnum() or c in "-_." else "-" for c in instance
    ) or "proc"


class SpillWriter:
    """Bounded append-only CRC-framed segment log for one instance."""

    def __init__(
        self,
        directory: str,
        instance: str = "",
        max_bytes: Optional[int] = None,
        segment_bytes: Optional[int] = None,
        metrics=None,
    ):
        self.enabled = spill_enabled()
        self.dir = directory
        self.instance = _sanitize(instance or f"pid{os.getpid()}")
        self.max_bytes = (
            int(SPILL_BYTES)
            if max_bytes is None else int(max_bytes)
        )
        # Rotation grain: small enough that deleting the oldest segment
        # under byte pressure sheds history in slices, not halves.
        self.segment_bytes = (
            max(4096, self.max_bytes // 8)
            if segment_bytes is None else max(4096, int(segment_bytes))
        )
        self.metrics = metrics
        self._lock = threading.Lock()
        self._fh = None
        self._seq = 0
        self._written = 0  # bytes in the open segment

    def _segment_name(self) -> str:
        return f"spill-{self.instance}-{os.getpid()}-{self._seq:06d}.ktspill"

    def _open_locked(self) -> None:
        os.makedirs(self.dir, exist_ok=True)
        # Never append to a pre-existing file (a previous incarnation's
        # segment, possibly torn): claim the next free sequence number.
        while True:
            path = os.path.join(self.dir, self._segment_name())
            if not os.path.exists(path):
                break
            self._seq += 1
        self._fh = open(path, "wb")
        self._fh.write(MAGIC)
        self._written = len(MAGIC)
        if self.metrics is not None:
            self.metrics.counter("telespill_segment_rotations_total")

    def append(self, kind: str, payload: dict) -> bool:
        """Frame and append one record; returns False when spilling is
        disabled.  The write is flushed to the OS (SIGKILL-durable) but
        not fsynced — the spill protects against process death, not
        power loss, and an fsync per interval would dominate the ≤2%
        overhead budget."""
        if not self.enabled:
            return False
        blob = json.dumps(payload).encode()
        with self._lock:
            if self._fh is None or self._written >= self.segment_bytes:
                self._rotate_locked()
            self._fh.write(_FRAME.pack(len(blob), zlib.crc32(blob)))
            self._fh.write(blob)
            self._fh.flush()
            self._written += _FRAME.size + len(blob)
        if self.metrics is not None:
            self.metrics.counter("telespill_records_total", kind=kind)
            self.metrics.counter(
                "telespill_bytes_written_total",
                value=_FRAME.size + len(blob),
            )
        return True

    def _rotate_locked(self) -> None:
        if self._fh is not None:
            self._fh.close()
            self._fh = None
            self._seq += 1
        self._open_locked()
        self._prune_locked()

    def _prune_locked(self) -> None:
        """Delete oldest segments of THIS instance while the instance's
        total exceeds the byte bound (the open segment never deletes
        itself: at least the newest history always survives)."""
        segs = []
        try:
            for de in os.scandir(self.dir):
                if (
                    de.name.startswith(f"spill-{self.instance}-")
                    and de.name.endswith(".ktspill")
                ):
                    try:
                        segs.append((de.name, de.stat().st_size, de.path))
                    except OSError:
                        continue
        except OSError:
            return
        segs.sort()
        total = sum(size for _, size, _ in segs)
        for name, size, path in segs[:-1]:
            if total <= self.max_bytes:
                break
            try:
                os.unlink(path)
                total -= size
                if self.metrics is not None:
                    self.metrics.counter("telespill_segments_deleted_total")
            except OSError:
                pass

    def close(self) -> None:
        with self._lock:
            if self._fh is not None:
                self._fh.close()
                self._fh = None


# -- read side ---------------------------------------------------------------

def read_segment(
    path: str, quarantine: bool = True, metrics=None
) -> tuple[list[dict], bool]:
    """(records, damaged) — the longest fully-framed prefix of one
    segment.  A bad MAGIC, torn frame, short payload or CRC mismatch
    stops the scan; the damaged file is renamed ``*.quarantined``
    (mirroring snapshot-load semantics) so it is never re-read, but the
    salvaged prefix IS returned — a SIGKILL mid-append must not cost
    the records before the tear."""
    records: list[dict] = []
    damaged = False
    try:
        with open(path, "rb") as fh:
            if fh.read(len(MAGIC)) != MAGIC:
                damaged = True
            else:
                while True:
                    head = fh.read(_FRAME.size)
                    if not head:
                        break  # clean EOF
                    if len(head) < _FRAME.size:
                        damaged = True
                        break
                    length, crc = _FRAME.unpack(head)
                    if length > 64 << 20:
                        damaged = True  # implausible frame: corruption
                        break
                    blob = fh.read(length)
                    if len(blob) != length or zlib.crc32(blob) != crc:
                        damaged = True
                        break
                    try:
                        records.append(json.loads(blob))
                    except ValueError:
                        damaged = True
                        break
    except OSError:
        return [], True
    if damaged and quarantine:
        try:
            os.replace(path, path + ".quarantined")
        except OSError:
            pass
        if metrics is not None:
            metrics.counter("telespill_quarantined_total")
    return records, damaged


def load_dir(
    directory: str, quarantine: bool = True, metrics=None
) -> list[dict]:
    """Every salvageable record in a spill directory, in (instance,
    segment, append) order.  Quarantined files are skipped; damaged
    segments are quarantined on the way (unless ``quarantine=False``,
    for purely read-only consumers)."""
    names = []
    try:
        for de in os.scandir(directory):
            if de.name.endswith(".ktspill"):
                names.append((de.name, de.path))
    except OSError:
        return []
    out: list[dict] = []
    for _, path in sorted(names):
        records, _ = read_segment(path, quarantine=quarantine, metrics=metrics)
        out.extend(records)
    return out


# -- the periodic spiller -----------------------------------------------------

class TelemetrySpiller:
    """Periodically persists the process's telemetry surfaces:

    * ``spans`` records — the span-ring delta since the last spill
      (span ids are monotonic per tracer, so the delta is a cheap id
      cut), with the perf_counter wall anchor;
    * ``timeline`` records — the raw-tier bucket delta (by bucket end
      time), with the mono→wall anchor;
    * ``flightrec`` records — the decision ring summary (small;
      last-writer-wins on read).

    ``spill_now()`` is also the explicit hook the soak victim calls at
    the end of each round — the crash-durability contract is "whatever
    the last spill_now saw survives SIGKILL".
    """

    def __init__(
        self,
        directory: Optional[str] = None,
        instance: str = "",
        metrics=None,
        tracer=None,
        timeline=None,
        flightrec=None,
        interval_s: Optional[float] = None,
        max_bytes: Optional[int] = None,
    ):
        directory = directory or telemetry_dir()
        self.enabled = spill_enabled() and directory is not None
        self.instance = _sanitize(instance or f"pid{os.getpid()}")
        self.interval_s = (
            float(SPILL_INTERVAL_S)
            if interval_s is None else float(interval_s)
        )
        self.metrics = metrics
        self._tracer = tracer
        self._timeline = timeline
        self._flightrec = flightrec
        self._writer = (
            SpillWriter(
                directory, instance=self.instance, metrics=metrics,
                max_bytes=max_bytes,
            )
            if self.enabled else None
        )
        self._last_span_id = 0
        self._last_tl_t = float("-inf")
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()

    def _envelope(self, kind: str) -> dict:
        from kubeadmiral_tpu_torch.runtime import trace as trace_mod

        return {
            "kind": kind,
            "instance": self.instance,
            "pid": os.getpid(),
            "wall": time.time(),
            "mono": time.monotonic(),
            "wall_epoch": trace_mod.wall_epoch(),
        }

    # -- one pass ---------------------------------------------------------
    def spill_now(self) -> int:
        """Persist the deltas; returns the number of records written."""
        if not self.enabled or self._writer is None:
            return 0
        wrote = 0
        wrote += self._spill_spans()
        wrote += self._spill_timeline()
        wrote += self._spill_flightrec()
        return wrote

    def _spill_spans(self) -> int:
        from kubeadmiral_tpu_torch.runtime import trace as trace_mod

        tracer = self._tracer or trace_mod.get_default()
        fresh = []
        newest = self._last_span_id
        for sp in tracer.spans():
            if sp.span_id <= self._last_span_id:
                continue
            newest = max(newest, sp.span_id)
            fresh.append(
                {
                    "name": sp.name,
                    "span_id": sp.span_id,
                    "parent_id": sp.parent_id,
                    "trace_id": sp.trace_id,
                    "start": sp.start,
                    "end": sp.end,
                    "tid": sp.tid,
                    "thread_name": sp.thread_name,
                    "args": sp.args,
                }
            )
        if not fresh:
            return 0
        env = self._envelope("spans")
        env["spans"] = fresh
        if self._writer.append("spans", env):
            self._last_span_id = newest
            return 1
        return 0

    def _spill_timeline(self) -> int:
        from kubeadmiral_tpu_torch.runtime import timeline as timeline_mod

        tl = self._timeline or timeline_mod.get_default()
        if tl is None or not getattr(tl, "enabled", False):
            return 0
        doc = tl.to_doc(tier="raw")
        raw = (doc.get("tiers") or {}).get("raw") or {}
        series_out: dict[str, dict] = {}
        newest = self._last_tl_t
        for key, series in (raw.get("series") or {}).items():
            points = [
                p for p in series.get("points") or []
                if p[0] > self._last_tl_t
            ]
            if points:
                newest = max(newest, max(p[0] for p in points))
                series_out[key] = {"kind": series.get("kind"), "points": points}
        if not series_out:
            return 0
        env = self._envelope("timeline")
        env["interval_s"] = doc.get("interval_s")
        env["series"] = series_out
        if self._writer.append("timeline", env):
            self._last_tl_t = newest
            return 1
        return 0

    def _spill_flightrec(self) -> int:
        rec = self._flightrec
        if rec is None:
            from kubeadmiral_tpu_torch.runtime import flightrec as flightrec_mod

            rec = flightrec_mod.get_default()
        if rec is None or not getattr(rec, "enabled", True):
            return 0
        try:
            summary = rec.decisions()
        except Exception:
            return 0
        if not (summary.get("ticks") or summary.get("recent")):
            # An empty ring spills nothing (keeps spill-off parity
            # tests honest: no decisions -> no flightrec records).
            if not any(v for v in summary.values() if isinstance(v, list)):
                return 0
        env = self._envelope("flightrec")
        env["summary"] = summary
        return 1 if self._writer.append("flightrec", env) else 0

    # -- background thread ------------------------------------------------
    def start(self) -> bool:
        if not self.enabled or self.interval_s <= 0 or self._thread is not None:
            return False
        self._stop.clear()
        t = threading.Thread(
            target=self._run, name="kt-telespill", daemon=True
        )
        self._thread = t
        t.start()
        return True

    def stop(self, final_spill: bool = True) -> None:
        t = self._thread
        if t is not None:
            self._stop.set()
            t.join(timeout=5.0)
            self._thread = None
        if final_spill:
            try:
                self.spill_now()
            except Exception:
                pass
        if self._writer is not None:
            self._writer.close()

    def _run(self) -> None:
        while not self._stop.wait(self.interval_s):
            try:
                self.spill_now()
            except Exception:
                pass  # a failing spill must never take the process down
