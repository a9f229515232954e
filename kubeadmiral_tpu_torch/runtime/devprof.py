"""Device-time attribution: the dispatch ledger + on-demand profiler.

A copy of ``kubeadmiral_tpu/runtime/devprof.py`` on CUDA events.  Every
stage number the engine reports is a host-side ``perf_counter``
interval, which conflates device compute with dispatch backpressure — a
pipelined tick can spend seconds of its "decode" stage blocked behind
queued device work and the stage histograms cannot say so.  This module
turns "the tick took X ms" into "program P at shape S occupied the
device for Y ms and waited Z ms in queue":

* **Dispatch ledger** (:class:`DispatchLedger`).  Every device program
  the engine enqueues is followed by :meth:`DispatchLedger.observe`
  with the program kind and the program's output.  For an output on
  the card the hot path records one ``torch.cuda.Event`` (no timing
  flag) on the current stream, a ``perf_counter`` timestamp and a deque
  append — the ledger stays on, ``enabled=False`` disables.  A daemon
  watcher thread waits on each record's event IN DISPATCH ORDER
  (``event.synchronize()``, the counterpart of JAX's
  ``block_until_ready``, which pins no tensor), stamps ``ready`` with
  ``perf_counter`` and applies the single-stream chain model —

      start_i   = max(dispatch_ts_i, ready_ts_{i-1})
      device_s  = ready_ts_i - start_i
      queue_s   = start_i - dispatch_ts_i

  which is exact for an in-order device queue (the engine enqueues
  every program on one stream): ``device_s`` is the time the program
  actually occupied the device, ``queue_s`` the time it sat enqueued
  behind earlier work.  An output on the CPU has run by the time it is
  observed, so it is ready at its observation (device_s 0).  Records
  dispatched while no tick is open (the prewarm thread) land in a
  bounded "untracked" ring.

* **Per-tick waterfalls.**  The engine brackets each ``schedule()``
  call with :meth:`begin_tick`/:meth:`end_tick`; the resulting
  waterfall (ordered dispatch records with the host-side stage split
  attached) is served at ``GET /debug/waterfall``.

* **On-demand ``torch.profiler`` capture**
  (:func:`capture_device_profile`).  ``GET
  /debug/profile?seconds=N&mode=device`` runs a profiler with CPU and
  CUDA activities around live ticks for N seconds and writes its Chrome
  trace under ``PROFILE_DIR``.

The JAX module's knobs are constants here with its defaults: ``ENABLED``
(``KT_DEVPROF``), ``RING_TICKS`` (``KT_DEVPROF_TICKS``) and
``PROFILE_DIR`` (``KT_PROFILE_DIR``; the JAX default names its profiler,
this one ``/tmp/kt-torch-profile``).
"""

from __future__ import annotations

import dataclasses
import os
import threading
import time
from collections import deque
from typing import Optional

import torch

# Known program kinds (the engine's central wrappers): documented in
# docs/observability.md so waterfall readers have one vocabulary.
PROGRAM_KINDS = (
    "tick",            # fused dense/compact tick (full-width solve + diff)
    "tick_narrow",     # narrow tick (phase 1 + top-M candidate solve + cert)
    "narrow_fallback", # dense re-solve of certificate-failed narrow rows
    "gate",            # drift gate (row classification from cached planes)
    "wcheck",          # drift dynamic-weight comparison
    "resolve",         # sort-free drift survivor resolve
    "replan",          # selection-known replan of kinf fit-flip survivors
    "scoreonly",       # score-only narrow solve of finite-K fit-flip rows
    "survivor",        # UNIFIED drift-survivor kernel (subsumes the three
    #                    above; KT_SURVIVOR_UNIFIED)
    "nfeas",           # cached per-row feasible-count reduce (store-site
    #                    companion of prev_feas; kills the gate's pf.sum)
    "tiebreak",        # precomputed planner tie-break plane (full/patch)
    "gather",          # delta-row plane gathers (dense wire)
    "pack",            # packed-export wire compaction (gather/full)
    "overflow",        # K-overflow bit-packed row re-fetch gather
    "repair",          # in-place prev-plane / narrow-output scatter repair
    "patch",           # stale-row device input scatter repair
    "stack",           # window-drain same-shape transfer stacking
    "zeros",           # device-resident zero prev-plane builders
    "score_pack",      # f16 score-plane compress / upcast (KT_SCORE_F16)
)

_UNTRACKED_RING = 4096

# The ledger's switch and the closed ticks it keeps, and the root of the
# profiler's artifacts (the JAX module's KT_DEVPROF, KT_DEVPROF_TICKS and
# KT_PROFILE_DIR, with their defaults but for the directory's name).
ENABLED = True
RING_TICKS = 8
PROFILE_DIR = "/tmp/kt-torch-profile"


class DispatchRecord:
    __slots__ = (
        "seq", "tick", "kind", "shape", "t_dispatch", "t_ready",
        "queue_s", "device_s", "note", "device",
    )

    def __init__(self, seq: int, tick: Optional[int], kind: str):
        self.seq = seq
        self.tick = tick
        self.kind = kind
        self.shape = ""
        self.t_dispatch = time.perf_counter()
        self.t_ready: Optional[float] = None
        self.queue_s = 0.0
        self.device_s = 0.0
        self.note = "ok"
        # Which device the dispatched output resides on: "d<index>" of
        # a CUDA device, "d0" for the CPU (as JAX labels its CPU
        # device).  The label rides engine_device_seconds /
        # engine_queue_wait_seconds and the waterfall rows.
        self.device = "?"


class _TickEntry:
    __slots__ = (
        "tick", "t0", "t1", "meta", "stage_s", "records", "closed",
        "owner",
    )

    def __init__(self, tick: int, meta: dict):
        self.tick = tick
        self.t0 = time.perf_counter()
        self.t1: Optional[float] = None
        self.meta = meta
        self.stage_s: dict = {}
        self.records: list[DispatchRecord] = []
        self.closed = False
        # Dispatches are attributed to this tick only from the thread
        # that opened the bracket: a concurrent prewarm thread's
        # programs must not pollute a live tick's waterfall.
        self.owner = threading.get_ident()


def _tensors(out, depth: int = 0):
    """The tensors of a program's output: a tensor, or tensors inside
    tuples, lists, dicts and dataclasses (the engine's output records)."""
    if isinstance(out, torch.Tensor):
        yield out
    elif depth > 3 or out is None:
        return
    elif isinstance(out, (tuple, list)):
        for x in out:
            yield from _tensors(x, depth + 1)
    elif isinstance(out, dict):
        for x in out.values():
            yield from _tensors(x, depth + 1)
    elif dataclasses.is_dataclass(out) and not isinstance(out, type):
        for f in dataclasses.fields(out):
            yield from _tensors(getattr(out, f.name, None), depth + 1)


def _pick_leaf(out) -> Optional[torch.Tensor]:
    """The smallest tensor of a dispatched output: its shape labels the
    record.  On the card the event recorded after the program marks
    the whole program's completion, whichever output names it."""
    best = None
    for leaf in _tensors(out):
        if best is None or leaf.numel() < best.numel():
            best = leaf
    return best


def _ready_marker(leaf: torch.Tensor):
    """What the watcher waits on for an output: an event recorded on the
    current stream of the output's card (no timing flag), or None for a
    CPU output, which has run by the time it is observed."""
    if leaf.device.type != "cuda":
        return None
    event = torch.cuda.Event()
    event.record(torch.cuda.current_stream(leaf.device))
    return event


def _lane(device: torch.device) -> str:
    if device.type == "cuda":
        index = device.index if device.index is not None else torch.cuda.current_device()
        return f"d{index}"
    return "d0"


class DispatchLedger:
    """Central dispatch-site wrapper state: observe() on the hot path,
    a single watcher thread retiring records in dispatch order."""

    def __init__(
        self,
        enabled: Optional[bool] = None,
        ring_ticks: Optional[int] = None,
        metrics=None,
    ):
        if enabled is None:
            enabled = ENABLED
        self.enabled = bool(enabled)
        if ring_ticks is None:
            ring_ticks = RING_TICKS
        self.metrics = metrics
        self._cv = threading.Condition()
        self._pending: deque = deque()  # (record, CUDA event or None, shape)
        self._ticks: deque[_TickEntry] = deque(maxlen=max(1, ring_ticks))
        self._open: Optional[_TickEntry] = None
        self._untracked: deque[DispatchRecord] = deque(maxlen=_UNTRACKED_RING)
        self._seq = 0
        self._retired_seq = 0
        self._tick_seq = 0
        self._chain_ready: Optional[float] = None
        self.inflight = 0
        self._thread: Optional[threading.Thread] = None

    # -- wiring -----------------------------------------------------------
    def attach(self, metrics) -> None:
        """Point histogram emission at a registry (the engine attaches
        its own; last writer wins for the process-default ledger)."""
        self.metrics = metrics

    def _ensure_thread(self) -> None:
        if self._thread is None or not self._thread.is_alive():
            self._thread = threading.Thread(
                target=self._watch, name="devprof-watcher", daemon=True
            )
            self._thread.start()

    # -- hot path ---------------------------------------------------------
    def observe(self, kind: str, out) -> None:
        """Record one device dispatch (call immediately after the
        program is enqueued).  Cost: a leaf pick, one event record on the
        current stream for an output on the card, one perf_counter read
        and a lock-guarded deque append."""
        if not self.enabled:
            return
        leaf = _pick_leaf(out)
        if leaf is None:
            return  # host-only output: nothing dispatched
        event = _ready_marker(leaf)
        shape = tuple(leaf.shape)
        lane = _lane(leaf.device)
        with self._cv:
            self._seq += 1
            open_entry = self._open
            tick = (
                open_entry.tick
                if open_entry is not None
                and open_entry.owner == threading.get_ident()
                else None
            )
            rec = DispatchRecord(self._seq, tick, kind)
            rec.device = lane
            self._pending.append((rec, event, shape))
            self.inflight += 1
            self._ensure_thread()
            self._cv.notify_all()

    # -- tick bracketing --------------------------------------------------
    def begin_tick(self, **meta) -> int:
        """Open a tick bracket; returns the ledger-wide tick id.  The
        engine serializes schedule(), so one bracket is open at a time
        (a nested/overlapping begin closes the previous bracket)."""
        if not self.enabled:
            return 0
        with self._cv:
            self._tick_seq += 1
            if self._open is not None and not self._open.closed:
                self._finish_open_locked()
            self._open = _TickEntry(self._tick_seq, dict(meta))
            return self._tick_seq

    def _finish_open_locked(self) -> None:
        entry = self._open
        entry.closed = True
        if entry.t1 is None:
            entry.t1 = time.perf_counter()
        self._ticks.append(entry)

    def end_tick(self, stage_s: Optional[dict] = None) -> None:
        """Close the open bracket, attaching the host-side stage split
        (seconds).  Non-blocking: readiness observation may still be in
        flight — waterfall() drains before reading."""
        if not self.enabled:
            return
        with self._cv:
            if self._open is None:
                return
            self._open.t1 = time.perf_counter()
            if stage_s:
                self._open.stage_s = {
                    k: float(v) for k, v in stage_s.items()
                }
            self._finish_open_locked()
            self._open = None

    # -- watcher ----------------------------------------------------------
    def _chain(self, rec: DispatchRecord, t_ready: float) -> None:
        """The single-stream chain model: a program starts when it was
        dispatched or when its predecessor was ready, whichever is
        later; it occupied the device from then until it was ready."""
        start = rec.t_dispatch
        if self._chain_ready is not None and self._chain_ready > start:
            start = self._chain_ready
        if t_ready < start:
            t_ready = start
        rec.queue_s = start - rec.t_dispatch
        rec.device_s = t_ready - start
        rec.t_ready = t_ready
        self._chain_ready = t_ready

    def _watch(self) -> None:
        while True:
            with self._cv:
                while not self._pending:
                    self._cv.wait()
                rec, event, shape = self._pending.popleft()
            if event is not None:
                try:
                    event.synchronize()
                except Exception:
                    # A failed wait (a lost context): "ready by now" is
                    # the best lower bound.
                    rec.note = "unwaited"
                t_ready = time.perf_counter()
            else:
                # A CPU output has run by the time it is observed.
                t_ready = rec.t_dispatch
            del event
            rec.shape = "x".join(str(d) for d in shape)
            self._chain(rec, t_ready)
            m = self.metrics
            if m is not None:
                try:
                    m.histogram(
                        "engine_device_seconds", rec.device_s,
                        program=rec.kind, device=rec.device,
                    )
                    m.histogram(
                        "engine_queue_wait_seconds", rec.queue_s,
                        program=rec.kind, device=rec.device,
                    )
                except Exception:
                    pass
            with self._cv:
                self.inflight -= 1
                self._retired_seq = rec.seq
                entry = None
                if rec.tick is not None:
                    if self._open is not None and self._open.tick == rec.tick:
                        entry = self._open
                    else:
                        for e in reversed(self._ticks):
                            if e.tick == rec.tick:
                                entry = e
                                break
                if entry is not None:
                    entry.records.append(rec)
                else:
                    self._untracked.append(rec)
                if m is not None:
                    try:
                        m.store("engine_dispatch_inflight", self.inflight)
                    except Exception:
                        pass
                self._cv.notify_all()

    def drain(self, timeout: float = 5.0) -> bool:
        """Wait until every observed record has been retired (the
        programs themselves have long finished by the time callers ask
        — this waits out the watcher, not the device)."""
        if not self.enabled:
            return True
        deadline = time.monotonic() + timeout
        with self._cv:
            while self._pending or self.inflight:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    return False
                self._cv.wait(timeout=remaining)
        return True

    # -- readback ---------------------------------------------------------
    @staticmethod
    def _summarize(records) -> dict:
        by: dict[str, dict] = {}
        by_dev: dict[str, dict] = {}
        dev = queue = 0.0
        for r in records:
            slot = by.setdefault(
                r.kind, {"n": 0, "device_ms": 0.0, "queue_ms": 0.0}
            )
            slot["n"] += 1
            slot["device_ms"] += r.device_s * 1e3
            slot["queue_ms"] += r.queue_s * 1e3
            lane = by_dev.setdefault(
                getattr(r, "device", "?"),
                {"n": 0, "device_ms": 0.0, "queue_ms": 0.0},
            )
            lane["n"] += 1
            lane["device_ms"] += r.device_s * 1e3
            lane["queue_ms"] += r.queue_s * 1e3
            dev += r.device_s
            queue += r.queue_s
        for slot in by.values():
            slot["device_ms"] = round(slot["device_ms"], 3)
            slot["queue_ms"] = round(slot["queue_ms"], 3)
        for lane in by_dev.values():
            lane["device_ms"] = round(lane["device_ms"], 3)
            lane["queue_ms"] = round(lane["queue_ms"], 3)
        return {
            "records": len(records),
            "device_ms": round(dev * 1e3, 3),
            "queue_ms": round(queue * 1e3, 3),
            "by_program": by,
            "by_device": by_dev,
        }

    def tick_summary(self, tick: Optional[int] = None, timeout: float = 5.0) -> dict:
        """Per-program device/queue totals for one tick (default: the
        most recently closed one)."""
        if not self.enabled:
            return {"enabled": False}
        self.drain(timeout)
        with self._cv:
            entry = self._find_locked(tick)
            if entry is None:
                return {"enabled": True, "tick": None, "records": 0}
            summary = self._summarize(entry.records)
            summary.update(
                tick=entry.tick,
                wall_ms=round(((entry.t1 or entry.t0) - entry.t0) * 1e3, 3),
                stage_ms={
                    k: round(v * 1e3, 3) for k, v in entry.stage_s.items()
                },
                meta=dict(entry.meta),
            )
            return summary

    def _find_locked(self, tick: Optional[int]) -> Optional[_TickEntry]:
        if tick is None:
            return self._ticks[-1] if self._ticks else None
        for e in reversed(self._ticks):
            if e.tick == tick:
                return e
        return None

    def chrome_events(
        self,
        epoch: float,
        max_ticks: int = 8,
        max_records: int = 2048,
        timeout: float = 2.0,
    ) -> list[dict]:
        """The ledger's recent dispatch records as Chrome trace events on
        per-device lanes, timestamped against the span tracer's epoch
        (trace.epoch()) so GET /debug/trace shows host spans and device
        timelines on ONE timeline, correlated by tick id in args.

        Each record renders as a device-occupancy slice (name = program
        kind) on a synthetic ``device <lane>`` thread, preceded by a
        ``queue:<kind>`` slice when the program waited behind earlier
        device work — the same chain-model split the waterfall reports.
        """
        if not self.enabled:
            return []
        self.drain(timeout)
        with self._cv:
            records = [
                r
                for e in list(self._ticks)[-max_ticks:]
                for r in e.records
            ]
        records.sort(key=lambda r: r.seq)
        if len(records) > max_records:
            records = records[-max_records:]
        pid = os.getpid()
        # Stable synthetic tids per device lane, far above real thread
        # ids' typical range so tools sort them into their own block.
        lanes: dict[str, int] = {}
        events: list[dict] = []
        for r in records:
            lane = getattr(r, "device", "?")
            if lane not in lanes:
                lanes[lane] = 0x64657600 + len(lanes)
            tid = lanes[lane]
            t_ready = r.t_ready if r.t_ready is not None else r.t_dispatch
            start = t_ready - r.device_s
            args = {
                "tick": r.tick,
                "seq": r.seq,
                "shape": r.shape,
                "queue_ms": round(r.queue_s * 1e3, 3),
                "device_ms": round(r.device_s * 1e3, 3),
            }
            if r.note != "ok":
                args["note"] = r.note
            if r.queue_s > 0:
                events.append(
                    {
                        "name": f"queue:{r.kind}",
                        "ph": "X",
                        "ts": round((r.t_dispatch - epoch) * 1e6, 3),
                        "dur": round(r.queue_s * 1e6, 3),
                        "pid": pid,
                        "tid": tid,
                        "args": args,
                    }
                )
            events.append(
                {
                    "name": r.kind,
                    "ph": "X",
                    "ts": round((start - epoch) * 1e6, 3),
                    "dur": round(r.device_s * 1e6, 3),
                    "pid": pid,
                    "tid": tid,
                    "args": args,
                }
            )
        for lane, tid in lanes.items():
            events.append(
                {
                    "name": "thread_name",
                    "ph": "M",
                    "pid": pid,
                    "tid": tid,
                    "args": {"name": f"device {lane} (dispatch ledger)"},
                }
            )
        return events

    def waterfall(
        self,
        tick: Optional[int] = None,
        max_ticks: int = 4,
        max_records: int = 512,
        timeout: float = 5.0,
    ) -> dict:
        """The waterfall artifact: the most recent ticks' ordered
        dispatch records with the host/device split attached (schema in
        docs/observability.md)."""
        if not self.enabled:
            return {"enabled": False, "ticks": []}
        self.drain(timeout)
        out_ticks = []
        with self._cv:
            entries = (
                [e for e in self._ticks if e.tick == tick]
                if tick is not None
                else list(self._ticks)[-max_ticks:]
            )
            for e in entries:
                records = sorted(e.records, key=lambda r: r.seq)
                trimmed = len(records) > max_records
                rows = [
                    {
                        "seq": r.seq,
                        "kind": r.kind,
                        "shape": r.shape,
                        "device": getattr(r, "device", "?"),
                        "t_ms": round((r.t_dispatch - e.t0) * 1e3, 3),
                        "queue_ms": round(r.queue_s * 1e3, 3),
                        "device_ms": round(r.device_s * 1e3, 3),
                        "ready_ms": round(
                            ((r.t_ready or r.t_dispatch) - e.t0) * 1e3, 3
                        ),
                        **({"note": r.note} if r.note != "ok" else {}),
                    }
                    for r in records[:max_records]
                ]
                summary = self._summarize(records)
                out_ticks.append(
                    {
                        "tick": e.tick,
                        "meta": dict(e.meta),
                        "wall_ms": round(
                            ((e.t1 or e.t0) - e.t0) * 1e3, 3
                        ),
                        "stage_ms": {
                            k: round(v * 1e3, 3)
                            for k, v in e.stage_s.items()
                        },
                        "device_ms": summary["device_ms"],
                        "queue_ms": summary["queue_ms"],
                        "by_program": summary["by_program"],
                        "records": rows,
                        **({"records_trimmed": True} if trimmed else {}),
                    }
                )
            untracked = self._summarize(self._untracked)
        return {
            "enabled": True,
            "inflight": self.inflight,
            "ticks": out_ticks,
            "untracked": untracked,
        }


_default = DispatchLedger()


def get_default() -> DispatchLedger:
    return _default


# -- on-demand torch.profiler capture -------------------------------------
_capture_lock = threading.Lock()


def profile_dir() -> str:
    """Root directory for on-demand profiler artifacts (PROFILE_DIR)."""
    return PROFILE_DIR


def capture_device_profile(
    seconds: float = 2.0,
    out_dir: Optional[str] = None,
    ready: Optional[threading.Event] = None,
    stop: Optional[threading.Event] = None,
) -> dict:
    """Capture a ``torch.profiler`` trace (CPU activity, and CUDA
    activity when a card is present) of whatever the process is doing
    for ``seconds`` (live ticks included, from every thread's kernels)
    into a fresh timestamped subdirectory of ``out_dir`` (default
    :func:`profile_dir`), as a Chrome trace (``trace.json``; load it in
    chrome://tracing or ui.perfetto.dev).  ``ready`` is set once the
    profiler records (its start-up can take seconds), so a caller on
    another thread can start the work to capture; setting ``stop`` ends
    the capture before ``seconds`` have passed.  One capture at a time —
    overlapping profilers would corrupt each other."""
    seconds = max(0.05, min(float(seconds), 120.0))
    root = out_dir or profile_dir()
    target = os.path.join(
        root, time.strftime("%Y%m%d-%H%M%S") + f"-{os.getpid()}"
    )
    if not _capture_lock.acquire(blocking=False):
        return {"error": "a profiler capture is already running"}
    t0 = time.perf_counter()
    path = os.path.join(target, "trace.json")
    try:
        from torch.profiler import ProfilerActivity, profile

        activities = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            activities.append(ProfilerActivity.CUDA)
        os.makedirs(target, exist_ok=True)
        with profile(activities=activities) as prof:
            if ready is not None:
                ready.set()
            (stop or threading.Event()).wait(seconds)
        prof.export_chrome_trace(path)
    except Exception as e:
        return {"error": f"profiler capture failed: {e}", "dir": target}
    finally:
        _capture_lock.release()
    n_files = sum(len(files) for _, _, files in os.walk(target))
    # wall_s > seconds is expected: the profiler's start-up and the
    # trace export fall outside the captured window.
    return {
        "dir": target,
        "trace": path,
        "seconds": seconds,
        "wall_s": round(time.perf_counter() - t0, 2),
        "files": n_files,
    }
