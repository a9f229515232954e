"""Scheduling decision flight recorder.

A copy of ``kubeadmiral_tpu/runtime/flightrec.py`` for the port's
engine.  A bounded ring of the last N ticks' decision records: for every
object row the engine actually fetched off the device, the recorder
keeps the chosen clusters + replica split, the top-k scores among the
selected clusters, the per-reason rejection counts + feasible count and
the tick/program fingerprint — enough to answer "why is object X on
clusters {A, B} and not C?" without re-running the solver.

Populated off the device path: the engine records from the host-side
arrays its fetch stage already pulled (the packed wire carries each
row's reason-summary counts and feasible count, so no reason plane
crosses to the host).  Ticks that ride the no-op/skip fast paths record
nothing — the previous records remain current, because the tick provably
reproduced the previous outputs.  A record describes the decision as of
the tick that last fetched that row (each record carries its tick id and
age).

Sizing: packed records cost ~300 bytes flat.  The ring keeps at most
``max_ticks`` tick entries and evicts oldest-first past ``max_bytes``,
but always retains the most recent tick so a cold full-batch schedule
stays explainable.  The JAX module's ``KT_FLIGHTREC*`` knobs are the
constructor's defaults here (8 ticks, 256 MiB, top-k 8, enabled); the
port reads no environment variable.  ``summarize_reasons`` is the
ScheduleFailed event vocabulary the scheduler controller reads.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from typing import Callable, Mapping, Optional, Sequence

import numpy as np

from kubeadmiral_tpu_torch.ops import reasons as RSN


class DecisionRecord:
    """One object's scheduling decision, as of ``tick``.

    The format-independent core (identical whichever fetch format the
    engine ran): ``placements``, ``reason_counts`` (clusters rejected
    per reason bit, ops.reasons.REASON_BITS order), ``feasible_n``, and
    the top-k scores among the SELECTED clusters.  ``reasons`` — the
    full per-cluster mask row — is carried only when a caller passes
    dense reason rows; the port's engine fetches the packed wire, so its
    records hold None there and ``explain`` reports the summary
    counts."""

    __slots__ = (
        "key", "tick", "when", "program", "placements", "reasons",
        "reason_counts", "feasible_n", "topk_idx", "topk_scores", "names",
    )

    def __init__(self, key, tick, when, program, placements, reasons,
                 reason_counts, feasible_n, topk_idx, topk_scores, names):
        self.key = key
        self.tick = tick
        self.when = when
        self.program = program
        self.placements = placements      # Mapping[str, Optional[int]]
        self.reasons = reasons            # np.int16[C] or None (packed)
        self.reason_counts = reason_counts  # np.int64[NUM_REASON_BITS]
        self.feasible_n = feasible_n      # int
        self.topk_idx = topk_idx          # np.int32[k] selected cluster idx
        self.topk_scores = topk_scores    # np.int64[k] matching scores
        self.names = names                # tuple[str, ...] (shared per tick)

    @property
    def nbytes(self) -> int:
        dense = self.reasons.nbytes if self.reasons is not None else 0
        return int(dense + self.reason_counts.nbytes + self.topk_idx.nbytes
                   + self.topk_scores.nbytes) + 200


class _TickEntry:
    __slots__ = ("tick", "when", "objects", "clusters", "records",
                 "nbytes", "programs")

    def __init__(self, tick, when, objects, clusters):
        self.tick = tick
        self.when = when
        self.objects = objects
        self.clusters = clusters
        self.records: dict[str, DecisionRecord] = {}
        self.nbytes = 0
        self.programs: set[str] = set()


class FlightRecorder:
    """The ring and its key index, behind one lock: the engine records
    under its tick, readers (``lookup``, ``explain``) may run on other
    threads."""

    def __init__(
        self,
        max_ticks: int = 8,
        max_bytes: int = 256 << 20,
        topk: int = 8,
        enabled: bool = True,
        clock=time.time,
    ):
        self.max_ticks = max_ticks
        self.max_bytes = max_bytes
        self.topk = topk
        self.enabled = enabled
        self.clock = clock
        self._lock = threading.Lock()
        self._ring: deque[_TickEntry] = deque()
        self._index: dict[str, DecisionRecord] = {}
        self._tick_seq = 0
        self._bytes = 0
        self._current: Optional[_TickEntry] = None
        # Cluster-name tuple interning: one tuple shared by every record
        # of a topology, not one list per record.
        self._names_cache: Optional[tuple[str, ...]] = None

    # -- recording (engine-facing) ---------------------------------------
    def begin_tick(self, objects: int, clusters: int) -> int:
        with self._lock:
            self._tick_seq += 1
            self._current = _TickEntry(
                self._tick_seq, self.clock(), objects, clusters
            )
            return self._tick_seq

    def end_tick(self) -> None:
        with self._lock:
            self._current = None
            self._evict_locked()

    def record_rows(
        self,
        keys: Sequence[str],
        placements: Sequence[Mapping[str, Optional[int]]],
        reasons: Optional[np.ndarray],  # int[n, >=C] or None (packed fetch)
        scores: Optional[np.ndarray],   # int[n, >=C] or None
        names: Sequence[str],
        program: str = "",
        reason_counts: Optional[np.ndarray] = None,  # int[n, NUM_REASON_BITS]
        feasible_n: Optional[np.ndarray] = None,     # int[n]
        topk_idx: Optional[np.ndarray] = None,       # int[n, <=topk]
        topk_scores: Optional[np.ndarray] = None,
    ) -> None:
        """Record a batch of fetched rows for the current tick.  Padded
        cluster columns are masked out (sliced to ``len(names)``);
        callers pass only real (non-padded) object rows.

        The dense fetch format passes ``reasons`` (and optionally
        ``scores``) and the compact fields are derived here; the packed
        format passes ``reason_counts``/``feasible_n``/``topk_*``
        straight off the wire — both produce the SAME record core, so
        packed-vs-dense A/B records are identical apart from the dense
        path's extra per-cluster mask row."""
        if not self.enabled or not keys:
            return
        c = len(names)
        n = len(keys)
        k = min(self.topk, c)
        name_idx = {nm: j for j, nm in enumerate(names)}
        if reasons is not None:
            reasons = np.asarray(reasons)[:, :c].astype(np.int16)
            if reason_counts is None:
                r32 = reasons.astype(np.int64)
                reason_counts = np.stack(
                    [((r32 & bit) != 0).sum(axis=1) for bit in RSN.REASON_BITS],
                    axis=1,
                )
            if feasible_n is None:
                feasible_n = ((reasons & RSN.FILTER_REASON_MASK) == 0).sum(axis=1)
        if reason_counts is None:
            reason_counts = np.zeros((n, RSN.NUM_REASON_BITS), np.int64)
        reason_counts = np.asarray(reason_counts, dtype=np.int64)
        if feasible_n is None:
            feasible_n = np.zeros(n, np.int64)
        feasible_n = np.asarray(feasible_n)
        if topk_idx is None and scores is not None:
            # Top-k among the SELECTED clusters ("why these won"): rank
            # by score desc, index asc — the select stage's tie order.
            scores = np.asarray(scores)[:, :c]
            topk_idx, topk_scores = [], []
            for i in range(n):
                sel = sorted(
                    (j for nm in placements[i] if (j := name_idx.get(nm)) is not None)
                )
                ranked = sorted(sel, key=lambda j: (-int(scores[i, j]), j))[:k]
                topk_idx.append(np.asarray(ranked, np.int32))
                topk_scores.append(
                    np.asarray([int(scores[i, j]) for j in ranked], np.int64)
                )
        if topk_idx is None:
            empty_i = np.zeros(0, np.int32)
            empty_s = np.zeros(0, np.int64)
            topk_idx = [empty_i] * n
            topk_scores = [empty_s] * n
        with self._lock:
            entry = self._current
            if entry is None:  # recording outside a tick: tolerate
                self._tick_seq += 1
                entry = self._current = _TickEntry(
                    self._tick_seq, self.clock(), n, c
                )
            if self._names_cache is None or tuple(self._names_cache) != tuple(names):
                self._names_cache = tuple(names)
            names_t = self._names_cache
            if not entry.records and entry not in self._ring:
                self._ring.append(entry)
            if program:
                entry.programs.add(program)
            when = entry.when
            for i, key in enumerate(keys):
                rec = DecisionRecord(
                    key=key,
                    tick=entry.tick,
                    when=when,
                    program=program,
                    placements=placements[i],
                    reasons=reasons[i] if reasons is not None else None,
                    reason_counts=reason_counts[i],
                    feasible_n=int(feasible_n[i]),
                    topk_idx=np.asarray(topk_idx[i], np.int32),
                    topk_scores=np.asarray(topk_scores[i], np.int64),
                    names=names_t,
                )
                old = entry.records.get(key)
                if old is not None:
                    entry.nbytes -= old.nbytes
                    self._bytes -= old.nbytes
                entry.records[key] = rec
                entry.nbytes += rec.nbytes
                self._bytes += rec.nbytes
                self._index[key] = rec
            self._evict_locked()

    def _evict_locked(self) -> None:
        while len(self._ring) > 1 and (
            len(self._ring) > self.max_ticks or self._bytes > self.max_bytes
        ):
            evicted = self._ring.popleft()
            self._bytes -= evicted.nbytes
            for key, rec in evicted.records.items():
                if self._index.get(key) is rec:
                    del self._index[key]

    def clear(self) -> None:
        with self._lock:
            self._ring.clear()
            self._index.clear()
            self._bytes = 0
            self._current = None
            self._names_cache = None

    # -- durable state (runtime/snapshot.py) -------------------------------
    def export_state(self) -> dict:
        """Restart-durable image of the ring: every tick entry's records
        as plain fields (numpy arrays pickle verbatim).  Restoring this
        into a successor makes ``explain`` and the kill-matrix's
        reason-count comparison identical to an uninterrupted process —
        rows the successor resumes via the no-op replay never re-record,
        so without this their decisions would be unexplainable."""
        with self._lock:
            ticks = []
            for e in self._ring:
                ticks.append({
                    "tick": e.tick, "when": e.when, "objects": e.objects,
                    "clusters": e.clusters, "programs": sorted(e.programs),
                    "records": [
                        {
                            "key": r.key, "program": r.program,
                            "placements": dict(r.placements),
                            "reasons": r.reasons,
                            "reason_counts": r.reason_counts,
                            "feasible_n": r.feasible_n,
                            "topk_idx": r.topk_idx,
                            "topk_scores": r.topk_scores,
                            "names": tuple(r.names),
                        }
                        for r in e.records.values()
                    ],
                })
            return {"tick_seq": self._tick_seq, "ticks": ticks}

    def restore_state(self, payload: dict) -> None:
        """Rebuild the ring from an exported image.  Tick ids continue
        from the snapshot's sequence so restored and freshly recorded
        ticks stay ordered."""
        with self._lock:
            self._ring.clear()
            self._index.clear()
            self._bytes = 0
            self._current = None
            self._tick_seq = max(self._tick_seq, int(payload.get("tick_seq", 0)))
            for t in payload.get("ticks", ()):
                entry = _TickEntry(
                    t["tick"], t["when"], t["objects"], t["clusters"]
                )
                entry.programs = set(t.get("programs", ()))
                for rd in t.get("records", ()):
                    rec = DecisionRecord(
                        key=rd["key"], tick=entry.tick, when=entry.when,
                        program=rd.get("program", ""),
                        placements=rd["placements"],
                        reasons=rd.get("reasons"),
                        reason_counts=np.asarray(rd["reason_counts"], np.int64),
                        feasible_n=int(rd["feasible_n"]),
                        topk_idx=np.asarray(rd["topk_idx"], np.int32),
                        topk_scores=np.asarray(rd["topk_scores"], np.int64),
                        names=tuple(rd.get("names", ())),
                    )
                    entry.records[rec.key] = rec
                    entry.nbytes += rec.nbytes
                    self._bytes += rec.nbytes
                    self._index[rec.key] = rec
                if entry.records:
                    self._ring.append(entry)
            self._evict_locked()

    # -- introspection ---------------------------------------------------
    def stats(self) -> dict:
        with self._lock:
            return {
                "enabled": self.enabled,
                "ticks_seen": self._tick_seq,
                "ring_ticks": len(self._ring),
                "records": len(self._index),
                "bytes": self._bytes,
                "max_ticks": self.max_ticks,
                "max_bytes": self.max_bytes,
                "topk": self.topk,
            }

    def decisions(self) -> dict:
        """Ring summary: recent ticks and their volumes."""
        now = self.clock()
        with self._lock:
            ticks = [
                {
                    "tick": e.tick,
                    "age_seconds": round(now - e.when, 3),
                    "objects": e.objects,
                    "clusters": e.clusters,
                    "recorded_rows": len(e.records),
                    "bytes": e.nbytes,
                    "programs": sorted(e.programs),
                }
                for e in self._ring
            ]
        out = self.stats()
        out["ticks"] = ticks
        return out

    def lookup(self, key: str) -> Optional[DecisionRecord]:
        with self._lock:
            return self._index.get(key)

    def explain(self, key: str) -> Optional[dict]:
        """Human-readable per-cluster verdicts for one object.

        With a dense record (full per-cluster masks) every cluster gets
        a verdict.  A packed record covers the selected clusters
        individually and aggregates the rejections under ``rejected``
        (reason slug -> cluster count) — the fidelity trade of the
        packed wire."""
        rec = self.lookup(key)
        if rec is None:
            return None
        top_by_idx = {
            int(j): (rank, int(s))
            for rank, (j, s) in enumerate(zip(rec.topk_idx, rec.topk_scores), 1)
            if s > np.iinfo(np.int64).min
        }
        feasible_n = int(rec.feasible_n)
        clusters = {}
        if rec.reasons is not None:
            for j, name in enumerate(rec.names):
                mask = int(rec.reasons[j])
                verdict = _verdict(
                    mask, rec.placements.get(name, _MISSING),
                    top_by_idx.get(j), feasible_n,
                )
                clusters[name] = verdict
        else:
            nidx = {nm: j for j, nm in enumerate(rec.names)}
            for name, reps in rec.placements.items():
                j = nidx.get(name)
                clusters[name] = _verdict(
                    0, reps, top_by_idx.get(j) if j is not None else None,
                    feasible_n,
                )
        rejected = {
            RSN.REASON_NAMES[bit]: int(count)
            for bit, count in zip(RSN.REASON_BITS, rec.reason_counts)
            if count
        }
        return {
            "key": key,
            "tick": rec.tick,
            "age_seconds": round(self.clock() - rec.when, 3),
            "program": rec.program,
            "placements": {
                cl: (None if reps is None else int(reps))
                for cl, reps in rec.placements.items()
            },
            "feasible_clusters": feasible_n,
            "clusters": clusters,
            "rejected": rejected,
        }


_MISSING = object()


def _verdict(mask, replicas, top_rank, feasible_n) -> dict:
    """One (object, cluster) verdict: the reason slugs plus a sentence."""
    slugs = RSN.describe(mask)
    if mask == 0 and replicas is not _MISSING:
        text = (
            "selected (no replica count)"
            if replicas is None
            else f"selected, replicas={int(replicas)}"
        )
    elif mask == 0:
        # Selected by the recorded tick but absent from the decoded
        # placement map — only possible for padded rows, which callers
        # never record; keep a faithful fallback.
        text = "selected"
    elif mask & RSN.REASON_STICKY:
        text = "cut by sticky_cluster (object is stickily placed)"
    elif mask & RSN.FILTER_REASON_MASK:
        text = "filtered: " + ", ".join(
            RSN.describe(mask & RSN.FILTER_REASON_MASK)
        )
    elif mask & RSN.REASON_MAX_CLUSTERS:
        if top_rank is not None:
            rank, score = top_rank
            text = (
                f"feasible, scored {score}, rank {rank}/{feasible_n}, "
                f"cut by maxClusters"
            )
        else:
            text = (
                f"feasible but below the recorded top-k of {feasible_n} "
                f"feasible clusters, cut by maxClusters"
            )
    elif mask & RSN.REASON_ZERO_REPLICAS:
        text = "selected by top-K but the replica planner assigned 0"
    else:
        text = "rejected: " + ", ".join(slugs)
    out = {"reasons": slugs, "verdict": text}
    if top_rank is not None:
        rank, score = top_rank
        out["score"] = score
        out["rank"] = rank
    return out


def summarize_reasons(rec: DecisionRecord, limit: int = 4) -> str:
    """Aggregate one record's rejection-reason counts into a short
    operator string ("resources_fit x3, taint_toleration x1") — the
    ScheduleFailed event message vocabulary.  Fed by reason_counts, so
    packed- and dense-format records summarize identically."""
    counts = {
        RSN.REASON_NAMES[bit]: int(n)
        for bit, n in zip(RSN.REASON_BITS, rec.reason_counts)
        if n
    }
    parts = sorted(counts.items(), key=lambda kv: (-kv[1], kv[0]))[:limit]
    return ", ".join(f"{slug} x{n}" for slug, n in parts)


# -- process-wide default (the port's engines meet here) ----------------
_default = FlightRecorder()


def get_default() -> FlightRecorder:
    return _default


# -- drift providers ------------------------------------------------------
# federation/monitor.py's drift detector registers a snapshot callable;
# ``drift_report`` collects every registered provider.  Kept here so
# runtime/ has no federation/ import and any controller can contribute
# a drift view.
_drift_lock = threading.Lock()
_drift_providers: dict[str, Callable[[], dict]] = {}


def register_drift_provider(name: str, fn: Callable[[], dict]) -> None:
    with _drift_lock:
        _drift_providers[name] = fn


def unregister_drift_provider(name: str) -> None:
    with _drift_lock:
        _drift_providers.pop(name, None)


def drift_report() -> dict:
    with _drift_lock:
        providers = dict(_drift_providers)
    out: dict = {"providers": sorted(providers)}
    drifted: list[dict] = []
    for name, fn in sorted(providers.items()):
        try:
            snap = fn()
        except Exception as e:  # a broken provider must not break the report
            snap = {"error": repr(e)}
        out[name] = snap
        drifted.extend(snap.get("drifted", ()) if isinstance(snap, dict) else ())
    out["drifted"] = drifted
    out["drifted_total"] = len(drifted)
    return out
