"""Continuous telemetry timeline — the soak observatory's recorder.

Every surface this control plane exposes today (/metrics, /debug/slo,
/debug/members, bench detail) is a point-in-time snapshot; a whole-run
claim like "no SLO window went red during the soak" is unverifiable
from snapshots.  This module adds the missing time axis: a sampler
(thread or explicit :meth:`Timeline.sample_now` calls) scrapes the
Metrics registry — in ONE lock-held copy per scrape, so counters can
never go backwards mid-tick — plus a set of provider callables (the SLO
evaluator's burn rates and red/green verdicts, breaker states, stream
depth/age, RSS and live device-buffer bytes) into a bounded RRD-style
downsampling ring:

* **raw** tier: one bucket per scrape (INTERVAL_S apart);
* **10s** and **60s** tiers: coarser buckets the raw samples merge into
  as they age (or under byte pressure), counters by SUM of per-scrape
  deltas, gauges by MAX — so a red burn-rate sample survives
  downsampling as a red bucket, and counter rates integrate exactly;
* the whole ring stays under MAX_BYTES (oldest coarse buckets
  drop last, with a drop counter so truncation is never silent).

Counters are stored as per-scrape DELTAS clamped at >= 0 (a registry
reset reads as a zero-delta sample, not a negative spike); gauges as
last-read values; histograms contribute ``<series>:count`` and
``<series>:sum`` delta series (quantiles don't downsample — counts and
sums do).

Served as JSON at GET /debug/timeline (health + profiling servers,
runtime/profiling.py) and dumped into SOAK_r<n>.json by the soak
scenario (bench.py --scenario soak).  ENABLED = False disables the module
entirely: no thread is ever created and sample_now() is a no-op.

Schema and tier semantics: docs/observability.md ("Soak observatory").
"""

from __future__ import annotations

import json
import os
import sys
import threading
import time
from typing import Callable, Optional

from kubeadmiral_tpu_torch.runtime import lockcheck

__all__ = [
    "Timeline",
    "timeline_enabled",
    "get_default",
    "set_default",
    "reset_default",
]


# The JAX module's knobs, as constants with its defaults: the master
# switch (KT_TIMELINE), the sampling interval (KT_TIMELINE_INTERVAL_S)
# and the ring's byte budget (KT_TIMELINE_BYTES).  The constructor's
# arguments override the last two.
ENABLED = True
INTERVAL_S = 1.0
MAX_BYTES = 2 << 20


def timeline_enabled() -> bool:
    """ENABLED: master switch (default on).  Off means no sampler
    thread exists and every sample call early-outs."""
    return bool(ENABLED)


# Age horizons: raw samples older than RAW_HORIZON_S merge into the 10s
# tier, 10s buckets older than MID_HORIZON_S into the 60s tier.  Byte
# pressure (MAX_BYTES) promotes earlier when the budget demands.
RAW_HORIZON_S = 900.0
MID_HORIZON_S = 7200.0

TIER_WIDTHS_S = (0.0, 10.0, 60.0)  # 0.0 = raw (one bucket per scrape)


class _Bucket:
    """One time bucket: counter deltas (merge: sum) + gauges (merge:
    max) observed over [t0, t1], covering ``n`` raw scrapes."""

    __slots__ = ("t0", "t1", "n", "counters", "gauges", "cost")

    def __init__(self, t0: float, t1: float, n: int,
                 counters: dict, gauges: dict):
        self.t0 = t0
        self.t1 = t1
        self.n = n
        self.counters = counters
        self.gauges = gauges
        self.cost = _bucket_cost(counters, gauges)

    def merge(self, other: "_Bucket") -> None:
        """Fold ``other`` (adjacent in time) into this bucket: counter
        deltas SUM (rates integrate), gauges MAX (a spike survives)."""
        self.t0 = min(self.t0, other.t0)
        self.t1 = max(self.t1, other.t1)
        self.n += other.n
        for key, val in other.counters.items():
            self.counters[key] = self.counters.get(key, 0.0) + val
        for key, val in other.gauges.items():
            prev = self.gauges.get(key)
            self.gauges[key] = val if prev is None else max(prev, val)
        self.cost = _bucket_cost(self.counters, self.gauges)


def _bucket_cost(counters: dict, gauges: dict) -> int:
    """Approximate resident bytes of one bucket: per-series key string +
    float box + dict slot, plus the bucket object itself.  An estimate
    (CPython internals vary) but a stable one, so MAX_BYTES is a
    real, testable bound on ring growth."""
    n = len(counters) + len(gauges)
    chars = sum(len(k) for k in counters) + sum(len(k) for k in gauges)
    return 120 + 110 * n + chars


class _Tier:
    __slots__ = ("name", "width", "horizon", "buckets")

    def __init__(self, name: str, width: float, horizon: Optional[float]):
        self.name = name
        self.width = width
        self.horizon = horizon  # None = terminal tier (drops, no promote)
        self.buckets: list[_Bucket] = []


@lockcheck.shared_field_guard
class Timeline:
    """The bounded, downsampling telemetry ring (see module docstring).

    Thread-shape: the sampler thread appends; HTTP handler threads read
    via :meth:`to_doc`; the soak harness calls :meth:`sample_now` from
    its round loop.  All ring state is guarded by ``_lock`` (declared
    below per the lockcheck discipline); provider callables and the
    registry scrape run OUTSIDE the ring lock — the registry snapshot is
    one atomic copy under the registry's own lock, which is what keeps
    counters monotonic within a series.
    """

    _shared_fields_ = {
        "_tiers": "_lock",
        "_prev": "_lock",
        "_external": "_lock",
        "_samples": "_lock",
        "_dropped": "_lock",
        "_provider_errors": "_lock",
        "_sample_seconds": "_lock",
    }

    def __init__(
        self,
        metrics=None,
        interval_s: Optional[float] = None,
        max_bytes: Optional[int] = None,
        clock=time.monotonic,
    ):
        self.metrics = metrics
        self.clock = clock
        self.enabled = timeline_enabled()
        self.interval_s = (
            float(INTERVAL_S)
            if interval_s is None else float(interval_s)
        )
        self.max_bytes = (
            int(MAX_BYTES)
            if max_bytes is None else int(max_bytes)
        )
        self._lock = lockcheck.make_lock("timeline")
        self._tiers = [
            _Tier("raw", TIER_WIDTHS_S[0], RAW_HORIZON_S),
            _Tier("10s", TIER_WIDTHS_S[1], MID_HORIZON_S),
            _Tier("60s", TIER_WIDTHS_S[2], None),
        ]
        self._prev: dict[str, float] = {}   # last absolute counter reads
        self._external: dict[str, float] = {}  # harness-set gauges (obj/s)
        self._samples = 0
        self._dropped = 0
        self._provider_errors = 0
        self._sample_seconds = 0.0
        self._providers: list[Callable[[], Optional[dict]]] = []
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()

    # -- providers ---------------------------------------------------------
    def add_provider(self, fn: Callable[[], Optional[dict]]) -> None:
        """Register a callable returning a gauge dict merged into every
        scrape.  Providers run outside the ring lock and are exception-
        guarded (a failing provider degrades to a missing series, never
        a dead sampler)."""
        self._providers.append(fn)

    def set_gauge(self, name: str, value: float) -> None:
        """Pin an externally-computed gauge (e.g. the harness's obj/s)
        into every subsequent scrape."""
        with self._lock:
            self._external[name] = float(value)

    def attach_runtime(self, slo=None, breakers=None, stream=None) -> None:
        """Wire the standard runtime providers: SLO burn/red verdicts,
        breaker states, stream depth/age, RSS + live device bytes."""
        self.add_provider(lambda: _slo_gauges(slo))
        if breakers is not None:
            self.add_provider(lambda: _breaker_gauges(breakers))
        if stream is not None:
            self.add_provider(lambda: _stream_gauges(stream))
        self.add_provider(_process_gauges)

    # -- sampling ----------------------------------------------------------
    def start(self) -> bool:
        """Spawn the sampler thread.  Returns False (and creates NO
        thread) when ENABLED is off or the interval is non-positive."""
        if not self.enabled or self.interval_s <= 0 or self._thread is not None:
            return False
        self._stop.clear()
        t = threading.Thread(
            target=self._run, name="kt-timeline", daemon=True
        )
        self._thread = t
        t.start()
        return True

    def stop(self) -> None:
        t = self._thread
        if t is None:
            return
        self._stop.set()
        t.join(timeout=5.0)
        self._thread = None

    def _run(self) -> None:
        while not self._stop.wait(self.interval_s):
            try:
                self.sample_now()
            except Exception:
                with self._lock:
                    self._provider_errors += 1

    def sample_now(self, now: Optional[float] = None) -> bool:
        """Take one sample synchronously (the soak harness's per-round
        call; also what the sampler thread runs).  Returns False when
        the timeline is disabled."""
        if not self.enabled:
            return False
        t_work = time.perf_counter()
        t = self.clock() if now is None else now
        gauges: dict[str, float] = {}
        errors = 0
        for fn in self._providers:
            try:
                extra = fn()
            except Exception:
                errors += 1
                continue
            if extra:
                for key, val in extra.items():
                    try:
                        gauges[str(key)] = float(val)
                    except (TypeError, ValueError):
                        continue
        # ONE lock-held registry copy: every counter in this scrape is
        # from the same instant, so per-series deltas are >= 0 by
        # construction (clamped anyway against registry resets).
        if self.metrics is not None:
            snap = self.metrics.snapshot()
        else:
            snap = {"counters": {}, "gauges": {}, "histograms": {}}
        registry_gauges = dict(snap["gauges"])
        registry_gauges.update(gauges)
        with self._lock:
            counters: dict[str, float] = {}
            for key, val in snap["counters"].items():
                delta = val - self._prev.get(key, 0.0)
                counters[key] = delta if delta > 0.0 else 0.0
                self._prev[key] = val
            for key, hist in snap["histograms"].items():
                for suffix, val in (
                    (":count", float(hist["count"])),
                    (":sum", float(hist["sum"])),
                ):
                    hkey = key + suffix
                    delta = val - self._prev.get(hkey, 0.0)
                    counters[hkey] = delta if delta > 0.0 else 0.0
                    self._prev[hkey] = val
            registry_gauges.update(self._external)
            self._tiers[0].buckets.append(
                _Bucket(t, t, 1, counters, registry_gauges)
            )
            self._samples += 1
            self._provider_errors += errors
            self._rebalance_locked(t)
            # Sampler self-cost, for the "timeline overhead <= 2% of
            # steady obj/s" acceptance: cumulative wall seconds spent
            # inside sample_now (providers + scrape + ring work).
            self._sample_seconds += time.perf_counter() - t_work
        return True

    # -- ring maintenance --------------------------------------------------
    @lockcheck.assumes_held("_lock")
    def _rebalance_locked(self, now: float) -> None:
        raw, mid, coarse = self._tiers
        # Age-based promotion keeps the tiers meaningful even far below
        # the byte budget.
        while raw.buckets and raw.buckets[0].t1 < now - raw.horizon:
            self._promote_locked(raw, mid)
        while mid.buckets and mid.buckets[0].t1 < now - mid.horizon:
            self._promote_locked(mid, coarse)
        # Byte pressure: promote oldest-first, drop terminal-tier
        # buckets only as the last resort (and count the drops).
        guard = 0
        while self._approx_bytes_locked() > self.max_bytes:
            guard += 1
            if guard > 100000:  # defensive: never wedge the sampler
                break
            if len(raw.buckets) > 1:
                self._promote_locked(raw, mid)
            elif len(mid.buckets) > 1:
                self._promote_locked(mid, coarse)
            elif coarse.buckets:
                coarse.buckets.pop(0)
                self._dropped += 1
                if not raw.buckets and not mid.buckets and not coarse.buckets:
                    break
            else:
                break

    @lockcheck.assumes_held("_lock")
    def _promote_locked(self, src: _Tier, dst: _Tier) -> None:
        """Move the oldest src bucket into dst's slot grid (floor-
        aligned to dst.width), merging when the slot already exists.
        Buckets are appended in time order, so the landing slot is
        always dst's LAST bucket or a new one."""
        bucket = src.buckets.pop(0)
        slot = (bucket.t0 // dst.width) * dst.width if dst.width > 0 else bucket.t0
        if dst.buckets and dst.buckets[-1].t0 >= slot - 1e-9:
            dst.buckets[-1].merge(bucket)
        else:
            bucket.t0 = slot
            dst.buckets.append(bucket)

    @lockcheck.assumes_held("_lock")
    def _approx_bytes_locked(self) -> int:
        return sum(b.cost for tier in self._tiers for b in tier.buckets)

    def approx_bytes(self) -> int:
        with self._lock:
            return self._approx_bytes_locked()

    # -- read side ---------------------------------------------------------
    def to_doc(
        self,
        series: Optional[str] = None,
        tier: Optional[str] = None,
    ) -> dict:
        """The GET /debug/timeline payload: per tier, series-major
        ``[t_end, value]`` point lists.  ``series`` substring-filters
        series names; ``tier`` selects one tier."""
        with self._lock:
            tiers_out = {}
            for t in self._tiers:
                if tier is not None and t.name != tier:
                    continue
                out: dict[str, dict] = {}
                for b in t.buckets:
                    point_t = round(b.t1, 3)
                    for key, val in b.counters.items():
                        if series is not None and series not in key:
                            continue
                        entry = out.get(key)
                        if entry is None:
                            entry = out[key] = {
                                "kind": "counter", "points": []
                            }
                        entry["points"].append([point_t, val])
                    for key, val in b.gauges.items():
                        if series is not None and series not in key:
                            continue
                        entry = out.get(key)
                        if entry is None:
                            entry = out[key] = {"kind": "gauge", "points": []}
                        entry["points"].append([point_t, val])
                tiers_out[t.name] = {
                    "width_s": t.width,
                    "buckets": len(t.buckets),
                    "series": out,
                }
            return {
                "enabled": self.enabled,
                "interval_s": self.interval_s,
                "max_bytes": self.max_bytes,
                "approx_bytes": self._approx_bytes_locked(),
                "samples_total": self._samples,
                "dropped_buckets_total": self._dropped,
                "provider_errors_total": self._provider_errors,
                "sample_seconds_total": round(self._sample_seconds, 6),
                "tiers": tiers_out,
            }

    def to_json(self, **kw) -> str:
        return json.dumps(self.to_doc(**kw))

    def dump(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(self.to_doc(), f)


# -- standard providers -----------------------------------------------------

def _slo_gauges(rec=None) -> dict:
    """One evaluator pass: burn rates per (objective, window) plus a
    synthesized 0/1 ``slo_red{objective=...}`` verdict gauge — MAX-merge
    makes a downsampled bucket red iff ANY sample inside it was red,
    exactly the semantics the soak's red-outside-injection-window gate
    needs."""
    from kubeadmiral_tpu_torch.runtime import slo as slo_mod

    recorder = rec if rec is not None else slo_mod.get_default()
    if recorder is None or not getattr(recorder, "enabled", False):
        return {}
    status = recorder.evaluate()
    out: dict[str, float] = {}
    for name, entry in status.items():
        for window, burn in entry.get("burn", {}).items():
            out[f"slo_burn_rate{{objective={name},window={window}}}"] = burn
        out[f"slo_red{{objective={name}}}"] = 1.0 if entry.get("red") else 0.0
    return out


def _breaker_gauges(breakers) -> dict:
    from kubeadmiral_tpu_torch.transport import breaker as breaker_mod

    out: dict[str, float] = {}
    snap = breakers.snapshot()
    for name, entry in snap.items():
        state = entry.get("state") if isinstance(entry, dict) else entry
        code = breaker_mod.STATE_CODE.get(state, -1) if isinstance(
            state, str
        ) else float(state)
        out[f"member_breaker_state{{cluster={name}}}"] = float(code)
    return out


def _stream_gauges(stream) -> dict:
    return {
        "engine_stream_slab_depth": float(stream.pending()),
        "engine_stream_oldest_age_seconds": float(stream.oldest_age()),
    }


def _process_gauges() -> dict:
    """Resident set + live device-buffer bytes (the caching allocator's
    ``memory_allocated``).  torch is consulted only when it is ALREADY
    imported and CUDA already initialised — the timeline never pulls the
    device stack into a process that didn't need it."""
    out: dict[str, float] = {}
    try:
        with open("/proc/self/statm") as f:
            pages = int(f.read().split()[1])
        out["process_resident_bytes"] = float(pages * os.sysconf("SC_PAGE_SIZE"))
    except (OSError, ValueError, IndexError):
        try:
            import resource

            out["process_resident_bytes"] = float(
                resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024
            )
        except Exception:
            pass
    torch = sys.modules.get("torch")
    if torch is not None:
        try:
            if torch.cuda.is_initialized():
                out["device_buffer_bytes"] = float(torch.cuda.memory_allocated())
        except Exception:
            pass
    return out


# -- process default --------------------------------------------------------
_default: Optional[Timeline] = None
_default_lock = threading.Lock()


def get_default() -> Optional[Timeline]:
    """The installed process timeline, or None — unlike the SLO
    recorder there is no lazy auto-construction: a timeline needs a
    registry to scrape, so embedders install one explicitly."""
    return _default


def set_default(timeline: Optional[Timeline]) -> Optional[Timeline]:
    global _default
    with _default_lock:
        prev = _default
        _default = timeline
    return prev


def reset_default() -> None:
    prev = set_default(None)
    if prev is not None:
        prev.stop()
