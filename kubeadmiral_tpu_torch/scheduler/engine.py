"""The scheduling engine: batch in, placements out.

Torch counterpart of ``kubeadmiral_tpu/scheduler/engine.py``: take every
pending SchedulingUnit, featurize against the member clusters (compact
form, with the dense featurizer as the fallback when a vocabulary
overflows a cap), solve on the device chunk by chunk over the object
axis (padded to the same row and cluster buckets as the JAX engine, so a
padded chunk is the same problem), pull each chunk's placements off the
device as the packed wire, and decode them into ``ScheduleResult``s.

On a cluster bucket wider than the candidate width M the chunk runs the
narrow solve (``ops.pipeline.schedule_tick_narrow``); rows that fail its
certificate are re-solved by the dense tick and written back before the
pack.  Narrower buckets run the dense tick.  Rows selecting more
clusters than the wire's K slots are re-fetched as bit-packed masks plus
the replica plane.

Steady-state ticks are cheap, as in the JAX engine.  Each chunk keeps
its featurized rows (keyed by unit identity, then by featurize
signature), its device-resident inputs, its previous output planes and
its decoded results.  The same unit list against the same cluster view
replays the previous results with no dispatch (the no-op gate); a chunk
whose rows are unchanged against the same view replays per chunk; a
chunk with a few changed rows schedules only those rows, in sub-batch
slabs, and merges them; any other dispatch diffs its outputs against the
previous planes and fetches only the changed rows (the delta fetch).

A capacity-drift tick (a clean hit whose cluster view changed at a few
columns) runs the drift gate: one program per chunk classifies every row
from the device-resident inputs and the stored planes; rows that can
move are re-solved by the unified survivor program (256 rows or fewer a
group) or the sub-batch slabs, dynamic-weight rows are checked first,
and a chunk where most rows move takes the full dispatch.

Full dispatches run through the pipelined window (the JAX engine's
default): up to ``pipeline_depth`` chunks (PIPELINE_DEPTH, 16) are
queued on the card while the host featurizes the next ones, then the
window is drained with one read per kind and width of certificate, diff
mask, wire and overflow gather (the chunks' tensors joined on the card).
Queuing waits for nothing: uploads go through pinned memory, and the
planner runs a fixed round budget with its unsettled rows read at the
drain (a chunk with one is dispatched again with the checked loop).
Depth 1 is the sequential path: a window of one chunk, dispatched with
the checked round loop, waited for and fetched before the next.

``schedule`` takes the JAX engine's whole call surface: a caller-built
cluster ``view``; ``webhook_eval`` (webhook planes are per-tick results,
so a webhook tick featurizes every chunk dense, reads and writes no
cache entry and neither hits nor arms the no-op gate); ``want_scores``
(each result also carries the selected clusters' scores, decoded off the
same wire and cached beside the placements; a tick that wants scores
takes no drift gate); ``follower_index`` (the follower union of
``ops/follower.py`` over the returned rows, recomputed for the followers
of ``last_changed``); ``dirty_rows``; and it counts its ticks
(``tick_seq``, ``last_tick_id``: the dispatch ledger's tick id).  Every
device program it enqueues is observed in the dispatch ledger
(``runtime/devprof.py``, ``devprof=``) under the JAX engine's program
kinds.  One tick runs at a time on an engine
(a lock).  The device is ``"cuda"`` unless the caller asks for the CPU;
without CUDA the default raises instead of carrying on on the CPU.

Durable state and telemetry, as in the JAX engine: ``snapshot_state``
captures the converged chunks' planes, row signatures and pack-K hints
(one batched read per chunk); ``stage_restore`` stages such an image,
consumed by the next tick before the no-op gate, which verifies every
row's signature and the cluster tensors (equal: the tick replays with
no launch; drifted: the drift gate; churned rows: the sub-batch);
``post_tick`` is called after each tick under the tick lock (the
snapshot manager's hook, ``runtime/snapshot.py``).  Each tick reports
into ``metrics`` (``runtime/metrics.py``; the JAX engine's series
except ``engine_xla_compiles_total`` and
``engine_persistent_cache_total``, which have no XLA behind them) and
feeds the flight recorder (``runtime/flightrec.py``) from the wire
arrays its drains already read.  ``prewarm`` builds the kernel.
"""

from __future__ import annotations

import logging
import threading
import time
from dataclasses import dataclass, field
from typing import Optional, Sequence

import numpy as np
import torch

from kubeadmiral_tpu_torch.convert import tensor
from kubeadmiral_tpu_torch.models import types as T
from kubeadmiral_tpu_torch.ops import phase1 as phase1_mod
from kubeadmiral_tpu_torch.ops.pipeline import (
    DRIFT_RECOMPUTE,
    DRIFT_WCHECK,
    NIL_REPLICAS,
    PackedRows,
    TickInputs,
    drift_gate_compact,
    drift_gate_dense,
    drift_survivor,
    drift_wcheck,
    expand_compact,
    pack_wire,
    refresh_scores,
    schedule_tick,
    schedule_tick_narrow,
    unpack_wire,
)
from kubeadmiral_tpu_torch.ops.planner import INT32_INF, RoundBudget
from kubeadmiral_tpu_torch.runtime import devprof as devprof_mod
from kubeadmiral_tpu_torch.runtime import flightrec as flightrec_mod
from kubeadmiral_tpu_torch.runtime import trace
from kubeadmiral_tpu_torch.runtime.metrics import Metrics, null_metrics
from kubeadmiral_tpu_torch.scheduler import compact as Cmp
from kubeadmiral_tpu_torch.scheduler.compact import (
    CompactInputs,
    CompactVocab,
    VocabOverflow,
    featurize_compact,
)
from kubeadmiral_tpu_torch.scheduler.featurize import (
    ClusterView,
    _build_cluster_view,
    featurize,
    featurize_signature,
)

# TickInputs fields carrying cluster-axis-only state: uploaded once per
# tick and shared by every chunk.
_CLUSTER_ONLY_FIELDS = ("alloc", "used", "cpu_alloc", "cpu_avail", "cluster_valid")

# Duplicate-mode placements carry no replica count.
DUPLICATE = None

# Chunk geometry, as the JAX engine's defaults: a 4096 x 5120 cell budget
# keeps full 4096-row chunks through C = 5120; from C = 256 row counts
# bucket to a 3-rung ladder; rows pad to at least 64 and the cluster axis
# to at least 8.
CELL_BUDGET = 4096 * 5120
MEGACHUNK_ROWS = 4096
CANONICAL_C = 256
MIN_ROW_BUCKET = 64
MIN_CLUSTER_BUCKET = 8
# Narrow solve and packed wire, as the JAX engine's defaults: the
# candidate width M is pow2 over the chunk's finite maxClusters bound,
# floored at NARROW_M (capacity-spill headroom); the wire's slot count K
# is pow2 over the same bound, floored at PACK_K_MIN.
NARROW_M = 128
PACK_K_MIN = 16
# The chunk cache's budget in bytes (the JAX engine's default): an entry
# is charged its host rows three times over plus 15 B per padded cell of
# device planes (previous outputs, feasibility, reasons); chunks past the
# budget run uncached.
CACHE_BYTES = 16 << 30
# Adaptive wire width, as the JAX engine's defaults: when the byte-optimal
# K leaves more than PACK_OVERFLOW_PCT of a chunk's rows overflowing, K
# widens to meet that share if the wire then costs at most PACK_WIDEN
# times the byte optimum.
PACK_OVERFLOW_PCT = 0.01
PACK_WIDEN = 1.25
# Chunks in flight before the window is drained (the JAX engine's
# default KT_PIPELINE_DEPTH); 1 is the sequential dispatch.
PIPELINE_DEPTH = 16
# Weighted planner rounds a windowed dispatch runs without reading the
# card, per round loop (three a solve).  Every row of the c3 and c5
# worlds settles in one round (testing/sample_counts.py,
# planner_rounds), and a chunk with a row still going after
# PLANNER_ROUNDS is dispatched again at its drain, so any budget is
# exact; each extra round is host time in every windowed dispatch.
PLANNER_ROUNDS = 1

# Bits of the per-row diff mask against the previous tick's planes.
_DIFF_PLACEMENT = 1
_DIFF_SCORES = 2

log = logging.getLogger("kubeadmiral.engine")

# The snapshot payload's format (the JAX engine's version: the payloads
# have the same keys and dtypes).
SNAPSHOT_STATE_VERSION = 1

# Placeholder members of a restored chunk's ``units`` list: never a live
# unit object, so the cache's identity check falls through to the
# signature comparison for every row of a restored chunk.
_RESTORE_SENTINEL = object()


class _SnapshotView:
    """The cluster-tensor face of a ClusterView rebuilt from a snapshot:
    a restored chunk whose relisted cluster tensors differ holds one as
    ``prev_view``, and the drift machinery reads only ``names`` and the
    four resource planes (``_drift_delta``, ``_wcheck_cpu_device``), so
    a stale snapshot resumes through the drift gate."""

    __slots__ = ("names", "alloc", "used", "cpu_alloc", "cpu_avail")

    def __init__(self, names, alloc, used, cpu_alloc, cpu_avail):
        self.names = list(names)
        self.alloc = np.asarray(alloc)
        self.used = np.asarray(used)
        self.cpu_alloc = np.asarray(cpu_alloc)
        self.cpu_avail = np.asarray(cpu_avail)


class _FrozenDict(dict):
    """Read-only mapping for ScheduleResults (the JAX engine shares its
    cached decodes by reference; the port keeps the same contract)."""

    __slots__ = ()

    def _blocked(self, *a, **k):
        raise TypeError(
            "ScheduleResult mappings are read-only; build a new dict instead "
            "of mutating"
        )

    __setitem__ = __delitem__ = __ior__ = _blocked
    clear = pop = popitem = setdefault = update = _blocked

    def __reduce__(self):  # deepcopy/pickle detach to a plain dict
        return (dict, (dict(self),))


@dataclass(frozen=True)
class ScheduleResult:
    """Placement decision for one object: cluster -> replicas (None in
    Duplicate mode), mirroring core.ScheduleResult.SuggestedClusters.
    ``scores`` holds the selected clusters' post-normalize totals on a
    tick that asked for them (``want_scores``), else it is empty."""

    clusters: dict[str, Optional[int]]
    scores: dict[str, int] = field(default_factory=dict)

    def __post_init__(self):
        if type(self.clusters) is not _FrozenDict:
            object.__setattr__(self, "clusters", _FrozenDict(self.clusters))
        if type(self.scores) is not _FrozenDict:
            object.__setattr__(self, "scores", _FrozenDict(self.scores))

    @property
    def cluster_set(self) -> set[str]:
        return set(self.clusters)


def _pad_batch(inputs: TickInputs, b_pad: int) -> TickInputs:
    """Pad the object axis with inert rows (no members, Duplicate mode)."""
    b = inputs.total.shape[0]
    if b == b_pad:
        return inputs
    extra = b_pad - b

    def pad(x, fill):
        shape = (extra,) + x.shape[1:]
        return np.concatenate([x, np.full(shape, fill, x.dtype)])

    per_object_fill = {
        "filter_enabled": False,
        "api_ok": False,
        "taint_ok_new": False,
        "taint_ok_cur": False,
        "selector_ok": False,
        "placement_has": False,
        "placement_ok": False,
        "request": 0,
        "score_enabled": False,
        "taint_counts": 0,
        "affinity_scores": 0,
        "webhook_ok": True,
        "webhook_scores": 0,
        "max_clusters": 0,
        "mode_divide": False,
        "sticky": False,
        "current_mask": False,
        "current_replicas": NIL_REPLICAS,
        "total": 0,
        "weights_given": True,
        "weights": 0,
        "min_replicas": 0,
        "max_replicas": np.iinfo(np.int32).max,
        "scale_max": np.iinfo(np.int32).max,
        "capacity": np.iinfo(np.int32).max,
        "keep_unschedulable": False,
        "avoid_disruption": False,
        "tiebreak": 0,
    }
    fields = {}
    for name, arr in inputs._asdict().items():
        if name in per_object_fill:
            fields[name] = pad(np.asarray(arr), per_object_fill[name])
        else:
            fields[name] = arr  # cluster-axis tensors are shared
    return TickInputs(**fields)


# Fill values for padded cluster slots, per [B, C] field.
_CLUSTER_AXIS_FILL = {
    "api_ok": False,
    "taint_ok_new": False,
    "taint_ok_cur": False,
    "selector_ok": False,
    "placement_ok": False,
    "taint_counts": 0,
    "affinity_scores": 0,
    "webhook_ok": True,
    "webhook_scores": 0,
    "current_mask": False,
    "current_replicas": NIL_REPLICAS,
    "weights": 0,
    "min_replicas": 0,
    "max_replicas": np.iinfo(np.int32).max,
    "scale_max": np.iinfo(np.int32).max,
    "capacity": np.iinfo(np.int32).max,
    "tiebreak": 0,
}


def _pad_clusters(inputs: TickInputs, c_pad: int) -> TickInputs:
    """Pad the cluster axis of the [B, C] planes with invalid slots; the
    cluster-axis-only tensors (cluster_valid=False on padded slots) are
    padded once per tick by _cluster_planes_device."""
    c = inputs.cluster_valid.shape[0]
    if c == c_pad:
        return inputs
    fields = {}
    for name, arr in inputs._asdict().items():
        fill = _CLUSTER_AXIS_FILL.get(name)
        if fill is not None:
            arr = np.asarray(arr)
            pad = np.full((arr.shape[0], c_pad - c), fill, arr.dtype)
            arr = np.concatenate([arr, pad], axis=1)
        fields[name] = arr
    return TickInputs(**fields)


def _pow2_bucket(n: int, minimum: int, cap: int) -> int:
    b = minimum
    while b < n:
        b *= 2
    return min(b, max(cap, minimum))


def _cluster_bucket(n: int, minimum: int) -> int:
    """Cluster-axis bucket: power-of-two up to 512, then the next
    multiple of 512 (5k clusters pad to 5120, not 8192)."""
    if n <= 512:
        return _pow2_bucket(n, minimum, 1 << 30)
    return ((n + 511) // 512) * 512


def _finite_bound(max_clusters) -> int:
    """The largest finite, non-negative maxClusters of a chunk (0 if none)."""
    mc = np.asarray(max_clusters)
    finite = mc[(mc >= 0) & (mc < INT32_INF)]
    return int(finite.max()) if finite.size else 0


def _bitpack_bool(x):
    """bool[N, C] -> i32[N, ceil(C/32)] little-endian bit words: a mask
    costs 1 bit per cluster on the wire instead of 32."""
    n, c = x.shape
    x = torch.nn.functional.pad(x.to(torch.int64), (0, (-c) % 32))
    bit = 2 ** torch.arange(32, dtype=torch.int64, device=x.device)
    words = (x.reshape(n, -1, 32) * bit).sum(dim=-1)
    # The uint32 word's bits as int32.
    return torch.where(words >= 2**31, words - 2**32, words).to(torch.int32)


def _unpack_bits(words: np.ndarray, c: int) -> np.ndarray:
    """Host inverse of _bitpack_bool: i32[N, ceil(C/32)] -> uint8[N, C]."""
    u8 = np.ascontiguousarray(words.astype("<i4")).view(np.uint8)
    bits = np.unpackbits(u8.reshape(words.shape[0], -1), axis=1, bitorder="little")
    return bits[:, :c]


def _gather_overflow3(sel, cnt, rep, idx):
    """K-overflow row fetch: bit-packed selected/counted masks plus the
    replica plane of the given rows in ONE transfer (C/32 + C/32 + C
    words against the dense 3C)."""
    return torch.cat(
        [_bitpack_bool(sel[idx] != 0), _bitpack_bool(cnt[idx] != 0), rep[idx]],
        dim=1,
    )


def _gather_overflow4(sel, cnt, rep, sco, idx):
    """The score-carrying variant, for a decode that carries scores: the
    score plane's C words after _gather_overflow3's."""
    return torch.cat([_gather_overflow3(sel, cnt, rep, idx), sco[idx]], dim=1)


def _pad_cluster_axis(arr, c_pad: int, fill):
    arr = np.asarray(arr)
    extra = c_pad - arr.shape[0]
    if extra <= 0:
        return arr
    return np.concatenate([arr, np.full((extra,) + arr.shape[1:], fill, arr.dtype)])


def _diff_bits(out, prev: tuple, n: int) -> torch.Tensor:
    """i8[n] per-row diff of a tick's first n output rows against the
    previous tick's planes: _DIFF_PLACEMENT when selected, replicas or
    counted changed, _DIFF_SCORES when the score plane changed."""
    psel, prep, pcnt, psco = (p[:n] for p in prev)
    place = (
        (out.selected[:n] != psel)
        | (out.replicas[:n] != prep)
        | (out.counted[:n] != pcnt)
    ).any(dim=1)
    score = (out.scores[:n] != psco).any(dim=1)
    return place.to(torch.int8) * _DIFF_PLACEMENT + score.to(torch.int8) * _DIFF_SCORES


@dataclass
class _CachedChunk:
    """A previous tick's featurized chunk, patchable row by row, with the
    device state and decodes the steady-state paths reuse."""

    sigs: list
    units: list  # identity fast path: `is`-compare before sig-compare
    inputs: object  # TickInputs (dense) or CompactInputs, host arrays
    fmt: str  # "compact" | "dense"
    topo_fp: tuple
    nbytes: int
    # The CompactVocab instance the cached ids were issued by (0 for
    # dense): ids mean nothing against another instance's tables.
    vocab_uid: int = 0
    # Device copies of the padded per-object tensors and their shape key
    # ((B, C), plus the sparse-entry and key-byte widths for compact).
    device_per_object: Optional[dict] = None
    padded_shape: Optional[tuple] = None
    # The previous tick's device planes (selected, replicas, counted,
    # scores) at the padded shape, its feasibility and reason planes, the
    # per-row feasible counts of prev_feas (kept beside it at every
    # store and repair, read by the drift gate) and its decoded results;
    # prev_view is the ClusterView they were computed against (the same
    # view and a clean hit replay with no dispatch).
    prev_out: Optional[tuple] = None
    prev_feas: Optional[torch.Tensor] = None
    prev_reasons: Optional[torch.Tensor] = None
    prev_nfeas: Optional[torch.Tensor] = None
    prev_results: Optional[list] = None
    # Whether prev_results carry score dicts (decoded on a want_scores
    # tick): a tick that wants scores replays them only then.
    prev_has_scores: bool = False
    prev_view: Optional[object] = None
    # (changed rows, their featurized rows) of the last patch, consumed
    # once by the sub-batch path.
    last_patch: Optional[tuple] = None
    # Rows whose device input copy is stale (patched on the host since
    # the last upload), and rows whose prev_out planes are stale (merged
    # on the host by a sub-batch pass whose write-back could not run):
    # the next delta fetch gathers the latter whatever the diff says.
    stale_rows: Optional[list] = None
    stale_out_rows: Optional[list] = None
    # Adaptive wire width from the observed selected counts (0: none
    # yet, use the static maxClusters bound) and its shrink hysteresis.
    pack_k_hint: int = 0
    pack_shrink_votes: int = 0
    # Restored from a snapshot and not yet ticked: the next cache check
    # verifies every row's signature, whatever dirty-row hint it gets.
    restored: bool = False


@dataclass
class _InFlight:
    """A chunk's full dispatch queued on the device, awaiting its drain:
    its outputs, certificate (narrow; None dense), the planner's
    unsettled rows (bool[B] under a round budget, else None) and what the
    drain needs to re-dispatch, re-solve and fetch it."""

    slot: int
    entry: Optional[_CachedChunk]
    out: object  # TickOutputs
    cert: Optional[torch.Tensor]
    unsettled: Optional[torch.Tensor]
    device_in: object
    fmt: str
    n: int
    pack_k: int
    m: Optional[int]
    key_max: Optional[int]
    delta_ok: bool
    # Whether a full fetch decodes scores (the tick's want_scores); a
    # delta fetch follows its entry's prev_has_scores.
    want_scores: bool = False
    # Rows the certificate fallback re-solved (forced into the delta).
    fb_rows: Optional[np.ndarray] = None


def _planes(out) -> tuple:
    """The five planes a wire packs, in pack_wire's order."""
    return (out.selected, out.replicas, out.counted, out.scores, out.reasons)


class SchedulerEngine:
    """Chunked, shape-bucketed engine around ops.pipeline's narrow and
    dense ticks, with the JAX engine's chunk cache, no-op replay,
    sub-batch path and delta fetch.

    ``device`` defaults to ``"cuda"`` (phase 1 then runs as the
    hand-written kernel); pass ``device="cpu"`` for the plain torch path.
    The chunk geometry, candidate width, wire width and cache budget are
    the JAX engine's defaults (module constants above): 4096-row chunks,
    a 4096 x 5120 cell budget, M >= 128, K >= 16 and 16 GiB.

    ``schedule`` treats the unit list and the units as immutable: derive
    a changed batch as a fresh list with fresh unit objects.

    ``metrics`` is the registry each tick reports into (None: a private
    one); ``flight_recorder`` is the decision recorder the drains feed
    ("default": the process-wide one, None: no recording)."""

    def __init__(self, device="cuda", metrics: Optional[Metrics] = None,
                 flight_recorder="default", devprof="default"):
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                "SchedulerEngine: CUDA is not available; pass device='cpu' "
                "to run on the CPU"
            )
        # Per-stage wall seconds of the last schedule() call: featurize
        # (host encoding, padding, cache checks, input repairs, drift
        # gate dispatch), device (upload + tick; the weight checks,
        # survivor programs and windowed dispatches as queued, the
        # sequential ones synchronised), narrow_fallback (dense re-solve
        # of uncertified rows and their write-back, synchronised), fetch
        # (certificate, diff mask, gate mask and weight-check reads,
        # pack and device->host copies; with the window, the wait for
        # the card's work lands here, as in the JAX engine, so a
        # windowed device stage is not comparable with a sequential
        # one), gate_wait (the gate-mask and weight-check reads, inside
        # fetch), overflow_fetch (the K-overflow re-fetch, inside
        # fetch), decode (ScheduleResult construction, merges, drift
        # classification).
        self.timings: dict[str, float] = {}
        # Rows certified by the narrow solve ("rows") and rows re-solved
        # dense ("fallback"); narrow_last_m is the latest dispatch's M.
        self.narrow_stats = {"rows": 0, "fallback": 0}
        self.narrow_last_m = 0
        # Cumulative device->host result bytes, rows whose selected set
        # overflowed the wire's K slots and were re-fetched, and
        # host->device bytes: "object" counts per-object inputs (chunk
        # uploads, stale-row repairs, sub-batch slabs), "cluster" the
        # shared cluster planes and vocabulary tables.
        self.fetch_bytes_total = 0
        self.overflow_rows_total = 0
        self.upload_bytes = {"object": 0, "cluster": 0}
        # Chunk-cache outcomes per chunk ("hit": rows unchanged, "patch":
        # a few rows re-featurized, "miss": full featurize) and fetch
        # paths ("noop": no dispatch, "subbatch": only changed rows
        # scheduled, "skip": dispatched, no row changed, "delta": changed
        # rows gathered, "full": the whole chunk fetched).
        self.cache_stats = {"hit": 0, "patch": 0, "miss": 0}
        self.fetch_stats = {"noop": 0, "subbatch": 0, "skip": 0, "delta": 0, "full": 0}
        # Global rows whose placement may have changed in the last call
        # ([] none, None unknown: a chunk was fetched whole).
        self.last_changed: Optional[list[int]] = None
        # Drift-gate row classes (the JAX engine's keys; this engine runs
        # its default unified survivor stream, so the resolve, replan and
        # score_only keys stay 0): gated chunks; skip rows (provably
        # unchanged); wcheck rows (dynamic-weight check) and
        # wcheck_changed of them; recompute rows sent to the sub-batch
        # slabs; unified rows settled by the survivor program and
        # unified_fallback rows failing its certificate; fallback chunks
        # (most rows moved: the full dispatch).
        self.drift_stats = {
            "gated": 0, "skip": 0, "wcheck": 0, "wcheck_changed": 0,
            "recompute": 0, "resolve": 0, "resolve_fallback": 0,
            "replan": 0, "replan_fallback": 0,
            "score_only": 0, "score_only_fallback": 0,
            "unified": 0, "unified_fallback": 0,
            "fallback": 0,
        }
        # Survivor program shapes: rows dispatched, groups, group-padded
        # rows and rows failing the certificate.
        self.survivor_stats = {
            "rows": 0, "groups": 0, "padded_rows": 0, "fallback_rows": 0,
        }
        self._chunk_cache: dict[int, _CachedChunk] = {}
        self._cache_used = 0
        # (cluster fingerprint, view): an unchanged cluster list yields
        # the same ClusterView object, the identity the no-op paths key on.
        self._view_cache: tuple = (None, None)
        # One vocabulary per recent topology (None: the topology
        # overflows a cap, dense fallback).
        self._vocabs: dict[tuple, Optional[CompactVocab]] = {}
        # Device copies of the current vocabulary tables and of the
        # padded cluster planes, each keyed to what it was built from.
        self._device_tables: Optional[tuple] = None
        self._cluster_device: Optional[tuple] = None
        # The previous view's padded cpu planes on the device (the old
        # side of the drift weight check), keyed like _cluster_device.
        self._old_cpu_device: Optional[tuple] = None
        # Whole-batch no-op gate: (units list, row id array, view,
        # results, chunks) of the last call, or None.
        self._noop_gate: Optional[tuple] = None
        # Selected counts observed this tick, per cache entry, committed
        # as one pack-K vote per entry at the end of the tick.
        self._nsel_pending: dict[int, list] = {}
        # One tick at a time: overlapping ticks from several threads
        # would race the chunk cache.
        self._schedule_lock = threading.Lock()
        # Chunks in flight before a drain (1: the sequential dispatch),
        # and windowed chunks dispatched again because a planner row
        # was still going after PLANNER_ROUNDS.
        self.pipeline_depth = PIPELINE_DEPTH
        self.planner_reruns = 0
        # Ticks with units so far, and the last tick's id: the dispatch
        # ledger's tick id, shared by the waterfall, the trace span and
        # the logs (the tick count when the ledger is off).
        self.tick_seq = 0
        self.last_tick_id = 0
        # Dispatch ledger (runtime/devprof.py): every device program the
        # engine enqueues is observed (devprof.observe), so per-tick waterfalls
        # split the host stage timers into device time per program.
        # "default" is the process-wide ledger behind GET
        # /debug/waterfall; pass a DispatchLedger of its own, or None
        # for a disabled one.
        if devprof == "default":
            devprof = devprof_mod.get_default()
        self.devprof = devprof or devprof_mod.DispatchLedger(enabled=False)
        # Telemetry registry (runtime/metrics.py): per-tick stage
        # histograms and path counters, emitted from the host counters
        # above after each tick.
        self.metrics = metrics or null_metrics()
        self.devprof.attach(self.metrics)
        # Rows featurized per path ("full": whole chunks, "delta":
        # patched rows), and stale device-input rows repaired per phase
        # ("churn": eagerly in the tick that made them stale, "drift":
        # by a drift gate first, "dispatch": at a full dispatch).
        self.featurize_rows = {"full": 0, "delta": 0}
        self.stale_repair_rows = {"churn": 0, "drift": 0, "dispatch": 0}
        # Device programs queued (ticks, slabs, re-dispatches, dense
        # re-solves, gates, weight checks, survivor groups), and the
        # (fmt, B, C) shapes the tick dispatches have run at.
        self.dispatches_total = 0
        self.program_shapes: set[tuple] = set()
        # Decision flight recorder (runtime/flightrec.py), armed per
        # tick in _tick_rec.
        self.flightrec = (
            flightrec_mod.get_default()
            if flight_recorder == "default"
            else flight_recorder
        )
        self._tick_rec = None
        # A staged snapshot (stage_restore), consumed by the next tick;
        # restore_info says what that consumption decided.
        self._pending_restore: Optional[tuple] = None
        self.restore_info: Optional[dict] = None
        # Called with the engine after every tick, under the tick lock
        # (the snapshot manager's capture hook).
        self.post_tick = None

    @property
    def chunk_size(self) -> int:
        """Rows per chunk at most (MEGACHUNK_ROWS), which the controller
        manager reads to size its prewarm."""
        return MEGACHUNK_ROWS

    def prewarm(
        self,
        n_objects: int,
        n_clusters: int,
        scalar_resources: Sequence[str] = (),
        key_len: int = 32,
        policy_entries: int = 1,
        webhooks: bool = False,
        wait: bool = False,
    ) -> threading.Thread:
        """Build the phase-1 kernel in a background thread, so the first
        tick does not wait for nvcc, then run one warm dispatch at the
        workload's geometry (``_warm_dispatch``); the JAX engine's
        signature (its arguments pick the XLA program shapes its ladder
        compiles; ``policy_entries`` and ``webhooks`` pick programs the
        port does not compile).  On the CPU it builds nothing.  A
        failure is logged here, and the first tick's build then raises."""
        del policy_entries, webhooks

        def run():
            try:
                if self.device.type == "cuda":
                    phase1_mod._library()
                self._warm_dispatch(n_objects, n_clusters, scalar_resources, key_len)
            except Exception:
                log.warning("engine prewarm failed", exc_info=True)

        thread = threading.Thread(target=run, daemon=True, name="engine-prewarm")
        thread.start()
        if wait:
            thread.join()
        return thread

    def _warm_dispatch(self, n_objects: int, n_clusters: int,
                       scalar_resources: Sequence[str] = (), key_len: int = 32) -> None:
        """One chunk dispatch of a one-object warm world at the
        workload's geometry (rows up to ``n_objects``, ``n_clusters``
        clusters advertising ``scalar_resources``, a ``key_len`` key):
        the JAX engine's prewarm ladder cut to the production program.
        It loads the kernel module and warms the caching allocator, so
        the first tick starts on a warm card.  Uses none of the engine's
        caches or counters; its programs land in the dispatch ledger's
        untracked ring."""
        alloc = {"cpu": "8", "memory": "16Gi", **{r: "8" for r in scalar_resources}}
        avail = {"cpu": "4", "memory": "8Gi", **{r: "4" for r in scalar_resources}}
        gvk = "apps/v1/Deployment"
        clusters = [
            T.ClusterState(
                name=f"warm-{j}", labels={}, taints=(),
                allocatable=T.parse_resources(alloc),
                available=T.parse_resources(avail),
                api_resources=frozenset({gvk}),
            )
            for j in range(max(1, n_clusters))
        ]
        unit = T.SchedulingUnit(
            gvk=gvk, namespace="prewarm",
            name="prewarm".ljust(max(1, key_len - len("prewarm/")), "x"),
            scheduling_mode=T.MODE_DIVIDE, desired_replicas=1,
            resource_request=T.parse_resources(
                {"cpu": "100m", **{r: "1" for r in scalar_resources}}
            ),
        )
        view = _build_cluster_view(clusters, [unit])
        vocab = CompactVocab(view)
        c_bucket, eff_chunk, ladder = self._tick_geometry(len(clusters))
        b_pad = self._bucket_rows(min(max(1, n_objects), eff_chunk), ladder, eff_chunk, False)
        padded = self._pad_for_dispatch(
            featurize_compact([unit], view, vocab), "compact", b_pad, c_bucket
        )
        host = {
            **{n: np.asarray(getattr(padded, n)) for n in self._per_object_fields("compact")},
            **Cmp.pad_tables(vocab.tables(), c_bucket),
            **self._cluster_planes_host(view, c_bucket),
        }
        device_in = CompactInputs(**{k: tensor(v, self.device) for k, v in host.items()})
        tick_in = expand_compact(device_in, self._key_max(padded, "compact"))
        self.devprof.observe("tiebreak", tick_in.tiebreak)
        m = self._narrow_m(padded, c_bucket)
        if m is None:
            self.devprof.observe("tick", schedule_tick(tick_in))
        else:
            self.devprof.observe("tick_narrow", schedule_tick_narrow(tick_in, m))
        self._sync()

    # -- shape policy ----------------------------------------------------
    def _tick_geometry(self, n_clusters: int) -> tuple[int, int, Optional[list]]:
        """(c_bucket, eff_chunk, row ladder or None): cell-budget
        chunking, with wide cluster axes bucketing rows to a 3-rung
        ladder."""
        c_bucket = _cluster_bucket(n_clusters, MIN_CLUSTER_BUCKET)
        max_rows = max(
            MIN_ROW_BUCKET, min(MEGACHUNK_ROWS, CELL_BUDGET // max(1, c_bucket))
        )
        # MEGACHUNK_ROWS also stands for the JAX engine's chunk_size (both
        # 4096 by default), which caps the chunk below MIN_ROW_BUCKET too.
        eff_chunk = min(MEGACHUNK_ROWS, 1 << (max_rows.bit_length() - 1))
        ladder = None
        if c_bucket >= CANONICAL_C:
            ladder = sorted(
                {
                    max(MIN_ROW_BUCKET, eff_chunk // 16),
                    max(MIN_ROW_BUCKET, eff_chunk // 4),
                    eff_chunk,
                }
            )
        return c_bucket, eff_chunk, ladder

    def _bucket_rows(
        self, n: int, ladder: Optional[list], eff_chunk: int, full: bool
    ) -> int:
        if ladder is None:
            return _pow2_bucket(n, MIN_ROW_BUCKET, eff_chunk)
        if full:
            # Multi-chunk batches pad every chunk (incl. the last
            # partial) to the full-chunk shape.
            return eff_chunk
        for rung in ladder:
            if n <= rung:
                return rung
        return eff_chunk

    @staticmethod
    def _narrow_m(inputs, c_bucket: int) -> Optional[int]:
        """The chunk's candidate width M, or None for the dense tick: pow2
        over the finite maxClusters bound, floored at NARROW_M; narrow
        only when M is narrower than the cluster bucket."""
        m = _pow2_bucket(
            max(_finite_bound(inputs.max_clusters), NARROW_M), 8, 1 << 30
        )
        return m if m < c_bucket else None

    @staticmethod
    def _pack_k(inputs, c_bucket: int, hint: int = 0) -> int:
        """The wire slot count K: the chunk's adaptive hint when it has
        one (see _commit_nsel), else pow2 over the finite maxClusters
        bound, floored at PACK_K_MIN; capped at the cluster bucket (K = C
        is lossless).  Rows selecting more than K clusters overflow and
        are re-fetched, so K tunes bytes, never correctness."""
        if hint:
            return min(max(hint, 8), c_bucket)
        k = _pow2_bucket(
            max(_finite_bound(inputs.max_clusters), PACK_K_MIN), 8, 1 << 30
        )
        return min(k, c_bucket)

    # -- adaptive wire width -----------------------------------------------
    def _observe_nsel(self, entry, nsel, c_bucket: int) -> None:
        """Buffer one fetched piece's selected counts for the entry's
        pack-K hint; _flush_nsel commits one vote per entry per tick."""
        if entry is None:
            return
        nsel = np.asarray(nsel)
        if nsel.size == 0:
            return
        slot = self._nsel_pending.get(id(entry))
        if slot is None:
            self._nsel_pending[id(entry)] = [entry, c_bucket, [nsel]]
        else:
            slot[1] = max(slot[1], c_bucket)
            slot[2].append(nsel)

    def _flush_nsel(self) -> None:
        pending, self._nsel_pending = self._nsel_pending, {}
        for entry, c_bucket, pieces in pending.values():
            self._commit_nsel(
                entry,
                pieces[0] if len(pieces) == 1 else np.concatenate(pieces),
                c_bucket,
            )

    @staticmethod
    def _commit_nsel(entry, nsel, c_bucket: int) -> None:
        """One tick's selected counts -> the entry's pack-K hint: the pow2
        K with the fewest expected wire bytes over the observed counts
        (each row pays 4K+2 words; an overflow row also pays its ~4.25 C
        bytes of re-fetch), widened to hold overflow under
        PACK_OVERFLOW_PCT when that costs at most PACK_WIDEN times the
        optimum.  The hint rises at once and halves only after two
        consecutive shrink votes."""
        nsel = np.asarray(nsel)
        over_bytes = 4.25 * c_bucket

        def cost_at(k_eff: int) -> float:
            return nsel.size * (4 * k_eff + 2) * 4 + float(
                (nsel > k_eff).sum()
            ) * over_bytes

        best_k, best_cost = None, None
        k = _pow2_bucket(PACK_K_MIN, 8, 1 << 30)
        while True:
            k_eff = min(k, c_bucket)
            cost = cost_at(k_eff)
            if best_cost is None or cost < best_cost:
                best_k, best_cost = k_eff, cost
            if k_eff >= c_bucket:
                break
            k *= 2
        if float((nsel > best_k).mean()) > PACK_OVERFLOW_PCT:
            k2 = best_k
            while k2 < c_bucket:
                k2 = min(k2 * 2, c_bucket)
                if float((nsel > k2).mean()) <= PACK_OVERFLOW_PCT:
                    break
            if cost_at(k2) <= best_cost * PACK_WIDEN:
                best_k = k2
        if best_k >= entry.pack_k_hint:
            entry.pack_k_hint = best_k
            entry.pack_shrink_votes = 0
        else:
            entry.pack_shrink_votes += 1
            if entry.pack_shrink_votes >= 2:
                entry.pack_k_hint = max(best_k, entry.pack_k_hint // 2)
                entry.pack_shrink_votes = 0

    # -- cluster view and vocabulary caching -------------------------------
    @staticmethod
    def _cluster_fingerprint(clusters, scalar_resources: tuple) -> tuple:
        return (
            tuple(
                (
                    c.name,
                    tuple(sorted(c.labels.items())),
                    c.taints,
                    tuple(sorted(c.allocatable.items())),
                    tuple(sorted(c.available.items())),
                    c.api_resources,
                )
                for c in clusters
            ),
            scalar_resources,
        )

    def _cached_view(self, units, clusters) -> ClusterView:
        """The same ClusterView object while the cluster state and the
        units' scalar resources are unchanged; a rebuild over the same
        cluster names keeps the tie-break hash cache."""
        scalars = tuple(
            sorted(
                {
                    r
                    for su in units
                    for r in su.resource_request
                    if r not in ("cpu", "memory", "ephemeral-storage")
                }
            )
        )
        fp = self._cluster_fingerprint(clusters, scalars)
        cached_fp, cached_view = self._view_cache
        if cached_fp == fp and cached_view is not None:
            return cached_view
        view = _build_cluster_view(clusters, units)
        if cached_view is not None and cached_view.names == view.names:
            view._tiebreak_cache = cached_view._tiebreak_cache
        self._view_cache = (fp, view)
        return view

    @staticmethod
    def _topo_fingerprint(view: ClusterView) -> tuple:
        """Everything cached rows depend on (names, taints, labels, API
        resources, scalar columns) but not resource quantities, which
        reach the tick through the cluster planes."""
        fp = getattr(view, "_topo_fp", None)
        if fp is None:
            fp = (
                tuple(view.names),
                tuple(view.taint_sets),
                view.taint_id.tobytes(),
                tuple(view.label_keys),
                view.label_id.tobytes(),
                tuple(frozenset(c.api_resources) for c in view.clusters),
                tuple(view.scalar_resources),
            )
            view._topo_fp = fp
        return fp

    def _vocab_for(self, view: ClusterView, topo_fp: tuple) -> Optional[CompactVocab]:
        """The engine-wide compact vocabulary for this topology (the four
        most recent are kept); None when the topology itself overflows a
        cap (dense fallback)."""
        if topo_fp in self._vocabs:
            return self._vocabs[topo_fp]
        try:
            vocab = CompactVocab(view)
        except VocabOverflow:
            self.metrics.counter("engine_vocab_overflow_total", scope="topology")
            vocab = None
        while len(self._vocabs) >= 4:
            self._vocabs.pop(next(iter(self._vocabs)))
        self._vocabs[topo_fp] = vocab
        return vocab

    # -- featurization ---------------------------------------------------
    @staticmethod
    def _per_object_fields(fmt: str) -> tuple:
        if fmt == "compact":
            return Cmp.PER_OBJECT_FIELDS
        return tuple(f for f in TickInputs._fields if f not in _CLUSTER_ONLY_FIELDS)

    def _featurize_full(self, chunk, clusters, view, vocab):
        """(inputs, fmt): compact unless the vocabulary overflows."""
        if vocab is not None:
            try:
                return featurize_compact(chunk, view, vocab), "compact"
            except VocabOverflow:
                self.metrics.counter("engine_vocab_overflow_total", scope="chunk")
        return featurize(chunk, clusters, view=view).inputs, "dense"

    def _featurize_rows(self, units, clusters, view, vocab, cached):
        """Featurize just the changed rows in the cached entry's format,
        aligned to its sparse and key widths; None when they cannot be
        patched in (wider rows, vocabulary overflow)."""
        if cached.fmt == "dense":
            return featurize(units, clusters, view=view).inputs
        if vocab is None:
            return None
        try:
            sub = featurize_compact(units, view, vocab)
        except VocabOverflow:
            self.metrics.counter("engine_vocab_overflow_total", scope="patch")
            return None
        p_cached = np.asarray(cached.inputs.sparse_idx).shape[1]
        l_cached = np.asarray(cached.inputs.key_bytes).shape[1]
        if (
            np.asarray(sub.sparse_idx).shape[1] > p_cached
            or np.asarray(sub.key_bytes).shape[1] > l_cached
        ):
            return None
        sub = Cmp.pad_axis1(sub, Cmp.SPARSE_FILLS, p_cached)
        return Cmp.pad_axis1(sub, {"key_bytes": 0}, l_cached)

    def _featurize_chunk(
        self, idx: int, chunk, clusters, view, webhook_eval, vocab, dirty=None
    ):
        """(inputs, status, entry, fmt); status is "hit" (rows unchanged),
        "patch" (at most a quarter of the rows re-featurized and patched
        in), "miss" (full featurize) or "nocache" (a webhook tick: the
        webhook planes are this tick's results, so the chunk is
        featurized dense and no cache entry is read or written).
        ``dirty`` (local rows) asserts every other row is the identical
        object of the previous call, so only those rows are checked (not
        on a restored chunk: every row is verified against its snapshot
        signature)."""
        if webhook_eval is not None:
            fb = featurize(chunk, clusters, view=view, webhook_eval=webhook_eval)
            self.featurize_rows["full"] += len(chunk)
            return fb.inputs, "nocache", None, "dense"
        topo_fp = self._topo_fingerprint(view)
        cached = self._chunk_cache.get(idx)
        if (
            cached is not None
            and cached.topo_fp == topo_fp
            and len(cached.units) == len(chunk)
            and (
                cached.fmt == "dense"
                or (vocab is not None and cached.vocab_uid == vocab.uid)
            )
        ):
            # Identical objects are identical rows (units are immutable),
            # so only replaced objects are signature-checked.
            if dirty is None or cached.restored:
                rows_to_check = range(len(chunk))
                cached.restored = False
            else:
                rows_to_check = dirty
            changed = [
                i
                for i in rows_to_check
                if chunk[i] is not cached.units[i]
                and featurize_signature(chunk[i]) != cached.sigs[i]
            ]
            refreshed = cached.inputs._replace(
                alloc=view.alloc,
                used=view.used,
                cpu_alloc=view.cpu_alloc,
                cpu_avail=view.cpu_avail,
            )
            cached.inputs = refreshed
            if not changed:
                cached.units = list(chunk)
                self.cache_stats["hit"] += 1
                return refreshed, "hit", cached, cached.fmt
            if len(changed) <= max(1, len(chunk) // 4):
                sub = self._featurize_rows(
                    [chunk[i] for i in changed], clusters, view, vocab, cached
                )
                if sub is not None:
                    rows = np.asarray(changed)
                    for name in self._per_object_fields(cached.fmt):
                        np.asarray(getattr(refreshed, name))[rows] = np.asarray(
                            getattr(sub, name)
                        )
                    for i in changed:
                        cached.sigs[i] = featurize_signature(chunk[i])
                    cached.units = list(chunk)
                    cached.last_patch = (changed, sub)
                    self.cache_stats["patch"] += 1
                    self.featurize_rows["delta"] += len(changed)
                    return refreshed, "patch", cached, cached.fmt

        inputs, fmt = self._featurize_full(chunk, clusters, view, vocab)
        self.cache_stats["miss"] += 1
        self.featurize_rows["full"] += len(chunk)
        if cached is not None:
            self._cache_used -= cached.nbytes
            del self._chunk_cache[idx]
        host_bytes = sum(
            np.asarray(getattr(inputs, name)).nbytes
            for name in self._per_object_fields(fmt)
        )
        b_pad = _pow2_bucket(len(chunk), MIN_ROW_BUCKET, 1 << 30)
        c_pad = _cluster_bucket(np.asarray(inputs.cluster_valid).shape[0], MIN_CLUSTER_BUCKET)
        nbytes = host_bytes * 3 + b_pad * c_pad * 15
        entry = None
        if self._cache_used + nbytes <= CACHE_BYTES:
            entry = _CachedChunk(
                sigs=[featurize_signature(su) for su in chunk],
                units=list(chunk),
                inputs=inputs,
                fmt=fmt,
                topo_fp=topo_fp,
                nbytes=nbytes,
                vocab_uid=vocab.uid if (fmt == "compact" and vocab) else 0,
            )
            prev_names = getattr(cached.prev_view, "names", None) if cached else None
            if (
                cached is not None
                and cached.fmt == fmt
                and len(cached.units) == len(chunk)
                and cached.prev_results is not None
                and len(cached.prev_results) == len(chunk)
                and prev_names is not None
                and list(prev_names) == list(view.names)
            ):
                # A topology miss over unchanged cluster names (label or
                # taint churn) or a mass row churn keeps the previous
                # outputs, so the dispatch can still delta-fetch.  Only
                # under the same name order: decodes map columns to names.
                entry.prev_out = cached.prev_out
                entry.prev_feas = cached.prev_feas
                entry.prev_reasons = cached.prev_reasons
                entry.prev_nfeas = cached.prev_nfeas
                entry.prev_results = cached.prev_results
                entry.prev_has_scores = cached.prev_has_scores
                entry.stale_out_rows = cached.stale_out_rows
            self._chunk_cache[idx] = entry
            self._cache_used += nbytes
        return inputs, "miss", entry, fmt

    def _pad_for_dispatch(self, inputs, fmt: str, b_pad: int, c_bucket: int):
        """Pad the per-object planes to (b_pad, c_bucket); the compact
        format also buckets its sparse-entry and key-byte widths.  The
        cluster-axis tensors and vocabulary tables are padded once per
        upload instead (_cluster_planes_device, _tables_device)."""
        if fmt == "dense":
            return _pad_clusters(_pad_batch(inputs, b_pad), c_bucket)
        padded = Cmp.pad_rows(inputs, b_pad)
        p = np.asarray(padded.sparse_idx).shape[1]
        padded = Cmp.pad_axis1(padded, Cmp.SPARSE_FILLS, _pow2_bucket(p, 8, 1 << 30))
        l = np.asarray(padded.key_bytes).shape[1]
        padded = Cmp.pad_axis1(padded, {"key_bytes": 0}, _pow2_bucket(l, 64, 1 << 30))
        return Cmp.pad_clusters(
            padded, c_bucket, skip=Cmp.TABLE_FIELDS + Cmp.CLUSTER_FIELDS
        )

    # -- device uploads --------------------------------------------------
    def _cluster_planes_device(self, view: ClusterView, c_bucket: int) -> dict:
        """The padded cluster-axis tensors, uploaded once per (view,
        c_bucket) and shared by every dispatch."""
        key = (id(view), c_bucket)
        if self._cluster_device is not None and self._cluster_device[0] == key:
            return self._cluster_device[2]
        host = self._cluster_planes_host(view, c_bucket)
        self.upload_bytes["cluster"] += sum(a.nbytes for a in host.values())
        dev = {k: tensor(v, self.device) for k, v in host.items()}
        # The view reference keeps id(view) stable for the key.
        self._cluster_device = (key, view, dev)
        return dev

    @staticmethod
    def _cluster_planes_host(view: ClusterView, c_bucket: int) -> dict:
        c = len(view.names)
        return {
            "alloc": _pad_cluster_axis(view.alloc, c_bucket, 0),
            "used": _pad_cluster_axis(view.used, c_bucket, 0),
            "cpu_alloc": _pad_cluster_axis(view.cpu_alloc, c_bucket, 0),
            "cpu_avail": _pad_cluster_axis(view.cpu_avail, c_bucket, 0),
            "cluster_valid": _pad_cluster_axis(np.ones(c, bool), c_bucket, False),
        }

    def _tables_device(self, vocab: CompactVocab, c_bucket: int) -> dict:
        """Device copies of the vocabulary tables, re-uploaded only when
        the vocabulary grows or the cluster padding changes."""
        key = (vocab.uid, vocab.version, c_bucket)
        if self._device_tables is None or self._device_tables[0] != key:
            tables = Cmp.pad_tables(vocab.tables(), c_bucket)
            self.upload_bytes["cluster"] += sum(
                np.asarray(t).nbytes for t in tables.values()
            )
            dev = {k: tensor(v, self.device) for k, v in tables.items()}
            self._device_tables = (key, dev)
        return self._device_tables[1]

    def _upload_per_object(self, padded, fmt: str) -> dict:
        names = self._per_object_fields(fmt)
        host = {name: np.asarray(getattr(padded, name)) for name in names}
        self.upload_bytes["object"] += sum(a.nbytes for a in host.values())
        return {name: tensor(a, self.device) for name, a in host.items()}

    def _assemble(self, per_object: dict, fmt: str, vocab, c_bucket: int, cluster_dev):
        if fmt == "compact":
            return CompactInputs(
                **per_object, **self._tables_device(vocab, c_bucket), **cluster_dev
            )
        return TickInputs(**per_object, **cluster_dev)

    def _device_inputs(self, entry, padded, status: str, fmt: str, vocab, c_bucket: int,
                       cluster_dev: dict):
        """The dispatch's device inputs.  A clean hit reuses the entry's
        device copy of its per-object tensors (stale rows repaired by a
        row scatter) and uploads nothing; anything else uploads the
        padded rows and, with an entry, keeps them as its device copy."""
        b_pad = np.asarray(padded.total).shape[0]
        shape = (b_pad, c_bucket)
        if fmt == "compact":
            shape += (
                np.asarray(padded.sparse_idx).shape[1],
                np.asarray(padded.key_bytes).shape[1],
            )
        if (
            entry is not None
            and status == "hit"
            and entry.device_per_object is not None
            and entry.padded_shape == shape
        ):
            self._repair_stale_inputs(entry, fmt, c_bucket)
            per_object = entry.device_per_object
        else:
            per_object = self._upload_per_object(padded, fmt)
            if entry is not None:
                entry.device_per_object = per_object
                entry.padded_shape = shape
                entry.stale_rows = None
        return self._assemble(per_object, fmt, vocab, c_bucket, cluster_dev)

    def _slice_rows(self, entry: _CachedChunk, rows: list):
        """The given rows of a cached chunk's host inputs, in its format."""
        idx = np.asarray(rows)
        per_object = set(self._per_object_fields(entry.fmt))
        cls = CompactInputs if entry.fmt == "compact" else TickInputs
        return cls(
            **{
                name: np.asarray(arr)[idx] if name in per_object else arr
                for name, arr in entry.inputs._asdict().items()
            }
        )

    def _repair_stale_inputs(
        self, entry, fmt: str, c_bucket: int, phase: str = "dispatch"
    ) -> None:
        """Scatter the stale rows' host inputs into the entry's device
        per-object tensors (aligned to their padded widths): a row
        upload, never a whole chunk.  ``phase`` is the stale_repair_rows
        key the rows count under."""
        stale = entry.stale_rows
        if not stale or entry.device_per_object is None:
            return
        self.stale_repair_rows[phase] += len(stale)
        piece = self._slice_rows(entry, stale)
        if fmt == "compact":
            _b, _c, p_pad, l_pad = entry.padded_shape
            piece = Cmp.pad_axis1(piece, Cmp.SPARSE_FILLS, p_pad)
            piece = Cmp.pad_axis1(piece, {"key_bytes": 0}, l_pad)
        else:
            piece = _pad_clusters(piece, c_bucket)
        rows = self._upload_per_object(piece, fmt)
        dst = self._index(stale)
        for name, dev in entry.device_per_object.items():
            dev.index_copy_(0, dst, rows[name])
        self.devprof.observe("patch", entry.device_per_object)
        entry.stale_rows = None

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _read_np(self, t: torch.Tensor) -> np.ndarray:
        """Blocking device->host copy, counted in fetch_bytes_total."""
        arr = t.cpu().numpy()
        self.fetch_bytes_total += arr.nbytes
        return arr

    def _index(self, rows) -> torch.Tensor:
        return tensor(np.asarray(rows, np.int64), self.device)

    @staticmethod
    def _key_max(inputs, fmt: str) -> Optional[int]:
        """The longest object key of compact host inputs (where the
        device-side FNV scan may stop), None for the dense format."""
        if fmt != "compact":
            return None
        key_len = np.asarray(inputs.key_len)
        return int(key_len.max()) if key_len.size else 0

    def _tick(self, device_in, fmt: str, m: Optional[int], key_max=None, budget=None):
        """One dispatch: (outputs, cert or None).  ``key_max`` bounds the
        keys (``_key_max``); ``budget`` is the planner's RoundBudget, if
        any.  The module-level tick functions are looked up at call time
        (chip_smoke counts them)."""
        if fmt == "compact":
            tick_in = expand_compact(device_in, key_max)
            self.devprof.observe("tiebreak", tick_in.tiebreak)
        else:
            tick_in = device_in
        if m is None:
            out = schedule_tick(tick_in, budget=budget)
            self.devprof.observe("tick", out)
            return out, None
        self.narrow_last_m = m
        out, cert = schedule_tick_narrow(tick_in, m, budget=budget)
        self.devprof.observe("tick_narrow", (out, cert))
        return out, cert

    # -- the tick ----------------------------------------------------------
    def schedule(
        self,
        units: Sequence[T.SchedulingUnit],
        clusters: Sequence[T.ClusterState],
        view: Optional[ClusterView] = None,
        webhook_eval=None,
        want_scores: bool = False,
        follower_index=None,
        dirty_rows=None,
    ) -> list[ScheduleResult]:
        """Schedule every unit against the clusters.

        ``view`` is a ClusterView the caller built over ``clusters``
        (None: the engine's cached one).  ``webhook_eval(unit, clusters)
        -> (ok_row, score_row) | None`` adds out-of-process plugins' mask
        and score planes (featurize.featurize).  ``want_scores`` also
        decodes each result's score dict.  ``follower_index`` (an
        ops.follower.FollowerIndex) overwrites follower rows with their
        leaders' placement union.  ``dirty_rows`` (global row indices) is
        the delta-featurization hint: the caller asserts that every row
        outside it is the identical unit object of its previous call over
        this list, so the cache check visits only those rows.  Ticks from
        several threads run one at a time; each with units advances
        ``tick_seq``, reports into ``metrics`` and then calls
        ``post_tick``."""
        if not units:
            self.last_changed = []
            return []
        with self._schedule_lock:
            before = self._tick_counters()
            # Arm the flight recorder: the drains record the rows they
            # decode; no-op and skip paths record nothing, so the
            # previous records stay current.
            rec = self.flightrec if (self.flightrec is not None and self.flightrec.enabled) else None
            self._tick_rec = rec
            if rec is not None:
                rec.begin_tick(len(units), len(clusters))
            self.tick_seq += 1
            # One correlation id per tick, shared by the dispatch-ledger
            # waterfall, the trace spans and the logs.
            self.last_tick_id = self.devprof.begin_tick(
                engine_tick=self.tick_seq,
                objects=len(units),
                clusters=len(clusters),
            ) or self.tick_seq
            t_start = time.perf_counter()
            try:
                with trace.span(
                    "engine.schedule", objects=len(units), clusters=len(clusters),
                    tick=self.last_tick_id,
                ):
                    results = self._schedule(
                        units, clusters, view, webhook_eval, want_scores, follower_index,
                        dirty_rows,
                    )
            finally:
                if rec is not None:
                    rec.end_tick()
                self.devprof.end_tick(self.timings)
            self._emit_tick_metrics(len(units), time.perf_counter() - t_start, before)
            if self.post_tick is not None:
                # A persistence failure logs; it never fails the tick.
                try:
                    self.post_tick(self)
                except Exception:
                    log.warning("post-tick hook failed", exc_info=True)
            return results

    # -- telemetry ---------------------------------------------------------
    def _tick_counters(self) -> dict:
        """The host counters a tick's metrics are deltas of."""
        return {
            "cache": dict(self.cache_stats),
            "fetch": dict(self.fetch_stats),
            "bytes": self.fetch_bytes_total,
            "overflow": self.overflow_rows_total,
            "upload": dict(self.upload_bytes),
            "drift": dict(self.drift_stats),
            "narrow": dict(self.narrow_stats),
            "featurize": dict(self.featurize_rows),
            "stale": dict(self.stale_repair_rows),
        }

    def _emit_tick_metrics(self, n_units: int, wall: float, before: dict) -> None:
        """Per-tick telemetry, the JAX engine's series: stage-latency
        histograms, cache/fetch/drift/narrow path counters as deltas of
        the host counters over this call, and shape-count and recorder
        gauges.  Every value is a host counter: nothing waits on the
        card."""
        m = self.metrics
        m.counter("engine_ticks_total")
        m.store("engine_tick_objects", n_units)
        m.histogram("engine_tick_seconds", wall)
        for stage, secs in self.timings.items():
            m.histogram("engine_tick_stage_seconds", secs, stage=stage)

        def deltas(name, now, then, label, keys=None):
            for key in keys or now:
                delta = now[key] - then.get(key, 0)
                if delta:
                    m.counter(name, delta, **{label: key})

        deltas("engine_chunk_cache_total", self.cache_stats, before["cache"], "result")
        deltas("engine_fetch_total", self.fetch_stats, before["fetch"], "path")
        bytes_delta = self.fetch_bytes_total - before["bytes"]
        if bytes_delta:
            m.counter("engine_fetch_bytes_total", bytes_delta, format="packed")
        overflow_delta = self.overflow_rows_total - before["overflow"]
        if overflow_delta:
            m.counter("engine_fetch_overflow_rows_total", overflow_delta)
        deltas("engine_upload_bytes_total", self.upload_bytes, before["upload"], "plane")
        deltas(
            "engine_drift_rows_total", self.drift_stats, before["drift"], "kind",
            keys=(
                "skip", "wcheck", "wcheck_changed", "recompute", "resolve",
                "resolve_fallback", "replan", "replan_fallback",
                "score_only", "score_only_fallback",
                "unified", "unified_fallback",
            ),
        )
        deltas("engine_stale_rows_total", self.stale_repair_rows, before["stale"], "phase")
        deltas("engine_featurize_rows_total", self.featurize_rows, before["featurize"], "path")
        for key, path in (("rows", "narrow"), ("fallback", "fallback")):
            delta = self.narrow_stats[key] - before["narrow"].get(key, 0)
            if delta:
                m.counter("engine_narrow_rows_total", delta, path=path)
        m.store("engine_program_shapes", len(self.program_shapes))
        if self._tick_rec is not None:
            st = self._tick_rec.stats()
            m.store("flightrec_records", st["records"])
            m.store("flightrec_bytes", st["bytes"])
            m.store("flightrec_ring_ticks", st["ring_ticks"])

    def _count_dispatch(self, fmt: str, b_pad: int, c_bucket: int) -> None:
        """Program-shape accounting for one tick dispatch: a shape's
        first dispatch is the shape cache's "miss", every later one a
        "hit" (the JAX engine's compile-cache series; a program shape is
        the (fmt, B, C) a dispatch runs at)."""
        shape_key = (fmt, b_pad, c_bucket)
        shape = f"{fmt}:{b_pad}x{c_bucket}"
        self.metrics.counter(
            "engine_compile_cache_total",
            result="hit" if shape_key in self.program_shapes else "miss",
            shape=shape,
        )
        self.metrics.counter("engine_dispatches_total", shape=shape)
        self.dispatches_total += 1
        self.program_shapes.add(shape_key)

    # -- durable state: snapshots (runtime/snapshot.py) ----------------------
    def _snapshot_config(self) -> dict:
        """The engine-shape fingerprint a snapshot must match to be
        restorable, under the JAX engine's keys: the port's geometry
        constants (MEGACHUNK_ROWS stands for both chunk_size and
        megachunk_rows), one device, i32 scores and the packed wire.  A
        mismatch rejects the snapshot: restore never reinterprets
        planes."""
        return {
            "version": SNAPSHOT_STATE_VERSION,
            "chunk_size": MEGACHUNK_ROWS,
            "cell_budget": CELL_BUDGET,
            "megachunk_rows": MEGACHUNK_ROWS,
            "min_bucket": MIN_ROW_BUCKET,
            "min_cluster_bucket": MIN_CLUSTER_BUCKET,
            "canonical_c": CANONICAL_C,
            "fetch_format": "packed",
            "narrow": True,
            "narrow_m": NARROW_M,
            "mesh": None,
            "score_f16": False,
        }

    @staticmethod
    def _planes_to_host(planes) -> list:
        """Host copies of several device planes in ONE device->host read:
        their bytes joined on the device, read, and split back into
        arrays of their dtypes and shapes."""
        flat = torch.cat([p.contiguous().reshape(-1).view(torch.uint8) for p in planes])
        host = flat.cpu().numpy()
        out, start = [], 0
        for p in planes:
            nbytes = p.numel() * p.element_size()
            dtype = torch.empty(0, dtype=p.dtype).numpy().dtype
            out.append(host[start : start + nbytes].view(dtype).reshape(tuple(p.shape)))
            start += nbytes
        return out

    def snapshot_state(self) -> Optional[dict]:
        """Host-side image of the engine's resumable working set: per
        converged chunk the prev output planes (placements, scores,
        feasibility, reasons), row signatures and pack-K hints, plus the
        cluster tensors they were computed against; the JAX engine's
        payload, key for key and dtype for dtype.  None when there is
        nothing coherent to persist.  Callers serialise ticks around
        this (the snapshot manager's hook runs under the tick lock)."""
        entries = sorted(self._chunk_cache.items())
        view = next((e.prev_view for _i, e in entries if e.prev_view is not None), None)
        if view is None or getattr(view, "names", None) is None:
            return None
        chunks: dict[int, dict] = {}
        rows = 0
        for idx, e in entries:
            if (
                e.prev_view is not view
                or e.prev_out is None
                or e.prev_feas is None
                or e.prev_reasons is None
                or e.prev_results is None
                or len(e.prev_results) != len(e.units)
                or e.stale_out_rows  # device planes disagree with decodes
            ):
                continue
            sel, rep, cnt, sco, feas, rsn = self._planes_to_host(
                e.prev_out + (e.prev_feas, e.prev_reasons)
            )
            chunks[idx] = {
                "n": len(e.units),
                "fmt": e.fmt,
                "sigs": list(e.sigs),
                "has_scores": e.prev_has_scores,
                "pack_k_hint": e.pack_k_hint,
                "pack_shrink_votes": e.pack_shrink_votes,
                "sel": sel,
                "rep": rep,
                "cnt": cnt,
                "sco": sco,
                "feas": feas,
                "rsn": rsn,
            }
            rows += len(e.units)
        if not chunks:
            return None
        return {
            "version": SNAPSHOT_STATE_VERSION,
            "config": self._snapshot_config(),
            "tick": self.tick_seq,
            "names": list(view.names),
            "topo_fp": None if isinstance(view, _SnapshotView) else self._topo_fingerprint(view),
            "view": {
                k: np.asarray(getattr(view, k)).copy()
                for k in ("alloc", "used", "cpu_alloc", "cpu_avail")
            },
            "rows": rows,
            "chunks": chunks,
        }

    def resident_state_bytes(self) -> dict:
        """The chunk cache's device bytes by plane family (the JAX
        engine's families; the port keeps no tie-break plane, so that
        family is 0), also stored as ``engine_resident_bytes`` gauges."""
        fams = {"prev_planes": 0, "per_object": 0, "tiebreak": 0, "vectors": 0}
        for e in self._chunk_cache.values():
            planes = (e.prev_out or ()) + (e.prev_feas, e.prev_reasons)
            fams["prev_planes"] += sum(p.nbytes for p in planes if p is not None)
            if e.device_per_object is not None:
                fams["per_object"] += sum(t.nbytes for t in e.device_per_object.values())
            if e.prev_nfeas is not None:
                fams["vectors"] += e.prev_nfeas.nbytes
        total = sum(fams.values())
        for family, v in fams.items():
            self.metrics.store("engine_resident_bytes", v, family=family)
        self.metrics.store("engine_resident_bytes_per_device", total)
        return {
            "by_family": fams,
            "total": total,
            "device_count": 1,
            "per_device": total,
            "score_dtype": "i32",
            "chunks": len(self._chunk_cache),
        }

    def stage_restore(self, payload: Optional[dict], assume_fresh: bool = False) -> None:
        """Stage a snapshot payload for the next tick, whose units and
        clusters the restore verifies it against.  ``assume_fresh`` says
        the caller's resourceVersion watermarks matched the relist —
        telemetry only: freshness is proven in the engine by equal
        cluster tensors and the per-row signature walk, so a wrong
        watermark can cost a re-solve, never a wrong placement."""
        # Under the tick lock: a tick running on another thread must not
        # consume a torn pair.
        with self._schedule_lock:
            self._pending_restore = (
                None if payload is None else (payload, bool(assume_fresh))
            )

    def _consume_restore(self, units, clusters, view: ClusterView) -> None:
        """Consume the staged payload into ``restore_info`` (the JAX
        engine's keys, plus ``seconds``: the restore's featurize, upload
        and decode wall time)."""
        payload, assume_fresh = self._pending_restore
        self._pending_restore = None
        info = {
            "result": "rejected", "fresh": False, "chunks": 0, "rows": 0,
            "watermarks_matched": assume_fresh,
            "seconds": {"featurize": 0.0, "upload": 0.0, "decode": 0.0},
        }
        self.restore_info = info
        try:
            self._restore_impl(payload, units, clusters, view, info)
        except Exception:
            log.warning("snapshot restore failed; falling back cold", exc_info=True)
            info["result"] = "rejected"
        result = info["result"]
        if result == "loaded":
            result = "loaded_fresh" if info["fresh"] else "loaded_stale"
        self.metrics.counter("engine_snapshot_total", result=result)
        log.info(
            "snapshot restore: %s chunks=%d rows=%d fresh=%s",
            result, info["chunks"], info["rows"], info["fresh"],
        )

    def _restore_impl(self, payload, units, clusters, view, info) -> None:
        """Rebuild the chunk cache from a payload: each chunk whose row
        count, padded shape and format match is featurized from the
        relisted units (signatures from the snapshot, so the tick
        verifies every row), its per-object inputs and planes uploaded
        and its results decoded.  Nothing is launched: a fresh resume's
        tick replays with no dispatch."""
        if payload.get("version") != SNAPSHOT_STATE_VERSION:
            return
        if payload.get("config") != self._snapshot_config():
            return
        topo_fp = self._topo_fingerprint(view)
        if payload.get("topo_fp") != topo_fp:
            return  # labels, taints or API resources moved: rows invalid
        if payload.get("names") != list(view.names):
            return
        snap_view = payload["view"]
        if np.asarray(snap_view["alloc"]).shape != np.asarray(view.alloc).shape:
            return
        # Freshness by content: equal cluster tensors (plus the tick's
        # signature walk) mean the snapshot world is the relisted one;
        # anything else resumes as a capacity drift from the snapshot's.
        fresh = all(
            np.array_equal(np.asarray(snap_view[k]), np.asarray(getattr(view, k)))
            for k in ("alloc", "used", "cpu_alloc", "cpu_avail")
        )
        old_view = view if fresh else _SnapshotView(
            payload["names"], snap_view["alloc"], snap_view["used"],
            snap_view["cpu_alloc"], snap_view["cpu_avail"],
        )
        c_bucket, eff_chunk, ladder = self._tick_geometry(len(view.clusters))
        multi_chunk = len(units) > eff_chunk
        vocab = self._vocab_for(view, topo_fp)
        snap_chunks = payload.get("chunks") or {}
        restored = rows = 0
        secs = info["seconds"]
        for chunk_idx, start in enumerate(range(0, len(units), eff_chunk)):
            cs = snap_chunks.get(chunk_idx)
            chunk = units[start : start + eff_chunk]
            n = len(chunk)
            if cs is None or cs["n"] != n:
                continue
            b_pad = self._bucket_rows(n, ladder, eff_chunk, multi_chunk)
            if tuple(cs["sel"].shape) != (b_pad, c_bucket):
                continue
            t0 = time.perf_counter()
            inputs, fmt = self._featurize_full(chunk, clusters, view, vocab)
            self.featurize_rows["full"] += n
            secs["featurize"] += time.perf_counter() - t0
            if fmt != cs["fmt"]:
                continue
            host_bytes = sum(
                np.asarray(getattr(inputs, name)).nbytes
                for name in self._per_object_fields(fmt)
            )
            c = np.asarray(inputs.cluster_valid).shape[0]
            nbytes = (
                host_bytes * 3
                + _pow2_bucket(n, MIN_ROW_BUCKET, 1 << 30)
                * _cluster_bucket(c, MIN_CLUSTER_BUCKET)
                * 15
            )
            if self._cache_used + nbytes > CACHE_BYTES:
                continue
            entry = _CachedChunk(
                sigs=list(cs["sigs"]),
                units=[_RESTORE_SENTINEL] * n,
                inputs=inputs,
                fmt=fmt,
                topo_fp=topo_fp,
                nbytes=nbytes,
                vocab_uid=vocab.uid if (fmt == "compact" and vocab) else 0,
                restored=True,
            )
            # Device residency, the cold upload paid here instead of in
            # the first tick: the per-object inputs (the drift gate's and
            # slabs' substrate) and the prev planes.
            t0 = time.perf_counter()
            padded = self._pad_for_dispatch(inputs, fmt, b_pad, c_bucket)
            entry.device_per_object = self._upload_per_object(padded, fmt)
            entry.padded_shape = (b_pad, c_bucket)
            if fmt == "compact":
                entry.padded_shape += (
                    np.asarray(padded.sparse_idx).shape[1],
                    np.asarray(padded.key_bytes).shape[1],
                )

            def put(name, dtype):
                return tensor(np.ascontiguousarray(cs[name], dtype=dtype), self.device)

            entry.prev_out = (
                put("sel", np.int8), put("rep", np.int32),
                put("cnt", np.int8), put("sco", np.int32),
            )
            entry.prev_feas = put("feas", np.int8)
            entry.prev_reasons = put("rsn", np.int32)
            # The feasible counts are derived on the host, not stored:
            # the snapshot's format stays the JAX engine's and nothing is
            # launched.
            entry.prev_nfeas = tensor(
                (np.asarray(cs["feas"]) != 0).sum(axis=1).astype(np.int32), self.device
            )
            t1 = time.perf_counter()
            secs["upload"] += t1 - t0
            entry.prev_results = self._decode_rows(
                np.asarray(cs["sel"])[:n], np.asarray(cs["rep"])[:n],
                np.asarray(cs["cnt"])[:n], view.names,
                scores=np.asarray(cs["sco"])[:n] if cs["has_scores"] else None,
            )
            secs["decode"] += time.perf_counter() - t1
            entry.prev_has_scores = bool(cs["has_scores"])
            entry.prev_view = old_view
            entry.pack_k_hint = int(cs.get("pack_k_hint", 0))
            entry.pack_shrink_votes = int(cs.get("pack_shrink_votes", 0))
            existing = self._chunk_cache.pop(chunk_idx, None)
            if existing is not None:
                self._cache_used -= existing.nbytes
            self._chunk_cache[chunk_idx] = entry
            self._cache_used += nbytes
            restored += 1
            rows += n
        info.update(
            result="loaded" if restored else "rejected",
            fresh=fresh and bool(restored),
            chunks=restored,
            rows=rows,
        )

    def _schedule(
        self, units, clusters, view, webhook_eval, want_scores, follower_index,
        dirty_rows,
    ) -> list[ScheduleResult]:
        units_arg = units
        units = list(units)
        timings = dict.fromkeys(
            ("featurize", "device", "narrow_fallback", "fetch", "gate_wait",
             "overflow_fetch", "decode"),
            0.0,
        )
        self.timings = timings
        if view is None:
            view = self._cached_view(units, clusters)
        if self._pending_restore is not None:
            # A staged snapshot is consumed here, where the relisted
            # units and clusters it is verified against exist; restored
            # chunks then ride the cache's paths below (the snapshot only
            # seeds prev state, never outputs).
            self._consume_restore(units, clusters, view)
        # Whole-batch no-op gate: the same list (or a fresh list of the
        # same objects, compared by id; the gate keeps them alive, so an
        # id match is identity) against the same view, with the same
        # want_scores and follower index, replays the previous results
        # with no per-chunk walk.  A webhook tick neither hits nor arms
        # it (its plugin set is not in the key).
        if webhook_eval is None and self._noop_gate is not None:
            g_units, g_ids, g_view, g_ws, g_fidx, g_results, g_chunks = self._noop_gate
            same = view is g_view and want_scores == g_ws and follower_index is g_fidx
            replay = same and units_arg is g_units
            if not replay and same and len(units) == len(g_units):
                ids = np.fromiter(map(id, units), np.int64, count=len(units))
                if np.array_equal(ids, g_ids):
                    replay = True
                    self._noop_gate = (
                        units_arg, g_ids, g_view, g_ws, g_fidx, g_results, g_chunks
                    )
            if replay:
                self.fetch_stats["noop"] += g_chunks
                self.last_changed = []
                return list(g_results)

        chunk_results: list[Optional[list]] = []
        # Per chunk: local rows whose placement may have changed ([]
        # none, None unknown).
        chunk_changed: list[Optional[list]] = []
        # (slot, entry, rows, their host inputs, inputs_stale): the
        # sub-batch pass's rows.  inputs_stale says the rows' host
        # inputs changed (a churn patch); drift recompute rows keep
        # inputs whose device copies are current.
        pending_sub: list[tuple] = []
        # Drift-gated chunks awaiting their row classification.
        pending_gate: list[tuple] = []
        drift_cache: dict[int, Optional[dict]] = {}
        # Full dispatches in flight (the pipelined window).
        window: list[_InFlight] = []
        c_bucket, eff_chunk, ladder = self._tick_geometry(len(view.clusters))
        multi_chunk = len(units) > eff_chunk
        vocab = (
            self._vocab_for(view, self._topo_fingerprint(view))
            if webhook_eval is None
            else None
        )
        dirty_sorted = (
            np.asarray(sorted(dirty_rows), dtype=np.int64)
            if dirty_rows is not None
            else None
        )
        for chunk_idx, start in enumerate(range(0, len(units), eff_chunk)):
            chunk = units[start : start + eff_chunk]
            n = len(chunk)
            dirty_chunk = None
            if dirty_sorted is not None:
                lo = np.searchsorted(dirty_sorted, start)
                hi = np.searchsorted(dirty_sorted, start + n)
                dirty_chunk = (dirty_sorted[lo:hi] - start).tolist()
            t0 = time.perf_counter()
            inputs, status, entry, fmt = self._featurize_chunk(
                chunk_idx, chunk, clusters, view, webhook_eval, vocab, dirty=dirty_chunk
            )
            patch_info = None
            if entry is not None:
                patch_info, entry.last_patch = entry.last_patch, None
            # The cached decode serves this tick only if it carries what
            # the tick needs (scores when want_scores).
            prev_valid = (
                entry is not None
                and entry.prev_results is not None
                and len(entry.prev_results) == n
                and (entry.prev_has_scores or not want_scores)
            )
            # Per-chunk no-op: a clean hit against the same view would
            # reproduce the previous outputs.
            if status == "hit" and prev_valid and entry.prev_view is view:
                self.fetch_stats["noop"] += 1
                timings["featurize"] += time.perf_counter() - t0
                chunk_results.append(entry.prev_results)
                chunk_changed.append([])
                continue
            # Sub-batch: only rows changed and the view is the same, so by
            # row independence scheduling just those rows is exact.
            if (
                status == "patch"
                and prev_valid
                and entry.prev_view is view
                and patch_info is not None
            ):
                changed_rows, sub_inputs = patch_info
                pending_sub.append(
                    (len(chunk_results), entry, changed_rows, sub_inputs, True)
                )
                chunk_results.append(None)  # filled by the sub-batch pass
                chunk_changed.append(list(changed_rows))
                self.fetch_stats["subbatch"] += 1
                timings["featurize"] += time.perf_counter() - t0
                continue

            b_pad = self._bucket_rows(n, ladder, eff_chunk, multi_chunk)
            pack_k = self._pack_k(
                inputs, c_bucket, entry.pack_k_hint if entry is not None else 0
            )
            drift_info = None
            if (
                status == "hit"
                and entry is not None
                and entry.prev_view is not None
                and entry.prev_view is not view
            ):
                drift_info = self._drift_delta(entry.prev_view, view, drift_cache)
            if drift_info is not None and drift_info["empty"] and prev_valid:
                # The views differ only in ways that leave the cluster
                # tensors equal: every row reproduces its outputs.
                self.fetch_stats["skip"] += 1
                self.drift_stats["gated"] += 1
                self.drift_stats["skip"] += n
                entry.prev_view = view
                chunk_results.append(entry.prev_results)
                chunk_changed.append([])
                timings["featurize"] += time.perf_counter() - t0
                continue
            # Drift: a clean hit whose only change is cluster resource
            # quantities at a few columns classifies its rows on the
            # device instead of re-running the whole chunk.  Not for a
            # decode that carries scores: the gate's skipped rows keep
            # their stored score dicts, which the drift may have moved.
            shape = (b_pad, c_bucket)
            if (
                status == "hit"
                and drift_info is not None
                and prev_valid
                and not want_scores
                and not entry.prev_has_scores
                and entry.prev_out is not None
                and entry.prev_feas is not None
                and entry.device_per_object is not None
                and tuple(entry.prev_out[0].shape) == shape
                and tuple(entry.prev_feas.shape) == shape
                and entry.padded_shape is not None
                and entry.padded_shape[0] == b_pad
            ):
                gate = self._dispatch_drift_gate(entry, fmt, c_bucket, drift_info, vocab)
                pending_gate.append(
                    (len(chunk_results), entry, n, gate, fmt, b_pad, pack_k)
                )
                chunk_results.append(None)
                chunk_changed.append(None)
                timings["featurize"] += time.perf_counter() - t0
                continue

            timings["featurize"] += time.perf_counter() - t0
            delta_ok = (
                prev_valid
                and entry.prev_out is not None
                and tuple(entry.prev_out[0].shape) == shape
            )
            chunk_results.append(None)
            chunk_changed.append(None)
            self._full_dispatch(
                window, len(chunk_results) - 1, entry, inputs, status, fmt, n,
                b_pad, pack_k, view, vocab, c_bucket, delta_ok, chunk_results,
                chunk_changed, timings, want_scores,
            )

        # The window drains before the drift gates and the sub-batch
        # pass, which read the chunks' stored planes.
        self._drain_window(window, chunk_results, chunk_changed, view, timings)
        if pending_gate:
            self._drain_drift_gates(
                pending_gate, chunk_results, chunk_changed, view, timings,
                pending_sub, c_bucket, vocab,
            )
        if pending_sub:
            self._run_sub_batch(
                pending_sub, chunk_results, view, timings, eff_chunk, ladder,
                c_bucket, vocab,
            )
        self._flush_nsel()

        results: list[ScheduleResult] = []
        for part in chunk_results:
            results.extend(part)
        if any(ch is None for ch in chunk_changed):
            self.last_changed = None
        else:
            self.last_changed = [
                slot * eff_chunk + row
                for slot, ch in enumerate(chunk_changed)
                for row in ch
            ]
        if follower_index is not None:
            t0 = time.perf_counter()
            follower_index.apply(results, self.last_changed)
            timings["follower"] = time.perf_counter() - t0
        self._noop_gate = (
            (
                units_arg,
                np.fromiter(map(id, units), np.int64, count=len(units)),
                view, want_scores, follower_index, results, len(chunk_results),
            )
            if webhook_eval is None
            else None
        )
        return results

    # -- full dispatch: through the window ---------------------------------
    def _full_dispatch(
        self, window: list, slot: int, entry, inputs, status: str, fmt: str, n: int,
        b_pad: int, pack_k: int, view, vocab, c_bucket: int, delta_ok: bool,
        chunk_results, chunk_changed, timings, want_scores: bool = False,
    ) -> None:
        """One chunk dispatched whole, its results landing in ``slot``
        (a full fetch decodes scores if ``want_scores``): queued into
        ``window``, which is drained once it holds ``pipeline_depth``
        chunks.  Depth 1 is the sequential dispatch: a window of one
        chunk whose planner runs the checked round loop, with the wait
        for the card counted as ``device``."""
        windowed = self.pipeline_depth > 1
        item = self._queue_chunk(
            slot, entry, inputs, status, fmt, n, b_pad, pack_k, view, vocab,
            c_bucket, delta_ok, timings,
            RoundBudget(PLANNER_ROUNDS) if windowed else None,
        )
        item.want_scores = want_scores
        window.append(item)
        if not windowed:
            t0 = time.perf_counter()
            self._sync()
            timings["device"] += time.perf_counter() - t0
        if len(window) >= max(1, self.pipeline_depth):
            self._drain_window(window, chunk_results, chunk_changed, view, timings)

    def _queue_chunk(
        self, slot: int, entry, inputs, status: str, fmt: str, n: int, b_pad: int,
        pack_k: int, view, vocab, c_bucket: int, delta_ok: bool, timings, budget=None,
    ) -> "_InFlight":
        """Pad, upload and queue one chunk's tick (narrow or dense), with
        the planner under ``budget`` if given.  Under a round budget
        nothing here waits for the card (without one the planner reads
        its loop condition); the queuing time counts as ``device``."""
        t0 = time.perf_counter()
        padded = self._pad_for_dispatch(inputs, fmt, b_pad, c_bucket)
        m = self._narrow_m(inputs, c_bucket)
        key_max = self._key_max(padded, fmt)
        t1 = time.perf_counter()
        timings["featurize"] += t1 - t0
        device_in = self._device_inputs(
            entry, padded, status, fmt, vocab, c_bucket,
            self._cluster_planes_device(view, c_bucket),
        )
        self._count_dispatch(fmt, b_pad, c_bucket)
        out, cert = self._tick(device_in, fmt, m, key_max, budget)
        timings["device"] += time.perf_counter() - t1
        return _InFlight(
            slot=slot, entry=entry, out=out, cert=cert,
            unsettled=None if budget is None else budget.unsettled,
            device_in=device_in, fmt=fmt, n=n, pack_k=pack_k, m=m,
            key_max=key_max, delta_ok=delta_ok,
        )

    def _drain_window(self, items: list, chunk_results, chunk_changed, view, timings) -> None:
        """Drain the in-flight window with batched reads (the JAX
        engine's _drain_fetch_window with the packed wire): settle the
        certificates and planner budgets, read every diff mask (one
        read), plan each chunk's fetch (skip, delta or full), then
        pack, read and decode the wires.  Empties ``items``."""
        if not items:
            return
        self._settle_window(items, timings)
        t0 = time.perf_counter()
        diffed = [it for it in items if it.delta_ok]
        masks = self._read_all([_diff_bits(it.out, it.entry.prev_out, it.n) for it in diffed])
        timings["fetch"] += time.perf_counter() - t0
        mask_of = {id(it): mask for it, mask in zip(diffed, masks)}
        delta_items, full_items = [], []
        for it in items:
            if not it.delta_ok:
                full_items.append(it)
                continue
            mask = mask_of[id(it)]
            if it.fb_rows is not None:
                # Rows the dense re-solve rewrote are fetched whatever
                # the diff says (the JAX engine's mask forces them).
                mask = mask.copy()
                mask[it.fb_rows] |= _DIFF_PLACEMENT
            kind, idx = self._plan_delta(it.entry, mask, it.n)
            if kind == "skip":
                self._note_skip(it.entry, it.out, view)
                chunk_results[it.slot] = it.entry.prev_results
                chunk_changed[it.slot] = []
            elif kind == "full":
                full_items.append(it)
            else:
                delta_items.append((it, idx))
        self._drain_window_packed(delta_items, full_items, chunk_results, chunk_changed,
                                  view, timings)
        items.clear()

    def _settle_window(self, items: list, timings) -> None:
        """Resolve a window's certificates and planner budgets before any
        plane leaves the card.  Each chunk's i8[B] flags (bit 0 its
        narrow certificate, bit 1 a planner row still going after the
        round budget) are read in one copy.  A chunk with an
        unsettled row is dispatched again with the checked round loop
        (counted in ``planner_reruns``) and its certificate read alone;
        then uncertified rows are re-solved dense and written back
        (_apply_cert_fallback), their rows kept in ``fb_rows``."""
        flagged, devs = [], []
        for it in items:
            flag = it.cert
            if it.unsettled is not None:
                late = it.unsettled.to(torch.int8) * 2
                flag = late if flag is None else flag | late
            if flag is not None:
                flagged.append(it)
                devs.append(flag)
        t0 = time.perf_counter()
        flags = self._read_all(devs)
        timings["fetch"] += time.perf_counter() - t0
        for it, flag in zip(flagged, flags):
            if (flag & 2).any():
                t0 = time.perf_counter()
                self.planner_reruns += 1
                self.dispatches_total += 1
                it.out, it.cert = self._tick(it.device_in, it.fmt, it.m, it.key_max)
                timings["device"] += time.perf_counter() - t0
                if it.cert is None:
                    continue
                t0 = time.perf_counter()
                flag = self._read_np(it.cert)
                timings["fetch"] += time.perf_counter() - t0
            if it.cert is not None:
                it.out, it.fb_rows = self._apply_cert_fallback(
                    it.out, flag & 1, it.device_in, it.fmt, it.n, timings
                )
        for it in items:
            it.device_in = None

    def _drain_window_packed(
        self, delta_items, full_items, chunk_results, chunk_changed, view, timings,
    ) -> None:
        """Every planned chunk's wire queued before the first read: the
        changed rows' (delta: a row gather) or the first n rows' (full),
        read in one copy per wire width (_read_all); then the K-overflow
        rows of the whole window (_fetch_overflow_window; with the score
        plane where the decode carries scores: a delta's entry's
        prev_has_scores, a full fetch's want_scores) and the decodes."""
        t0 = time.perf_counter()
        wires = []  # (item, gathered rows or None for full, device wire)
        for it, idx in delta_items:
            self.fetch_stats["delta"] += 1
            gidx = self._index(idx)
            wire = pack_wire(*(p.index_select(0, gidx) for p in _planes(it.out)), it.pack_k)
            self.devprof.observe("pack", wire)
            wires.append((it, idx, wire))
        for it in full_items:
            wire = pack_wire(*(p[: it.n] for p in _planes(it.out)), it.pack_k)
            self.devprof.observe("pack", wire)
            wires.append((it, None, wire))
        arrs = self._read_all([w[2] for w in wires])
        timings["fetch"] += time.perf_counter() - t0

        t0 = time.perf_counter()
        parsed = []  # (item, gathered rows or None, packed, overflow positions)
        # (parsed index, the dispatch's outputs, its overflow rows, scores)
        over_jobs = []
        for (it, idx, _wire), arr in zip(wires, arrs):
            packed = unpack_wire(arr, it.pack_k)
            self._observe_nsel(it.entry, packed.nsel, it.out.selected.shape[1])
            over_pos = np.nonzero(packed.nsel > it.pack_k)[0]
            if over_pos.size:
                if idx is None:
                    over_jobs.append((len(parsed), it.out, over_pos, it.want_scores))
                else:
                    over_jobs.append(
                        (len(parsed), it.out, idx[over_pos], it.entry.prev_has_scores)
                    )
            parsed.append((it, idx, packed, over_pos))
        over = self._fetch_overflow_window([job[1:] for job in over_jobs], timings)
        over_of = {job[0]: dense for job, dense in zip(over_jobs, over)}
        timings["fetch"] += time.perf_counter() - t0

        t0 = time.perf_counter()
        for i, (it, idx, packed, over_pos) in enumerate(parsed):
            if idx is not None:
                chunk_results[it.slot], chunk_changed[it.slot] = self._apply_packed_delta(
                    it.entry, it.out, idx, packed, over_pos, over_of.get(i), view
                )
            else:
                chunk_results[it.slot] = self._apply_packed_full(
                    it.entry, it.out, packed, over_pos, over_of.get(i), view,
                    it.want_scores,
                )
                chunk_changed[it.slot] = None
        timings["decode"] += time.perf_counter() - t0

    # -- drift gate ----------------------------------------------------------
    @staticmethod
    def _drift_delta(old_view, view: ClusterView, cache: dict) -> Optional[dict]:
        """The cluster columns that changed between the view a chunk's
        outputs were computed against and this one.  None: not
        drift-shaped (another topology or shape, or more than
        max(8, C // 4) columns moved); {"empty": True}: the cluster
        tensors are equal.  Else the changed columns padded to a bucket
        (exactly 1 for one column, else pow2 floored at 8; padding slots
        carry an out-of-range index) and the old and new cluster planes
        at them.  Cached per old view for the tick."""
        key = id(old_view)
        if key in cache:
            return cache[key]
        info = None
        if (
            getattr(old_view, "names", None) == view.names
            and np.asarray(old_view.alloc).shape == np.asarray(view.alloc).shape
        ):
            dcpu_col = (old_view.cpu_alloc != view.cpu_alloc) | (
                old_view.cpu_avail != view.cpu_avail
            )
            diff = (
                (old_view.alloc != view.alloc).any(axis=1)
                | (old_view.used != view.used).any(axis=1)
                | dcpu_col
            )
            cols = np.nonzero(diff)[0]
            c = len(view.names)
            if cols.size == 0:
                info = {"empty": True}
            elif cols.size <= max(8, c // 4):
                nb = 1 if cols.size == 1 else _pow2_bucket(cols.size, 8, 1 << 30)
                didx = np.full(nb, 1 << 30, np.int32)
                didx[: cols.size] = cols
                dvalid = np.zeros(nb, bool)
                dvalid[: cols.size] = True
                dcpu = np.zeros(nb, bool)
                dcpu[: cols.size] = dcpu_col[cols]

                def slice_cols(arr):
                    arr = np.asarray(arr)
                    out = np.zeros((nb,) + arr.shape[1:], arr.dtype)
                    out[: cols.size] = arr[cols]
                    return out

                info = {
                    "empty": False, "cols": cols, "didx": didx, "dvalid": dvalid,
                    "dcpu": dcpu,
                    "alloc_old_d": slice_cols(old_view.alloc),
                    "used_old_d": slice_cols(old_view.used),
                    "alloc_new_d": slice_cols(view.alloc),
                    "used_new_d": slice_cols(view.used),
                }
        cache[key] = info
        return info

    @staticmethod
    def _fin_rows(entry, b_pad: int) -> np.ndarray:
        """The chunk's finite-maxClusters rows (the only rows whose top-K
        cut can engage), padded with an out-of-range index to a two-rung
        bucket: max(64, b_pad // 4), else b_pad."""
        mc = np.asarray(entry.inputs.max_clusters)
        fin = np.nonzero((mc >= 0) & (mc < INT32_INF))[0]
        cap = max(64, b_pad // 4)
        idx = np.full(cap if fin.size <= cap else b_pad, 1 << 30, np.int32)
        idx[: fin.size] = fin
        return idx

    def _wcheck_cpu_device(self, old_view: ClusterView, c_bucket: int) -> dict:
        """The previous view's padded cpu planes on the device: the old
        side of the weight check."""
        key = (id(old_view), c_bucket)
        if self._old_cpu_device is not None and self._old_cpu_device[0] == key:
            return self._old_cpu_device[2]
        host = {
            "cpu_alloc": _pad_cluster_axis(old_view.cpu_alloc, c_bucket, 0),
            "cpu_avail": _pad_cluster_axis(old_view.cpu_avail, c_bucket, 0),
        }
        self.upload_bytes["cluster"] += sum(a.nbytes for a in host.values())
        dev = {k: tensor(v, self.device) for k, v in host.items()}
        self._old_cpu_device = (key, old_view, dev)
        return dev

    def _start_read(self, t: torch.Tensor):
        """Start a device->host copy of ``t`` that a later _finish_read
        waits for: on the card a copy into pinned memory behind an
        event, so the wait covers only the work queued before it."""
        if t.device.type != "cuda":
            return t, None
        host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        host.copy_(t, non_blocking=True)
        done = torch.cuda.Event()
        done.record()
        return host, done

    def _finish_read(self, handle) -> np.ndarray:
        host, done = handle
        if done is not None:
            done.synchronize()
        arr = host.numpy()
        self.fetch_bytes_total += arr.nbytes
        return arr

    def _read_all(self, tensors: list) -> list:
        """Host copies of several tensors: those of one dtype and one
        shape past the first axis are joined on the device (torch.cat)
        and read in one copy, then split by their row counts; every copy
        is queued before the first wait."""
        out: list = [None] * len(tensors)
        groups: dict[tuple, list[int]] = {}
        for i, t in enumerate(tensors):
            groups.setdefault((tuple(t.shape[1:]), t.dtype), []).append(i)
        reads = [
            (
                members,
                self._start_read(
                    tensors[members[0]]
                    if len(members) == 1
                    else torch.cat([tensors[i] for i in members])
                ),
            )
            for members in groups.values()
        ]
        for members, handle in reads:
            arr = self._finish_read(handle)
            start = 0
            for i in members:
                rows = tensors[i].shape[0]
                out[i] = arr[start : start + rows]
                start += rows
        return out

    def _dispatch_drift_gate(self, entry, fmt: str, c_bucket: int, info: dict, vocab) -> dict:
        """Queue one chunk's drift gate and the copy of its row mask (read
        in _drain_drift_gates; nothing here waits on the device)."""
        b_pad = entry.padded_shape[0]
        if entry.stale_rows:
            # Backstop: rows patched since the last upload whose eager
            # repair could not run.
            self._repair_stale_inputs(entry, fmt, c_bucket, phase="drift")
        slices = (
            info["alloc_old_d"], info["used_old_d"],
            info["alloc_new_d"], info["used_new_d"],
        )
        self.upload_bytes["cluster"] += sum(a.nbytes for a in slices)
        dev = self.device
        args = (
            entry.prev_feas,
            entry.prev_out[3],
            *(tensor(a, dev) for a in slices),
            *(tensor(info[k], dev) for k in ("didx", "dvalid", "dcpu")),
            tensor(self._fin_rows(entry, b_pad), dev),
            self._ensure_nfeas(entry),
        )
        self.dispatches_total += 1
        if fmt == "compact":
            mask, new_cols = drift_gate_compact(
                entry.device_per_object, self._tables_device(vocab, c_bucket),
                *args, Cmp.CUR_ABSENT,
            )
        else:
            mask, new_cols = drift_gate_dense(entry.device_per_object, *args)
        self.devprof.observe("gate", (mask, new_cols))
        return {
            "mask": self._start_read(mask),
            "new_cols": new_cols,
            "cols": self._index(info["cols"]),
        }

    @staticmethod
    def _survivor_groups(rows: list) -> list[tuple[list, int]]:
        """Greedy least-padding cut of rows into 256, 128 and 64-row
        groups (140 rows: 128 + 64, never one 256)."""
        out = []
        i, n = 0, len(rows)
        while i < n:
            rem = n - i
            size = 256 if rem > 192 else (128 if rem > 64 else 64)
            out.append((rows[i : i + size], size))
            i += size
        return out

    def _dispatch_drift_survivors(
        self, pi: int, entry, fmt: str, rows: set, cluster_dev, vocab, c_bucket: int,
    ) -> list[dict]:
        """Queue the unified survivor program over a gated chunk's rows,
        in _survivor_groups: each group's device inputs and stored reason
        rows are gathered, expanded and solved by ``drift_survivor``, and
        the wire packed at K = min(M, C).  [] when the chunk cannot take
        the path; certificate failures stay in the recompute set."""
        if (
            entry.prev_reasons is None
            or entry.device_per_object is None
            or entry.prev_feas is None
            or entry.prev_reasons.shape != entry.prev_feas.shape
        ):
            return []
        m = self._narrow_m(entry.inputs, c_bucket)
        if m is None or not rows:
            return []
        rows = sorted(rows)
        pack_k = min(m, c_bucket)
        device_in = self._assemble(entry.device_per_object, fmt, vocab, c_bucket, cluster_dev)
        per_object = self._per_object_fields(fmt)
        key_max = self._key_max(entry.inputs, fmt)
        self.survivor_stats["rows"] += len(rows)
        jobs = []
        for seg, g in self._survivor_groups(rows):
            # Padding repeats the group's first row; only seg is read.
            idx = np.full(g, seg[0], np.int64)
            idx[: len(seg)] = seg
            gidx = self._index(idx)
            sub = device_in._replace(
                **{name: getattr(device_in, name).index_select(0, gidx) for name in per_object}
            )
            out, cert = drift_survivor(
                expand_compact(sub, key_max) if fmt == "compact" else sub,
                entry.prev_reasons.index_select(0, gidx),
                m,
                i32_keys=True,
            )
            self.devprof.observe("survivor", (out, cert))
            wire = pack_wire(
                out.selected, out.replicas, out.counted, out.scores, out.reasons, pack_k
            )
            self.devprof.observe("pack", wire)
            self.survivor_stats["groups"] += 1
            self.survivor_stats["padded_rows"] += g
            self.dispatches_total += 1
            jobs.append({"pi": pi, "entry": entry, "rows": seg, "out": out,
                         "cert": cert, "wire": wire, "pack_k": pack_k})
        return jobs

    def _repair_entry_rows(self, entry, out, src_pos, dst_rows) -> bool:
        """Write certified survivor rows into the chunk's prev planes in
        place; False (the caller marks them stale) when the planes cannot
        take them."""
        if entry.prev_out is None or entry.prev_feas is None or entry.prev_reasons is None:
            return False
        b_pad, c_pad = entry.prev_out[0].shape
        if (
            tuple(entry.prev_feas.shape) != (b_pad, c_pad)
            or tuple(entry.prev_reasons.shape) != (b_pad, c_pad)
            or out.selected.shape[1] != c_pad
            or max(dst_rows, default=0) >= b_pad
        ):
            return False
        self._scatter_prev_rows(entry, out, self._index(src_pos), self._index(dst_rows))
        return True

    def _drain_drift_resolve(self, jobs, plans, plan_resolved, view, timings) -> None:
        """Read the queued survivor groups (one copy per shape for the
        certificates, one for the wires), decode the certified rows,
        merge them into the cached decodes and write them into the prev
        planes.  Rows failing the certificate stay in their chunk's
        recompute set."""
        t0 = time.perf_counter()
        certs = self._read_all([job["cert"] for job in jobs])
        wires = self._read_all([job["wire"] for job in jobs])
        timings["fetch"] += time.perf_counter() - t0
        for job, cert, wire in zip(jobs, certs, wires):
            t0 = time.perf_counter()
            entry, rows, out, k = job["entry"], job["rows"], job["out"], job["pack_k"]
            nr = len(rows)
            ok_pos = np.nonzero(cert[:nr] != 0)[0]
            self.drift_stats["unified"] += int(ok_pos.size)
            self.drift_stats["unified_fallback"] += int(nr - ok_pos.size)
            self.survivor_stats["fallback_rows"] += int(nr - ok_pos.size)
            res_rows = [rows[p] for p in ok_pos.tolist()]
            plans[job["pi"]][3] -= set(res_rows)
            if not ok_pos.size:
                timings["decode"] += time.perf_counter() - t0
                continue
            full = unpack_wire(wire[:nr], k)
            packed = PackedRows(*(np.asarray(f)[ok_pos] for f in full))
            self._observe_nsel(entry, packed.nsel, out.selected.shape[1])
            over_pos = np.nonzero(packed.nsel > k)[0]
            over_dense = None
            if over_pos.size:
                t1 = time.perf_counter()
                timings["decode"] += t1 - t0
                over_dense = self._fetch_overflow(out, ok_pos[over_pos], False, timings)
                timings["fetch"] += time.perf_counter() - t1
                t0 = time.perf_counter()
            results = self._decode_packed_mixed(
                packed, over_pos, over_dense, view.names, False
            )
            merged = list(entry.prev_results)
            for r, res in zip(res_rows, results):
                merged[r] = res
            entry.prev_results = merged
            self._record_packed(entry, res_rows, results, packed, view, f"{entry.fmt}:unified")
            if not self._repair_entry_rows(entry, out, ok_pos, res_rows):
                entry.stale_out_rows = sorted(set(entry.stale_out_rows or ()) | set(res_rows))
            plan_resolved.setdefault(job["pi"], []).extend(res_rows)
            timings["decode"] += time.perf_counter() - t0

    def _drain_drift_gates(
        self, items, chunk_results, chunk_changed, view, timings, pending_sub,
        c_bucket, vocab,
    ) -> None:
        """Settle the gated chunks.  Masks are read in dispatch order (the
        read of chunk i waits only on gate i); each read refreshes the
        chunk's stored score plane at the changed columns, queues the
        weight checks (fixed 256/128/64-row groups) and the survivor
        program over the recompute rows.  Then the survivors and weight
        checks are read; weight-changed rows, 256 or fewer a chunk, take
        a second survivor wave.  Each chunk then skips, keeps the
        resolved rows (delta), sends its remaining rows to the sub-batch
        slabs, or, when more than half its rows move, takes the full
        dispatch."""
        self.metrics.store("engine_gate_inflight", len(items))
        jobs: list[dict] = []
        plans: list[list] = []  # [slot, entry, n, recompute rows, fmt, b_pad, pack_k]
        wcheck_jobs: list[tuple] = []  # (plan index, rows, device flags)
        plan_resolved: dict[int, list] = {}
        newc = self._cluster_planes_device(view, c_bucket)
        for slot, entry, n, gate, fmt, b_pad, pack_k in items:
            t0 = time.perf_counter()
            mask = self._finish_read(gate["mask"])[:n]
            dt = time.perf_counter() - t0
            timings["gate_wait"] += dt
            timings["fetch"] += dt
            t0 = time.perf_counter()
            self.drift_stats["gated"] += 1
            # Skipped rows keep exact stored totals; recomputed rows are
            # overwritten by their write-back after this.
            refresh_scores(entry.prev_out[3], gate["cols"], gate["new_cols"])
            rec = set(np.nonzero(mask & DRIFT_RECOMPUTE)[0].tolist())
            # Rows whose stored planes or device inputs could not be
            # brought up to date are gate-blind: recompute them.
            forced = set()
            if entry.stale_out_rows:
                forced.update(r for r in entry.stale_out_rows if r < n)
            if entry.stale_rows:
                forced.update(r for r in entry.stale_rows if r < n)
            rec |= forced
            wrows = np.nonzero(mask & DRIFT_WCHECK)[0]
            if forced and wrows.size:
                wrows = wrows[~np.isin(wrows, sorted(forced))]
            plans.append([slot, entry, n, rec, fmt, b_pad, pack_k])
            pi = len(plans) - 1
            t1 = time.perf_counter()
            timings["decode"] += t1 - t0
            if wrows.size:
                self.drift_stats["wcheck"] += int(wrows.size)
                oldc = self._wcheck_cpu_device(entry.prev_view, c_bucket)
                for seg, g in self._survivor_groups(wrows.tolist()):
                    ridx = np.zeros(g, np.int64)
                    ridx[: len(seg)] = seg
                    self.dispatches_total += 1
                    flags = drift_wcheck(
                        entry.prev_feas, self._index(ridx),
                        oldc["cpu_alloc"], oldc["cpu_avail"],
                        newc["cpu_alloc"], newc["cpu_avail"],
                    )
                    self.devprof.observe("wcheck", flags)
                    wcheck_jobs.append((pi, np.asarray(seg), flags))
            jobs.extend(
                self._dispatch_drift_survivors(
                    pi, entry, fmt, rec - forced, newc, vocab, c_bucket
                )
            )
            timings["device"] += time.perf_counter() - t1

        if jobs:
            self._drain_drift_resolve(jobs, plans, plan_resolved, view, timings)

        if wcheck_jobs:
            t0 = time.perf_counter()
            flags = self._read_all([job[2] for job in wcheck_jobs])
            changed_by_pi: dict[int, list] = {}
            for (pi, wrows, _dev), flag in zip(wcheck_jobs, flags):
                changed = wrows[flag[: wrows.size] != 0]
                self.drift_stats["wcheck_changed"] += int(changed.size)
                plans[pi][3] |= set(changed.tolist())
                if changed.size:
                    changed_by_pi.setdefault(pi, []).extend(changed.tolist())
            dt = time.perf_counter() - t0
            timings["gate_wait"] += dt
            timings["fetch"] += dt
            # Weight-changed rows (kinf, no fit flip) take the survivor
            # program when a chunk has one group's worth; a larger set
            # fills a slab better.
            t1 = time.perf_counter()
            wave2: list[dict] = []
            for pi, rows_c in changed_by_pi.items():
                if len(rows_c) > 256:
                    continue
                entry, fmt = plans[pi][1], plans[pi][4]
                wave2.extend(
                    self._dispatch_drift_survivors(
                        pi, entry, fmt, set(rows_c), newc, vocab, c_bucket
                    )
                )
            timings["device"] += time.perf_counter() - t1
            if wave2:
                self._drain_drift_resolve(wave2, plans, plan_resolved, view, timings)

        t0 = time.perf_counter()
        fallback: list[tuple] = []
        for pi, (slot, entry, n, rec, fmt, b_pad, pack_k) in enumerate(plans):
            rec = {r for r in rec if r < n}
            resolved = plan_resolved.get(pi, [])
            if not rec:
                entry.prev_view = view
                chunk_results[slot] = entry.prev_results
                if resolved:
                    self.fetch_stats["delta"] += 1
                    self.drift_stats["skip"] += n - len(resolved)
                    chunk_changed[slot] = sorted(resolved)
                else:
                    self.fetch_stats["skip"] += 1
                    self.drift_stats["skip"] += n
                    chunk_changed[slot] = []
            elif len(rec) > n // 2:
                # Most rows move: the full dispatch with the delta fetch.
                self.drift_stats["fallback"] += 1
                fallback.append((slot, entry, n, fmt, b_pad, pack_k))
            else:
                rows = sorted(rec)
                self.fetch_stats["delta"] += 1
                self.drift_stats["recompute"] += len(rows)
                self.drift_stats["skip"] += n - len(rows) - len(resolved)
                pending_sub.append((slot, entry, rows, self._slice_rows(entry, rows), False))
                chunk_changed[slot] = sorted(rec | set(resolved))
        timings["featurize"] += time.perf_counter() - t0
        self.metrics.store("engine_gate_inflight", 0)

        window: list[_InFlight] = []
        for slot, entry, n, fmt, b_pad, pack_k in fallback:
            delta_ok = (
                entry.prev_out is not None
                and tuple(entry.prev_out[0].shape) == (b_pad, c_bucket)
            )
            self._full_dispatch(
                window, slot, entry, entry.inputs, "hit", fmt, n, b_pad, pack_k,
                view, vocab, c_bucket, delta_ok, chunk_results, chunk_changed, timings,
            )
        self._drain_window(window, chunk_results, chunk_changed, view, timings)

    # -- narrow certificate fallback ---------------------------------------
    def _apply_cert_fallback(self, out, cert_np, device_in, fmt: str, n: int, timings):
        """Resolve one narrow dispatch's certificate: certified rows stand
        (bit-identical to the dense tick by the certificate's proof);
        uncertified rows are gathered from the dispatch's device inputs,
        expanded, re-solved by the dense tick and written back into the
        selected/replicas/counted/reasons planes before anything reads
        them (scores and feasibility come from the shared phase 1 and
        are exact already).  Returns (out, re-solved rows or None)."""
        rows = np.nonzero(cert_np[:n] == 0)[0]
        self.narrow_stats["rows"] += int(n - rows.size)
        if rows.size == 0:
            return out, None
        t0 = time.perf_counter()
        self.narrow_stats["fallback"] += int(rows.size)
        self.dispatches_total += 1
        idx = self._index(rows)
        sub = device_in._replace(
            **{name: getattr(device_in, name)[idx] for name in self._per_object_fields(fmt)}
        )
        fb = schedule_tick(expand_compact(sub) if fmt == "compact" else sub)
        self.devprof.observe("narrow_fallback", fb)
        for name in ("selected", "replicas", "counted", "reasons"):
            getattr(out, name)[idx] = getattr(fb, name)
        self.devprof.observe("repair", out.reasons)
        self._sync()
        timings["narrow_fallback"] += time.perf_counter() - t0
        return out, rows

    # -- sub-batch path ------------------------------------------------------
    def _run_sub_batch(
        self, pending, chunk_results, view, timings, eff_chunk, ladder, c_bucket, vocab
    ) -> None:
        """Schedule every pending row (the changed rows of patched chunks,
        the drift recompute rows of gated chunks) in slabs and merge them
        into the cached decodes; one group per format."""
        for fmt in ("compact", "dense"):
            group = [p for p in pending if p[1].fmt == fmt]
            if group:
                self._run_sub_batch_group(
                    group, fmt, chunk_results, view, timings, eff_chunk, ladder,
                    c_bucket, vocab,
                )

    @staticmethod
    def _slab_cut(total: int, eff_chunk: int, ladder: Optional[list]) -> int:
        """Rows per sub-batch slab for ``total`` changed rows: the ladder
        rung with the fewest padded cells (ties to fewer dispatches), so
        1,988 rows take two 1,024-row slabs, not one of 4,096."""
        slab_cut = eff_chunk
        if ladder is not None and total < eff_chunk:
            best_cells = -(-total // eff_chunk) * eff_chunk
            for rung in ladder:
                cells = -(-total // rung) * rung
                if cells < best_cells or (cells == best_cells and rung > slab_cut):
                    slab_cut, best_cells = rung, cells
        return slab_cut

    def _run_sub_batch_group(
        self, pending, fmt, chunk_results, view, timings, eff_chunk, ladder,
        c_bucket, vocab,
    ) -> None:
        t0 = time.perf_counter()
        per_object = self._per_object_fields(fmt)
        subs = [sub for _, _, _, sub, _ in pending]
        if fmt == "compact":
            # Align sparse and key widths across chunks before joining.
            p_max = max(np.asarray(s.sparse_idx).shape[1] for s in subs)
            l_max = max(np.asarray(s.key_bytes).shape[1] for s in subs)
            subs = [
                Cmp.pad_axis1(
                    Cmp.pad_axis1(s, Cmp.SPARSE_FILLS, p_max), {"key_bytes": 0}, l_max
                )
                for s in subs
            ]
        combined = {
            name: np.concatenate([np.asarray(getattr(s, name)) for s in subs])
            for name in per_object
        }
        # Host placeholders for the cluster planes (the dispatch takes the
        # shared device copy) complete the tuple for padding.
        shared = dict(
            alloc=view.alloc,
            used=view.used,
            cpu_alloc=view.cpu_alloc,
            cpu_avail=view.cpu_avail,
            cluster_valid=np.ones(len(view.names), bool),
        )
        if fmt == "compact":
            cls = CompactInputs
            inputs = CompactInputs(
                **combined,
                **{name: getattr(subs[0], name) for name in Cmp.TABLE_FIELDS},
                **shared,
            )
        else:
            cls = TickInputs
            inputs = TickInputs(**combined, **shared)
        total = inputs.total.shape[0]
        # The widest hint of the group's chunks (the slabs serve rows of
        # every chunk), else the static maxClusters bound.
        pack_k = self._pack_k(inputs, c_bucket, max(p[1].pack_k_hint for p in pending))
        # Scores are decoded if any chunk's cached decode carries them.
        want_scores = any(p[1].prev_has_scores for p in pending)
        slab_cut = self._slab_cut(total, eff_chunk, ladder)
        m = self._narrow_m(inputs, c_bucket)
        key_max = self._key_max(inputs, fmt)
        cluster_dev = self._cluster_planes_device(view, c_bucket)
        # Rows whose device inputs are current (drift recomputes) are
        # gathered on the device, uploading nothing.
        dev_rows = None
        if not any(p[4] for p in pending) and all(
            p[1].device_per_object is not None
            and p[1].padded_shape is not None
            and p[1].padded_shape[1] == c_bucket
            for p in pending
        ):
            dev_rows = self._gather_device_rows(pending, fmt)
        slabs = []  # (n, out)
        for start in range(0, total, slab_cut):
            n = min(slab_cut, total - start)
            b_pad = self._bucket_rows(n, ladder, eff_chunk, False)
            if dev_rows is not None:
                # Padding rows repeat the slab's first row: rows are
                # independent and only the first n are read.
                idx = np.full(b_pad, start, np.int64)
                idx[:n] = np.arange(start, start + n)
                gidx = self._index(idx)
                per_object_dev = {
                    name: t.index_select(0, gidx) for name, t in dev_rows.items()
                }
                t1 = time.perf_counter()
                timings["featurize"] += t1 - t0
            else:
                piece = cls(
                    **{
                        name: (
                            np.asarray(arr)[start : start + slab_cut]
                            if name in combined
                            else arr
                        )
                        for name, arr in inputs._asdict().items()
                    }
                )
                padded = self._pad_for_dispatch(piece, fmt, b_pad, c_bucket)
                t1 = time.perf_counter()
                timings["featurize"] += t1 - t0
                per_object_dev = self._upload_per_object(padded, fmt)
            device_in = self._assemble(per_object_dev, fmt, vocab, c_bucket, cluster_dev)
            self._count_dispatch(fmt, b_pad, c_bucket)
            out, cert = self._tick(device_in, fmt, m, key_max)
            self._sync()
            timings["device"] += time.perf_counter() - t1
            if cert is not None:
                # Certificates resolve before the pack reads the planes.
                t2 = time.perf_counter()
                cert_np = self._read_np(cert)
                timings["fetch"] += time.perf_counter() - t2
                out, _ = self._apply_cert_fallback(out, cert_np, device_in, fmt, n, timings)
            del device_in
            slabs.append((n, out))
            t0 = time.perf_counter()

        decoded: list[ScheduleResult] = []
        nsel_all = []
        rec = self._tick_rec
        rec_parts = []  # per slab: the recorder's fields off its wire
        for n, out in slabs:
            t2 = time.perf_counter()
            planes = (out.selected, out.replicas, out.counted, out.scores, out.reasons)
            wire = pack_wire(*(p[:n] for p in planes), pack_k)
            self.devprof.observe("pack", wire)
            packed = unpack_wire(self._read_np(wire), pack_k)
            nsel_all.append(packed.nsel)
            if rec is not None:
                rec_parts.append(
                    (packed.rsum, packed.nfeas, *self._packed_record_fields(packed, rec.topk))
                )
            over_pos = np.nonzero(packed.nsel > pack_k)[0]
            over_dense = (
                self._fetch_overflow(out, over_pos, want_scores, timings)
                if over_pos.size
                else None
            )
            t3 = time.perf_counter()
            timings["fetch"] += t3 - t2
            decoded.extend(
                self._decode_packed_mixed(packed, over_pos, over_dense, view.names, want_scores)
            )
            timings["decode"] += time.perf_counter() - t3

        t3 = time.perf_counter()
        nsel_all = np.concatenate(nsel_all)
        if rec_parts:
            rec_counts = np.concatenate([p[0] for p in rec_parts])
            rec_feas = np.concatenate([p[1] for p in rec_parts])
            rec_ti = [t for p in rec_parts for t in p[2]]
            rec_ts = [t for p in rec_parts for t in p[3]]
        offset = 0
        eager_repairs = []
        for slot, entry, changed_rows, _sub, inputs_stale in pending:
            merged = list(entry.prev_results)
            span = slice(offset, offset + len(changed_rows))
            for j, row in enumerate(changed_rows):
                res = decoded[offset + j]
                if want_scores and not entry.prev_has_scores:
                    res = ScheduleResult(res.clusters)
                merged[row] = res
            if rec_parts:
                rec.record_rows(
                    [entry.units[r].key for r in changed_rows],
                    [res.clusters for res in decoded[span]],
                    None, None, view.names, program=f"{fmt}:sub",
                    reason_counts=rec_counts[span], feasible_n=rec_feas[span],
                    topk_idx=rec_ti[span], topk_scores=rec_ts[span],
                )
            self._observe_nsel(entry, nsel_all[span], c_bucket)
            entry.prev_results = merged
            entry.prev_view = view
            if inputs_stale:
                # The patched rows' device inputs are stale until the
                # eager repair below.
                entry.stale_rows = sorted(
                    set(entry.stale_rows or ()) | set(changed_rows)
                )
                eager_repairs.append(entry)
            # Write the slab outputs back into the chunk's prev planes so
            # later diffs stay exact row for row; where shapes disagree
            # the rows are marked for a forced fetch instead.
            if not self._repair_prev_planes(entry, changed_rows, offset, slabs, slab_cut):
                entry.stale_out_rows = sorted(
                    set(entry.stale_out_rows or ()) | set(changed_rows)
                )
            offset += len(changed_rows)
            chunk_results[slot] = merged
        timings["decode"] += time.perf_counter() - t3
        t4 = time.perf_counter()
        for entry in eager_repairs:
            self._repair_stale_inputs(entry, fmt, c_bucket, phase="churn")
        timings["featurize"] += time.perf_counter() - t4

    def _gather_device_rows(self, pending, fmt: str) -> dict:
        """The pending rows' per-object tensors gathered from their
        chunks' device copies, in pending order; compact sparse-entry and
        key-byte widths padded on the device to the widest chunk's."""
        names = self._per_object_fields(fmt)
        pieces = []
        for _slot, entry, rows, _sub, _stale in pending:
            idx = self._index(rows)
            pieces.append(
                {name: entry.device_per_object[name].index_select(0, idx) for name in names}
            )
        if fmt == "compact":
            fills = dict(Cmp.SPARSE_FILLS, key_bytes=0)
            for name, fill in fills.items():
                width = max(p[name].shape[1] for p in pieces)
                for p in pieces:
                    extra = width - p[name].shape[1]
                    if extra:
                        p[name] = torch.nn.functional.pad(
                            p[name], (0, extra), value=int(fill)
                        )
        return {name: torch.cat([p[name] for p in pieces]) for name in names}

    def _repair_prev_planes(self, entry, changed_rows, offset: int, slabs, slab_cut: int) -> bool:
        """Scatter the slab outputs of this chunk's rows into its prev
        planes (prev_out, prev_feas, prev_reasons, prev_nfeas).  False (the caller
        marks the rows stale instead) when the planes are absent or a
        slab's cluster axis disagrees."""
        have = (
            entry.prev_out is not None
            and entry.prev_feas is not None
            and entry.prev_reasons is not None
        )
        if not have or not changed_rows:
            return have
        b_pad, c_pad = entry.prev_out[0].shape
        if (
            tuple(entry.prev_feas.shape) != (b_pad, c_pad)
            or tuple(entry.prev_reasons.shape) != (b_pad, c_pad)
        ):
            return False
        segments: dict[int, tuple[list, list]] = {}
        for j, dst in enumerate(changed_rows):
            if dst >= b_pad:
                return False
            pos = offset + j
            srcs, dsts = segments.setdefault(pos // slab_cut, ([], []))
            srcs.append(pos % slab_cut)
            dsts.append(dst)
        for s in segments:
            if s >= len(slabs) or slabs[s][1].selected.shape[1] != c_pad:
                return False
        for s, (srcs, dsts) in segments.items():
            self._scatter_prev_rows(entry, slabs[s][1], self._index(srcs), self._index(dsts))
        if entry.stale_out_rows:
            entry.stale_out_rows = sorted(set(entry.stale_out_rows) - set(changed_rows))
        return True

    # -- delta fetch ---------------------------------------------------------
    @staticmethod
    def _plan_delta(entry, mask: np.ndarray, n: int):
        """('skip' | 'delta' | 'full', rows) from a chunk's diff mask:
        placement changes count (score-only changes matter only to a
        decode that carries scores), rows merged by a sub-batch pass
        without a write-back are forced, and more than a quarter of the
        chunk (at least 16 rows) is fetched whole."""
        relevant = mask & _DIFF_PLACEMENT
        if entry.prev_has_scores:
            relevant = relevant | (mask & _DIFF_SCORES)
        if entry.stale_out_rows:
            stale = np.asarray([r for r in entry.stale_out_rows if r < n], np.int64)
            if stale.size:
                relevant[stale] |= _DIFF_PLACEMENT
        idx = np.nonzero(relevant)[0]
        if idx.size > max(16, n // 4):
            return "full", None
        if idx.size == 0:
            return "skip", None
        return "delta", idx

    def _scatter_prev_rows(self, entry, out, src, dst) -> None:
        """Write rows ``src`` of a dispatch's outputs into rows ``dst`` of
        the entry's six prev planes in place, and their feasible counts
        into prev_nfeas."""
        nfeas = self._ensure_nfeas(entry)
        planes = entry.prev_out + (entry.prev_feas, entry.prev_reasons)
        out_planes = (
            out.selected, out.replicas, out.counted, out.scores,
            out.feasible, out.reasons,
        )
        for plane, out_plane in zip(planes, out_planes):
            plane.index_copy_(0, dst, out_plane.index_select(0, src))
        nfeas.index_copy_(
            0, dst, (out.feasible.index_select(0, src) != 0).sum(dim=1, dtype=torch.int32)
        )
        self.devprof.observe("repair", nfeas)

    def _store_prev(self, entry, out) -> None:
        """Adopt a dispatch's six output planes as the entry's prev state,
        with their feasible counts."""
        entry.prev_out = (out.selected, out.replicas, out.counted, out.scores)
        entry.prev_feas = out.feasible
        entry.prev_reasons = out.reasons
        self._store_nfeas(entry, out.feasible)
        entry.stale_out_rows = None

    @staticmethod
    def _store_nfeas(entry, feas) -> None:
        """The per-row feasible counts kept beside a stored prev_feas."""
        entry.prev_nfeas = (feas != 0).sum(dim=1, dtype=torch.int32)

    def _ensure_nfeas(self, entry) -> torch.Tensor:
        """The entry's feasible counts, derived when a store predates them."""
        nf = entry.prev_nfeas
        if nf is None or tuple(nf.shape) != (entry.prev_feas.shape[0],):
            self._store_nfeas(entry, entry.prev_feas)
        return entry.prev_nfeas

    def _note_skip(self, entry, out, view) -> None:
        self.fetch_stats["skip"] += 1
        self._store_prev(entry, out)
        entry.prev_view = view

    def _apply_packed_delta(self, entry, out, idx, packed, over_pos, over_dense, view):
        """Decode the gathered rows (with scores if the cached decode
        carries them) and merge them into the cached decode; returns
        (merged results, changed rows)."""
        results = self._decode_packed_mixed(
            packed, over_pos, over_dense, view.names, entry.prev_has_scores
        )
        idx_rows = idx.tolist()
        merged = list(entry.prev_results)
        for row, res in zip(idx_rows, results):
            merged[row] = res
        self._record_packed(entry, idx_rows, results, packed, view, self._program(entry, out))
        self._store_prev(entry, out)
        entry.prev_results = merged
        entry.prev_view = view
        return merged, idx_rows

    def _apply_packed_full(
        self, entry, out, packed, over_pos, over_dense, view, want_scores: bool
    ):
        """Decode a whole fetched chunk (with scores if ``want_scores``).
        With an entry, the fresh outputs and decode are always stored, on
        a want_scores tick too: a tick that patched rows and skipped the
        store would leave a decode of the old inputs for the next no-op
        to replay."""
        self.fetch_stats["full"] += 1
        results = self._decode_packed_mixed(
            packed, over_pos, over_dense, view.names, want_scores
        )
        if entry is not None:
            self._record_packed(
                entry, range(len(results)), results, packed, view, self._program(entry, out)
            )
            self._store_prev(entry, out)
            entry.prev_results = results
            entry.prev_has_scores = want_scores
            entry.prev_view = view
        return results

    # -- flight recorder feed ----------------------------------------------
    @staticmethod
    def _program(entry, out) -> str:
        """A record's program fingerprint: the chunk's format and the
        dispatch's padded shape."""
        return f"{entry.fmt}:{out.selected.shape[0]}x{out.selected.shape[1]}"

    @staticmethod
    def _packed_record_fields(packed: PackedRows, topk: int):
        """Per-row recorder top-k: the wire's slots are ordered (score
        desc, index asc) over the selected clusters, so the first slots
        are the top-k, for overflow rows too."""
        idx = np.asarray(packed.idx)[:, :topk]
        sco = np.asarray(packed.sco)[:, :topk]
        valid = idx >= 0
        splits = np.cumsum(valid.sum(axis=1))[:-1]
        return (
            np.split(idx[valid].astype(np.int32), splits),
            np.split(sco[valid].astype(np.int64), splits),
        )

    def _record_packed(self, entry, rows, results, packed: PackedRows, view, program: str):
        """Feed the flight recorder the decoded rows (LOCAL chunk rows;
        ``entry.units`` maps them to keys) from the wire already read:
        the reason-summary counts and feasible counts ride it, so no
        plane is read for the recorder."""
        rec = self._tick_rec
        if rec is None:
            return
        topk_i, topk_s = self._packed_record_fields(packed, rec.topk)
        rec.record_rows(
            [entry.units[r].key for r in rows],
            [res.clusters for res in results],
            None, None, view.names, program=program,
            reason_counts=np.asarray(packed.rsum),
            feasible_n=np.asarray(packed.nfeas),
            topk_idx=topk_i, topk_scores=topk_s,
        )

    def _fetch_overflow(self, out, rows: np.ndarray, with_scores: bool, timings):
        """Re-fetch of K-overflow rows (the packed wire's escape hatch):
        bit-packed selection/counted masks plus the replica plane (and
        the score plane ``with_scores``) in one copy, timed as the
        ``overflow_fetch`` part of the fetch stage."""
        return self._fetch_overflow_window([(out, rows, with_scores)], timings)[0]

    def _fetch_overflow_window(self, jobs: list, timings) -> list:
        """The K-overflow rows of several dispatches, ``jobs`` of (outputs,
        rows, with_scores): each job's rows gathered, and the gathers read
        in one copy per width (_read_all: the cluster width, and whether
        the score plane rides along).  Returns each job's (rows' words,
        c_pad, with_scores)."""
        if not jobs:
            return []
        t0 = time.perf_counter()
        gathers = []
        for out, rows, with_scores in jobs:
            idx = self._index(rows)
            if with_scores:
                gathers.append(_gather_overflow4(
                    out.selected, out.counted, out.replicas, out.scores, idx
                ))
            else:
                gathers.append(_gather_overflow3(out.selected, out.counted, out.replicas, idx))
            self.devprof.observe("overflow", gathers[-1])
        arrs = self._read_all(gathers)
        timings["overflow_fetch"] += time.perf_counter() - t0
        return [
            (arr, out.selected.shape[1], with_scores)
            for (out, _rows, with_scores), arr in zip(jobs, arrs)
        ]

    @staticmethod
    def _split_overflow(arr: np.ndarray, c_pad: int):
        """One overflow read -> (selected, replicas, counted) planes.
        Layout: [sel bits | cnt bits | rep | sco, with scores] with
        ceil(C/32)-word masks."""
        nw = -(-c_pad // 32)
        sel = _unpack_bits(arr[:, :nw], c_pad)
        cnt = _unpack_bits(arr[:, nw : 2 * nw], c_pad)
        return sel, arr[:, 2 * nw : 2 * nw + c_pad], cnt

    def _decode_packed_mixed(self, packed, over_pos, over_dense, names, with_scores: bool):
        """Decode a packed fetch: packable rows from the wire slots,
        K-overflow rows from their re-fetched planes; score dicts too if
        ``with_scores``."""
        results = self._decode_packed_rows(packed, names, with_scores)
        if over_pos.size:
            self.overflow_rows_total += int(over_pos.size)
            arr, c_pad, has_scores = over_dense
            sel, rep, cnt = self._split_overflow(arr, c_pad)
            # A score-carrying read ends with the C score words.
            sco = arr[:, -c_pad:] if with_scores and has_scores else None
            decoded = self._decode_rows(sel, rep, cnt, names, sco)
            for p, r in zip(over_pos.tolist(), decoded):
                results[p] = r
        return results

    @staticmethod
    def _build_results(n_rows, rows, cols, replicas_at, counted_at, names, scores_at=None):
        """Shared decode tail: (row, col) placement pairs, sorted by row,
        -> frozen ScheduleResults, one dict(zip(...)) per row, and a score
        dict over the same pairs when ``scores_at`` is given.  ``*_at``
        are the values already gathered at the pairs."""
        bounds = np.searchsorted(rows, np.arange(n_rows + 1))
        reps_obj = replicas_at.astype(object)
        reps_obj[counted_at == 0] = DUPLICATE
        sel_names = np.asarray(names, dtype=object)[cols].tolist()
        reps_list = reps_obj.tolist()
        spans = zip(bounds[:-1], bounds[1:])
        if scores_at is None:
            return [
                ScheduleResult(clusters=_FrozenDict(zip(sel_names[s:e], reps_list[s:e])))
                for s, e in spans
            ]
        score_list = scores_at.tolist()
        return [
            ScheduleResult(
                clusters=_FrozenDict(zip(sel_names[s:e], reps_list[s:e])),
                scores=_FrozenDict(zip(sel_names[s:e], score_list[s:e])),
            )
            for s, e in spans
        ]

    @classmethod
    def _decode_rows(cls, selected, replicas, counted, names, scores=None) -> list[ScheduleResult]:
        """Vectorized decode of dense [n, C] planes (scores too if given)."""
        rows, cols = np.nonzero(selected)
        return cls._build_results(
            selected.shape[0], rows, cols, replicas[rows, cols], counted[rows, cols], names,
            scores[rows, cols] if scores is not None else None,
        )

    @classmethod
    def _decode_packed_rows(cls, packed, names, scores: bool = False) -> list[ScheduleResult]:
        """Decode packed [n, K] rows (slots score-ordered, PACK_FILL
        padded), with the slots' scores if ``scores``.  Dict content
        equals the dense decode; insertion order is score order, which no
        consumer observes.  Overflow rows (nsel > K) decode truncated
        here and are replaced by the caller."""
        idx = packed.idx
        rows, slots = np.nonzero(idx >= 0)
        return cls._build_results(
            idx.shape[0], rows, idx[rows, slots],
            packed.rep[rows, slots], packed.cnt[rows, slots], names,
            packed.sco[rows, slots] if scores else None,
        )
