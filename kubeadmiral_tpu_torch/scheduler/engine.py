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

The JAX engine's opt-in paths are keyword switches of the engine, with
the JAX engine's defaults (the class docstring): the three-stream
survivor revert, f16 resident score planes, the dense fetch format, the
dense solve, int64 select keys, full featurization and buffer donation.

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

The JAX engine's geometry and cache arguments are keywords with its
defaults, and so is its ``mesh``: over several devices each objects
shard keeps its rows of every chunk's resident state (``RowShards``,
``parallel/mesh.py``) and solves them in place with every row-wise
program on its own device and stream; the shards are collected in row
order only on the host, where it reads, so a meshed tick equals the
single-device one.  A mesh with a clusters axis (Nc > 1) also splits
every [B, C] plane by columns, one block per entry (``GridShards``):
the narrow tick, the packed wire, the diff, the feasible counts, the
f16 planes and the drift gate run split (``ops/split.py``: cell-local
stages on the blocks, per-row reductions and merges on each lane's
entry (i, 0)), and the programs that read whole rows (the dense solve,
the certificate fallback, the survivor programs, the weight check,
the overflow and dense-fetch gathers) gather them on (i, 0) and send
their planes back to the blocks.

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
from typing import NamedTuple, Optional, Sequence

import numpy as np
import torch

from kubeadmiral_tpu_torch.convert import tensor
from kubeadmiral_tpu_torch.models import types as T
from kubeadmiral_tpu_torch.ops import phase1 as phase1_mod
from kubeadmiral_tpu_torch.ops import split as split_mod
from kubeadmiral_tpu_torch.ops.pipeline import (
    DRIFT_RECOMPUTE,
    DRIFT_WCHECK,
    NIL_REPLICAS,
    DRIFT_FITFLIP,
    DRIFT_REFINE_MAX_COLS,
    PackedRows,
    TickInputs,
    _delta_tables,
    drift_gate_compact,
    drift_gate_dense,
    drift_replan,
    drift_resolve,
    drift_survivor,
    drift_wcheck,
    exact_rows,
    expand_compact,
    pack_wire,
    refresh_scores,
    schedule_tick,
    schedule_tick_narrow,
    unpack_wire,
    upcast_scores,
)
from kubeadmiral_tpu_torch.ops.planner import INT32_INF, RoundBudget
from kubeadmiral_tpu_torch.parallel.mesh import (
    _FIELD_SPECS,
    CLUSTERS,
    Blocks,
    GridShards,
    RowIndex,
    RowReplicas,
    RowShards,
    cat_rows,
    clusters_axis_size,
    leading_rows,
    make_mesh,
    objects_axis_size,
    run_rows,
    run_whole,
)
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


def tick_geometry(
    n_clusters: int, n_dev: int = 1, *, chunk_size: int = MEGACHUNK_ROWS,
    min_bucket: int = MIN_ROW_BUCKET, min_cluster_bucket: int = MIN_CLUSTER_BUCKET,
    cell_budget: int = CELL_BUDGET, megachunk_rows: int = MEGACHUNK_ROWS,
    canonical_c: int = CANONICAL_C,
) -> tuple[int, int, Optional[list]]:
    """(c_bucket, eff_chunk, row ladder or None) over ``n_dev`` devices
    on the objects axis: cell-budget chunking (``cell_budget`` and
    ``megachunk_rows`` are per device), with wide cluster axes bucketing
    rows to a 3-rung ladder.  The engine's geometry at its keywords, and
    the census's at any device count."""
    c_bucket = _cluster_bucket(n_clusters, min_cluster_bucket)
    max_rows = max(
        min_bucket,
        min(megachunk_rows * n_dev, (cell_budget * n_dev) // max(1, c_bucket)),
    )
    eff_chunk = min(chunk_size, 1 << (max_rows.bit_length() - 1))
    ladder = None
    if c_bucket >= canonical_c:
        ladder = sorted(
            {max(min_bucket, eff_chunk // 16), max(min_bucket, eff_chunk // 4), eff_chunk}
        )
    return c_bucket, eff_chunk, ladder


def bucket_rows(
    n: int, ladder: Optional[list], eff_chunk: int, full: bool,
    min_bucket: int = MIN_ROW_BUCKET,
) -> int:
    """The padded rows of an n-row chunk under ``tick_geometry``."""
    if ladder is None:
        return _pow2_bucket(n, min_bucket, eff_chunk)
    if full:
        # Multi-chunk batches pad every chunk (incl. the last
        # partial) to the full-chunk shape.
        return eff_chunk
    for rung in ladder:
        if n <= rung:
            return rung
    return eff_chunk


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


def _overflow_words(sel, cnt, rep, sco=None):
    """Overflow rows already gathered as one array: bit-packed
    selected/counted masks, the replica plane, and the score plane when
    given."""
    words = [_bitpack_bool(sel != 0), _bitpack_bool(cnt != 0), rep]
    return torch.cat(words + ([] if sco is None else [sco]), dim=1)


def _gather_overflow3(sel, cnt, rep, idx):
    """K-overflow row fetch: bit-packed selected/counted masks plus the
    replica plane of the given rows in ONE transfer (C/32 + C/32 + C
    words against the dense 3C)."""
    return _overflow_words(sel[idx], cnt[idx], rep[idx])


def _gather_overflow4(sel, cnt, rep, sco, idx):
    """The score-carrying variant, for a decode that carries scores: the
    score plane's C words after _gather_overflow3's."""
    return _overflow_words(sel[idx], cnt[idx], rep[idx], sco[idx])


def _feasible_counts(feas):
    """i32[n]: each row's feasible clusters."""
    return (feas != 0).sum(dim=1, dtype=torch.int32)


def _int32_side_by_side(*planes):
    """Row-gathered planes as one int32 array, side by side."""
    return torch.cat([p.to(torch.int32) for p in planes], dim=1)


def _settle_flags(unsettled, cert):
    """i8 per-row window flags: bit 0 the narrow certificate (if any),
    bit 1 a planner row still going after the round budget."""
    late = unsettled.to(torch.int8) * 2
    return late if cert is None else cert | late


def _placement_moved(sel, rep, cnt, sel0, rep0, cnt0):
    """i8 diff bits of rows whose placement planes moved."""
    moved = ((sel != sel0) | (rep != rep0) | (cnt != cnt0)).any(dim=1)
    return moved.to(torch.int8) * _DIFF_PLACEMENT


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
    # Under score_f16: prev_out's score plane is float16, and this i8[B]
    # vector flags the rows whose scores round-trip exactly (missing:
    # every row inexact); sco_inexact_host caches its inexact rows.
    prev_sco_exact: Optional[torch.Tensor] = None
    sco_inexact_host: Optional[np.ndarray] = None
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
    # Under donation: the diff mask, queued at dispatch against the
    # previous planes it released.
    mask: Optional[torch.Tensor] = None


def _pieces_of(out):
    """``out`` with every holder replaced by the list of its pieces (what
    the dispatch ledger walks for a ready marker)."""
    if isinstance(out, GridShards):
        out = RowShards(out.mesh, [p for row in out.pieces for p in row], out.bounds)
    if isinstance(out, Blocks):
        out = RowShards(out.mesh, [v for row in out.values for v in row if v is not None],
                        out.bounds)
    if isinstance(out, RowShards):
        return [p for p in out.pieces if p.numel()] or out.pieces
    if isinstance(out, tuple):
        return [_pieces_of(x) for x in out]
    if isinstance(out, dict):
        return {k: _pieces_of(v) for k, v in out.items()}
    return out


def _unsettled(budget):
    return None if budget is None else budget.unsettled


def _planes(out) -> tuple:
    """The five planes a wire packs, in pack_wire's order."""
    return (out.selected, out.replicas, out.counted, out.scores, out.reasons)


class TickPlanes(NamedTuple):
    """The five planes of _planes under their output names."""

    selected: torch.Tensor
    replicas: torch.Tensor
    counted: torch.Tensor
    scores: torch.Tensor
    reasons: torch.Tensor


class SchedulerEngine:
    """Chunked, shape-bucketed engine around ops.pipeline's narrow and
    dense ticks, with the JAX engine's chunk cache, no-op replay,
    sub-batch path and delta fetch.

    ``device`` defaults to ``"cuda"`` (phase 1 then runs as the
    hand-written kernel); pass ``device="cpu"`` for the plain torch path.
    The chunk geometry, candidate width, wire width, cache budget and
    vocabulary caps are the JAX engine's keywords with its defaults
    (the module constants above): ``chunk_size`` 4096 rows,
    ``min_bucket`` 64, ``min_cluster_bucket`` 8, ``cell_budget`` 4096 x
    5120 cells and ``megachunk_rows`` 4096 a device, ``canonical_c``
    256, ``narrow_m`` 128, ``pack_k_min`` 16, ``cache_bytes`` 16 GiB.

    ``mesh`` is the JAX engine's: "auto" builds an objects-axis mesh over
    the visible CUDA devices when there are several (``_resolve_mesh``),
    None is one device, a ``parallel.mesh.Mesh`` is taken as given.
    Under a mesh each objects shard ("lane") holds its rows of every
    chunk's resident state (the prev planes, feasibility and reasons,
    the per-object inputs and the per-row vectors, as ``RowShards``) on
    its own device and runs every row-wise program on them in place, on
    its own stream; gathers and scatters by global row go to the lanes
    that own the rows, and reads collect the lanes' pieces on the host.
    Under a clusters axis each entry (i, j) holds column block j of lane
    i's [B, C] planes (the prev planes, feasibility, reasons and the
    dense format's per-object planes) and runs the cell-local programs
    on it.  The window, the cell budget and the row cap are per device
    of the objects axis.

    ``schedule`` treats the unit list and the units as immutable: derive
    a changed batch as a fresh list with fresh unit objects.

    ``metrics`` is the registry each tick reports into (None: a private
    one); ``flight_recorder`` is the decision recorder the drains feed
    ("default": the process-wide one, None: no recording).

    The keyword-only switches are the JAX engine's opt-in paths, each
    defaulting to the JAX engine's default; every one gives the same
    placements.  ``survivor_unified=False`` reverts the drift survivors
    to three streams: rows without a fit flip through the sort-free
    resolve (``drift_resolve``), kinf fit-flip rows through the
    selection-known replan and finite-K ones through the score-only
    solve (``replan``).  ``score_f16`` keeps the resident score plane as
    float16 with a per-row exactness vector; inexact rows leave every
    path that trusts stored scores.  ``fetch_format="dense"`` fetches
    the full [B, C] planes (the flight recorder then keeps every
    cluster's verdict) and runs no survivor program.  ``narrow=False``
    runs the dense solve at every width.  ``phase1_i32=False`` keeps
    the narrow select keys int64.  ``delta_feat=False`` sends every
    changed chunk through the full featurizer and ignores the dirty-row
    hint.  ``donate`` releases a warm full dispatch's previous output
    planes once its diff is queued (False: they live until the drain).
    Each is an attribute, read where it applies."""

    def __init__(self, device="cuda", metrics: Optional[Metrics] = None,
                 flight_recorder="default", devprof="default", *,
                 survivor_unified: bool = True, drift_resolve: bool = True,
                 replan: bool = True, score_f16: bool = False,
                 fetch_format: str = "packed", narrow: bool = True,
                 phase1_i32: bool = True, delta_feat: bool = True,
                 donate: bool = True, chunk_size: int = MEGACHUNK_ROWS,
                 min_bucket: int = MIN_ROW_BUCKET,
                 min_cluster_bucket: int = MIN_CLUSTER_BUCKET,
                 cache_bytes: int = CACHE_BYTES, cell_budget: Optional[int] = None,
                 megachunk_rows: Optional[int] = None, canonical_c: int = CANONICAL_C,
                 vocab_caps: Optional[dict] = None, pack_k_min: Optional[int] = None,
                 narrow_m: Optional[int] = None, mesh="auto"):
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                "SchedulerEngine: CUDA is not available; pass device='cpu' "
                "to run on the CPU"
            )
        # Chunk geometry (the JAX engine's keywords and defaults): rows
        # per chunk at most, the row and cluster bucket floors, the
        # per-device cell budget and row cap, the cluster width from
        # which rows bucket to a 3-rung ladder, and the cache budget.
        self.chunk_size = int(chunk_size)
        self.min_bucket = int(min_bucket)
        self.min_cluster_bucket = int(min_cluster_bucket)
        self.cell_budget = CELL_BUDGET if cell_budget is None else int(cell_budget)
        self.megachunk_rows = max(
            1, MEGACHUNK_ROWS if megachunk_rows is None else int(megachunk_rows)
        )
        self.canonical_c = int(canonical_c)
        self.cache_bytes = int(cache_bytes)
        # The candidate width's floor (narrow solve) and the wire's
        # slot-count floor (packed fetch).
        self.narrow_m = NARROW_M if narrow_m is None else int(narrow_m)
        self.pack_k_min = PACK_K_MIN if pack_k_min is None else int(pack_k_min)
        # Compact vocabulary caps (a test or operations override, e.g. to
        # force the dense fallback); a misspelt key fails here, not deep
        # inside the first tick.
        self._vocab_caps = dict(vocab_caps or {})
        unknown = set(self._vocab_caps) - Cmp.CAP_NAMES
        if unknown:
            raise ValueError(
                f"unknown vocab_caps keys {sorted(unknown)}; "
                f"valid: {sorted(Cmp.CAP_NAMES)}"
            )
        if fetch_format not in ("packed", "dense"):
            raise ValueError(
                f"fetch_format must be 'packed' or 'dense', got {fetch_format!r}"
            )
        self.survivor_unified = bool(survivor_unified)
        self.drift_resolve = bool(drift_resolve)
        self.replan = bool(replan)
        self.score_f16 = bool(score_f16)
        self.fetch_format = fetch_format
        self.narrow = bool(narrow)
        self.phase1_i32 = bool(phase1_i32)
        self.delta_feat = bool(delta_feat)
        self.donate = bool(donate)
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
        # Drift-gate row classes (the JAX engine's keys): gated chunks;
        # skip rows (provably unchanged); wcheck rows (dynamic-weight
        # check) and wcheck_changed of them; recompute rows sent to the
        # sub-batch slabs; unified rows settled by the survivor program
        # (resolve, replan and score_only rows by the three-stream
        # revert's programs) and the *_fallback rows failing their
        # certificate; fallback chunks (most rows moved: the full
        # dispatch).
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
        # The window is per device (the JAX engine's KT_PIPELINE_DEPTH):
        # a mesh multiplies it by its objects axis.
        self.mesh = self._resolve_mesh(mesh)
        # Under a clusters axis (Nc > 1) every [B, C] plane lies in
        # column blocks on the mesh's entries (GridShards) and the
        # tick's programs run split (ops/split.py).
        self._grid = clusters_axis_size(self.mesh) > 1
        self._mesh_rows = (
            self.mesh if objects_axis_size(self.mesh) > 1 or self._grid else None
        )
        self._lane = None if self.mesh is None else f"mesh{self.mesh.devices.size}"
        self.pipeline_depth_per_device = PIPELINE_DEPTH
        self.pipeline_depth = PIPELINE_DEPTH * objects_axis_size(self.mesh)
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

    # -- devices -----------------------------------------------------------
    def _resolve_mesh(self, mesh):
        """The engine's mesh: an explicit Mesh or None as given; "auto"
        builds one over the visible CUDA devices when the engine runs on
        CUDA and there are several: the largest power-of-two count,
        objects axis first (up to ``min_bucket``, so every row rung
        splits evenly), the rest on the clusters axis (up to
        ``min_cluster_bucket``).  One device: None."""
        if isinstance(mesh, str):
            if mesh != "auto":
                raise ValueError(f"mesh must be 'auto', a Mesh or None, got {mesh!r}")
            if self.device.type != "cuda":
                return None
            n = torch.cuda.device_count()
            if n <= 1:
                return None
            usable = 1 << (n.bit_length() - 1)
            obj = min(usable, self.min_bucket)
            clus = min(usable // obj, self.min_cluster_bucket)
            return make_mesh(
                [torch.device("cuda", i) for i in range(obj * clus)], objects_axis=obj
            )
        if mesh is None:
            return None
        obj_dim, clus_dim = mesh.shape
        if obj_dim > self.min_bucket or clus_dim > self.min_cluster_bucket:
            raise ValueError(
                f"mesh {mesh.shape} larger than minimum buckets "
                f"({self.min_bucket}, {self.min_cluster_bucket})"
            )
        kinds = {d.type for d in mesh.devices.ravel()}
        if kinds != {self.device.type}:
            raise ValueError(
                f"mesh devices {sorted(kinds)} do not match the engine's "
                f"device {self.device}"
            )
        return mesh

    def _on_rows(self, fn, rows: tuple, whole: tuple = (), bounds: bool = False):
        """``fn(*rows, *whole)``; under a mesh, on each lane's rows in
        place, on its device and stream, the outputs kept on the lanes
        as holders (``parallel.mesh.run_rows``).  With ``bounds`` the
        lane's row range (lo, hi) leads the arguments ((0, n) without a
        mesh)."""
        if self._mesh_rows is None:
            if bounds:
                return fn(0, leading_rows(rows[0]), *rows, *whole)
            return fn(*rows, *whole)
        return run_rows(self._mesh_rows, fn, rows, whole, bounds=bounds)

    def _whole(self, fn, rows: tuple, whole: tuple = (), cols: Optional[int] = None,
               bounds: bool = False):
        """A whole-row program (kind 4 under a clusters axis): ``_on_rows``,
        with every [B, C] grid plane gathered as each lane's whole rows
        on entry (i, 0) and each ``[rows, cols]`` output split back into
        the blocks (``parallel.mesh.run_whole``).  Without a clusters
        axis it is ``_on_rows``."""
        if not self._grid:
            return self._on_rows(fn, rows, whole, bounds=bounds)
        return run_whole(self._mesh_rows, fn, rows, whole, cols=cols, bounds=bounds)

    def _reduce_rows(self, fn, planes: tuple, op: str):
        """``fn`` of [rows, C] planes to a per-row value (or a tuple of
        them), by rows under a mesh (``_on_rows``); under a clusters axis
        on every block, combined per row on (i, 0) by ``op`` (kinds 1
        and 2: ``split.grid_reduce_rows``)."""
        if self._grid:
            return split_mod.grid_reduce_rows(self._mesh_rows, fn, planes, op)
        return self._on_rows(fn, planes)

    def _map_cells(self, fn, planes: tuple):
        """A cell-local ``fn`` of [rows, C] planes, by rows under a mesh;
        under a clusters axis on every block (kind 1)."""
        if self._grid:
            return split_mod.grid_map(self._mesh_rows, fn, planes)
        return self._on_rows(fn, planes)

    def _cols_index(self, cols) -> torch.Tensor:
        """Changed columns for ``_write_cols``: on the device for the row
        programs, on the host under a clusters axis (which routes each
        column to its block)."""
        cols = np.asarray(cols, np.int64)
        return cols if self._grid else tensor(cols, self.device)

    def _write_cols(self, plane, cols, values) -> None:
        """``refresh_scores``: ``values`` [B, >= len(cols)] written into
        the columns ``cols`` (``_cols_index``) of ``plane`` in place, by
        rows; under a clusters axis each column to the block that owns
        it (kind 1)."""
        if self._grid:
            plane.index_copy_cols_(cols, values)
            return
        self._on_rows(
            lambda sco, new_cols, cols: refresh_scores(sco, cols, new_cols),
            (plane, values), (cols,),
        )

    def _upload_rows(self, arr) -> torch.Tensor:
        """A host ``[n, ...]`` array on the device; under a mesh split by
        rows, one copy straight to each lane."""
        if self._mesh_rows is None:
            return tensor(arr, self.device)
        return RowShards.from_host(self._mesh_rows, arr)

    def _upload_inputs(self, arr) -> torch.Tensor:
        """A host per-row input on the device: under a clusters axis on
        every entry of its rows' shard (``RowReplicas``), else as
        ``_upload_rows``."""
        if not self._grid:
            return self._upload_rows(arr)
        return RowReplicas.from_host(self._mesh_rows, arr)

    def _upload_plane(self, arr) -> torch.Tensor:
        """A host ``[n, C]`` plane on the device: under a clusters axis
        split by rows and columns, one copy straight to each entry."""
        if not self._grid:
            return self._upload_rows(arr)
        return GridShards.from_host(self._mesh_rows, arr)

    def _pack(self, planes: tuple, k: int) -> torch.Tensor:
        """The packed wire of five [N, C] planes (``pack_wire``), by rows
        under a mesh; split over the column blocks under a clusters axis
        (kinds 1 and 3: ``split.grid_pack_wire``)."""
        if isinstance(planes[0], GridShards):
            return split_mod.grid_pack_wire(self._mesh_rows, planes, k)
        return self._on_rows(pack_wire, planes, (k,))

    def _gather_planes(self, out, planes: int, idx) -> torch.Tensor:
        """The given rows of a dispatch's planes as one int32 array for
        the dense format's delta fetch: selected, replicas, counted, then
        the score plane (``planes`` >= 4) and the reason plane (5).  Under
        a mesh each lane takes its share of the index from the lanes that
        own the rows and lays the planes side by side (kind 4: the dense
        fetch format reads whole rows)."""
        return self._whole(
            _int32_side_by_side, tuple(p.index_select(0, idx) for p in _planes(out)[:planes])
        )

    def _diff(self, out, prev: tuple, n: int) -> torch.Tensor:
        """``_diff_bits`` of a dispatch's first n rows, by rows under a
        mesh (kinds 1 and 2 under a clusters axis: each block's per-row
        OR, OR-ed on (i, 0))."""
        planes = (out.selected, out.replicas, out.counted, out.scores) + tuple(prev)
        planes = tuple(p[:n] for p in planes)

        def diff(sel, rep, cnt, sco, *old):
            return _diff_bits(TickPlanes(sel, rep, cnt, sco, None), old, sel.shape[0])

        # The two diff bits of the blocks OR-ed: those of the whole row.
        return self._reduce_rows(diff, planes, "any")

    def _observe(self, kind: str, out) -> None:
        """One dispatch into the ledger; a meshed engine's programs on
        the ``mesh<N>`` lane (a holder observed through its pieces)."""
        if self._lane is None:
            self.devprof.observe(kind, out)
        else:
            self.devprof.observe(kind, _pieces_of(out), lane=self._lane)

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
        vocab = CompactVocab(view, **self._vocab_caps)
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
        self._observe("tiebreak", tick_in.tiebreak)
        m = self._narrow_m(padded, c_bucket)
        if m is None:
            self._observe("tick", schedule_tick(tick_in))
        else:
            self._observe(
                "tick_narrow", schedule_tick_narrow(tick_in, m, i32_keys=self.phase1_i32)
            )
        self._sync()

    # -- shape policy ----------------------------------------------------
    def _tick_geometry(self, n_clusters: int) -> tuple[int, int, Optional[list]]:
        """``tick_geometry`` at this engine's keywords and mesh."""
        return tick_geometry(
            n_clusters, objects_axis_size(self.mesh), chunk_size=self.chunk_size,
            min_bucket=self.min_bucket, min_cluster_bucket=self.min_cluster_bucket,
            cell_budget=self.cell_budget, megachunk_rows=self.megachunk_rows,
            canonical_c=self.canonical_c,
        )

    def _bucket_rows(
        self, n: int, ladder: Optional[list], eff_chunk: int, full: bool
    ) -> int:
        return bucket_rows(n, ladder, eff_chunk, full, self.min_bucket)

    def _narrow_m(self, inputs, c_bucket: int) -> Optional[int]:
        """The chunk's candidate width M, or None for the dense tick: pow2
        over the finite maxClusters bound, floored at ``narrow_m``; narrow
        only when M is narrower than the cluster bucket (never under
        ``narrow=False``)."""
        if not self.narrow:
            return None
        m = _pow2_bucket(
            max(_finite_bound(inputs.max_clusters), self.narrow_m), 8, 1 << 30
        )
        return m if m < c_bucket else None

    def _pack_k(self, inputs, c_bucket: int, hint: int = 0) -> int:
        """The wire slot count K: the chunk's adaptive hint when it has
        one (see _commit_nsel), else pow2 over the finite maxClusters
        bound, floored at ``pack_k_min``; capped at the cluster bucket (K = C
        is lossless).  Rows selecting more than K clusters overflow and
        are re-fetched, so K tunes bytes, never correctness."""
        if hint:
            return min(max(hint, 8), c_bucket)
        k = _pow2_bucket(
            max(_finite_bound(inputs.max_clusters), self.pack_k_min), 8, 1 << 30
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
                self.pack_k_min,
            )

    @staticmethod
    def _commit_nsel(entry, nsel, c_bucket: int, pack_k_min: int = PACK_K_MIN) -> None:
        """One tick's selected counts -> the entry's pack-K hint: the pow2
        K with the fewest expected wire bytes over the observed counts
        (each row pays 4K+2 words; an overflow row also pays its ~4.25 C
        bytes of re-fetch), widened to hold overflow under
        PACK_OVERFLOW_PCT when that costs at most PACK_WIDEN times the
        optimum.  The hint rises at once and halves only after two
        consecutive shrink votes.  The search starts at ``pack_k_min``'s
        bucket (the engine's)."""
        nsel = np.asarray(nsel)
        over_bytes = 4.25 * c_bucket

        def cost_at(k_eff: int) -> float:
            return nsel.size * (4 * k_eff + 2) * 4 + float(
                (nsel > k_eff).sum()
            ) * over_bytes

        best_k, best_cost = None, None
        k = _pow2_bucket(pack_k_min, 8, 1 << 30)
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
            vocab = CompactVocab(view, **self._vocab_caps)
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
            # so only replaced objects are signature-checked; under
            # delta_feat=False the dirty-row hint is ignored.
            if dirty is None or cached.restored or not self.delta_feat:
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
            if self.delta_feat and len(changed) <= max(1, len(chunk) // 4):
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
        b_pad = _pow2_bucket(len(chunk), self.min_bucket, 1 << 30)
        c_pad = _cluster_bucket(
            np.asarray(inputs.cluster_valid).shape[0], self.min_cluster_bucket
        )
        nbytes = host_bytes * 3 + b_pad * c_pad * 15
        entry = None
        if self._cache_used + nbytes <= self.cache_bytes:
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
        c_bucket) and shared by every dispatch; under a clusters axis
        each entry reads its column block (``Mesh.column_block``: a view
        on the engine's device, a copy kept on another)."""
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
        the vocabulary grows or the cluster padding changes; under a
        clusters axis each entry reads the cluster-axis tables' column
        block (``Mesh.column_block``)."""
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
        """The per-object tensors of ``padded`` on the device (split by
        rows over the lanes under a mesh; the dense format's [B, C]
        planes by rows and columns under a clusters axis)."""
        names = self._per_object_fields(fmt)
        host = {name: np.asarray(getattr(padded, name)) for name in names}
        self.upload_bytes["object"] += sum(a.nbytes for a in host.values())
        return {
            name: self._upload_plane(a)
            if fmt == "dense" and CLUSTERS in _FIELD_SPECS[name]
            else self._upload_inputs(a)
            for name, a in host.items()
        }

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
        self._observe("patch", entry.device_per_object)
        entry.stale_rows = None

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _read_np(self, t: torch.Tensor) -> np.ndarray:
        """Blocking device->host copy, counted in fetch_bytes_total (a
        holder piece by piece, joined on the host)."""
        arr = t.numpy() if isinstance(t, (RowShards, GridShards)) else t.cpu().numpy()
        self.fetch_bytes_total += arr.nbytes
        return arr

    def _index(self, rows):
        """Global row indices for a gather or scatter: a tensor on the
        device, or under a mesh a ``RowIndex`` that routes each row to
        the lane owning it."""
        if self._mesh_rows is not None:
            return RowIndex(rows)
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
        any.  Under a mesh each objects shard expands and solves its
        rows (each with a budget of its own, their unsettled rows and
        recorded rounds joined into ``budget``).  The module-level tick
        functions are looked up at call time (chip_smoke counts them)."""
        if m is not None:
            self.narrow_last_m = m
        budgets: list = []

        def lane_budget():
            sub = budget
            if budget is not None and self._mesh_rows is not None:
                sub = RoundBudget(budget.rounds, record=budget.per_row is not None)
            budgets.append(sub)
            return sub

        if self._grid and m is not None:
            # Kinds 1-3: each block expands, runs the split phase 1 and
            # its cell-local stages; the rows' reductions, merges and the
            # planner's scans over [rows, M] run on (i, 0).
            c = device_in.cluster_valid.shape[0]
            out, cert, unsettled = split_mod.grid_tick_narrow(
                self._mesh_rows, device_in, fmt, c, m, self.phase1_i32, key_max,
                lane_budget if budget is not None else None,
                observe=self._observe,
            )
            self._join_budgets(budget, budgets, unsettled)
            self._observe("tick_narrow", (out, cert))
            return out, cert

        def solve(piece):
            sub = lane_budget()
            if fmt == "compact":
                tick_in = expand_compact(piece, key_max)
                if len(budgets) == 1:
                    self._observe("tiebreak", tick_in.tiebreak)
            else:
                tick_in = piece
            if m is None:
                return schedule_tick(tick_in, budget=sub), None, _unsettled(sub)
            out, cert = schedule_tick_narrow(
                tick_in, m, i32_keys=self.phase1_i32, budget=sub
            )
            return out, cert, _unsettled(sub)

        # Kind 4 under a clusters axis: the dense solve reads whole rows.
        out, cert, unsettled = self._whole(
            solve, (device_in,), cols=device_in.cluster_valid.shape[0]
        )
        self._join_budgets(budget, budgets, unsettled)
        if m is None:
            self._observe("tick", out)
        else:
            self._observe("tick_narrow", (out, cert))
        return out, cert

    def _join_budgets(self, budget, budgets: list, unsettled) -> None:
        """Under a mesh, the lanes' planner budgets joined into the
        tick's: their unsettled rows and recorded rounds, in row order."""
        if budget is None or self._mesh_rows is None:
            return
        budget.unsettled = unsettled
        if budget.per_row is not None:
            loops = zip(*(b.per_row for b in budgets))
            budget.per_row.extend(np.concatenate(rounds) for rounds in loops)

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
            m.counter("engine_fetch_bytes_total", bytes_delta, format=self.fetch_format)
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
        restorable, under the JAX engine's keys: the geometry, the mesh's
        (objects, clusters) shape (None: one device), the fetch format,
        the narrow solve and the score plane's dtype.  A mismatch rejects
        the snapshot: restore never reinterprets planes."""
        return {
            "version": SNAPSHOT_STATE_VERSION,
            "chunk_size": self.chunk_size,
            "cell_budget": self.cell_budget,
            "megachunk_rows": self.megachunk_rows,
            "min_bucket": self.min_bucket,
            "min_cluster_bucket": self.min_cluster_bucket,
            "canonical_c": self.canonical_c,
            "fetch_format": self.fetch_format,
            "narrow": self.narrow,
            "narrow_m": self.narrow_m,
            "mesh": None if self.mesh is None else tuple(self.mesh.shape),
            "score_f16": self.score_f16,
        }

    @staticmethod
    def _planes_to_host(planes) -> list:
        """Host copies of several device planes in ONE device->host read:
        their bytes joined on the device, read, and split back into
        arrays of their dtypes and shapes.  Holders: one read per lane
        (its pieces joined on its device), the lanes' rows concatenated
        on the host."""
        if isinstance(planes[0], GridShards):
            return [p.numpy() for p in planes]
        if isinstance(planes[0], RowShards):
            lanes = [
                SchedulerEngine._planes_to_host([p.pieces[i] for p in planes])
                for i in range(len(planes[0].pieces))
            ]
            return [np.concatenate([lane[k] for lane in lanes]) for k in range(len(planes))]
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
            # Under score_f16 the exactness vector rides the same read.
            vec = (e.prev_sco_exact,) if (self.score_f16 and e.prev_sco_exact is not None) else ()
            sel, rep, cnt, sco, feas, rsn, *exact = self._planes_to_host(
                e.prev_out + (e.prev_feas, e.prev_reasons) + vec
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
            if self.score_f16:
                # The f16 plane cannot rebuild its exactness vector (the
                # i32 scores are gone), so the vector rides along; a
                # missing one restores as every row inexact.
                chunks[idx]["sco_exact"] = exact[0] if exact else None
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
        family is 0), also stored as ``engine_resident_bytes`` gauges.
        ``by_device`` sums them by lane: the device each piece lies on,
        or ``"<device>/<lane>"`` where several lanes share one device
        (``RowShards.lane_labels``); without a mesh, the engine's
        device.  ``per_device`` is the busiest lane's (the number an HBM
        budget is compared against).  Under a mesh every family is split
        by rows over the lanes, the [B] vectors too, so each lane holds
        its share of the chunks' padded rows (the census's "rows"
        layout).  Under a clusters axis (Nc > 1) the keys are the mesh's
        entries: each [B, C] plane's block books under its entry's device,
        or ``"<device>/<i>.<j>"`` where entries share one, each per-row
        input's copy (``RowReplicas``) under its entry, and the [B]
        vectors under entry (i, 0)'s; the [B, C] families thus divide by
        No * Nc and the rest by No, and ``by_family`` counts one copy of
        each input (the JAX engine's figure divides every family by the
        objects axis alone)."""
        fams = {"prev_planes": 0, "per_object": 0, "tiebreak": 0, "vectors": 0}
        by_device: dict[str, int] = {}
        prev_by_device: dict[str, int] = {}

        def book(family, t):
            if t is None:
                return
            fams[family] += t.nbytes
            if isinstance(t, (GridShards, RowReplicas)):
                lanes = [(label, p.nbytes) for label, p in t.entries()]
            elif self._grid and isinstance(t, RowShards):
                # A [B] vector: on its lane's entry (i, 0).
                lanes = [(self.mesh.entry_label(i, 0), p.nbytes) for i, p in enumerate(t.pieces)]
            elif isinstance(t, RowShards):
                lanes = zip(t.lane_labels(), (p.nbytes for p in t.pieces))
            else:
                lanes = [(str(t.device), t.nbytes)]
            for dev, nbytes in lanes:
                by_device[dev] = by_device.get(dev, 0) + nbytes
                if family == "prev_planes":
                    prev_by_device[dev] = prev_by_device.get(dev, 0) + nbytes

        for e in self._chunk_cache.values():
            for p in (e.prev_out or ()) + (e.prev_feas, e.prev_reasons):
                book("prev_planes", p)
            for t in (e.device_per_object or {}).values():
                book("per_object", t)
            for vec in (e.prev_nfeas, e.prev_sco_exact):
                book("vectors", vec)
        total = sum(fams.values())
        per_device = max(by_device.values(), default=0)
        for family, v in fams.items():
            self.metrics.store("engine_resident_bytes", v, family=family)
        self.metrics.store("engine_resident_bytes_per_device", per_device)
        return {
            "by_family": fams,
            "total": total,
            "device_count": objects_axis_size(self.mesh),
            "by_device": by_device,
            "prev_planes_by_device": prev_by_device,
            "per_device": per_device,
            "score_dtype": "f16" if self.score_f16 else "i32",
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
            if cs["has_scores"] and self.score_f16:
                # Lossy rows' score dicts cannot be replayed from an f16
                # plane: the chunk is solved cold instead.
                continue
            host_bytes = sum(
                np.asarray(getattr(inputs, name)).nbytes
                for name in self._per_object_fields(fmt)
            )
            c = np.asarray(inputs.cluster_valid).shape[0]
            nbytes = (
                host_bytes * 3
                + _pow2_bucket(n, self.min_bucket, 1 << 30)
                * _cluster_bucket(c, self.min_cluster_bucket)
                * 15
            )
            if self._cache_used + nbytes > self.cache_bytes:
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

            def put(name, dtype, upload=self._upload_plane):
                return upload(np.ascontiguousarray(cs[name], dtype=dtype))

            entry.prev_out = (
                put("sel", np.int8), put("rep", np.int32),
                put("cnt", np.int8),
                put("sco", np.float16 if self.score_f16 else np.int32),
            )
            entry.prev_feas = put("feas", np.int8)
            entry.prev_reasons = put("rsn", np.int32)
            if self.score_f16 and cs.get("sco_exact") is not None:
                entry.prev_sco_exact = put("sco_exact", np.int8, self._upload_rows)
            # The feasible counts are derived on the host, not stored:
            # the snapshot's format stays the JAX engine's and nothing is
            # launched.
            entry.prev_nfeas = self._upload_rows(
                (np.asarray(cs["feas"]) != 0).sum(axis=1).astype(np.int32)
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
            # An f16 score plane cannot replay score dicts exactly: a
            # chunk whose decode carries scores fetches whole.
            delta_ok = (
                prev_valid
                and entry.prev_out is not None
                and tuple(entry.prev_out[0].shape) == shape
                and not (self.score_f16 and entry.prev_has_scores)
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
        mask = None
        if delta_ok and self.donate and not entry.prev_has_scores:
            # Donation: the diff is queued now and the previous output
            # planes are released; every drain path stores the fresh
            # outputs before they are read again.  (A chunk whose decode
            # carries scores keeps them: a re-dispatch at the drain could
            # not diff its score rows against the decoded dicts.)
            mask = self._diff(out, self._prev_for_diff(entry), n)
            entry.prev_out = None
        timings["device"] += time.perf_counter() - t1
        return _InFlight(
            slot=slot, entry=entry, out=out, cert=cert,
            unsettled=None if budget is None else budget.unsettled,
            device_in=device_in, fmt=fmt, n=n, pack_k=pack_k, m=m,
            key_max=key_max, delta_ok=delta_ok, mask=mask,
        )

    def _rediff_late_rows(self, it, late: np.ndarray, names) -> torch.Tensor:
        """A donated diff after its chunk's re-dispatch: rows the planner
        had settled within its round budget kept their outputs, and with
        them their diff bits; the late rows are diffed again against
        their previous placements, rebuilt from the cached decode (the
        selected, replicas and counted planes are a function of each
        row's placement dict over ``names``, the view's columns, which a
        delta-capable chunk shares with its previous tick; the chunk's
        decode carries no scores)."""
        if late.size == 0:
            return it.mask
        entry = it.entry
        c_pad = it.out.selected.shape[1]
        col = {name: j for j, name in enumerate(names)}
        sel = np.zeros((late.size, c_pad), np.int8)
        rep = np.zeros((late.size, c_pad), np.int32)
        cnt = np.zeros((late.size, c_pad), np.int8)
        for i, row in enumerate(late.tolist()):
            for name, reps in entry.prev_results[row].clusters.items():
                j = col[name]
                sel[i, j] = 1
                rep[i, j] = int(NIL_REPLICAS) if reps is None else reps
                cnt[i, j] = reps is not None
        self.upload_bytes["object"] += sel.nbytes + rep.nbytes + cnt.nbytes
        idx = self._index(late)
        out = it.out
        now = tuple(p.index_select(0, idx) for p in (out.selected, out.replicas, out.counted))
        old = tuple(self._upload_plane(a) for a in (sel, rep, cnt))
        moved = self._reduce_rows(_placement_moved, now + old, "any")
        mask = it.mask.clone()
        mask[idx] = moved
        return mask

    def _drain_window(self, items: list, chunk_results, chunk_changed, view, timings) -> None:
        """Drain the in-flight window with batched reads (the JAX
        engine's _drain_fetch_window with the packed wire): settle the
        certificates and planner budgets, read every diff mask (one
        read), plan each chunk's fetch (skip, delta or full), then
        pack, read and decode the wires.  Empties ``items``."""
        if not items:
            return
        single = len(items) == 1
        self._settle_window(items, view, timings)
        t0 = time.perf_counter()
        diffed = [it for it in items if it.delta_ok]
        masks = self._read_all([
            it.mask if it.mask is not None
            else self._diff(it.out, self._prev_for_diff(it.entry), it.n)
            for it in diffed
        ])
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
        if self.fetch_format == "packed":
            self._drain_window_packed(delta_items, full_items, chunk_results, chunk_changed,
                                      view, timings)
        else:
            self._drain_window_dense(delta_items, full_items, chunk_results, chunk_changed,
                                     view, timings, single)
        items.clear()

    def _settle_window(self, items: list, view, timings) -> None:
        """Resolve a window's certificates and planner budgets before any
        plane leaves the card.  Each chunk's i8[B] flags (bit 0 its
        narrow certificate, bit 1 a planner row still going after the
        round budget) are read in one copy.  A chunk with an
        unsettled row is dispatched again with the checked round loop
        (counted in ``planner_reruns``; a donated diff then redone for its
        late rows, ``_rediff_late_rows``) and its certificate read alone;
        then uncertified rows are re-solved dense and written back
        (_apply_cert_fallback), their rows kept in ``fb_rows``."""
        flagged, devs = [], []
        for it in items:
            flag = it.cert
            if it.unsettled is not None:
                flag = self._on_rows(_settle_flags, (it.unsettled, it.cert))
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
                if it.mask is not None:
                    it.mask = self._rediff_late_rows(
                        it, np.nonzero(flag[: it.n] & 2)[0], view.names
                    )
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
            wire = self._pack(tuple(p.index_select(0, gidx) for p in _planes(it.out)), it.pack_k)
            self._observe("pack", wire)
            wires.append((it, idx, wire))
        for it in full_items:
            wire = self._pack(tuple(p[: it.n] for p in _planes(it.out)), it.pack_k)
            self._observe("pack", wire)
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

    def _drain_window_dense(
        self, delta_items, full_items, chunk_results, chunk_changed, view, timings,
        single: bool,
    ) -> None:
        """The dense format's drain (the JAX engine's dense window drain,
        and its sequential fetch for a window of one): each delta
        chunk's changed rows gathered as int32 planes side by side
        (selected, replicas, counted; the scores when the cached decode
        carries them; scores and reasons for the flight recorder), the
        gathers of one plane count padded to one pow2 row count of at
        least 16; a whole chunk read plane by plane at its padded shape
        (scores on a want_scores tick or for the recorder, reasons for
        the recorder — with a window of one, only for a cache entry).
        Every read is queued before the first wait."""
        t0 = time.perf_counter()
        record = self._tick_rec is not None
        by_planes: dict[int, list] = {}
        for it, idx in delta_items:
            self.fetch_stats["delta"] += 1
            planes = 5 if record else (4 if it.entry.prev_has_scores else 3)
            by_planes.setdefault(planes, []).append((it, idx))
        gathers = []  # (item, rows, planes, device gather)
        for planes, group in by_planes.items():
            k = max(_pow2_bucket(idx.size, 16, 1 << 30) for _it, idx in group)
            for it, idx in group:
                gidx = np.zeros(k, np.int64)
                gidx[: idx.size] = idx
                dev = self._gather_planes(it.out, planes, self._index(gidx))
                self._observe("gather", dev)
                gathers.append((it, idx, planes, dev))
        fulls = []  # (item, device planes)
        for it in full_items:
            rec_it = record and (it.entry is not None or not single)
            out = it.out
            planes = [out.selected, out.replicas, out.counted]
            if it.want_scores or rec_it:
                planes.append(out.scores)
            if rec_it:
                planes.append(out.reasons)
            fulls.append((it, planes))
        arrs = self._read_all([g[3] for g in gathers] + [p for _it, ps in fulls for p in ps])
        timings["fetch"] += time.perf_counter() - t0

        t0 = time.perf_counter()
        for (it, idx, planes, _dev), arr in zip(gathers, arrs):
            chunk_results[it.slot], chunk_changed[it.slot] = self._apply_dense_delta(
                it.entry, it.out, idx, arr[: idx.size], planes, view
            )
        pos = len(gathers)
        for it, ps in fulls:
            got = arrs[pos : pos + len(ps)]
            pos += len(ps)
            chunk_results[it.slot] = self._apply_dense_full(
                it.entry, it.out, got, it.n, view, it.want_scores
            )
            chunk_changed[it.slot] = None
        timings["decode"] += time.perf_counter() - t0

    def _apply_dense_delta(self, entry, out, idx, arr, planes: int, view):
        """Decode gathered dense rows (scores if the cached decode carries
        them), merge them into the cached decode and record them with
        their full reason rows; returns (merged, changed rows)."""
        c_pad = arr.shape[1] // planes
        sco = arr[:, 3 * c_pad : 4 * c_pad] if planes >= 4 else None
        rsn = arr[:, 4 * c_pad : 5 * c_pad] if planes >= 5 else None
        results = self._decode_rows(
            arr[:, :c_pad], arr[:, c_pad : 2 * c_pad], arr[:, 2 * c_pad : 3 * c_pad],
            view.names, sco if entry.prev_has_scores else None,
        )
        idx_rows = idx.tolist()
        merged = list(entry.prev_results)
        for row, res in zip(idx_rows, results):
            merged[row] = res
        self._record_decisions(entry, idx_rows, results, rsn, sco, view, self._program(entry, out))
        self._store_prev(entry, out)
        entry.prev_results = merged
        entry.prev_view = view
        return merged, idx_rows

    def _apply_dense_full(self, entry, out, planes: list, n: int, view, want_scores: bool):
        """Decode a whole chunk's dense planes ([selected, replicas,
        counted] and, when read, scores and reasons); with an entry the
        outputs and decode are stored, as ``_apply_packed_full`` does."""
        self.fetch_stats["full"] += 1
        sel, rep, cnt = planes[:3]
        sco = planes[3] if len(planes) > 3 else None
        rsn = planes[4] if len(planes) > 4 else None
        results = self._decode_rows(
            sel[:n], rep[:n], cnt[:n], view.names,
            sco[:n] if (sco is not None and want_scores) else None,
        )
        if entry is not None:
            self._record_decisions(
                entry, range(n), results, None if rsn is None else rsn[:n],
                None if sco is None else sco[:n], view, self._program(entry, out),
            )
            self._store_prev(entry, out)
            entry.prev_results = results
            entry.prev_has_scores = want_scores
            entry.prev_view = view
        return results

    def _record_decisions(self, entry, rows, results, reasons, scores, view, program: str):
        """Feed the flight recorder dense rows already read (LOCAL chunk
        rows): every cluster's reason bits ride along, so /debug/explain
        names each cluster's verdict.  Nothing without reasons."""
        rec = self._tick_rec
        if rec is None or reasons is None:
            return
        rec.record_rows(
            [entry.units[r].key for r in rows],
            [res.clusters for res in results],
            reasons, scores, view.names, program=program,
        )

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
        event, so the wait covers only the work queued before it.  A
        holder starts one copy per lane (a grid plane one per entry, each
        lane's blocks joined side by side on the host)."""
        if isinstance(t, GridShards):
            return [{"cols": [self._start_read(p) for p in row]} for row in t.pieces]
        if isinstance(t, RowShards):
            return [self._start_read(p) for p in t.pieces]
        if t.device.type != "cuda":
            return t, None
        host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        host.copy_(t, non_blocking=True)
        done = torch.cuda.Event()
        done.record()
        return host, done

    def _finish_read(self, handle) -> np.ndarray:
        if isinstance(handle, list):
            return np.concatenate([self._finish_read(h) for h in handle])
        if isinstance(handle, dict):
            return np.concatenate([self._finish_read(h) for h in handle["cols"]], axis=1)
        host, done = handle
        if done is not None:
            done.synchronize()
        arr = host.numpy()
        self.fetch_bytes_total += arr.nbytes
        return arr

    def _read_all(self, tensors: list) -> list:
        """Host copies of several tensors: those of one dtype, one shape
        past the first axis and one device are joined there (torch.cat)
        and read in one copy, then split by their row counts; every copy
        is queued before the first wait.  A holder's pieces are read
        with their lanes' groups and joined on the host (a grid plane's
        blocks side by side, then its lanes' rows)."""
        pieces, layouts = [], []
        for t in tensors:
            if isinstance(t, GridShards):
                rows = t.pieces
            elif isinstance(t, RowShards):
                rows = [[p] for p in t.pieces]
            else:
                rows = [[t]]
            layout = []
            for row in rows:
                layout.append(list(range(len(pieces), len(pieces) + len(row))))
                pieces.extend(row)
            layouts.append(layout)
        groups: dict[tuple, list[int]] = {}
        for k, t in enumerate(pieces):
            groups.setdefault((tuple(t.shape[1:]), t.dtype, str(t.device)), []).append(k)
        reads = [
            (
                members,
                self._start_read(
                    pieces[members[0]]
                    if len(members) == 1
                    else torch.cat([pieces[k] for k in members])
                ),
            )
            for members in groups.values()
        ]
        got: list = [None] * len(pieces)
        for members, handle in reads:
            arr = self._finish_read(handle)
            start = 0
            for k in members:
                rows = pieces[k].shape[0]
                got[k] = arr[start : start + rows]
                start += rows
        out = []
        for layout in layouts:
            rows = [
                got[row[0]] if len(row) == 1 else np.concatenate([got[k] for k in row], axis=1)
                for row in layout
            ]
            out.append(rows[0] if len(rows) == 1 else np.concatenate(rows))
        return out

    def _dispatch_drift_gate(self, entry, fmt: str, c_bucket: int, info: dict, vocab) -> dict:
        """Queue one chunk's drift gate and the copy of its row mask (read
        in _drain_drift_gates; nothing here waits on the device).  The
        gate reads an i32 score plane: a stored f16 one is upcast, and
        the copy is what the drain refreshes and compresses again.  The
        delta slots' device copies ride along for the resolve stream."""
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
        delta = tuple(tensor(a, dev) for a in slices) + tuple(
            tensor(info[k], dev) for k in ("didx", "dvalid", "dcpu")
        )
        scores = entry.prev_out[3]
        if scores.dtype == torch.float16:
            scores = self._upcast_scores(scores)
        fin = tensor(self._fin_rows(entry, b_pad), dev)
        tables = self._tables_device(vocab, c_bucket) if fmt == "compact" else None
        self.dispatches_total += 1

        def gate(lo, hi, per_object, feas, sco, nfeas, fin, tables, *delta):
            if self._mesh_rows is not None:
                # The shard's finite rows, local (others out of range).
                fin = torch.where((fin >= lo) & (fin < hi), fin - lo, 1 << 30)
            args = (feas, sco, *delta, fin, nfeas)
            if fmt == "compact":
                return drift_gate_compact(per_object, tables, *args, Cmp.CUR_ABSENT)
            return drift_gate_dense(per_object, *args)

        if self._grid:
            # Kinds 1 and 2: the changed columns' cells from the blocks
            # that own them, the rows classified on (i, 0), the exact
            # refinement's counts summed over the blocks.
            tables_d = None
            if fmt == "compact":
                d_safe = torch.clamp(delta[4].to(torch.int64), 0, c_bucket - 1)
                tables_d = _delta_tables(tables, d_safe)
            mask, new_cols = split_mod.grid_drift_gate(
                self._mesh_rows, fmt, entry.device_per_object, entry.prev_feas, scores,
                self._ensure_nfeas(entry), fin, delta, tables_d, Cmp.CUR_ABSENT,
            )
        else:
            mask, new_cols = self._on_rows(
                gate,
                (entry.device_per_object, entry.prev_feas, scores, self._ensure_nfeas(entry)),
                (fin, tables, *delta),
                bounds=True,
            )
        self._observe("gate", (mask, new_cols))
        return {
            "mask": self._start_read(mask),
            "new_cols": new_cols,
            "cols": self._cols_index(info["cols"]),
            "scores": scores,
            "delta": delta,
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

    def _survivor_inputs(self, entry, fmt: str, vocab, c_bucket: int, cluster_dev):
        """(device inputs, per-object fields, key bound) of a gated
        chunk, for the survivor programs' row gathers."""
        device_in = self._assemble(entry.device_per_object, fmt, vocab, c_bucket, cluster_dev)
        return device_in, self._per_object_fields(fmt), self._key_max(entry.inputs, fmt)

    def _gather_group(self, survivor_in, fmt: str, seg: list, g: int):
        """(row index, gathered inputs) of one survivor group of ``g``
        rows; padding repeats the group's first row (rows are
        independent, and only the first len(seg) are read)."""
        device_in, per_object, _key_max = survivor_in
        idx = np.full(g, seg[0], np.int64)
        idx[: len(seg)] = seg
        gidx = self._index(idx)
        sub = device_in._replace(
            **{name: getattr(device_in, name).index_select(0, gidx) for name in per_object}
        )
        return gidx, sub

    def _run_group(self, survivor_in, fmt: str, sub, fn, rows: tuple, whole: tuple = ()):
        """``fn(expanded group inputs, *rows, *whole)`` over a gathered
        survivor group; under a mesh each objects shard expands and
        solves G/N of its rows (the JAX engine's row-sharded groups):
        a whole-row program (kind 4) under a clusters axis."""
        key_max = survivor_in[2]

        def run(piece, *rest):
            return fn(expand_compact(piece, key_max) if fmt == "compact" else piece, *rest)

        return self._whole(run, (sub,) + rows, whole, cols=sub.cluster_valid.shape[0])

    def _survivor_job(self, pi: int, entry, seg, out, cert, pack_k: int, kind: str,
                      program: str) -> dict:
        """A queued survivor group for _drain_drift_resolve: its outputs'
        wire packed at ``pack_k``, in one ledger record under
        ``program`` with the solve (the JAX programs fuse the pack)."""
        wire = self._pack(_planes(out), pack_k)
        self._observe(program, (out, cert, wire))
        return {"pi": pi, "entry": entry, "rows": seg, "out": out, "cert": cert,
                "wire": wire, "pack_k": pack_k, "kind": kind}

    def _survivor_ready(self, entry) -> bool:
        """Whether a gated chunk's stored planes can feed a survivor
        program (the packed wire only)."""
        return (
            self.fetch_format == "packed"
            and entry.prev_reasons is not None
            and entry.device_per_object is not None
            and entry.prev_feas is not None
            and entry.prev_reasons.shape == entry.prev_feas.shape
        )

    def _dispatch_drift_survivors(
        self, pi: int, entry, fmt: str, rows: set, cluster_dev, vocab, c_bucket: int,
    ) -> list[dict]:
        """Queue the unified survivor program over a gated chunk's rows,
        in _survivor_groups: each group's device inputs and stored reason
        rows are gathered, expanded and solved by ``drift_survivor``, and
        the wire packed at K = min(M, C).  [] when the chunk cannot take
        the path; certificate failures stay in the recompute set."""
        if not self._survivor_ready(entry):
            return []
        m = self._narrow_m(entry.inputs, c_bucket)
        if m is None or not rows:
            return []
        rows = sorted(rows)
        pack_k = min(m, c_bucket)
        survivor_in = self._survivor_inputs(entry, fmt, vocab, c_bucket, cluster_dev)
        self.survivor_stats["rows"] += len(rows)
        jobs = []
        for seg, g in self._survivor_groups(rows):
            gidx, sub = self._gather_group(survivor_in, fmt, seg, g)
            out, cert = self._run_group(
                survivor_in, fmt, sub,
                lambda inp, reasons: drift_survivor(inp, reasons, m, i32_keys=self.phase1_i32),
                (entry.prev_reasons.index_select(0, gidx),),
            )
            self.survivor_stats["groups"] += 1
            self.survivor_stats["padded_rows"] += g
            self.dispatches_total += 1
            jobs.append(
                self._survivor_job(pi, entry, seg, out, cert, pack_k, "unified", "survivor")
            )
        return jobs

    def _dispatch_drift_resolve(
        self, pi: int, entry, fmt: str, gate: dict, mask: np.ndarray, rec: set,
        forced: set, cluster_dev, vocab, c_bucket: int,
    ) -> list[dict]:
        """The three-stream revert's sort-free resolve over a gated
        chunk's recompute rows without a fit flip, from the refreshed
        score plane: [] when ``drift_resolve`` is off, the chunk cannot
        take it (dense fetch, f16 scores, more than
        DRIFT_REFINE_MAX_COLS delta slots, no narrow M) or has no such
        row.  Each group's wire is packed at K = min(M, C)."""
        if not self.drift_resolve or self.score_f16 or not self._survivor_ready(entry):
            return []
        delta = gate["delta"]
        if delta[4].shape[0] > DRIFT_REFINE_MAX_COLS:
            return []
        m = self._narrow_m(entry.inputs, c_bucket)
        if m is None:
            return []
        fitflip = set(np.nonzero(mask & DRIFT_FITFLIP)[0].tolist())
        rows = sorted(rec - fitflip - forced)
        if not rows:
            return []
        pack_k = min(m, c_bucket)
        survivor_in = self._survivor_inputs(entry, fmt, vocab, c_bucket, cluster_dev)
        jobs = []
        for seg, g in self._survivor_groups(rows):
            gidx, sub = self._gather_group(survivor_in, fmt, seg, g)
            self.dispatches_total += 1
            out, cert = self._run_group(
                survivor_in, fmt, sub,
                lambda inp, feas, sco, rsn, *d: drift_resolve(inp, feas, sco, rsn, *d, m),
                (
                    entry.prev_feas.index_select(0, gidx),
                    entry.prev_out[3].index_select(0, gidx),
                    entry.prev_reasons.index_select(0, gidx),
                ),
                delta[:6],
            )
            jobs.append(self._survivor_job(pi, entry, seg, out, cert, pack_k, "resolve", "resolve"))
        return jobs

    def _dispatch_drift_replans(
        self, pi: int, entry, fmt: str, mask: np.ndarray, rec: set, forced: set,
        cluster_dev, vocab, c_bucket: int,
    ) -> list[dict]:
        """The three-stream revert's fit-flip survivors of a gated chunk:
        kinf rows (maxClusters unlimited or negative) through the
        selection-known ``drift_replan``, finite-K rows through the
        score-only solve (``drift_survivor``), in _survivor_groups.  []
        when ``replan`` is off, the chunk cannot take it (dense fetch,
        f16 scores, no narrow M) or has no such row."""
        if not self.replan or self.score_f16 or not self._survivor_ready(entry):
            return []
        m = self._narrow_m(entry.inputs, c_bucket)
        if m is None:
            return []
        fitflip = set(np.nonzero(mask & DRIFT_FITFLIP)[0].tolist())
        rows = sorted((rec & fitflip) - forced)
        if not rows:
            return []
        mc = np.asarray(entry.inputs.max_clusters)
        kinf_host = (mc == INT32_INF) | (mc < 0)
        pack_k = min(m, c_bucket)
        survivor_in = self._survivor_inputs(entry, fmt, vocab, c_bucket, cluster_dev)
        jobs = []
        for scored in (False, True):
            path_rows = [r for r in rows if bool(kinf_host[r]) != scored]
            for seg, g in self._survivor_groups(path_rows):
                gidx, sub = self._gather_group(survivor_in, fmt, seg, g)
                self.dispatches_total += 1
                reasons = entry.prev_reasons.index_select(0, gidx)
                if scored:
                    # JAX's drift_scoreonly: the unified survivor's solve.
                    out, cert = self._run_group(
                        survivor_in, fmt, sub,
                        lambda inp, r: drift_survivor(inp, r, m, i32_keys=self.phase1_i32),
                        (reasons,),
                    )
                else:
                    out, cert = self._run_group(
                        survivor_in, fmt, sub,
                        lambda inp, r, sco: drift_replan(inp, r, sco, m),
                        (reasons, entry.prev_out[3].index_select(0, gidx)),
                    )
                jobs.append(self._survivor_job(
                    pi, entry, seg, out, cert, pack_k,
                    *(("score_only", "scoreonly") if scored else ("replan", "replan")),
                ))
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
        recompute set.  Each job counts under its kind's drift_stats
        keys (unified, resolve, replan, score_only)."""
        t0 = time.perf_counter()
        certs = self._read_all([job["cert"] for job in jobs])
        wires = self._read_all([job["wire"] for job in jobs])
        timings["fetch"] += time.perf_counter() - t0
        for job, cert, wire in zip(jobs, certs, wires):
            t0 = time.perf_counter()
            entry, rows, out, k = job["entry"], job["rows"], job["out"], job["pack_k"]
            kind = job["kind"]
            nr = len(rows)
            ok_pos = np.nonzero(cert[:nr] != 0)[0]
            self.drift_stats[kind] += int(ok_pos.size)
            self.drift_stats[kind + "_fallback"] += int(nr - ok_pos.size)
            if kind == "unified":
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
            self._record_packed(entry, res_rows, results, packed, view, f"{entry.fmt}:{kind}")
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
        chunk's stored score plane at the changed columns (under
        score_f16 the refreshed plane is compressed again, its inexact
        rows forced into the recompute set first), queues the weight
        checks (fixed 256/128/64-row groups) and the survivor program
        over the recompute rows (the three-stream revert: resolve, then
        replan and score-only).  Then the survivors and weight checks
        are read; with the unified stream, weight-changed rows, 256 or
        fewer a chunk, take a second survivor wave.  Each chunk then
        skips, keeps the resolved rows (delta), sends its remaining rows
        to the sub-batch slabs, or, when more than half its rows move,
        takes the full dispatch."""
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
            # Rows whose stored planes or device inputs could not be
            # brought up to date are gate-blind: recompute them.  So are
            # rows whose f16 scores are lossy (read before the refreshed
            # plane replaces their exactness vector).
            forced = set()
            if self.score_f16:
                forced.update(int(r) for r in self._sco_inexact_rows(entry) if r < n)
            # Skipped rows keep exact stored totals; recomputed rows are
            # overwritten by their write-back after this.
            self._write_cols(gate["scores"], gate["cols"], gate["new_cols"])
            if self.score_f16:
                entry.prev_out = entry.prev_out[:3] + (
                    self._compress_scores(entry, gate["scores"], and_old=True),
                )
            rec = set(np.nonzero(mask & DRIFT_RECOMPUTE)[0].tolist())
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
                    # The group's stored feasibility rows, gathered from
                    # the lanes that own them; each lane checks its share
                    # (kind 4: the weight check reads whole rows).
                    flags = self._whole(
                        lambda feas, *cpu: drift_wcheck(
                            feas, torch.arange(feas.shape[0], device=feas.device), *cpu
                        ),
                        (entry.prev_feas.index_select(0, self._index(ridx)),),
                        (
                            oldc["cpu_alloc"], oldc["cpu_avail"],
                            newc["cpu_alloc"], newc["cpu_avail"],
                        ),
                    )
                    self._observe("wcheck", flags)
                    wcheck_jobs.append((pi, np.asarray(seg), flags))
            if self.survivor_unified:
                jobs.extend(
                    self._dispatch_drift_survivors(
                        pi, entry, fmt, rec - forced, newc, vocab, c_bucket
                    )
                )
            else:
                jobs.extend(
                    self._dispatch_drift_resolve(
                        pi, entry, fmt, gate, mask, rec, forced, newc, vocab, c_bucket
                    )
                )
                jobs.extend(
                    self._dispatch_drift_replans(
                        pi, entry, fmt, mask, rec, forced, newc, vocab, c_bucket
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
            # Weight-changed rows (kinf, no fit flip) take the unified
            # survivor program when a chunk has one group's worth; a
            # larger set fills a slab better.
            t1 = time.perf_counter()
            wave2: list[dict] = []
            for pi, rows_c in changed_by_pi.items():
                if not self.survivor_unified or len(rows_c) > 256:
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
                and not (self.score_f16 and entry.prev_has_scores)
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
        # Kind 4 under a clusters axis: the dense re-solve reads whole rows.
        fb = self._whole(
            lambda piece: schedule_tick(expand_compact(piece) if fmt == "compact" else piece),
            (sub,), cols=sub.cluster_valid.shape[0],
        )
        self._observe("narrow_fallback", fb)
        for name in ("selected", "replicas", "counted", "reasons"):
            getattr(out, name)[idx] = getattr(fb, name)
        self._observe("repair", out.reasons)
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
        rec_dense = []  # per slab (dense format): its reason and score rows
        for n, out in slabs:
            t2 = time.perf_counter()
            if self.fetch_format == "dense":
                # The slab's rows as int32 planes, pow2-bucketed rows.
                n_planes = 5 if rec is not None else (4 if want_scores else 3)
                gidx = np.zeros(_pow2_bucket(n, 16, 1 << 30), np.int64)
                gidx[:n] = np.arange(n)
                dev = self._gather_planes(out, n_planes, self._index(gidx))
                self._observe("gather", dev)
                arr = self._read_np(dev)[:n]
                c_pad = arr.shape[1] // n_planes
                sco = arr[:, 3 * c_pad : 4 * c_pad] if n_planes >= 4 else None
                if n_planes == 5:
                    rec_dense.append((arr[:, 4 * c_pad :], sco))
                t3 = time.perf_counter()
                timings["fetch"] += t3 - t2
                decoded.extend(self._decode_rows(
                    arr[:, :c_pad], arr[:, c_pad : 2 * c_pad], arr[:, 2 * c_pad : 3 * c_pad],
                    view.names, sco if want_scores else None,
                ))
                timings["decode"] += time.perf_counter() - t3
                continue
            planes = (out.selected, out.replicas, out.counted, out.scores, out.reasons)
            wire = self._pack(tuple(p[:n] for p in planes), pack_k)
            self._observe("pack", wire)
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
        nsel_all = np.concatenate(nsel_all) if nsel_all else None
        if rec_dense:
            rec_reasons = np.concatenate([p[0] for p in rec_dense])
            rec_scores = np.concatenate([p[1] for p in rec_dense])
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
            if rec_dense:
                self._record_decisions(
                    entry, changed_rows, decoded[span], rec_reasons[span],
                    rec_scores[span], view, f"{fmt}:sub",
                )
            if nsel_all is not None:
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
                    pad = (0, width - p[name].shape[1])
                    if pad[1]:
                        p[name] = self._on_rows(
                            lambda t, pad=pad, fill=int(fill): torch.nn.functional.pad(
                                t, pad, value=fill
                            ),
                            (p[name],),
                        )
        # Under a mesh the chunks' gathered holders end to end: the
        # slabs' row gathers take them from the lanes that hold them.
        return {name: cat_rows([p[name] for p in pieces]) for name in names}

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
        the entry's six prev planes in place (fresh scores cast into an
        f16 plane, their rows' exactness reset from the round trip), and
        their feasible counts into prev_nfeas."""
        nfeas = self._ensure_nfeas(entry)
        planes = entry.prev_out + (entry.prev_feas, entry.prev_reasons)
        out_planes = (
            out.selected, out.replicas, out.counted, out.scores,
            out.feasible, out.reasons,
        )
        for plane, out_plane in zip(planes, out_planes):
            plane.index_copy_(0, dst, out_plane.index_select(0, src).to(plane.dtype))
        nfeas.index_copy_(0, dst, self._feasible_counts(out.feasible.index_select(0, src)))
        if self.score_f16:
            exact = self._ensure_sco_exact_vec(entry)
            scores = out.scores.index_select(0, src)
            exact.index_copy_(0, dst, self._reduce_rows(exact_rows, (scores,), "all"))
            entry.sco_inexact_host = None
        self._observe("repair", nfeas)

    def _store_prev(self, entry, out) -> None:
        """Adopt a dispatch's six output planes as the entry's prev state,
        with their feasible counts; under score_f16 the score plane is
        stored compressed, with its exactness vector."""
        sco = self._compress_scores(entry, out.scores) if self.score_f16 else out.scores
        entry.prev_out = (out.selected, out.replicas, out.counted, sco)
        entry.prev_feas = out.feasible
        entry.prev_reasons = out.reasons
        self._store_nfeas(entry, out.feasible)
        entry.stale_out_rows = None

    # -- f16 score planes ----------------------------------------------------
    def _compress_scores(self, entry, scores, and_old: bool = False) -> torch.Tensor:
        """Store an i32 score plane's exactness vector on the entry and
        return the plane as f16; ``and_old`` ANDs the entry's previous
        vector in (a gate refresh writes through the stored plane)."""
        self.dispatches_total += 1
        old = entry.prev_sco_exact if and_old else None
        f16 = self._map_cells(lambda s: s.to(torch.float16), (scores,))
        # ``ops.pipeline.compress_scores``, its per-row exactness AND-ed
        # over the blocks under a clusters axis.
        exact = self._reduce_rows(exact_rows, (scores,), "all")
        if old is not None:
            exact = self._on_rows(torch.mul, (exact, old))
        self._observe("score_pack", (f16, exact))
        entry.prev_sco_exact = exact
        entry.sco_inexact_host = None
        return f16

    def _upcast_scores(self, f16) -> torch.Tensor:
        """A stored f16 score plane as i32 (exact rows bit for bit)."""
        self.dispatches_total += 1
        up = self._map_cells(upcast_scores, (f16,))
        self._observe("score_pack", up)
        return up

    def _prev_for_diff(self, entry) -> tuple:
        """The prev planes in the dtypes the diff compares: an f16 score
        plane upcast (inexact rows then flag as score-changed, which only
        a decode carrying scores reads, and such a chunk fetches whole)."""
        prev = entry.prev_out
        if prev[3].dtype != torch.float16:
            return prev
        return prev[:3] + (self._upcast_scores(prev[3]),)

    def _sco_inexact_rows(self, entry) -> np.ndarray:
        """The rows whose stored f16 scores are lossy (a read of the
        exactness vector, cached until it changes); no vector: every
        row."""
        if entry.sco_inexact_host is None:
            if entry.prev_sco_exact is None:
                b = entry.prev_out[0].shape[0] if entry.prev_out is not None else 0
                rows = np.arange(b, dtype=np.int64)
            else:
                rows = np.nonzero(self._read_np(entry.prev_sco_exact) == 0)[0].astype(np.int64)
            entry.sco_inexact_host = rows
        return entry.sco_inexact_host

    def _ensure_sco_exact_vec(self, entry) -> torch.Tensor:
        """The entry's exactness vector for a row repair; a missing one
        starts all-zero (every row inexact: extra recomputes only)."""
        b_pad = entry.prev_out[0].shape[0]
        vec = entry.prev_sco_exact
        if vec is None or tuple(vec.shape) != (b_pad,):
            if isinstance(entry.prev_out[0], (RowShards, GridShards)):
                vec = RowShards.zeros(entry.prev_out[0], torch.int8)
            else:
                vec = torch.zeros(b_pad, dtype=torch.int8, device=self.device)
            entry.prev_sco_exact = vec
            entry.sco_inexact_host = None
        return vec

    def _feasible_counts(self, feas):
        """``_feasible_counts`` of a feasibility plane; under a clusters
        axis each block's counts summed on (i, 0) (kinds 1 and 2)."""
        return self._reduce_rows(_feasible_counts, (feas,), "sum")

    def _store_nfeas(self, entry, feas) -> None:
        """The per-row feasible counts kept beside a stored prev_feas."""
        entry.prev_nfeas = self._feasible_counts(feas)

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
            planes = (out.selected, out.counted, out.replicas)
            if with_scores:
                planes += (out.scores,)
            # Kind 4 under a clusters axis: the overflow rows' dense
            # re-fetch reads whole rows.
            gathers.append(
                self._whole(_overflow_words, tuple(p.index_select(0, idx) for p in planes))
            )
            self._observe("overflow", gathers[-1])
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
