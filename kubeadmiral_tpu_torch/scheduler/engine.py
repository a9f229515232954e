"""The scheduling engine: batch in, placements out (cold ticks).

Torch counterpart of the cold path of ``kubeadmiral_tpu/scheduler/
engine.py``: take every pending SchedulingUnit, featurize against the
member clusters (compact form, with the dense featurizer as the fallback
when a vocabulary overflows a cap), solve on the device chunk by chunk
over the object axis (padded to the same row and cluster buckets as the
JAX engine, so a padded chunk is the same problem), pull each chunk's
placements off the device as the packed wire, and decode them into
``ScheduleResult``s.

On a cluster bucket wider than the candidate width M the chunk runs the
narrow solve (``ops.pipeline.schedule_tick_narrow``); rows that fail its
certificate are re-solved by the dense tick and written back before the
pack.  Narrower buckets run the dense tick.  Rows selecting more
clusters than the wire's K slots are re-fetched as bit-packed masks plus
the replica plane.

Every tick is cold: no chunk cache, delta fetch, drift path or snapshot
— each call featurizes and solves every row.  The device is ``"cuda"``
unless the caller asks for the CPU; without CUDA the default raises
instead of carrying on on the CPU.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Optional, Sequence

import numpy as np
import torch

from kubeadmiral_tpu_torch.convert import tensor
from kubeadmiral_tpu_torch.models import types as T
from kubeadmiral_tpu_torch.ops.pipeline import (
    NIL_REPLICAS,
    TickInputs,
    expand_compact,
    pack_wire,
    schedule_tick,
    schedule_tick_narrow,
    unpack_wire,
)
from kubeadmiral_tpu_torch.ops.planner import INT32_INF
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
    ``scores`` (post-normalize totals of the selected clusters) stays
    empty: score decoding is not ported yet."""

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


def _pad_cluster_axis(arr, c_pad: int, fill):
    arr = np.asarray(arr)
    extra = c_pad - arr.shape[0]
    if extra <= 0:
        return arr
    return np.concatenate([arr, np.full((extra,) + arr.shape[1:], fill, arr.dtype)])


class SchedulerEngine:
    """Chunked, shape-bucketed engine around ops.pipeline's narrow and
    dense ticks.

    ``device`` defaults to ``"cuda"`` (phase 1 then runs as the
    hand-written kernel); pass ``device="cpu"`` for the plain torch path.
    The chunk geometry, candidate width and wire width are the JAX
    engine's defaults (module constants above): 4096-row chunks, a
    4096 x 5120 cell budget, M >= 128 and K >= 16."""

    def __init__(self, device="cuda"):
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                "SchedulerEngine: CUDA is not available; pass device='cpu' "
                "to run on the CPU"
            )
        # Device copy of the current padded vocabulary tables.
        self._device_tables: Optional[tuple] = None
        # Per-stage wall seconds of the last schedule() call: featurize
        # (host encoding + padding), device (upload + tick, synchronised),
        # narrow_fallback (dense re-solve of uncertified rows and their
        # write-back, synchronised), fetch (certificate read, pack and
        # device->host copies), overflow_fetch (the K-overflow re-fetch,
        # inside fetch), decode (ScheduleResult construction).
        self.timings: dict[str, float] = {}
        # Rows certified by the narrow solve ("rows") and rows re-solved
        # dense ("fallback"); narrow_last_m is the latest chunk's M.
        self.narrow_stats = {"rows": 0, "fallback": 0}
        self.narrow_last_m = 0
        # Cumulative device->host result bytes, and rows whose selected
        # set overflowed the wire's K slots and were re-fetched.
        self.fetch_bytes_total = 0
        self.overflow_rows_total = 0

    # -- shape policy ----------------------------------------------------
    def _tick_geometry(self, n_clusters: int) -> tuple[int, int, Optional[list]]:
        """(c_bucket, eff_chunk, row ladder or None): cell-budget
        chunking, with wide cluster axes bucketing rows to a 3-rung
        ladder."""
        c_bucket = _cluster_bucket(n_clusters, MIN_CLUSTER_BUCKET)
        max_rows = max(
            MIN_ROW_BUCKET, min(MEGACHUNK_ROWS, CELL_BUDGET // max(1, c_bucket))
        )
        eff_chunk = 1 << (max_rows.bit_length() - 1)
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
    def _pack_k(inputs, c_bucket: int) -> int:
        """The chunk's wire slot count K: pow2 over the finite maxClusters
        bound, floored at PACK_K_MIN, capped at the cluster bucket (K = C
        is lossless).  Rows selecting more than K clusters overflow and
        are re-fetched, so K tunes bytes, never correctness."""
        k = _pow2_bucket(
            max(_finite_bound(inputs.max_clusters), PACK_K_MIN), 8, 1 << 30
        )
        return min(k, c_bucket)

    # -- featurization ---------------------------------------------------
    def _vocab_for(self, view: ClusterView) -> Optional[CompactVocab]:
        """A fresh compact vocabulary for this tick's topology; None when
        the topology itself overflows a cap (dense fallback)."""
        try:
            return CompactVocab(view)
        except VocabOverflow:
            return None

    def _featurize_full(self, chunk, clusters, view, vocab):
        """(inputs, fmt): compact unless the vocabulary overflows."""
        if vocab is not None:
            try:
                return featurize_compact(chunk, view, vocab), "compact"
            except VocabOverflow:
                pass
        return featurize(chunk, clusters, view=view).inputs, "dense"

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
        """The padded cluster-axis tensors, uploaded once per tick."""
        c = len(view.names)
        host = {
            "alloc": _pad_cluster_axis(view.alloc, c_bucket, 0),
            "used": _pad_cluster_axis(view.used, c_bucket, 0),
            "cpu_alloc": _pad_cluster_axis(view.cpu_alloc, c_bucket, 0),
            "cpu_avail": _pad_cluster_axis(view.cpu_avail, c_bucket, 0),
            "cluster_valid": _pad_cluster_axis(np.ones(c, bool), c_bucket, False),
        }
        return {k: tensor(v, self.device) for k, v in host.items()}

    def _tables_device(self, vocab: CompactVocab, c_bucket: int) -> dict:
        """Device copies of the vocabulary tables, re-uploaded only when
        the vocabulary grows or the cluster padding changes."""
        key = (vocab.uid, vocab.version, c_bucket)
        if self._device_tables is None or self._device_tables[0] != key:
            tables = Cmp.pad_tables(vocab.tables(), c_bucket)
            dev = {k: tensor(v, self.device) for k, v in tables.items()}
            self._device_tables = (key, dev)
        return self._device_tables[1]

    def _device_inputs(self, padded, fmt, vocab, c_bucket, cluster_dev):
        if fmt == "dense":
            per_object = {
                name: tensor(getattr(padded, name), self.device)
                for name in TickInputs._fields
                if name not in _CLUSTER_ONLY_FIELDS
            }
            return TickInputs(**per_object, **cluster_dev)
        per_object = {
            name: tensor(getattr(padded, name), self.device)
            for name in Cmp.PER_OBJECT_FIELDS
        }
        return CompactInputs(
            **per_object, **self._tables_device(vocab, c_bucket), **cluster_dev
        )

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _read_np(self, t: torch.Tensor) -> np.ndarray:
        """Blocking device->host copy, counted in fetch_bytes_total."""
        arr = t.cpu().numpy()
        self.fetch_bytes_total += arr.nbytes
        return arr

    # -- the tick ----------------------------------------------------------
    def schedule(
        self,
        units: Sequence[T.SchedulingUnit],
        clusters: Sequence[T.ClusterState],
    ) -> list[ScheduleResult]:
        """Schedule every unit against the clusters: one cold tick."""
        units = list(units)
        if not units:
            return []
        timings = dict.fromkeys(
            ("featurize", "device", "narrow_fallback", "fetch", "overflow_fetch",
             "decode"),
            0.0,
        )
        self.timings = timings
        view = _build_cluster_view(clusters, units)
        c_bucket, eff_chunk, ladder = self._tick_geometry(len(view.clusters))
        multi_chunk = len(units) > eff_chunk
        vocab = self._vocab_for(view)
        cluster_dev = self._cluster_planes_device(view, c_bucket)
        results: list[ScheduleResult] = []
        for start in range(0, len(units), eff_chunk):
            chunk = units[start : start + eff_chunk]
            n = len(chunk)
            t0 = time.perf_counter()
            inputs, fmt = self._featurize_full(chunk, clusters, view, vocab)
            b_pad = self._bucket_rows(n, ladder, eff_chunk, multi_chunk)
            padded = self._pad_for_dispatch(inputs, fmt, b_pad, c_bucket)
            m = self._narrow_m(inputs, c_bucket)
            k = self._pack_k(inputs, c_bucket)
            t1 = time.perf_counter()
            timings["featurize"] += t1 - t0
            device_in = self._device_inputs(padded, fmt, vocab, c_bucket, cluster_dev)
            tick_in = expand_compact(device_in) if fmt == "compact" else device_in
            if m is None:
                out = schedule_tick(tick_in)
            else:
                self.narrow_last_m = m
                out, cert = schedule_tick_narrow(tick_in, m)
            del tick_in
            self._sync()
            timings["device"] += time.perf_counter() - t1
            if m is not None:
                t2 = time.perf_counter()
                cert_np = self._read_np(cert)
                timings["fetch"] += time.perf_counter() - t2
                out = self._apply_cert_fallback(out, cert_np, device_in, fmt, n, timings)
            results.extend(self._fetch_decode_packed(out, n, k, view.names, timings))
        return results

    # -- narrow certificate fallback ---------------------------------------
    @staticmethod
    def _per_object_fields(fmt: str) -> tuple:
        if fmt == "compact":
            return Cmp.PER_OBJECT_FIELDS
        return tuple(f for f in TickInputs._fields if f not in _CLUSTER_ONLY_FIELDS)

    def _apply_cert_fallback(self, out, cert_np, device_in, fmt: str, n: int, timings):
        """Resolve one narrow chunk's certificate: certified rows stand
        (bit-identical to the dense tick by the certificate's proof);
        uncertified rows are gathered from the chunk's device inputs,
        expanded, re-solved by the dense tick and written back into the
        selected/replicas/counted/reasons planes before the pack reads
        them (scores and feasibility come from the shared phase 1 and
        are exact already)."""
        rows = np.nonzero(cert_np[:n] == 0)[0]
        self.narrow_stats["rows"] += int(n - rows.size)
        if rows.size == 0:
            return out
        t0 = time.perf_counter()
        self.narrow_stats["fallback"] += int(rows.size)
        idx = torch.from_numpy(rows).to(self.device)
        sub = device_in._replace(
            **{name: getattr(device_in, name)[idx] for name in self._per_object_fields(fmt)}
        )
        fb = schedule_tick(expand_compact(sub) if fmt == "compact" else sub)
        for name in ("selected", "replicas", "counted", "reasons"):
            getattr(out, name)[idx] = getattr(fb, name)
        self._sync()
        timings["narrow_fallback"] += time.perf_counter() - t0
        return out

    # -- packed fetch and decode -------------------------------------------
    def _fetch_decode_packed(self, out, n: int, k: int, names, timings):
        """Pull one chunk's first n rows off the device as the packed wire
        (one i32[n, 4K+2+NR] copy), re-fetch the K-overflow rows, and
        decode both."""
        t0 = time.perf_counter()
        planes = (out.selected, out.replicas, out.counted, out.scores, out.reasons)
        wire = self._read_np(pack_wire(*(p[:n] for p in planes), k))
        packed = unpack_wire(wire, k)
        over_pos = np.nonzero(packed.nsel > k)[0]
        over_dense = self._fetch_overflow(out, over_pos, timings) if over_pos.size else None
        t1 = time.perf_counter()
        timings["fetch"] += t1 - t0
        results = self._decode_packed_mixed(packed, over_pos, over_dense, names)
        timings["decode"] += time.perf_counter() - t1
        return results

    def _fetch_overflow(self, out, rows: np.ndarray, timings):
        """Re-fetch of K-overflow rows (the packed wire's escape hatch):
        bit-packed selection/counted masks plus the replica plane in one
        copy, timed as the ``overflow_fetch`` part of the fetch stage."""
        t0 = time.perf_counter()
        idx = torch.from_numpy(rows).to(self.device)
        arr = self._read_np(_gather_overflow3(out.selected, out.counted, out.replicas, idx))
        timings["overflow_fetch"] += time.perf_counter() - t0
        return arr, out.selected.shape[1]

    @staticmethod
    def _split_overflow(arr: np.ndarray, c_pad: int):
        """One overflow read -> (selected, replicas, counted) planes.
        Layout: [sel bits | cnt bits | rep] with ceil(C/32)-word masks."""
        nw = -(-c_pad // 32)
        sel = _unpack_bits(arr[:, :nw], c_pad)
        cnt = _unpack_bits(arr[:, nw : 2 * nw], c_pad)
        return sel, arr[:, 2 * nw : 2 * nw + c_pad], cnt

    def _decode_packed_mixed(self, packed, over_pos, over_dense, names):
        """Decode a packed fetch: packable rows from the wire slots,
        K-overflow rows from their re-fetched planes."""
        results = self._decode_packed_rows(packed, names)
        if over_pos.size:
            self.overflow_rows_total += int(over_pos.size)
            sel, rep, cnt = self._split_overflow(*over_dense)
            for p, r in zip(over_pos.tolist(), self._decode_rows(sel, rep, cnt, names)):
                results[p] = r
        return results

    @staticmethod
    def _build_results(n_rows, rows, cols, replicas_at, counted_at, names):
        """Shared decode tail: (row, col) placement pairs, sorted by row,
        -> frozen ScheduleResults, one dict(zip(...)) per row.  ``*_at``
        are the values already gathered at the pairs."""
        bounds = np.searchsorted(rows, np.arange(n_rows + 1))
        reps_obj = replicas_at.astype(object)
        reps_obj[counted_at == 0] = DUPLICATE
        sel_names = np.asarray(names, dtype=object)[cols].tolist()
        reps_list = reps_obj.tolist()
        return [
            ScheduleResult(
                clusters=_FrozenDict(zip(sel_names[s:e], reps_list[s:e]))
            )
            for s, e in zip(bounds[:-1], bounds[1:])
        ]

    @classmethod
    def _decode_rows(cls, selected, replicas, counted, names) -> list[ScheduleResult]:
        """Vectorized decode of dense [n, C] planes."""
        rows, cols = np.nonzero(selected)
        return cls._build_results(
            selected.shape[0], rows, cols, replicas[rows, cols], counted[rows, cols], names
        )

    @classmethod
    def _decode_packed_rows(cls, packed, names) -> list[ScheduleResult]:
        """Decode packed [n, K] rows (slots score-ordered, PACK_FILL
        padded).  Dict content equals the dense decode; insertion order
        is score order, which no consumer observes.  Overflow rows
        (nsel > K) decode truncated here and are replaced by the caller."""
        idx = packed.idx
        rows, slots = np.nonzero(idx >= 0)
        return cls._build_results(
            idx.shape[0], rows, idx[rows, slots],
            packed.rep[rows, slots], packed.cnt[rows, slots], names,
        )
