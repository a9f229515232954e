"""Device mesh and row sharding for the scheduling tick.

Torch counterpart of ``kubeadmiral_tpu/parallel/mesh.py``.  A ``Mesh``
is a 2-D grid of ``torch.device`` entries over ``(objects, clusters)``,
built by ``make_mesh`` with the JAX module's default layout: every
device on the objects axis.  A mesh may list one device several times:
each entry is then a logical device with a CUDA stream of its own (on
the CPU it runs in turn), which is how one card or the CPU holds the
logic of N devices.

The tick is row-independent, so the objects axis splits a batch's rows:
``run_rows`` runs a row-wise program on each objects shard's rows, on
its own device and stream.  The field tables ``_FIELD_SPECS`` and
``_COMPACT_FIELD_SPECS`` (the JAX module's) say which inputs split by
rows (``OBJECTS`` first) and which every shard takes whole (the cluster
tables): ``run_rows`` is the counterpart of the JAX module's
``shard_inputs`` and its rows / replicated shardings.

State stays on its shards: a ``RowShards`` holds one ``[B, ...]``
tensor as a piece per objects shard ("lane": mesh entry ``(i, 0)``)
with its row range.  ``run_rows`` takes holders in place and returns
its outputs as holders; a ``RowIndex`` (global rows, on the host)
routes ``index_select`` and ``index_copy_`` to the lanes that own the
rows; the host read copies each lane's piece to the host and
concatenates there.  No output is joined on one device.

Streams: each lane's stream first waits for its device's current stream
(``on_lane``), and when ``run_rows`` returns every lane device's current
stream waits for the lane's stream, so work queued outside ``run_rows``
(a holder's gathers, scatters and reads, on the current streams) is
ordered after the lanes' and before their next programs.

The clusters axis holds no work here.  JAX's GSPMD turns the per-row
normalize maxima, top-K and planner scans over a sharded cluster axis
into collectives, measured about 11x slower there, and the JAX engine
gives that axis devices only past 64 of them (``_resolve_mesh``).  The
port runs each program on whole rows on the first device of the
objects shard, so no sort or scan ever runs across devices, and the
other entries of a clusters-axis row stay idle.
"""

from __future__ import annotations

from contextlib import ExitStack
from typing import Callable, Optional, Sequence

import numpy as np
import torch

from kubeadmiral_tpu_torch.convert import tensor

OBJECTS = "objects"
CLUSTERS = "clusters"

# Axis layout per TickInputs field: which mesh axis each
# tensor dimension maps to (None = replicated dimension).
_FIELD_SPECS: dict[str, tuple[Optional[str], ...]] = {
    "filter_enabled": (OBJECTS, None),
    "api_ok": (OBJECTS, CLUSTERS),
    "taint_ok_new": (OBJECTS, CLUSTERS),
    "taint_ok_cur": (OBJECTS, CLUSTERS),
    "selector_ok": (OBJECTS, CLUSTERS),
    "placement_has": (OBJECTS,),
    "placement_ok": (OBJECTS, CLUSTERS),
    "request": (OBJECTS, None),
    "alloc": (CLUSTERS, None),
    "used": (CLUSTERS, None),
    "score_enabled": (OBJECTS, None),
    "taint_counts": (OBJECTS, CLUSTERS),
    "affinity_scores": (OBJECTS, CLUSTERS),
    "webhook_ok": (OBJECTS, CLUSTERS),
    "webhook_scores": (OBJECTS, CLUSTERS),
    "max_clusters": (OBJECTS,),
    "mode_divide": (OBJECTS,),
    "sticky": (OBJECTS,),
    "current_mask": (OBJECTS, CLUSTERS),
    "current_replicas": (OBJECTS, CLUSTERS),
    "total": (OBJECTS,),
    "weights_given": (OBJECTS,),
    "weights": (OBJECTS, CLUSTERS),
    "min_replicas": (OBJECTS, CLUSTERS),
    "max_replicas": (OBJECTS, CLUSTERS),
    "scale_max": (OBJECTS, CLUSTERS),
    "capacity": (OBJECTS, CLUSTERS),
    "keep_unschedulable": (OBJECTS,),
    "avoid_disruption": (OBJECTS,),
    "tiebreak": (OBJECTS, CLUSTERS),
    "cpu_alloc": (CLUSTERS,),
    "cpu_avail": (CLUSTERS,),
    "cluster_valid": (CLUSTERS,),
}

# Axis layout for the compact input format (scheduler/compact.py):
# per-object vectors shard over objects, vocabulary tables replicate
# their vocab axis and shard the cluster axis, taint tables replicate.
_COMPACT_FIELD_SPECS: dict[str, tuple[Optional[str], ...]] = {
    "gvk_id": (OBJECTS,),
    "tol_id": (OBJECTS,),
    "sel_id": (OBJECTS,),
    "pref_id": (OBJECTS,),
    "place_id": (OBJECTS,),
    "placement_has": (OBJECTS,),
    "filter_enabled": (OBJECTS, None),
    "score_enabled": (OBJECTS, None),
    "request": (OBJECTS, None),
    "max_clusters": (OBJECTS,),
    "mode_divide": (OBJECTS,),
    "sticky": (OBJECTS,),
    "total": (OBJECTS,),
    "weights_given": (OBJECTS,),
    "keep_unschedulable": (OBJECTS,),
    "avoid_disruption": (OBJECTS,),
    "sparse_idx": (OBJECTS, None),
    "sparse_min": (OBJECTS, None),
    "sparse_max": (OBJECTS, None),
    "sparse_weight": (OBJECTS, None),
    "sparse_capacity": (OBJECTS, None),
    "sparse_cur": (OBJECTS, None),
    "key_bytes": (OBJECTS, None),
    "key_len": (OBJECTS,),
    "api_matrix": (None, CLUSTERS),
    "taint_new": (None, None),
    "taint_cur": (None, None),
    "taint_prefer": (None, None),
    "sel_matrix": (None, CLUSTERS),
    "pref_matrix": (None, CLUSTERS),
    "place_matrix": (None, CLUSTERS),
    "taint_set_id": (CLUSTERS,),
    "name_hash_state": (CLUSTERS,),
    "alloc": (CLUSTERS, None),
    "used": (CLUSTERS, None),
    "cpu_alloc": (CLUSTERS,),
    "cpu_avail": (CLUSTERS,),
    "cluster_valid": (CLUSTERS,),
}


class Mesh:
    """An (objects, clusters) grid of ``torch.device`` entries.  Each
    entry on a CUDA device gets a stream of its own at first use
    (``stream``); CPU entries have none."""

    axis_names = (OBJECTS, CLUSTERS)

    def __init__(self, devices, objects_axis: int):
        devices = [torch.device(d) for d in devices]
        n = len(devices)
        if objects_axis < 1 or n < objects_axis:
            raise ValueError(f"objects_axis {objects_axis} over {n} devices")
        clusters_axis = n // objects_axis
        grid = np.empty((objects_axis, clusters_axis), dtype=object)
        for k, dev in enumerate(devices[: objects_axis * clusters_axis]):
            grid[k // clusters_axis, k % clusters_axis] = dev
        self.devices = grid
        self._streams: dict[tuple, torch.cuda.Stream] = {}

    @property
    def shape(self) -> tuple[int, int]:
        return tuple(int(d) for d in self.devices.shape)

    def stream(self, i: int, j: int = 0):
        """The CUDA stream of entry (i, j), or None on the CPU."""
        dev = self.devices[i, j]
        if dev.type != "cuda":
            return None
        s = self._streams.get((i, j))
        if s is None:
            s = self._streams[(i, j)] = torch.cuda.Stream(dev)
        return s


def make_mesh(
    devices: Optional[Sequence] = None, objects_axis: Optional[int] = None
) -> Mesh:
    """An (objects, clusters) mesh over the given devices (default: every
    visible CUDA device).  Default layout: every device on the objects
    axis; pass ``objects_axis`` to give the rest to the clusters axis."""
    if devices is None:
        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    devices = list(devices)
    if not devices:
        raise ValueError("make_mesh: no devices")
    if objects_axis is None:
        objects_axis = len(devices)
    return Mesh(devices, objects_axis)


def objects_axis_size(mesh: Optional[Mesh]) -> int:
    """Device count along the objects axis (1 for no mesh): the factor
    the engine's per-device budgets and window scale by."""
    if mesh is None:
        return 1
    return int(mesh.devices.shape[0])


# -- the row split ----------------------------------------------------------
def row_bounds(n: int, parts: int) -> list[tuple[int, int]]:
    """``parts`` contiguous row ranges over ``n`` rows, sizes differing
    by at most one (the first ranges take the remainder)."""
    base, extra = divmod(n, parts)
    out, lo = [], 0
    for i in range(parts):
        hi = lo + base + (1 if i < extra else 0)
        out.append((lo, hi))
        lo = hi
    return out


def on_lane(device: torch.device, stream) -> ExitStack:
    """A context running work on ``device``'s ``stream`` (nothing on the
    CPU), which first waits for the work queued on the device's current
    stream: the current device and stream of every launch inside."""
    stack = ExitStack()
    if stream is not None:
        stream.wait_stream(torch.cuda.current_stream(device))
        stack.enter_context(torch.cuda.device(device))
        stack.enter_context(torch.cuda.stream(stream))
    return stack


# -- row-sharded state -----------------------------------------------------
class RowIndex:
    """Global row indices kept on the host, so a holder routes them to
    the lanes that own the rows without reading anything back; the
    index on a device is built once per device (``on``)."""

    def __init__(self, rows):
        self.rows = np.ascontiguousarray(rows, dtype=np.int64).reshape(-1)
        self._on: dict = {}

    @property
    def shape(self) -> tuple:
        return self.rows.shape

    def on(self, device, lo: int = 0, hi: Optional[int] = None) -> torch.Tensor:
        """Positions [lo, hi) of the index as a tensor on ``device``."""
        hi = self.rows.size if hi is None else hi
        key = (str(device), lo, hi)
        t = self._on.get(key)
        if t is None:
            t = self._on[key] = tensor(self.rows[lo:hi], device)
        return t


def _owners(bounds: list, rows: np.ndarray) -> np.ndarray:
    """The piece of ``bounds`` each global row lies in."""
    if rows.size and (rows.min() < 0 or rows.max() >= bounds[-1][1]):
        raise IndexError(f"row index out of range [0, {bounds[-1][1]})")
    his = np.fromiter((hi for _lo, hi in bounds), np.int64, count=len(bounds))
    return np.searchsorted(his, rows, side="right")


def _take(pieces: list, bounds: list, rows: np.ndarray, device) -> torch.Tensor:
    """Global ``rows`` of pieces laid out by ``bounds``, in order, as one
    tensor on ``device``: each owning piece gathers its rows on its own
    device, and only the gathered rows move."""
    owner = _owners(bounds, rows)
    parts, order = [], []
    for j in np.unique(owner).tolist():
        pos = np.nonzero(owner == j)[0]
        local = rows[pos] - bounds[j][0]
        src = pieces[j]
        if local.size and local[-1] - local[0] + 1 == local.size and np.all(np.diff(local) == 1):
            got = src[int(local[0]) : int(local[-1]) + 1]
        else:
            got = src.index_select(0, tensor(local, src.device))
        parts.append(got.to(device, non_blocking=True))
        order.append(pos)
    if not parts:
        ref = pieces[0]
        return torch.empty((0,) + tuple(ref.shape[1:]), dtype=ref.dtype, device=device)
    out = parts[0] if len(parts) == 1 else torch.cat(parts)
    pos = np.concatenate(order)
    if np.any(np.diff(pos) < 0):
        inverse = np.empty_like(pos)
        inverse[pos] = np.arange(pos.size)
        out = out.index_select(0, tensor(inverse, device))
    return out


class RowShards:
    """One ``[B, ...]`` tensor held as one piece per lane of ``mesh``
    (piece i on ``mesh.devices[i, 0]``), piece i holding rows
    ``bounds[i]`` (contiguous, in order; a lane may hold none).  A
    concatenation of holders (``cat_rows``) has more pieces than lanes
    and serves only as a source of ``index_select``."""

    def __init__(self, mesh: "Mesh", pieces: list, bounds: list):
        self.mesh = mesh
        self.pieces = list(pieces)
        self.bounds = [tuple(b) for b in bounds]
        if self.bounds[0][0] != 0:
            raise ValueError("a holder's rows start at 0")

    # -- building ---------------------------------------------------------
    @classmethod
    def from_host(cls, mesh: "Mesh", arr) -> "RowShards":
        """A host array split by rows (``row_bounds``), one host-to-device
        copy per lane straight to its device, all from one host copy
        (pinned once for the card; see ``convert.tensor``)."""
        host = tensor(arr, "cpu")
        devices = [torch.device(d) for d in mesh.devices[:, 0]]
        if any(d.type == "cuda" for d in devices):
            host = host.pin_memory()
        bounds = row_bounds(host.shape[0], len(devices))
        return cls(
            mesh,
            [
                host[lo:hi].to(dev, non_blocking=True, copy=True)
                for dev, (lo, hi) in zip(devices, bounds)
            ],
            bounds,
        )

    @classmethod
    def zeros(cls, like: "RowShards", dtype) -> "RowShards":
        """A zero ``[B]`` vector laid out as ``like``'s rows."""
        return cls(
            like.mesh,
            [torch.zeros(p.shape[0], dtype=dtype, device=p.device) for p in like.pieces],
            like.bounds,
        )

    # -- tensor-like surface ------------------------------------------------
    @property
    def shape(self) -> torch.Size:
        ref = self.pieces[0]
        return torch.Size((self.bounds[-1][1] - self.bounds[0][0],) + tuple(ref.shape[1:]))

    @property
    def dtype(self) -> torch.dtype:
        return self.pieces[0].dtype

    @property
    def nbytes(self) -> int:
        return sum(p.nbytes for p in self.pieces)

    def __len__(self) -> int:
        return int(self.shape[0])

    def map(self, fn: Callable) -> "RowShards":
        """``fn`` on every piece (a row-wise function)."""
        return RowShards(self.mesh, [fn(p) for p in self.pieces], self.bounds)

    def to(self, dtype) -> "RowShards":
        return self.map(lambda p: p.to(dtype))

    def clone(self) -> "RowShards":
        return self.map(torch.clone)

    def __getitem__(self, key):
        if isinstance(key, RowIndex):
            return self.index_select(0, key)
        if not isinstance(key, slice) or key.step not in (None, 1):
            raise TypeError(f"RowShards takes a row slice or a RowIndex, not {key!r}")
        a, b, _ = key.indices(len(self))
        b = max(a, b)
        pieces, bounds = [], []
        for p, (lo, hi) in zip(self.pieces, self.bounds):
            s, e = min(max(lo, a), b), min(max(hi, a), b)
            pieces.append(p[s - lo : e - lo] if e > s else p[:0])
            bounds.append((s - a, max(s, e) - a))
        return RowShards(self.mesh, pieces, bounds)

    def __setitem__(self, key, src) -> None:
        if not isinstance(key, RowIndex):
            raise TypeError(f"RowShards assigns through a RowIndex, not {key!r}")
        self.index_copy_(0, key, src)

    def index_select(self, dim: int, idx: RowIndex) -> "RowShards":
        """Rows ``idx`` laid out as ``row_bounds(len(idx), N)``: each lane
        takes its share of the index from the lanes that own the rows."""
        if dim != 0:
            raise ValueError("RowShards selects rows only")
        rows = idx.rows
        bounds = row_bounds(rows.size, self.mesh.devices.shape[0])
        return RowShards(
            self.mesh,
            [
                _take(self.pieces, self.bounds, rows[lo:hi], self.mesh.devices[i, 0])
                for i, (lo, hi) in enumerate(bounds)
            ],
            bounds,
        )

    def index_copy_(self, dim: int, idx: RowIndex, src) -> "RowShards":
        """Write rows of ``src`` (a holder over the index's positions)
        into rows ``idx``: each lane takes the positions it owns from the
        lanes that hold them and copies them in place."""
        if dim != 0:
            raise ValueError("RowShards copies rows only")
        rows = idx.rows
        owner = _owners(self.bounds, rows)
        for j in np.unique(owner).tolist():
            pos = np.nonzero(owner == j)[0]
            piece = self.pieces[j]
            local = tensor(rows[pos] - self.bounds[j][0], piece.device)
            vals = _take(src.pieces, src.bounds, pos, piece.device)
            piece.index_copy_(0, local, vals.to(piece.dtype))
        return self

    # -- the host read -----------------------------------------------------
    def numpy(self) -> np.ndarray:
        """Each lane's piece copied to the host, concatenated there."""
        return np.concatenate([p.cpu().numpy() for p in self.pieces])

    def lane_labels(self) -> list[str]:
        """The label each piece's bytes book under: its device, or
        ``"<device>/<lane>"`` where several lanes share one device."""
        devs = [str(p.device) for p in self.pieces]
        shared = len(set(devs)) < len(devs)
        return [f"{d}/{i}" if shared else d for i, d in enumerate(devs)]


def cat_rows(parts: list):
    """Several row-wise values end to end: tensors concatenated; holders
    as one holder of all their pieces (a gather source)."""
    if not isinstance(parts[0], RowShards):
        return torch.cat(parts)
    pieces, bounds, off = [], [], 0
    for h in parts:
        for p, (lo, hi) in zip(h.pieces, h.bounds):
            pieces.append(p)
            bounds.append((lo + off, hi + off))
        off += len(h)
    return RowShards(parts[0].mesh, pieces, bounds)


def _holders(value, found: list) -> list:
    """Every RowShards inside a row argument (tensor, dict, NamedTuple)."""
    if isinstance(value, RowShards):
        found.append(value)
    elif isinstance(value, dict):
        for v in value.values():
            _holders(v, found)
    elif isinstance(value, tuple):
        for v in value:
            _holders(v, found)
    return found


# -- the engine's row-sharded programs ---------------------------------------
def _specs_of(value) -> Optional[dict]:
    fields = getattr(type(value), "_fields", None)
    if fields is None:
        return None
    if set(fields) <= set(_FIELD_SPECS):
        return _FIELD_SPECS
    return _COMPACT_FIELD_SPECS


def _place(t, device, stream):
    """``t`` on ``device`` for work on ``stream``: the allocator is told
    the stream reads it (``record_stream``), so its block is not reused
    before that work has run.  A RowIndex is placed as its tensor."""
    if isinstance(t, dict):
        return {k: _place(v, device, stream) for k, v in t.items()}
    if isinstance(t, RowIndex):
        return t.on(device)
    if not isinstance(t, torch.Tensor):
        return t
    if stream is not None and t.device.type == "cuda":
        t.record_stream(stream)
    return t.to(device, non_blocking=True)


def _rows_piece(value, i: int, lo: int, hi: int, device, stream):
    """Lane ``i``'s rows [lo, hi) of a row-sharded argument on its
    device: a holder's own piece (in place), a RowIndex's positions, a
    tensor's rows, a dict of them, or a TickInputs/CompactInputs (fields
    split by their table's spec, the rest placed whole); None stays."""
    if value is None:
        return None
    if isinstance(value, RowShards):
        return value.pieces[i]
    if isinstance(value, RowIndex):
        return value.on(device, lo, hi)
    if isinstance(value, torch.Tensor):
        return _place(value[lo:hi], device, stream)
    if isinstance(value, dict):
        return {k: _rows_piece(v, i, lo, hi, device, stream) for k, v in value.items()}
    specs = _specs_of(value)
    return type(value)(
        **{
            name: _rows_piece(v, i, lo, hi, device, stream)
            if specs.get(name, (None,))[:1] == (OBJECTS,)
            else _place(v, device, stream)
            for name, v in value._asdict().items()
        }
    )


def leading_rows(value) -> int:
    """Rows of a row-sharded argument: a tensor, a holder, a RowIndex, a
    dict of per-object tensors or a TickInputs/CompactInputs."""
    if isinstance(value, (torch.Tensor, RowShards, RowIndex)):
        return int(value.shape[0])
    if isinstance(value, dict):
        return leading_rows(next(iter(value.values())))
    specs = _specs_of(value)
    for name, v in value._asdict().items():
        if specs.get(name, (None,))[:1] == (OBJECTS,):
            return int(v.shape[0])
    raise ValueError("no row-sharded field")


def _keep(parts: list, mesh: Mesh, ranges: list):
    """Per-lane outputs of one structure as holders on ``ranges``
    (tensors; tuples and NamedTuples field by field; None stays; other
    values from the first lane).  A lane that ran nothing (None in
    ``parts``) gets an empty piece of the same trailing shape."""
    first = next((p for p in parts if p is not None), None)
    if first is None:
        return None
    if isinstance(first, torch.Tensor):
        pieces = [
            p if p is not None
            else torch.empty((0,) + tuple(first.shape[1:]), dtype=first.dtype,
                             device=mesh.devices[i, 0])
            for i, p in enumerate(parts)
        ]
        return RowShards(mesh, pieces, ranges)
    if isinstance(first, (tuple, list)):
        kept = [
            _keep([None if p is None else p[k] for p in parts], mesh, ranges)
            for k in range(len(first))
        ]
        if isinstance(first, list):
            return kept
        return type(first)(*kept) if hasattr(first, "_fields") else tuple(kept)
    return first


def run_rows(mesh: Mesh, fn: Callable, rows: tuple, whole: tuple = (),
             bounds: bool = False, **kw):
    """``fn(*row_pieces, *whole, **kw)`` on each objects shard of
    ``mesh``, on the first device of the shard's clusters axis and that
    entry's stream, over the shard's contiguous rows of every ``rows``
    argument; ``whole`` arguments go to every shard.  The shards' rows
    are the holders' (``RowShards`` arguments are taken in place, piece
    by piece, and must share their rows), else ``row_bounds``; a shard
    with no row runs nothing.  The outputs are returned as holders on
    those rows, and every lane device's current stream waits for the
    shards' streams.  With ``bounds`` the shard's row range (lo, hi)
    leads ``fn``'s arguments.  Nothing here waits on the host."""
    lead = next(a for a in rows if a is not None)
    held = [h for a in rows for h in _holders(a, [])]
    n = leading_rows(lead)
    ranges = held[0].bounds if held else row_bounds(n, mesh.devices.shape[0])
    for h in held:
        if h.bounds != ranges or len(h.pieces) != mesh.devices.shape[0]:
            raise ValueError(f"holders on other rows: {h.bounds} against {ranges}")
    parts, waits = [], []
    for i, (lo, hi) in enumerate(ranges):
        # A lane with no row runs nothing (on an empty batch, the first
        # lane runs once, so the output has its structure).
        if hi == lo and (n > 0 or i > 0):
            parts.append(None)
            continue
        dev, stream = mesh.devices[i, 0], mesh.stream(i, 0)
        with on_lane(dev, stream):
            pieces = [_rows_piece(a, i, lo, hi, dev, stream) for a in rows]
            rest = [_place(a, dev, stream) for a in whole]
            parts.append(fn(*((lo, hi) if bounds else ()), *pieces, *rest, **kw))
        if stream is not None:
            waits.append((dev, stream))
    for dev, stream in waits:
        torch.cuda.current_stream(dev).wait_stream(stream)
    return _keep(parts, mesh, ranges)
