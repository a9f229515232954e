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

The clusters axis splits the cluster columns, as the JAX module's grid
layout does (every ``[B, C]`` field ``P(OBJECTS, CLUSTERS)``).  Under a
mesh of shape (No, Nc) with Nc > 1, a ``GridShards`` holds a ``[B, C]``
plane as one piece per entry (i, j): objects shard i's rows, column
block ``col_bounds(C, Nc)[j]`` of the padded cluster axis, on
``devices[i, j]``.  The per-row ``[B, ...]`` inputs are held on every
entry of their row (``RowReplicas``), as the JAX module replicates them
over the clusters axis, so each block reads its own copy.  The ``[B]``
vectors of the state, which only kinds 2 and 4 read, stay ``RowShards``
on entry (i, 0).  Every program falls in one of four kinds, each with
its runner:

1. cell-local, per entry on its device and stream: ``run_grid`` (a
   ``GridShards`` argument gives the entry its own piece; a cluster
   table its column block; the outputs come back as ``Blocks``, one
   value per entry, and ``Blocks.grid()`` holds planes as a
   ``GridShards``);
2. per-row reductions and 3. per-row sorts and merges: each block's
   small ``[rows, k]`` partials go to entry (i, 0), where ``run_rows``
   hands a ``Blocks`` argument to the program as the list of the
   row's blocks in column order (``ops.pipeline``'s ``reduce_blocks``
   and ``merge_topk`` are the common combinations); the results are
   ``RowShards`` that a later ``run_grid`` sends back to the blocks;
4. whole-row programs: ``run_whole`` gathers the rows' columns on entry
   (i, 0) (``GridShards.lane``), runs the program there and splits its
   ``[rows, C]`` outputs back into the blocks (the JAX module's
   ``rows_only_sharding``).

No program of kinds 1-3 receives a whole ``[rows, C]`` plane.  With
Nc = 1 nothing here changes: ``run_rows`` runs each program on whole
rows of entry (i, 0), as before."""

from __future__ import annotations

import weakref
from contextlib import ExitStack
from typing import Callable, NamedTuple, Optional, Sequence

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
        # Each cluster table's column blocks on the entries' devices, by
        # the table's id, kept while the table lives (``column_block``).
        self._blocks: dict[int, dict] = {}

    @property
    def shape(self) -> tuple[int, int]:
        return tuple(int(d) for d in self.devices.shape)

    def column_block(self, t: torch.Tensor, axis: int, c0: int, c1: int, i: int, j: int):
        """Columns [c0, c1) of a cluster table ``t`` (along ``axis``) on
        entry (i, j)'s device: a view where the table lies there, else a
        copy made at first use and kept while the table lives, so that
        every entry holds its own block of the tables it reads."""
        block = t.narrow(axis, c0, c1 - c0)
        dev = self.devices[i, j]
        if t.device == dev:
            return block
        per_table = self._blocks.get(id(t))
        if per_table is None:
            per_table = self._blocks[id(t)] = {}
            weakref.finalize(t, self._blocks.pop, id(t), None)
        key = (axis, c0, c1, str(dev))
        got = per_table.get(key)
        if got is None:
            got = per_table[key] = block.to(dev, non_blocking=True).contiguous()
        return got

    def entry_label(self, i: int, j: int) -> str:
        """What entry (i, j)'s bytes book under on a mesh with a
        clusters axis: its device, or ``"<device>/<i>.<j>"`` where
        entries share one."""
        devs = [str(d) for d in self.devices.ravel()]
        dev = str(self.devices[i, j])
        return f"{dev}/{i}.{j}" if len(set(devs)) < len(devs) else dev

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


def col_bounds(c: int, parts: int) -> list[tuple[int, int]]:
    """The column blocks of a padded cluster axis of ``c`` columns over
    ``parts`` entries of the clusters axis (``row_bounds``' split)."""
    return row_bounds(c, parts)


def clusters_axis_size(mesh: Optional["Mesh"]) -> int:
    """Device count along the clusters axis (1 for no mesh)."""
    if mesh is None:
        return 1
    return int(mesh.devices.shape[1])


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


def _slice_rows(pieces: list, bounds: list, a: int, b: int) -> tuple[list, list]:
    """Rows [a, b) of a holder's pieces: (the pieces' views, their row
    ranges from 0)."""
    out, out_bounds = [], []
    for p, (lo, hi) in zip(pieces, bounds):
        s, e = min(max(lo, a), b), min(max(hi, a), b)
        out.append(p[s - lo : e - lo] if e > s else p[:0])
        out_bounds.append((s - a, max(s, e) - a))
    return out, out_bounds


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
    def zeros(cls, like, dtype) -> "RowShards":
        """A zero ``[B]`` vector laid out as ``like``'s rows (a holder of
        either kind)."""
        devices = [like.mesh.devices[i, 0] for i in range(len(like.bounds))]
        return cls(
            like.mesh,
            [
                torch.zeros(hi - lo, dtype=dtype, device=dev)
                for dev, (lo, hi) in zip(devices, like.bounds)
            ],
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
        pieces, bounds = _slice_rows(self.pieces, self.bounds, a, max(a, b))
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


class RowReplicas(RowShards):
    """A per-row ``[B, ...]`` input held on every entry of its objects
    shard's row, as the JAX module replicates the per-row fields over
    the clusters axis: ``copies[j][i]`` holds rows ``bounds[i]`` on
    ``mesh.devices[i, j]``.  As a ``RowShards`` it is its lanes' copy
    (``copies[0]``): what kinds 2-4 read on entry (i, 0).  A cell-local
    program on (i, j) reads its own copy (``_cell_piece``), so nothing
    moves between entries; a row gather or scatter runs on every copy
    on its own entries.  ``nbytes`` counts one copy (the logical
    tensor); ``entries`` lists every copy."""

    def __init__(self, mesh: "Mesh", copies: list, bounds: list):
        super().__init__(mesh, copies[0], bounds)
        self.copies = [list(c) for c in copies]
        self.pieces = self.copies[0]

    @classmethod
    def from_host(cls, mesh: "Mesh", arr) -> "RowReplicas":
        """A host array split by rows, one host-to-device copy per entry
        straight to its device, all from one host copy."""
        host = tensor(arr, "cpu")
        if any(torch.device(d).type == "cuda" for d in mesh.devices.ravel()):
            host = host.pin_memory()
        no, nc = mesh.devices.shape
        bounds = row_bounds(host.shape[0], no)
        return cls(
            mesh,
            [
                [
                    host[lo:hi].to(mesh.devices[i, j], non_blocking=True, copy=True)
                    for i, (lo, hi) in enumerate(bounds)
                ]
                for j in range(nc)
            ],
            bounds,
        )

    def copy(self, j: int) -> RowShards:
        """Column j's copy as a row holder."""
        return RowShards(self.mesh, self.copies[j], self.bounds)

    def map(self, fn: Callable) -> "RowReplicas":
        return RowReplicas(self.mesh, [[fn(p) for p in c] for c in self.copies], self.bounds)

    def __getitem__(self, key):
        if isinstance(key, RowIndex):
            return self.index_select(0, key)
        if not isinstance(key, slice) or key.step not in (None, 1):
            raise TypeError(f"RowReplicas takes a row slice or a RowIndex, not {key!r}")
        a, b, _ = key.indices(len(self))
        sliced = [_slice_rows(c, self.bounds, a, max(a, b)) for c in self.copies]
        return RowReplicas(self.mesh, [p for p, _b in sliced], sliced[0][1])

    def index_select(self, dim: int, idx: RowIndex) -> "RowReplicas":
        """Rows ``idx``, every copy gathered on its own entries."""
        if dim != 0:
            raise ValueError("RowReplicas selects rows only")
        rows = idx.rows
        bounds = row_bounds(rows.size, self.mesh.devices.shape[0])
        return RowReplicas(
            self.mesh,
            [
                [
                    _take(c, self.bounds, rows[lo:hi], self.mesh.devices[i, j])
                    for i, (lo, hi) in enumerate(bounds)
                ]
                for j, c in enumerate(self.copies)
            ],
            bounds,
        )

    def index_copy_(self, dim: int, idx: RowIndex, src) -> "RowReplicas":
        """Rows of ``src`` written into rows ``idx`` of every copy (from
        the same copy of ``src`` where it is replicated too)."""
        for j in range(len(self.copies)):
            part = src.copy(j) if isinstance(src, RowReplicas) else src
            self.copy(j).index_copy_(dim, idx, part)
        return self

    def entries(self) -> list[tuple[str, torch.Tensor]]:
        """(label, piece) per entry, row-major (``Mesh.entry_label``)."""
        return [
            (self.mesh.entry_label(i, j), c[i])
            for i in range(len(self.bounds))
            for j, c in enumerate(self.copies)
        ]


# -- the grid: [B, C] planes split by rows and columns ------------------------
class GridShards:
    """One ``[B, C]`` plane held as one piece per mesh entry: piece
    ``pieces[r][j]`` holds rows ``bounds[r]`` (contiguous, in order) and
    columns ``cols[j]`` (``col_bounds``), on ``mesh.devices[r, j]``.  A
    concatenation of holders (``cat_rows``) has more row pieces than
    lanes and serves only as a source of ``index_select``."""

    def __init__(self, mesh: "Mesh", pieces: list, bounds: list, cols: list):
        self.mesh = mesh
        self.pieces = [list(row) for row in pieces]
        self.bounds = [tuple(b) for b in bounds]
        self.cols = [tuple(c) for c in cols]
        if self.bounds[0][0] != 0:
            raise ValueError("a holder's rows start at 0")

    # -- building ---------------------------------------------------------
    @classmethod
    def from_host(cls, mesh: "Mesh", arr) -> "GridShards":
        """A host ``[B, C]`` array split by rows and columns, one
        host-to-device copy per entry straight to its device."""
        host = tensor(arr, "cpu")
        if any(torch.device(d).type == "cuda" for d in mesh.devices.ravel()):
            host = host.pin_memory()
        no, nc = mesh.devices.shape
        bounds = row_bounds(host.shape[0], no)
        cols = col_bounds(host.shape[1], nc)
        return cls(
            mesh,
            [
                [
                    host[lo:hi, c0:c1].to(mesh.devices[i, j], non_blocking=True, copy=True)
                    for j, (c0, c1) in enumerate(cols)
                ]
                for i, (lo, hi) in enumerate(bounds)
            ],
            bounds,
            cols,
        )

    @classmethod
    def split(cls, mesh: "Mesh", lanes: list, bounds: list) -> "GridShards":
        """Whole-row ``[rows, C]`` tensors, one per lane, split into the
        lanes' column blocks on their entries (a kind-4 program's
        output going back to the blocks)."""
        cols = col_bounds(int(lanes[0].shape[1]), mesh.devices.shape[1])
        return cls(
            mesh,
            [
                [
                    t[:, c0:c1].to(mesh.devices[i, j], non_blocking=True).contiguous()
                    for j, (c0, c1) in enumerate(cols)
                ]
                for i, t in enumerate(lanes)
            ],
            bounds,
            cols,
        )

    # -- tensor-like surface ------------------------------------------------
    @property
    def shape(self) -> torch.Size:
        return torch.Size((self.bounds[-1][1], self.cols[-1][1]))

    @property
    def dtype(self) -> torch.dtype:
        return self.pieces[0][0].dtype

    @property
    def nbytes(self) -> int:
        return sum(p.nbytes for row in self.pieces for p in row)

    def __len__(self) -> int:
        return self.bounds[-1][1]

    def map(self, fn: Callable) -> "GridShards":
        """``fn`` on every piece (a cell-wise function)."""
        return GridShards(
            self.mesh, [[fn(p) for p in row] for row in self.pieces], self.bounds, self.cols
        )

    def to(self, dtype) -> "GridShards":
        return self.map(lambda p: p.to(dtype))

    def clone(self) -> "GridShards":
        return self.map(torch.clone)

    def column(self, j: int) -> RowShards:
        """Column block j as a row holder over its pieces (the gathers
        and scatters by row work block by block)."""
        return RowShards(self.mesh, [row[j] for row in self.pieces], self.bounds)

    @classmethod
    def of_columns(cls, blocks: list, cols: list) -> "GridShards":
        """The inverse of ``column``: one row holder per column block."""
        first = blocks[0]
        return cls(
            first.mesh,
            [list(row) for row in zip(*(b.pieces for b in blocks))],
            first.bounds,
            cols,
        )

    def __getitem__(self, key):
        if isinstance(key, RowIndex):
            return self.index_select(0, key)
        blocks = [self.column(j)[key] for j in range(len(self.cols))]
        return GridShards.of_columns(blocks, self.cols)

    def __setitem__(self, key, src) -> None:
        if not isinstance(key, RowIndex):
            raise TypeError(f"GridShards assigns through a RowIndex, not {key!r}")
        self.index_copy_(0, key, src)

    def index_select(self, dim: int, idx: RowIndex) -> "GridShards":
        """Rows ``idx`` laid out as ``row_bounds(len(idx), No)``: each
        entry takes its share of the index, in its own column block,
        from the entries that own the rows."""
        if dim != 0:
            raise ValueError("GridShards selects rows only")
        rows = idx.rows
        bounds = row_bounds(rows.size, self.mesh.devices.shape[0])
        return GridShards(
            self.mesh,
            [
                [
                    _take([row[j] for row in self.pieces], self.bounds, rows[lo:hi],
                          self.mesh.devices[i, j])
                    for j in range(len(self.cols))
                ]
                for i, (lo, hi) in enumerate(bounds)
            ],
            bounds,
            self.cols,
        )

    def index_copy_(self, dim: int, idx: RowIndex, src: "GridShards") -> "GridShards":
        """Write rows of ``src`` (a grid holder over the index's
        positions, in the same column blocks) into rows ``idx``, block by
        block."""
        if dim != 0:
            raise ValueError("GridShards copies rows only")
        if not isinstance(src, GridShards) or src.cols != self.cols:
            raise ValueError("GridShards copies rows of a holder in its own column blocks")
        for j in range(len(self.cols)):
            self.column(j).index_copy_(0, idx, src.column(j))
        return self

    def index_copy_cols_(self, cols: np.ndarray, values: RowShards) -> "GridShards":
        """Write ``values`` ([B, >= len(cols)] per row, on the lanes) into
        the global columns ``cols`` (host int64), each column routed to
        the block that owns it."""
        for j, (c0, c1) in enumerate(self.cols):
            pos = np.nonzero((cols >= c0) & (cols < c1))[0]
            if not pos.size:
                continue
            for i, row in enumerate(self.pieces):
                piece = row[j]
                local = tensor(cols[pos] - c0, piece.device)
                vals = values.pieces[i].index_select(1, tensor(pos, values.pieces[i].device))
                piece.index_copy_(1, local, vals.to(piece.device).to(piece.dtype))
        return self

    # -- whole rows (kind 4) and the host read -----------------------------
    def lane(self, i: int) -> torch.Tensor:
        """Lane i's rows, every column, joined on entry (i, 0): what a
        whole-row program (``run_whole``) reads, and nothing else."""
        dev = self.mesh.devices[i, 0]
        return torch.cat([p.to(dev, non_blocking=True) for p in self.pieces[i]], dim=1)

    def numpy(self) -> np.ndarray:
        """Each entry's piece copied to the host, joined there in row and
        column order."""
        return np.concatenate(
            [np.concatenate([p.cpu().numpy() for p in row], axis=1) for row in self.pieces]
        )

    def entries(self) -> list[tuple[str, torch.Tensor]]:
        """(label, piece) per entry, row-major (``Mesh.entry_label``)."""
        return [
            (self.mesh.entry_label(i, j), p)
            for i, row in enumerate(self.pieces)
            for j, p in enumerate(row)
        ]


def cat_rows(parts: list):
    """Several row-wise values end to end: tensors concatenated; holders
    as one holder of all their pieces (a gather source)."""
    if isinstance(parts[0], GridShards):
        blocks = [cat_rows([h.column(j) for h in parts]) for j in range(len(parts[0].cols))]
        return GridShards.of_columns(blocks, parts[0].cols)
    if not isinstance(parts[0], RowShards):
        return torch.cat(parts)
    if all(isinstance(h, RowReplicas) for h in parts):
        copies = [cat_rows([h.copy(j) for h in parts]) for j in range(len(parts[0].copies))]
        return RowReplicas(parts[0].mesh, [c.pieces for c in copies], copies[0].bounds)
    pieces, bounds, off = [], [], 0
    for h in parts:
        for p, (lo, hi) in zip(h.pieces, h.bounds):
            pieces.append(p)
            bounds.append((lo + off, hi + off))
        off += len(h)
    return RowShards(parts[0].mesh, pieces, bounds)


class Blocks:
    """Per-entry values of a cell-local program (``run_grid``):
    ``values[i][j]`` on entry (i, j)'s device, None where the entry ran
    nothing; the rows are ``bounds[i]``, the columns ``cols[j]``."""

    def __init__(self, mesh: "Mesh", values: list, bounds: list, cols: list):
        self.mesh = mesh
        self.values = values
        self.bounds = [tuple(b) for b in bounds]
        self.cols = [tuple(c) for c in cols]

    def grid(self) -> GridShards:
        """The per-entry ``[rows, cols]`` tensors as a plane holder (an
        entry that ran nothing: an empty piece)."""
        ref = next(v for row in self.values for v in row if v is not None)
        pieces = [
            [
                v if v is not None
                else torch.empty((0, c1 - c0) + tuple(ref.shape[2:]), dtype=ref.dtype,
                                 device=self.mesh.devices[i, j])
                for j, (v, (c0, c1)) in enumerate(zip(row, self.cols))
            ]
            for i, row in enumerate(self.values)
        ]
        return GridShards(self.mesh, pieces, self.bounds, self.cols)


def _holders(value, found: list) -> list:
    """Every holder inside a row argument (tensor, dict, NamedTuple)."""
    if isinstance(value, (RowShards, GridShards, Blocks)):
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
    if set(fields) <= set(_COMPACT_FIELD_SPECS):
        return _COMPACT_FIELD_SPECS
    return None


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


def _rows_piece(value, i: int, lo: int, hi: int, device, stream, whole_rows: bool = False):
    """Lane ``i``'s rows [lo, hi) of a row-sharded argument on its
    device: a holder's own piece (in place), a RowIndex's positions, a
    tensor's rows, a dict of them, or a TickInputs/CompactInputs (fields
    split by their table's spec, the rest placed whole); None stays.  A
    ``Blocks`` gives the list of the row's per-entry values, moved to
    the lane's device; a ``GridShards`` its whole rows (``whole_rows``,
    kind 4 only)."""
    if value is None:
        return None
    if isinstance(value, RowShards):
        return value.pieces[i]
    if isinstance(value, GridShards):
        if not whole_rows:
            raise TypeError("a [B, C] grid plane goes whole to a lane only in run_whole")
        return value.lane(i)
    if isinstance(value, Blocks):
        return [None if v is None else _place(v, device, stream) for v in value.values[i]]
    if isinstance(value, RowIndex):
        return value.on(device, lo, hi)
    if isinstance(value, torch.Tensor):
        return _place(value[lo:hi], device, stream)
    if isinstance(value, dict):
        return {
            k: _rows_piece(v, i, lo, hi, device, stream, whole_rows) for k, v in value.items()
        }
    specs = _specs_of(value)
    if specs is None:
        parts = (_rows_piece(v, i, lo, hi, device, stream, whole_rows) for v in value)
        return type(value)(*parts) if hasattr(value, "_fields") else tuple(parts)
    return type(value)(
        **{
            name: _rows_piece(v, i, lo, hi, device, stream, whole_rows)
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


def _keep(parts: list, mesh: Mesh, ranges: list, cols: Optional[int] = None):
    """Per-lane outputs of one structure as holders on ``ranges``
    (tensors; tuples and NamedTuples field by field; None stays; other
    values from the first lane).  A lane that ran nothing (None in
    ``parts``) gets an empty piece of the same trailing shape.  With
    ``cols``, a ``[rows, cols]`` tensor is split into the lanes' column
    blocks (``GridShards``)."""
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
        if cols is not None and first.dim() == 2 and first.shape[1] == cols:
            return GridShards.split(mesh, pieces, ranges)
        return RowShards(mesh, pieces, ranges)
    if isinstance(first, (tuple, list)):
        kept = [
            _keep([None if p is None else p[k] for p in parts], mesh, ranges, cols)
            for k in range(len(first))
        ]
        if isinstance(first, list):
            return kept
        return type(first)(*kept) if hasattr(first, "_fields") else tuple(kept)
    return first


def _row_ranges(mesh: Mesh, rows: tuple) -> tuple[int, list]:
    """(row count, the lanes' row ranges) of a program's row arguments:
    the holders' (which must agree), else ``row_bounds``."""
    held = [h for a in rows for h in _holders(a, [])]
    if held:
        ranges = held[0].bounds
        n = ranges[-1][1]
    else:
        n = leading_rows(next(a for a in rows if a is not None))
        ranges = row_bounds(n, mesh.devices.shape[0])
    for h in held:
        lanes = len(h.pieces) if not isinstance(h, Blocks) else len(h.values)
        if h.bounds != ranges or lanes != mesh.devices.shape[0]:
            raise ValueError(f"holders on other rows: {h.bounds} against {ranges}")
    return n, ranges


def _on_lanes(mesh: Mesh, fn: Callable, rows: tuple, whole: tuple, bounds: bool,
              kw: dict, whole_rows: bool, cols: Optional[int]):
    n, ranges = _row_ranges(mesh, rows)
    parts, waits = [], []
    for i, (lo, hi) in enumerate(ranges):
        # A lane with no row runs nothing (on an empty batch, the first
        # lane runs once, so the output has its structure).
        if hi == lo and (n > 0 or i > 0):
            parts.append(None)
            continue
        dev, stream = mesh.devices[i, 0], mesh.stream(i, 0)
        with on_lane(dev, stream):
            pieces = [_rows_piece(a, i, lo, hi, dev, stream, whole_rows) for a in rows]
            rest = [_place(a, dev, stream) for a in whole]
            parts.append(fn(*((lo, hi) if bounds else ()), *pieces, *rest, **kw))
        if stream is not None:
            waits.append((dev, stream))
    for dev, stream in waits:
        torch.cuda.current_stream(dev).wait_stream(stream)
    return _keep(parts, mesh, ranges, cols)


def run_rows(mesh: Mesh, fn: Callable, rows: tuple, whole: tuple = (),
             bounds: bool = False, **kw):
    """``fn(*row_pieces, *whole, **kw)`` on each objects shard of
    ``mesh``, on the first device of the shard's clusters axis and that
    entry's stream, over the shard's contiguous rows of every ``rows``
    argument; ``whole`` arguments go to every shard.  The shards' rows
    are the holders' (``RowShards`` arguments are taken in place, piece
    by piece, and must share their rows), else ``row_bounds``; a shard
    with no row runs nothing.  A ``Blocks`` argument (a cell-local
    program's per-entry partials) comes as the list of the row's blocks
    in column order: the kind-2 and kind-3 combinations.  A
    ``GridShards`` plane is refused (``run_whole`` takes it).  The
    outputs are returned as holders on those rows, and every lane
    device's current stream waits for the shards' streams.  With
    ``bounds`` the shard's row range (lo, hi) leads ``fn``'s arguments.
    Nothing here waits on the host."""
    return _on_lanes(mesh, fn, rows, whole, bounds, kw, False, None)


def run_whole(mesh: Mesh, fn: Callable, rows: tuple, whole: tuple = (), cols=None,
              bounds: bool = False, **kw):
    """A whole-row program (kind 4): ``run_rows``, with every
    ``GridShards`` argument gathered as the lane's whole rows on entry
    (i, 0); with ``cols`` (the padded cluster axis), each ``[rows,
    cols]`` output goes back to the blocks as a ``GridShards``."""
    return _on_lanes(mesh, fn, rows, whole, bounds, kw, True, cols)


class Cell(NamedTuple):
    """Where a cell-local program runs: entry (i, j), its rows [lo, hi)
    and columns [c0, c1) of a cluster axis of ``c`` columns."""

    i: int
    j: int
    lo: int
    hi: int
    c0: int
    c1: int
    c: int


def _cell_piece(value, cell: Cell, device, stream, mesh: "Mesh"):
    """Entry ``cell``'s part of a ``run_grid`` argument on its device:
    a grid plane's, a ``Blocks``' or a ``RowReplicas``' own piece, a
    row holder's rows (moved to the entry: a kind-2 result going back
    to the blocks), a TickInputs/CompactInputs split by its
    table's spec (the cluster tables by their column block:
    ``Mesh.column_block``), a dict or tuple field by field; a tensor
    goes whole."""
    if value is None:
        return None
    if isinstance(value, GridShards):
        return value.pieces[cell.i][cell.j]
    if isinstance(value, Blocks):
        return value.values[cell.i][cell.j]
    if isinstance(value, RowReplicas):
        return value.copies[cell.j][cell.i]
    if isinstance(value, RowShards):
        return _place(value.pieces[cell.i], device, stream)
    if isinstance(value, dict):
        return {k: _cell_piece(v, cell, device, stream, mesh) for k, v in value.items()}
    specs = _specs_of(value)
    if specs is not None:
        out = {}
        for name, v in value._asdict().items():
            spec = specs.get(name, (None,))
            if isinstance(v, torch.Tensor) and CLUSTERS in spec:
                # A cluster table: the entry's own column block.
                out[name] = mesh.column_block(v, spec.index(CLUSTERS), cell.c0, cell.c1,
                                              cell.i, cell.j)
                continue
            out[name] = _cell_piece(v, cell, device, stream, mesh)
        return type(value)(**out)
    if isinstance(value, tuple):
        parts = (_cell_piece(v, cell, device, stream, mesh) for v in value)
        return type(value)(*parts) if hasattr(value, "_fields") else tuple(parts)
    if isinstance(value, torch.Tensor):
        return _place(value, device, stream)
    return value


def _keep_blocks(parts: list, mesh: Mesh, ranges: list, cols: list):
    """Per-entry outputs of one structure: each tensor leaf as a
    ``Blocks``; dicts, tuples and NamedTuples field by field; None
    stays."""
    first = next((v for row in parts for v in row if v is not None), None)
    if first is None:
        return None
    if isinstance(first, torch.Tensor):
        return Blocks(mesh, parts, ranges, cols)
    if isinstance(first, dict):
        return {
            k: _keep_blocks([[None if v is None else v[k] for v in row] for row in parts],
                            mesh, ranges, cols)
            for k in first
        }
    if isinstance(first, (tuple, list)):
        kept = [
            _keep_blocks([[None if v is None else v[k] for v in row] for row in parts],
                         mesh, ranges, cols)
            for k in range(len(first))
        ]
        if isinstance(first, list):
            return kept
        return type(first)(*kept) if hasattr(first, "_fields") else tuple(kept)
    return first


def run_grid(mesh: Mesh, fn: Callable, c: int, *args):
    """A cell-local program (kind 1): ``fn(cell, *pieces)`` on every
    entry (i, j) of ``mesh``, on its device and stream, over objects
    shard i's rows and column block j of a padded cluster axis of ``c``
    columns (``col_bounds``).  Each argument gives the entry its part
    (``_cell_piece``); the rows are the holders' (they must agree).  An
    entry with no row runs nothing.  Returns the outputs' structure with
    every tensor a ``Blocks``; every entry device's current stream then
    waits for the entries' streams."""
    n, ranges = _row_ranges(mesh, tuple(a for a in args if _holders(a, [])))
    cols = col_bounds(c, mesh.devices.shape[1])
    parts, waits = [], []
    for i, (lo, hi) in enumerate(ranges):
        row = []
        for j, (c0, c1) in enumerate(cols):
            if hi == lo and (n > 0 or i > 0):
                row.append(None)
                continue
            dev, stream = mesh.devices[i, j], mesh.stream(i, j)
            cell = Cell(i, j, lo, hi, c0, c1, c)
            with on_lane(dev, stream):
                pieces = [_cell_piece(a, cell, dev, stream, mesh) for a in args]
                row.append(fn(cell, *pieces))
            if stream is not None:
                waits.append((dev, stream))
        parts.append(row)
    for dev, stream in waits:
        torch.cuda.current_stream(dev).wait_stream(stream)
    return _keep_blocks(parts, mesh, ranges, cols)
