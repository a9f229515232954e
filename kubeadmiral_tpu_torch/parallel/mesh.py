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
its own device and stream, and joins the outputs in row order on the
engine's device.  The field tables ``_FIELD_SPECS`` and
``_COMPACT_FIELD_SPECS`` (the JAX module's) say which inputs split by
rows (``OBJECTS`` first) and which every shard takes whole (the cluster
tables): ``run_rows`` is the counterpart of the JAX module's
``shard_inputs`` and its rows / replicated shardings.

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
    before that work has run."""
    if isinstance(t, dict):
        return {k: _place(v, device, stream) for k, v in t.items()}
    if not isinstance(t, torch.Tensor):
        return t
    if stream is not None and t.device.type == "cuda":
        t.record_stream(stream)
    return t.to(device, non_blocking=True)


def _rows_piece(value, lo: int, hi: int, device, stream):
    """Rows [lo, hi) of a row-sharded argument on the shard's device: a
    tensor, a dict of tensors, or a TickInputs/CompactInputs (fields
    split by their table's spec, the rest placed whole); None stays."""
    if value is None:
        return None
    if isinstance(value, torch.Tensor):
        return _place(value[lo:hi], device, stream)
    if isinstance(value, dict):
        return {k: _rows_piece(v, lo, hi, device, stream) for k, v in value.items()}
    specs = _specs_of(value)
    return type(value)(
        **{
            name: _rows_piece(v, lo, hi, device, stream)
            if specs.get(name, (None,))[:1] == (OBJECTS,)
            else _place(v, device, stream)
            for name, v in value._asdict().items()
        }
    )


def leading_rows(value) -> int:
    """Rows of a row-sharded argument: a tensor, a dict of per-object
    tensors or a TickInputs/CompactInputs."""
    if isinstance(value, torch.Tensor):
        return int(value.shape[0])
    if isinstance(value, dict):
        return leading_rows(next(iter(value.values())))
    specs = _specs_of(value)
    for name, v in value._asdict().items():
        if specs.get(name, (None,))[:1] == (OBJECTS,):
            return int(v.shape[0])
    raise ValueError("no row-sharded field")


def _join(parts: list, home, home_stream):
    """Per-shard outputs of one structure joined in row order on
    ``home`` (tensors concatenated; tuples and NamedTuples field by
    field; None stays; other values from the first shard)."""
    first = parts[0]
    if first is None:
        return None
    if isinstance(first, torch.Tensor):
        if home_stream is not None:
            for p in parts:
                if p.device.type == "cuda":
                    p.record_stream(home_stream)
        return torch.cat([p.to(home, non_blocking=True) for p in parts])
    if isinstance(first, tuple):
        joined = [_join([p[k] for p in parts], home, home_stream) for k in range(len(first))]
        return type(first)(*joined) if hasattr(first, "_fields") else tuple(joined)
    if isinstance(first, list):
        return [_join([p[k] for p in parts], home, home_stream) for k in range(len(first))]
    return first


def run_rows(mesh: Mesh, fn: Callable, rows: tuple, whole: tuple = (), home=None,
             bounds: bool = False, **kw):
    """``fn(*row_pieces, *whole, **kw)`` on each objects shard of
    ``mesh``, on the first device of the shard's clusters axis and that
    entry's stream, over the shard's contiguous rows of every ``rows``
    argument (``row_bounds``; a shard with no row is skipped); ``whole``
    arguments go to every shard.  The outputs are joined in row order on
    ``home`` (default: the first entry's device), whose current stream
    waits for every shard's.  With ``bounds`` the shard's row range
    (lo, hi) leads ``fn``'s arguments.  Nothing here waits on the
    host."""
    home = torch.device(home if home is not None else mesh.devices[0, 0])
    n = leading_rows(rows[0])
    if n == 0:
        return fn(*((0, 0) if bounds else ()), *rows, *whole, **kw)
    ranges = row_bounds(n, mesh.devices.shape[0])
    home_stream = torch.cuda.current_stream(home) if home.type == "cuda" else None
    parts, lanes = [], []
    for i, (lo, hi) in enumerate(ranges):
        if hi == lo:
            continue
        dev, stream = mesh.devices[i, 0], mesh.stream(i, 0)
        with on_lane(dev, stream):
            pieces = [_rows_piece(a, lo, hi, dev, stream) for a in rows]
            rest = [_place(a, dev, stream) for a in whole]
            parts.append(fn(*((lo, hi) if bounds else ()), *pieces, *rest, **kw))
        if stream is not None:
            lanes.append(stream)
    for stream in lanes:
        home_stream.wait_stream(stream)
    return _join(parts, home, home_stream)
