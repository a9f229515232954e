"""The port's mesh against the JAX package's sharded tick.

Mirrors ``tests/test_mesh.py`` on the engine's own path: a
``SchedulerEngine`` over a port mesh (``parallel/mesh.py``) dispatches
a batch through ``_tick`` (each objects shard runs the program on its
rows; with a clusters axis the dense tick reads the lanes' whole rows,
``run_whole``, and its planes go back to the column blocks) and equals the JAX
package's unsharded ``schedule_tick`` field by field (exact), at the
layouts (1,1) (4,2) (2,4) (8,1) (1,8); the same engine schedules the
batch's world as the engine without a mesh does.  The mesh's entries
are logical CPU devices.  Also the field tables and the row split.
"""

from __future__ import annotations

import pathlib
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))

from kubeadmiral_tpu.ops.pipeline import schedule_tick as jax_schedule_tick  # noqa: E402
from kubeadmiral_tpu_torch.convert import to_device  # noqa: E402
from kubeadmiral_tpu_torch.ops.pipeline import TickInputs, TickOutputs  # noqa: E402
from kubeadmiral_tpu_torch.parallel import mesh as M  # noqa: E402
from kubeadmiral_tpu_torch.scheduler.engine import SchedulerEngine  # noqa: E402

from __graft_entry__ import _example_batch, _example_units_clusters  # noqa: E402


@pytest.fixture(scope="module")
def batch():
    return _example_batch(b=32, c=16)


@pytest.fixture(scope="module")
def unsharded(batch):
    return jax_schedule_tick(batch)


def _engine(mesh):
    return SchedulerEngine(device="cpu", mesh=mesh, flight_recorder=None, devprof=None)


def _assert_sharded_matches(batch, unsharded, objects_axis, clusters_axis):
    mesh = M.make_mesh(["cpu"] * (objects_axis * clusters_axis), objects_axis=objects_axis)
    assert mesh.shape == (objects_axis, clusters_axis)
    engine = _engine(mesh)
    assert engine.mesh is mesh
    out, cert = engine._tick(to_device(batch, "cpu"), "dense", None)
    assert cert is None
    for name in TickOutputs._fields:
        np.testing.assert_array_equal(
            getattr(out, name).numpy(),
            np.asarray(getattr(unsharded, name)),
            err_msg=f"field {name} diverges on mesh {objects_axis}x{clusters_axis}",
        )


@pytest.mark.parametrize(
    "objects_axis,clusters_axis",
    [(1, 1), (4, 2), (2, 4), (8, 1), (1, 8)],
)
def test_sharded_tick_matches_unsharded(batch, unsharded, objects_axis, clusters_axis):
    _assert_sharded_matches(batch, unsharded, objects_axis, clusters_axis)
    units, clusters = _example_units_clusters(32, 16)
    mesh = M.make_mesh(["cpu"] * (objects_axis * clusters_axis), objects_axis=objects_axis)
    assert _engine(mesh).schedule(units, clusters) == _engine(None).schedule(units, clusters)


def test_make_mesh_default_layout():
    mesh = M.make_mesh(["cpu"] * 8)
    assert mesh.axis_names == (M.OBJECTS, M.CLUSTERS)
    assert mesh.devices.size == 8 and mesh.shape == (8, 1)
    assert M.objects_axis_size(mesh) == 8 and M.objects_axis_size(None) == 1
    assert mesh.stream(0, 0) is None  # CPU entries have no stream


def test_sharded_tick_matches_unsharded_with_volume():
    """512 x 128 over a (4, 2) mesh: real per-shard volume on both axes."""
    batch = _example_batch(b=512, c=128)
    unsharded = jax_schedule_tick(batch)
    assert int(np.asarray(unsharded.selected).sum()) > 0
    _assert_sharded_matches(batch, unsharded, 4, 2)


def test_field_tables_match_jax():
    """The field tables are the JAX module's, entry for entry."""
    from kubeadmiral_tpu.parallel import mesh as jax_mesh

    assert M._FIELD_SPECS == jax_mesh._FIELD_SPECS
    assert M._COMPACT_FIELD_SPECS == jax_mesh._COMPACT_FIELD_SPECS
    assert set(M._FIELD_SPECS) == set(TickInputs._fields)


@pytest.mark.parametrize("n,parts", [(0, 4), (3, 4), (64, 4), (97, 8), (5, 1)])
def test_row_bounds_and_run_rows(n, parts):
    """The row split covers every row once, in order; run_rows keeps a
    row-wise program's per-shard outputs on their shards, which read
    back as the unsharded output (a dict, a tensor and a whole
    argument), skipping empty shards."""
    bounds = M.row_bounds(n, parts)
    assert bounds[0][0] == 0 and bounds[-1][1] == n
    assert all(a[1] == b[0] for a, b in zip(bounds, bounds[1:]))
    assert max(hi - lo for lo, hi in bounds) - min(hi - lo for lo, hi in bounds) <= 1
    mesh = M.make_mesh(["cpu"] * parts)
    x = torch.arange(n * 3, dtype=torch.int64).reshape(n, 3)
    calls = []

    def fn(d, t, w):
        calls.append(t.shape[0])
        return (d["a"] * 2 + t + w).sum(dim=1), None

    got, none = M.run_rows(mesh, fn, ({"a": x}, x + 1), (torch.tensor(7),))
    assert isinstance(got, M.RowShards) and got.bounds == bounds
    assert np.array_equal(got.numpy(), (x * 3 + 8).sum(dim=1).numpy()) and none is None
    assert sum(calls) == n and (n == 0 or 0 not in calls)


def test_layouts(batch):
    """run_rows splits a TickInputs by its field table: the per-object
    fields by rows over the objects axis, the cluster tables whole on
    every shard; a tensor argument by rows, a ``whole`` one whole."""
    mesh = M.make_mesh(["cpu"] * 4, objects_axis=2)
    inputs = to_device(batch, "cpu")
    seen = []

    def fn(piece, t, w):
        seen.append((piece, t, w))
        return piece.total

    got = M.run_rows(mesh, fn, (inputs, inputs.total), (inputs.alloc,))
    assert np.array_equal(got.numpy(), inputs.total.numpy())
    assert M.leading_rows(inputs) == 32 and M.leading_rows({"a": inputs.total}) == 32
    assert len(seen) == 2
    for (lo, hi), (piece, t, w) in zip(M.row_bounds(32, 2), seen):
        for name in TickInputs._fields:
            whole = getattr(inputs, name)
            part = getattr(piece, name)
            if M._FIELD_SPECS[name][0] == M.OBJECTS:
                assert torch.equal(part, whole[lo:hi]), name
            else:
                assert torch.equal(part, whole), name
        assert torch.equal(t, inputs.total[lo:hi]) and torch.equal(w, inputs.alloc)
