"""The port's engine over a clusters axis, tick by tick, against the JAX
engine on a mesh of the same shape.

The chain of test_torch_multidevice.py (cold, no-op replay, churn
sub-batch, capacity drift through the gate, fit-flip, boost and back)
on meshes (1, 2), (2, 2) and (1, 4) of logical CPU entries, each entry
(i, j) holding its column block of every [B, C] plane
(``parallel.mesh.GridShards``), equals the unmeshed port and the JAX
engine on ``jax_mesh.make_mesh(jax.devices()[:n], objects_axis=...)``
at every tick: results, counters and the flight recorder's per-key
placements and reason counts (``_run_chain``, which
tests/test_torch_grid_optin.py runs with the opt-in switches).  (The
JAX engines compile a program set per mesh shape, which dominates this
file's time; tests/test_torch_grid.py holds the rest of the clusters
axis.)
"""

from __future__ import annotations

import pathlib
import sys

import jax
import pytest

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))

from kubeadmiral_tpu.parallel import mesh as jax_mesh  # noqa: E402
from kubeadmiral_tpu.runtime.flightrec import FlightRecorder as JaxRecorder  # noqa: E402
from kubeadmiral_tpu.scheduler.engine import SchedulerEngine as JaxEngine  # noqa: E402
from kubeadmiral_tpu_torch.parallel import mesh as M  # noqa: E402
from kubeadmiral_tpu_torch.runtime.flightrec import FlightRecorder  # noqa: E402
from kubeadmiral_tpu_torch.scheduler.engine import SchedulerEngine  # noqa: E402

from test_multidevice import _rec_state, _world  # noqa: E402
from test_torch_multidevice import COUNTERS, JAX_COUNTERS, _chain  # noqa: E402

SHAPES = [(1, 2), (2, 2), (1, 4)]


def _port(shape, rec=None, **kw):
    mesh = None if shape is None else M.make_mesh(["cpu"] * (shape[0] * shape[1]),
                                                  objects_axis=shape[0])
    return SchedulerEngine(device="cpu", mesh=mesh, min_bucket=32, narrow_m=8,
                           flight_recorder=rec, devprof=None, **kw)


def _jax(shape, rec=None, **kw):
    n = shape[0] * shape[1]
    return JaxEngine(mesh=jax_mesh.make_mesh(jax.devices()[:n], objects_axis=shape[0]),
                     min_bucket=32, narrow_m=8, flight_recorder=rec, devprof=None, **kw)


# The JAX engine's environment switch for each switch it reads there
# (the others are keywords of both engines).
JAX_ENV = {"survivor_unified": ("KT_SURVIVOR_UNIFIED", "0"), "score_f16": ("KT_SCORE_F16", "1")}


def _run_chain(shape, switches: dict, monkeypatch):
    """The chain on a port engine over ``shape``, the unmeshed port and
    the JAX engine on a mesh of the same shape, each with ``switches``:
    results, counters and flight-recorder state equal at every tick."""
    jax_kw = {}
    for name, value in switches.items():
        if name in JAX_ENV:
            monkeypatch.setenv(*JAX_ENV[name])
        else:
            jax_kw[name] = value
    units, clusters = _world()
    recs = {"m": FlightRecorder(enabled=True), "s": FlightRecorder(enabled=True),
            "j": JaxRecorder(enabled=True)}
    grid = _port(shape, recs["m"], **switches)
    single = _port(None, recs["s"], **switches)
    ref = _jax(shape, recs["j"], **jax_kw)
    assert grid.mesh.shape == shape and ref.mesh.devices.shape == shape
    for label, batch, cl in _chain(units, clusters):
        where = (switches, label)
        got = grid.schedule(batch, cl)
        assert got == single.schedule(batch, cl), where
        assert [r.clusters for r in got] == [r.clusters for r in ref.schedule(batch, cl)], where
        for name in COUNTERS:
            assert getattr(grid, name) == getattr(single, name), (where, name)
        for name in JAX_COUNTERS:
            assert getattr(grid, name) == getattr(ref, name), (where, name)
        assert _rec_state(recs["m"]) == _rec_state(recs["s"]) == _rec_state(recs["j"]), where
    return grid


@pytest.mark.parametrize("shape", SHAPES)
def test_chain_equals_unmeshed_and_jax_grid(shape, monkeypatch):
    grid = _run_chain(shape, {}, monkeypatch)
    assert grid.drift_stats["gated"] >= 1 and grid.narrow_stats["rows"] > 0
    assert grid.fetch_stats["noop"] >= 1 and grid.fetch_stats["subbatch"] >= 1
