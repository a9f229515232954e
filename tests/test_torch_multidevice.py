"""The port's meshed engine: N in {2, 4} against N = 1 and the JAX mesh.

Mirrors ``tests/test_multidevice.py``.  A port engine over a mesh of N
logical CPU devices (``make_mesh(["cpu"] * N)``: each objects shard
solves its rows of every row-wise program) is bit-identical to the
port's single-device engine and to the JAX engine meshed at N over the
conftest's host devices, through the whole chain — cold, no-op replay,
churn sub-batch, capacity drift through the gate, the unified survivor
program (row-sharded groups), fit-flip and back — with the flight
recorder's per-key placements and reason counts, and the counters.
Also: the sharded snapshot round trip and the topology refusal, one
adaptive-K vote per tick on the aggregate of the pieces, the f16 score
plane under a mesh, the stream's per-device slab watermark,
``resident_state_bytes`` per lane, the dispatch ledger's ``mesh<N>``
lane, the per-device window and the engine's mesh resolution.

The resident state stays on its shards: through cold, no-op, churn,
drift, drift-zero (survivors), fit-flip and back, every tensor a cache
entry holds is a lane's piece over that lane's rows, each lane's
``prev_planes`` bytes are the JAX meshed engine's family divided by N,
no row-wise program joins its outputs on the engine's device, and no
program takes a [B, ...] plane whole on every shard.
"""

from __future__ import annotations

import dataclasses
import pathlib
import sys

import jax
import numpy as np
import pytest
import torch

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))

from kubeadmiral_tpu.parallel import mesh as jax_mesh  # noqa: E402
from kubeadmiral_tpu.runtime.flightrec import FlightRecorder as JaxRecorder  # noqa: E402
from kubeadmiral_tpu.scheduler.engine import SchedulerEngine as JaxEngine  # noqa: E402
from kubeadmiral_tpu_torch.parallel.mesh import RowShards, make_mesh, row_bounds  # noqa: E402
from kubeadmiral_tpu_torch.runtime import census  # noqa: E402
from kubeadmiral_tpu_torch.runtime.devprof import DispatchLedger  # noqa: E402
from kubeadmiral_tpu_torch.runtime.flightrec import FlightRecorder  # noqa: E402
from kubeadmiral_tpu_torch.scheduler import engine as engine_mod  # noqa: E402
from kubeadmiral_tpu_torch.scheduler.engine import SchedulerEngine  # noqa: E402
from kubeadmiral_tpu_torch.scheduler.streaming import StreamingScheduler  # noqa: E402
from kubeadmiral_tpu_torch.testing.worlds import drift_zero  # noqa: E402

from test_multidevice import _drifts, _rec_state, _world  # noqa: E402

COUNTERS = (
    "cache_stats", "fetch_stats", "drift_stats", "survivor_stats", "narrow_stats",
    "dispatches_total", "fetch_bytes_total", "upload_bytes", "last_changed",
    "overflow_rows_total",
)
# The counters a port engine shares with the JAX engine (the port's
# byte counters and program count differ by design).
JAX_COUNTERS = ("cache_stats", "fetch_stats", "drift_stats", "survivor_stats",
                "narrow_stats", "last_changed")


def _port(n, rec=None, **kw):
    mesh = None if n == 1 else make_mesh(["cpu"] * n)
    return SchedulerEngine(
        device="cpu", mesh=mesh, min_bucket=32, narrow_m=8,
        flight_recorder=rec, devprof=kw.pop("devprof", None), **kw,
    )


def _jax(n, rec=None):
    return JaxEngine(
        mesh=jax_mesh.make_mesh(jax.devices()[:n]), min_bucket=32, narrow_m=8,
        flight_recorder=rec, devprof=None,
    )


def _chain(units, clusters):
    churned = list(units)
    churned[0] = dataclasses.replace(
        churned[0], desired_replicas=(units[0].desired_replicas or 1) + 7
    )
    halved, squeezed, boosted = _drifts(clusters)
    return [
        ("cold", units, clusters), ("noop", units, clusters), ("churn", churned, clusters),
        ("drift", churned, halved), ("fitflip", churned, squeezed),
        ("boost", churned, boosted), ("back", churned, clusters),
    ]


@pytest.mark.parametrize("n", [2, 4])
def test_chain_equals_single_device_and_jax_mesh(n):
    units, clusters = _world()
    recs = {"m": FlightRecorder(enabled=True), "s": FlightRecorder(enabled=True),
            "j": JaxRecorder(enabled=True)}
    meshed, single = _port(n, recs["m"]), _port(1, recs["s"])
    ref = _jax(n, recs["j"])
    assert meshed.mesh.shape == (n, 1) and ref.mesh.devices.shape == (n, 1)
    assert meshed.pipeline_depth == meshed.pipeline_depth_per_device * n == ref.pipeline_depth
    for label, batch, cl in _chain(units, clusters):
        got = meshed.schedule(batch, cl)
        assert got == single.schedule(batch, cl), label
        assert [r.clusters for r in got] == [r.clusters for r in ref.schedule(batch, cl)], label
        for name in COUNTERS:
            assert getattr(meshed, name) == getattr(single, name), (label, name)
        for name in JAX_COUNTERS:
            assert getattr(meshed, name) == getattr(ref, name), (label, name)
    assert meshed.drift_stats["gated"] >= 1
    assert meshed.drift_stats["unified"] + meshed.drift_stats["unified_fallback"] > 0
    assert meshed.fetch_stats["noop"] >= 1 and meshed.fetch_stats["subbatch"] >= 1
    assert _rec_state(recs["m"]) == _rec_state(recs["s"]) == _rec_state(recs["j"])


@pytest.mark.parametrize("n", [2, 4])
def test_optin_paths_under_a_mesh(n):
    """The three-stream survivors, f16 score planes, the dense fetch and
    the dense solve under a mesh equal the single-device engine with the
    same switch, tick by tick, counters included."""
    units, clusters = _world()
    for switches in (
        {"survivor_unified": False}, {"score_f16": True},
        {"fetch_format": "dense"}, {"narrow": False},
    ):
        meshed, single = _port(n, **switches), _port(1, **switches)
        for label, batch, cl in _chain(units, clusters):
            assert meshed.schedule(batch, cl) == single.schedule(batch, cl), (switches, label)
            for name in COUNTERS:
                assert getattr(meshed, name) == getattr(single, name), (switches, label, name)
    assert meshed.mesh is not None


def test_score_f16_parity():
    """f16 score planes on a mesh of 4 equal the plain single-device
    engine; the payload carries the compressed plane and restores into a
    compressed meshed engine."""
    units, clusters = _world()
    packed, plain = _port(4, score_f16=True), _port(1)
    assert packed.schedule(units, clusters) == plain.schedule(units, clusters)
    entry = packed._chunk_cache[0]
    assert entry.prev_out[3].dtype == torch.float16 and entry.prev_sco_exact is not None
    churned = list(units)
    churned[5] = dataclasses.replace(churned[5], desired_replicas=83)
    assert packed.schedule(churned, clusters) == plain.schedule(churned, clusters)
    halved, squeezed, _ = _drifts(clusters)
    for world in (halved, squeezed):
        assert packed.schedule(churned, world) == plain.schedule(churned, world)
    assert packed.drift_stats["gated"] >= 1
    payload = packed.snapshot_state()
    assert payload["config"]["score_f16"] is True and payload["config"]["mesh"] == (4, 1)
    fresh = _port(4, score_f16=True)
    fresh.stage_restore(payload, assume_fresh=True)
    assert fresh.schedule(churned, squeezed) == plain.schedule(churned, squeezed)


def test_snapshot_round_trip_sharded():
    units, clusters = _world(b=64)
    src = _port(4)
    want = src.schedule(units, clusters)
    payload = src.snapshot_state()
    assert payload is not None and payload["config"]["mesh"] == (4, 1)
    dst = _port(4)
    dst.stage_restore(payload, assume_fresh=True)
    before = dst.dispatches_total
    assert dst.schedule(units, clusters) == want
    assert dst.restore_info["result"] == "loaded" and dst.restore_info["fresh"] is True
    assert dst.dispatches_total == before, "fresh resume dispatched"
    halved, _, _ = _drifts(clusters)
    single = _port(1)
    single.schedule(units, clusters)
    assert dst.schedule(units, halved) == single.schedule(units, halved)
    assert dst.drift_stats["gated"] >= 1


@pytest.mark.parametrize("src_n,dst_n", [(4, 2), (2, 1), (1, 4)])
def test_snapshot_topology_mismatch_rejected(src_n, dst_n):
    units, clusters = _world(b=64)
    src = _port(src_n)
    want = src.schedule(units, clusters)
    dst = _port(dst_n)
    dst.stage_restore(src.snapshot_state(), assume_fresh=True)
    assert dst.schedule(units, clusters) == want  # a cold solve, the same answer
    assert dst.restore_info["result"] == "rejected"


def test_observe_nsel_aggregates_per_tick():
    """One adaptive-K vote per tick on the aggregate of its pieces, as
    the JAX engine casts it."""
    for eng in (_port(2), JaxEngine(mesh=None, min_bucket=32, flight_recorder=None,
                                    devprof=None)):
        entry = type("E", (), {"pack_k_hint": 64, "pack_shrink_votes": 0})()
        narrow = np.ones(32, np.int64)
        eng._observe_nsel(entry, narrow, 256)
        eng._observe_nsel(entry, narrow, 256)
        eng._flush_nsel()
        assert (entry.pack_shrink_votes, entry.pack_k_hint) == (1, 64)
        eng._observe_nsel(entry, narrow, 256)
        eng._observe_nsel(entry, narrow, 256)
        eng._flush_nsel()
        assert (entry.pack_shrink_votes, entry.pack_k_hint) == (0, 32)


def test_pack_k_hints_equal_single_device():
    units, clusters = _world()
    meshed, single = _port(4), _port(1)
    for _ in range(3):
        assert meshed.schedule(list(units), clusters) == single.schedule(list(units), clusters)
        hints = [(i, e.pack_k_hint, e.pack_shrink_votes)
                 for i, e in sorted(meshed._chunk_cache.items())]
        assert hints == [(i, e.pack_k_hint, e.pack_shrink_votes)
                         for i, e in sorted(single._chunk_cache.items())]


def test_stream_slab_rows_scale_with_objects_axis():
    units, clusters = _world(b=32)
    ref = JaxEngine(mesh=jax_mesh.make_mesh(jax.devices()[:4]), flight_recorder=None,
                    devprof=None)
    from kubeadmiral_tpu.scheduler.streaming import StreamingScheduler as JaxStream

    mine = StreamingScheduler(_port(4), clusters, units)
    theirs = JaxStream(ref, clusters, units)
    assert mine.slab_rows == theirs.slab_rows == 4 * StreamingScheduler(
        _port(1), clusters, units
    ).slab_rows
    assert StreamingScheduler(_port(4), clusters, units, slab_rows=24).slab_rows == 24


@pytest.mark.parametrize("n", [2, 4])
def test_resident_state_bytes_per_device(n):
    units, clusters = _world()
    meshed, single = _port(n), _port(1)
    meshed.schedule(units, clusters)
    single.schedule(units, clusters)
    got, one = meshed.resident_state_bytes(), single.resident_state_bytes()
    assert got["by_family"] == one["by_family"] and got["total"] == one["total"]
    assert got["device_count"] == n and one["device_count"] == 1
    # Every family lies on the lanes, each lane holding its rows; the
    # lanes share the CPU, so each books under "<device>/<lane>".
    lanes = [f"cpu/{i}" for i in range(n)]
    assert one["by_device"] == {"cpu": got["total"]}
    assert sorted(got["by_device"]) == lanes and sum(got["by_device"].values()) == got["total"]
    assert got["prev_planes_by_device"] == {
        lane: got["by_family"]["prev_planes"] // n for lane in lanes
    }
    assert got["per_device"] == max(got["by_device"].values()) == got["total"] // n
    assert one["per_device"] == got["total"]
    model = census.project(len(units), len(clusters), n)
    vec = model["by_family"]["vectors"]
    assert model["layout"] == "rows"
    assert model["per_device"] == (model["total"] - vec) // n + vec < model["total"]


def _entry_tensors(entry) -> dict:
    """Every device tensor a cache entry holds, by name."""
    found = {f"prev_out[{k}]": t for k, t in enumerate(entry.prev_out or ())}
    found.update(prev_feas=entry.prev_feas, prev_reasons=entry.prev_reasons,
                 prev_nfeas=entry.prev_nfeas, prev_sco_exact=entry.prev_sco_exact)
    found.update({f"per_object.{k}": t for k, t in (entry.device_per_object or {}).items()})
    return {k: t for k, t in found.items() if t is not None}


def _assert_on_lanes(engine, n, label):
    """Every cached tensor is a holder with one piece per lane, piece i
    on lane i's device over rows ``row_bounds(B, n)[i]``."""
    for idx, entry in engine._chunk_cache.items():
        b_pad = entry.padded_shape[0]
        for name, t in _entry_tensors(entry).items():
            where = (label, idx, name)
            assert isinstance(t, RowShards), where
            assert t.bounds == row_bounds(b_pad, n) and len(t.pieces) == n, where
            for i, (piece, (lo, hi)) in enumerate(zip(t.pieces, t.bounds)):
                assert piece.shape[0] == hi - lo, where
                assert piece.device == engine.mesh.devices[i, 0], where


def _tensors(value) -> list:
    if isinstance(value, dict):
        value = tuple(value.values())
    if isinstance(value, (tuple, list)):
        return [t for v in value for t in _tensors(v)]
    return [value] if isinstance(value, (torch.Tensor, RowShards)) else []


def _checked_run_rows(monkeypatch):
    """The engine's ``run_rows`` wrapped: no whole argument is a holder
    or a [B, ...] plane (B the row count of any program output so far,
    or a padded chunk row count the caller adds to the returned set; a
    dict of vocabulary tables is not a plane), and every output stays
    on the lanes (nothing joined on one device).  Returns (that set,
    calls)."""
    b_pads: set = set()
    calls = {"run_rows": 0}
    real = engine_mod.run_rows

    def checked(mesh, fn, rows, whole=(), **kw):
        calls["run_rows"] += 1
        for t in _tensors(list(whole)):
            assert not isinstance(t, RowShards)
        for t in whole:
            if isinstance(t, torch.Tensor) and t.dim() >= 2:
                assert t.shape[0] not in b_pads, ("whole plane", tuple(t.shape))
        out = real(mesh, fn, rows, whole, **kw)
        assert all(isinstance(t, RowShards) for t in _tensors(out)), out
        b_pads.update(len(t) for t in _tensors(out) if len(t) >= 32)
        return out

    monkeypatch.setattr(engine_mod, "run_rows", checked)
    return b_pads, calls


def _zero_chain(units, clusters):
    churned = list(units)
    churned[0] = dataclasses.replace(
        churned[0], desired_replicas=(units[0].desired_replicas or 1) + 7
    )
    halved, squeezed, _ = _drifts(clusters)
    return [
        ("cold", units, clusters), ("churn", churned, clusters), ("noop", churned, clusters),
        ("drift", churned, halved), ("drift-zero", churned, drift_zero(clusters)),
        ("fitflip", churned, squeezed), ("back", churned, clusters),
    ]


@pytest.mark.parametrize("n", [2, 4])
def test_state_stays_on_its_shards(n, monkeypatch):
    """Through the chain, each lane's prev planes are the JAX meshed
    engine's prev_planes family divided by N, every cached tensor lies
    on its lanes, results and counters equal the unmeshed port and the
    JAX mesh, no row-wise program's outputs are joined on the engine's
    device, and no [B, ...] plane goes whole to every shard."""
    units, clusters = _world()
    meshed, single, ref = _port(n), _port(1), _jax(n)
    b_pads, calls = _checked_run_rows(monkeypatch)
    for label, batch, cl in _zero_chain(units, clusters):
        got = meshed.schedule(batch, cl)
        assert got == single.schedule(batch, cl), label
        assert [r.clusters for r in got] == [r.clusters for r in ref.schedule(batch, cl)], label
        for name in COUNTERS:
            assert getattr(meshed, name) == getattr(single, name), (label, name)
        for name in JAX_COUNTERS:
            assert getattr(meshed, name) == getattr(ref, name), (label, name)
        _assert_on_lanes(meshed, n, label)
        b_pads |= {e.padded_shape[0] for e in meshed._chunk_cache.values()}
        mine, theirs = meshed.resident_state_bytes(), ref.resident_state_bytes()
        assert theirs["by_family"]["prev_planes"] == mine["by_family"]["prev_planes"], label
        assert mine["prev_planes_by_device"] == {
            f"cpu/{i}": theirs["by_family"]["prev_planes"] // n for i in range(n)
        }, label
        assert mine["by_family"] == single.resident_state_bytes()["by_family"], label
    assert calls["run_rows"] > 0
    assert meshed.drift_stats["unified"] + meshed.drift_stats["unified_fallback"] > 0
    assert meshed.fetch_stats["subbatch"] >= 1 and meshed.fetch_stats["noop"] >= 1


@pytest.mark.parametrize("n", [2, 4])
def test_optin_state_stays_on_its_shards(n, monkeypatch):
    """The opt-in switches keep their state on the lanes too (the f16
    plane and its exactness vector, the dense fetch's gathers, the
    three-stream survivors), under the same run_rows checks."""
    units, clusters = _world()
    b_pads, calls = _checked_run_rows(monkeypatch)
    for switches in ({"score_f16": True}, {"fetch_format": "dense"},
                     {"survivor_unified": False}):
        meshed, single = _port(n, **switches), _port(1, **switches)
        for label, batch, cl in _zero_chain(units, clusters):
            assert meshed.schedule(batch, cl) == single.schedule(batch, cl), (switches, label)
            for name in COUNTERS:
                assert getattr(meshed, name) == getattr(single, name), (switches, label, name)
            _assert_on_lanes(meshed, n, (switches, label))
            b_pads |= {e.padded_shape[0] for e in meshed._chunk_cache.values()}
    assert calls["run_rows"] > 0


def test_ledger_labels_mesh_lane():
    units, clusters = _world()
    ledger = DispatchLedger(enabled=True)
    eng = _port(4, devprof=ledger)
    eng.schedule(units, clusters)
    rows = ledger.waterfall()["ticks"][-1]["records"]
    assert rows and {r["device"] for r in rows} == {"mesh4"}
    single_ledger = DispatchLedger(enabled=True)
    _port(1, devprof=single_ledger).schedule(units, clusters)
    single_rows = single_ledger.waterfall()["ticks"][-1]["records"]
    assert [r["kind"] for r in rows] == [r["kind"] for r in single_rows]
    assert {r["device"] for r in single_rows} == {"d0"}


def test_mesh_resolution():
    """"auto" is one device on the CPU; an explicit mesh is taken, and
    checked against the buckets and the engine's device type."""
    assert SchedulerEngine(device="cpu").mesh is None
    assert SchedulerEngine(device="cpu", mesh=None).mesh is None
    mesh = make_mesh(["cpu"] * 2)
    eng = SchedulerEngine(device="cpu", mesh=mesh)
    assert eng.mesh is mesh and eng.pipeline_depth == 2 * eng.pipeline_depth_per_device
    with pytest.raises(ValueError, match="minimum buckets"):
        SchedulerEngine(device="cpu", mesh=make_mesh(["cpu"] * 8), min_bucket=4)
    with pytest.raises(ValueError, match="mesh"):
        SchedulerEngine(device="cpu", mesh="all")
    # Geometry scales the per-device budgets by the objects axis.
    wide = 20_000
    assert (
        SchedulerEngine(device="cpu", mesh=make_mesh(["cpu"] * 4))._tick_geometry(wide)
        == JaxEngine(mesh=jax_mesh.make_mesh(jax.devices()[:4]), flight_recorder=None,
                     devprof=None)._tick_geometry(wide)
    )
    assert (
        SchedulerEngine(device="cpu", mesh=make_mesh(["cpu"] * 4))._tick_geometry(wide)[1]
        > SchedulerEngine(device="cpu")._tick_geometry(wide)[1]
    )
