"""Durable engine state on the port: snapshot capture, the store and
staged restore, beside the JAX engine.

* ``TestSnapshotStore``: the port's ``runtime/snapshot.py`` store —
  atomic round trip, generation pruning, torn (truncated), CRC-failing,
  bad-magic and future-version files quarantined and never loaded.
* ``TestEngineRestore``: tests/test_restart.py's ``TestEngineRestore``
  cases on the port's ``SchedulerEngine(device="cpu")`` and store — a
  fresh resume replays with no dispatch, a stale one rides the drift
  gate, a churned one re-solves only the changed rows, topology and
  config mismatches reject, a scoreless snapshot never serves scores —
  at the sequential dispatch and, in ``test_case_at_depth_16``, at the
  pipelined window's default depth.
* ``test_payload_equals_jax``: the port's ``snapshot_state()`` equals
  the JAX engine's after the same cold, churn and drift ticks, field by
  field (names, topology fingerprint, cluster view, rows, per chunk the
  row count, format, signatures, score flag, pack-K hints and the six
  planes with JAX's dtypes), ``config`` on every key, at depths 1 and 16.
* ``test_meshed_snapshot_equals_unmeshed``: a meshed engine's payload
  (its planes read lane by lane) equals the unmeshed engine's byte for
  byte, ``config["mesh"]`` aside; it restores into a mesh of N, each
  lane's rows uploaded to its lane, and its planes into no mesh.
* ``TestJaxControlPlane``: the JAX package's ``SnapshotManager`` and
  ``ControllerManager(engine=)`` drive the port's engine through their
  duck-typed surface (``post_tick``, ``last_changed``, ``tick_seq``,
  ``flightrec``, ``snapshot_state``, ``stage_restore``, ``chunk_size``,
  ``prewarm``).
"""

import dataclasses
import os
import pickle
import struct
import sys
import zlib

import numpy as np
import pytest

from test_drift_replan import _fitflip_world, _quarter_cpu
from test_drift_tick import halve_available
from test_engine_cache import make_world
from test_restart import clusters_eq, small_world
from test_torch_engine import _port

from kubeadmiral_tpu.scheduler.engine import SchedulerEngine as JaxEngine
from kubeadmiral_tpu_torch.parallel.mesh import RowShards, make_mesh, row_bounds
from kubeadmiral_tpu_torch.runtime.metrics import Metrics
from kubeadmiral_tpu_torch.runtime.snapshot import SnapshotManager, SnapshotStore
from kubeadmiral_tpu_torch.scheduler.engine import SchedulerEngine

# The pipeline depth of the engines under test (test_case_at_depth_16
# sets 16).
DEPTH = 1

PLANES = {
    "sel": np.int8, "rep": np.int32, "cnt": np.int8,
    "sco": np.int32, "feas": np.int8, "rsn": np.int32,
}


def engine(**kw) -> SchedulerEngine:
    eng = SchedulerEngine(device="cpu", **kw)
    eng.pipeline_depth = DEPTH
    return eng


def converged(units, clusters):
    """An engine after one cold tick, and its snapshot through pickle."""
    eng = engine()
    eng.schedule(units, clusters)
    return eng, pickle.loads(pickle.dumps(eng.snapshot_state()))


class TestSnapshotStore:
    def test_atomic_roundtrip(self, tmp_path):
        store = SnapshotStore(str(tmp_path))
        payload = {"x": np.arange(10), "y": [("a", 1)]}
        store.save(7, payload)
        header, loaded = store.load_latest()
        assert header["tick"] == 7
        assert np.array_equal(loaded["x"], payload["x"])
        assert loaded["y"] == payload["y"]
        assert store.last_bytes > 0

    def test_keep_prunes_old_generations(self, tmp_path):
        store = SnapshotStore(str(tmp_path), keep=2)
        for t in (1, 2, 3, 4):
            store.save(t, {"t": t})
        snaps = sorted(f for f in os.listdir(tmp_path) if f.endswith(".ktsnap"))
        assert len(snaps) == 2
        assert store.load_latest()[0]["tick"] == 4

    @pytest.mark.parametrize(
        "corrupt", ["truncate", "flip-payload", "bad-magic", "bad-version"],
    )
    def test_corrupt_snapshot_quarantined_never_loaded(self, tmp_path, corrupt):
        metrics = Metrics()
        store = SnapshotStore(str(tmp_path), metrics=metrics)
        store.save(1, {"gen": "old"})
        path = store.save(2, {"gen": "new"})
        raw = bytearray(open(path, "rb").read())
        if corrupt == "truncate":  # a torn file
            raw = raw[: len(raw) - 7]
        elif corrupt == "flip-payload":  # the CRC fails
            raw[-1] ^= 0xFF
        elif corrupt == "bad-magic":
            raw[:8] = b"NOTSNAP0"
        else:
            blob = pickle.dumps({"gen": "future"}, protocol=4)
            header = pickle.dumps(
                {"version": 999, "tick": 2, "crc": zlib.crc32(blob),
                 "payload_len": len(blob), "wall": 0.0},
                protocol=4,
            )
            raw = bytearray(b"KTSNAP01" + struct.pack("<Q", len(header)) + header + blob)
        open(path, "wb").write(bytes(raw))
        header, payload = store.load_latest()
        assert payload["gen"] == "old"
        assert os.path.exists(path + ".quarantined")
        assert metrics.get_counter("engine_snapshot_total", result="quarantined") == 1

    def test_all_generations_corrupt_falls_back_cold(self, tmp_path):
        store = SnapshotStore(str(tmp_path))
        path = store.save(1, {"gen": "only"})
        raw = bytearray(open(path, "rb").read())
        raw[-1] ^= 0xFF
        open(path, "wb").write(bytes(raw))
        assert store.load_latest() is None

    def test_write_cut_before_rename_leaves_nothing_loadable(self, tmp_path):
        """A writer killed between the payload and the rename leaves a
        temp file: never loaded, pruned by the next save."""
        store = SnapshotStore(str(tmp_path))
        store.save(1, {"gen": "old"})

        def crash(tmp, final):
            raise KeyboardInterrupt  # stands in for the kill

        store._publish = crash
        with pytest.raises(KeyboardInterrupt):
            store.save(2, {"gen": "new"})
        assert any(".tmp." in f for f in os.listdir(tmp_path))
        assert store.load_latest()[1]["gen"] == "old"
        del store._publish
        store.save(3, {"gen": "newer"})
        assert not any(".tmp." in f for f in os.listdir(tmp_path))


class TestEngineRestore:
    def test_fresh_resume_rides_noop_replay_zero_dispatches(self, tmp_path):
        units, clusters = small_world()
        e1, snap = converged(units, clusters)
        r1 = e1.schedule(units, clusters)

        units2, clusters2 = small_world()  # a relist: new objects, same world
        e2 = engine()
        e2.stage_restore(snap, assume_fresh=True)
        d0 = e2.dispatches_total
        r2 = e2.schedule(units2, clusters2)
        assert e2.restore_info["result"] == "loaded"
        assert e2.restore_info["fresh"] is True
        assert e2.dispatches_total == d0, "fresh resume must not dispatch"
        assert e2.fetch_stats["noop"] >= 1
        assert clusters_eq(r1, r2)

    def test_stale_resume_revalidates_through_drift_paths(self, tmp_path):
        units, clusters = small_world()
        _e1, snap = converged(units, clusters)

        units2, clusters2 = small_world()
        clusters2[0] = halve_available(clusters2[0])
        e2 = engine()
        e2.stage_restore(snap)
        r2 = e2.schedule(units2, clusters2)
        assert e2.restore_info["result"] == "loaded"
        assert e2.restore_info["fresh"] is False
        assert e2.drift_stats["gated"] >= 1, "stale resume must ride the gate"
        assert clusters_eq(engine().schedule(units2, clusters2), r2)

    def test_churned_resume_resolves_only_changed_rows(self, tmp_path):
        units, clusters = small_world()
        _e1, snap = converged(units, clusters)

        units2, clusters2 = small_world()
        changed = (3, 17, 100)
        for i in changed:
            units2[i] = dataclasses.replace(
                units2[i], desired_replicas=(units2[i].desired_replicas or 1) + 9
            )
        e2 = engine()
        e2.stage_restore(snap)
        r2 = e2.schedule(units2, clusters2)
        assert e2.restore_info["result"] == "loaded"
        assert e2.fetch_stats["subbatch"] >= 1
        assert set(e2.last_changed) == set(changed)
        assert clusters_eq(engine().schedule(units2, clusters2), r2)

    def test_topology_change_rejects_to_cold(self, tmp_path):
        units, clusters = small_world()
        _e1, snap = converged(units, clusters)
        units2, clusters2 = small_world()
        clusters2[0] = dataclasses.replace(clusters2[0], labels={"region": "mars"})
        e2 = engine()
        e2.stage_restore(snap)
        r2 = e2.schedule(units2, clusters2)
        assert e2.restore_info["result"] == "rejected"
        assert clusters_eq(engine().schedule(units2, clusters2), r2)

    def test_config_mismatch_rejects(self, tmp_path):
        units, clusters = small_world()
        _e1, snap = converged(units, clusters)
        snap["config"] = dict(snap["config"], narrow_m=999)
        e2 = engine(metrics=Metrics())
        e2.stage_restore(snap)
        e2.schedule(*small_world())
        assert e2.restore_info["result"] == "rejected"
        assert e2.metrics.get_counter("engine_snapshot_total", result="rejected") == 1

    def test_want_scores_not_served_by_scoreless_snapshot(self, tmp_path):
        units, clusters = small_world(n=80)
        _e1, snap = converged(units, clusters)
        e2 = engine()
        e2.stage_restore(snap)
        r2 = e2.schedule(*small_world(n=80), want_scores=True)
        ref = engine().schedule(*small_world(n=80), want_scores=True)
        assert clusters_eq(ref, r2)
        assert all(a.scores == b.scores for a, b in zip(ref, r2))

    def test_snapshot_manager_end_to_end_via_store(self, tmp_path):
        units, clusters = small_world()
        metrics = Metrics()
        e1 = engine(metrics=metrics)
        store = SnapshotStore(str(tmp_path), metrics=metrics)
        SnapshotManager(e1, store, every=1, flightrec=None)
        r1 = e1.schedule(units, clusters)
        assert store.load_latest() is not None

        e2 = engine()
        mgr2 = SnapshotManager(e2, store, flightrec=None)
        assert mgr2.restore() == "staged"
        r2 = e2.schedule(*small_world())
        assert e2.restore_info["result"] == "loaded"
        assert clusters_eq(r1, r2)


def test_broken_payload_rejects_and_solves_cold(caplog):
    """A payload that raises inside the restore is counted rejected and
    the tick solves cold, with a fresh engine's results."""
    units, clusters = small_world()
    _e1, snap = converged(units, clusters)
    del snap["view"]
    e2 = engine(metrics=Metrics())
    e2.stage_restore(snap)
    with caplog.at_level("WARNING", logger="kubeadmiral.engine"):
        r2 = e2.schedule(*small_world())
    assert "snapshot restore failed" in caplog.text
    assert e2.restore_info["result"] == "rejected"
    assert e2.metrics.get_counter("engine_snapshot_total", result="rejected") == 1
    assert e2.cache_stats["miss"] == 1 and e2.dispatches_total == 1
    assert clusters_eq(engine().schedule(*small_world()), r2)


_CASES = [
    pytest.param(getattr(TestEngineRestore(), name), id=name)
    for name in sorted(vars(TestEngineRestore))
    if name.startswith("test_")
]


@pytest.mark.parametrize("case", _CASES)
def test_case_at_depth_16(case, monkeypatch, tmp_path):
    """Every TestEngineRestore case at the pipelined window's depth."""
    monkeypatch.setattr(sys.modules[__name__], "DEPTH", 16)
    case(tmp_path)


# -- the payload against the JAX engine's -----------------------------------
WORLDS = {
    # Narrow chunks (bucket 32 above M = 16), three of them.
    "narrow": (
        lambda: _fitflip_world(b=300, c=24),
        dict(chunk_size=128, min_bucket=32, min_cluster_bucket=8, narrow_m=16),
    ),
    # Dense chunks (bucket 8 under M), four of them.
    "dense": (lambda: make_world(b=100, c=6), dict(chunk_size=32, min_bucket=8)),
}


def assert_payload_equal(got, want):
    assert got is not None and want is not None
    assert got.keys() == want.keys()
    assert got["config"] == want["config"]
    for key in ("version", "tick", "names", "topo_fp", "rows"):
        assert got[key] == want[key], key
    for key, arr in want["view"].items():
        assert np.array_equal(got["view"][key], arr), key
    assert got["chunks"].keys() == want["chunks"].keys()
    for idx, w in want["chunks"].items():
        g = got["chunks"][idx]
        assert g.keys() == w.keys(), idx
        for key in ("n", "fmt", "sigs", "has_scores", "pack_k_hint", "pack_shrink_votes"):
            assert g[key] == w[key], (idx, key)
        for key, dtype in PLANES.items():
            assert g[key].dtype == w[key].dtype == dtype, (idx, key)
            assert np.array_equal(g[key], w[key]), (idx, key)


@pytest.mark.parametrize("depth", [1, 16])
@pytest.mark.parametrize("world", sorted(WORLDS))
def test_payload_equals_jax(world, depth, monkeypatch):
    make, kw = WORLDS[world]
    monkeypatch.setenv("KT_PIPELINE_DEPTH", str(depth))
    ref = JaxEngine(mesh=None, flight_recorder=None, devprof=None, **kw)
    port = _port(**kw)
    port.pipeline_depth = depth
    units, clusters = make()
    churned = list(units)
    for i in range(0, len(units), 37):
        churned[i] = dataclasses.replace(
            churned[i], desired_replicas=(churned[i].desired_replicas or 1) + 3
        )
    drifted = [halve_available(c) if j == 0 else c for j, c in enumerate(clusters)]
    fit_flip = _quarter_cpu(drifted, 3)
    for us, cs in ((units, clusters), (churned, clusters), (churned, drifted),
                   (churned, fit_flip)):
        got = port.schedule(us, cs)
        assert clusters_eq(got, ref.schedule(us, cs))
        assert_payload_equal(port.snapshot_state(), ref.snapshot_state())
    assert port.drift_stats["gated"] >= 1


def test_f16_payload_equals_jax(monkeypatch):
    """Under f16 score planes (the JAX engine's KT_SCORE_F16): the
    payload carries the f16 plane and the exactness vector, equal to the
    JAX engine's, through cold, churn, drift and fit-flip ticks; the
    config says so."""
    make, kw = WORLDS["narrow"]
    monkeypatch.setenv("KT_SCORE_F16", "1")
    ref = JaxEngine(mesh=None, flight_recorder=None, devprof=None, **kw)
    port = _port(**kw)
    port.score_f16 = True
    units, clusters = make()
    churned = list(units)
    churned[5] = dataclasses.replace(churned[5], desired_replicas=61)
    drifted = [halve_available(c) if j == 0 else c for j, c in enumerate(clusters)]
    for us, cs in ((units, clusters), (churned, clusters), (churned, drifted),
                   (churned, _quarter_cpu(drifted, 3))):
        assert clusters_eq(port.schedule(us, cs), ref.schedule(us, cs))
        got, want = port.snapshot_state(), ref.snapshot_state()
        assert got["config"] == want["config"] and got["config"]["score_f16"] is True
        assert got["chunks"].keys() == want["chunks"].keys()
        for idx, w in want["chunks"].items():
            g = got["chunks"][idx]
            assert g.keys() == w.keys(), idx
            assert g["sco"].dtype == w["sco"].dtype == np.float16
            assert np.array_equal(g["sco"].view(np.uint16), w["sco"].view(np.uint16)), idx
            assert np.array_equal(g["sco_exact"], w["sco_exact"]), idx
            for key in ("sel", "rep", "cnt", "feas", "rsn"):
                assert np.array_equal(g[key], w[key]), (idx, key)


def assert_same_bytes(got, want):
    """Two payloads equal key for key; every array by dtype and bytes."""
    assert got.keys() == want.keys()
    for key in got:
        if key == "chunks":
            assert got[key].keys() == want[key].keys()
            for idx, w in want[key].items():
                assert_same_bytes(got[key][idx], w)
        elif isinstance(want[key], dict) and key == "view":
            assert_same_bytes(got[key], want[key])
        elif isinstance(want[key], np.ndarray):
            assert got[key].dtype == want[key].dtype, key
            assert got[key].shape == want[key].shape, key
            assert got[key].tobytes() == want[key].tobytes(), key
        else:
            assert got[key] == want[key], key


@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("f16", [False, True])
def test_meshed_snapshot_equals_unmeshed(n, f16):
    make, kw = WORLDS["narrow"]
    units, clusters = make()
    churned = list(units)
    churned[5] = dataclasses.replace(churned[5], desired_replicas=61)
    drifted = [halve_available(c) if j == 0 else c for j, c in enumerate(clusters)]
    meshed = engine(mesh=make_mesh(["cpu"] * n), score_f16=f16, **kw)
    single = engine(score_f16=f16, **kw)
    for us, cs in ((units, clusters), (churned, clusters), (churned, drifted)):
        assert clusters_eq(meshed.schedule(us, cs), single.schedule(us, cs))
        got, want = meshed.snapshot_state(), single.snapshot_state()
        assert got["config"] == dict(want["config"], mesh=(n, 1))
        assert_same_bytes(dict(got, config=want["config"]), want)
    payload = pickle.loads(pickle.dumps(got))
    # Into a mesh of N: a fresh resume, nothing launched, each lane's
    # rows on its lane.
    dst = engine(mesh=make_mesh(["cpu"] * n), score_f16=f16, **kw)
    dst.stage_restore(payload, assume_fresh=True)
    before = dst.dispatches_total
    assert clusters_eq(dst.schedule(churned, drifted), single.schedule(churned, drifted))
    assert dst.restore_info["result"] == "loaded" and dst.restore_info["fresh"]
    assert dst.dispatches_total == before
    for entry in dst._chunk_cache.values():
        for t in entry.prev_out + (entry.prev_feas, entry.prev_reasons, entry.prev_nfeas):
            assert isinstance(t, RowShards) and t.bounds == row_bounds(entry.padded_shape[0], n)
    assert_same_bytes(dict(dst.snapshot_state(), config=want["config"], tick=want["tick"]), want)
    # Into no mesh: the same planes, under an unmeshed config.
    flat = engine(score_f16=f16, **kw)
    flat.stage_restore(dict(payload, config=dict(payload["config"], mesh=None)),
                       assume_fresh=True)
    before = flat.dispatches_total
    assert clusters_eq(flat.schedule(churned, drifted), single.schedule(churned, drifted))
    assert flat.restore_info["result"] == "loaded" and flat.dispatches_total == before
    assert_same_bytes(dict(flat.snapshot_state(), tick=want["tick"]), want)


@pytest.mark.parametrize("f16_side", ["giver", "taker"])
def test_f16_snapshot_restores_only_into_an_f16_engine(f16_side):
    """A snapshot of an f16 engine is rejected by a default engine, and
    a default engine's by an f16 engine; an f16 engine takes its own."""
    units, clusters = small_world()
    giver = engine(score_f16=f16_side == "giver")
    giver.schedule(units, clusters)
    snap = pickle.loads(pickle.dumps(giver.snapshot_state()))
    taker = engine(score_f16=f16_side == "taker")
    taker.stage_restore(snap)
    assert clusters_eq(taker.schedule(units, clusters), giver.schedule(units, clusters))
    assert taker.restore_info["result"] == "rejected"
    same = engine(score_f16=f16_side == "giver")
    same.stage_restore(snap)
    same.schedule(units, clusters)
    assert same.restore_info["result"] == "loaded" and same.restore_info["fresh"]


# -- the JAX control plane drives the port's engine ------------------------
class TestJaxControlPlane:
    def test_jax_snapshot_manager_captures_and_restores_port_engine(self, tmp_path):
        from kubeadmiral_tpu.runtime.snapshot import (
            SnapshotManager as JaxSnapshotManager,
            SnapshotStore as JaxSnapshotStore,
        )
        from kubeadmiral_tpu_torch.runtime.flightrec import FlightRecorder

        units, clusters = small_world()
        e1 = SchedulerEngine(device="cpu", flight_recorder=FlightRecorder())
        store = JaxSnapshotStore(str(tmp_path))
        JaxSnapshotManager(e1, store, every=1)
        r1 = e1.schedule(units, clusters)
        header, payload = store.load_latest()
        assert header["tick"] == e1.tick_seq == 1
        assert payload["flightrec"]["ticks"], "the engine's recorder rides along"

        e2 = SchedulerEngine(device="cpu", flight_recorder=FlightRecorder())
        mgr2 = JaxSnapshotManager(e2, store)
        assert mgr2.restore() == "staged"
        units2, clusters2 = small_world()
        r2 = e2.schedule(units2, clusters2)
        assert e2.restore_info["result"] == "loaded"
        assert clusters_eq(r1, r2)
        got, want = e2.flightrec.explain(units2[5].key), e1.flightrec.explain(units2[5].key)
        got.pop("age_seconds"), want.pop("age_seconds")
        assert got == want

    def test_controller_manager_writes_final_snapshot(self, tmp_path, monkeypatch):
        monkeypatch.setenv("KT_SNAPSHOT_DIR", str(tmp_path))
        from kubeadmiral_tpu.runtime.manager import ControllerManager
        from kubeadmiral_tpu.testing.fakekube import ClusterFleet

        fleet = ClusterFleet()
        fleet.add_member("c1")
        port = SchedulerEngine(device="cpu")
        manager = ControllerManager(fleet, engine=port)
        assert manager.engine is port and manager.snapshots is not None
        # The manager's prewarm call, on the port a build (none on the CPU).
        thread = port.prewarm(
            port.chunk_size, 1, scalar_resources=[], key_len=32, webhooks=False
        )
        thread.join()
        port.schedule(*small_world(n=32, c=4))
        summary = manager.shutdown(deadline_s=5.0)
        assert summary["snapshot"] is not None
        assert manager.snapshots.store.load_latest() is not None

        m2 = ControllerManager(ClusterFleet(), engine=SchedulerEngine(device="cpu"))
        assert m2.snapshots.restore() == "staged"
        m2.engine.schedule(*small_world(n=32, c=4))
        assert m2.engine.restore_info["result"] == "loaded"
        assert m2.engine.restore_info["fresh"] is True
