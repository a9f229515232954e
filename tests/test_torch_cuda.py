"""The port on the card: the phase-1 CUDA kernel against its plain twin,
the whole dense tick on CUDA against the CPU, and the engine on CUDA
against the CPU engine (cold, warm and drift ticks, with their
counters; the pipelined window on the card against the CPU engine's
sequential dispatch; score-carrying and webhook ticks) — tolerance 0
(integer math) — the window's dispatch of a chunk making no host
synchronisation, and durable state on the card: a fresh resume from a
snapshot launching nothing, a stale one through the drift gate, and a
kill-matrix round (``testing/restart_driver.py`` on ``--device cuda``);
the control plane with sync writing to the members, and the streaming
front end's flushes (the dirty-row hint on the card), each equal to
the CPU engine's; the three-stream survivor programs and the f16
score compressor on CUDA tensors against their CPU results, and the
engine under each opt-in switch on the card against the CPU engine
with the same switch; engines over meshes of 2 and 4 logical devices on
the card against the CPU engine, each lane's resident rows on its lane,
with no host synchronisation in a meshed window dispatch; over several
cards (where the machine has them) each lane's state on its own card;
the memory census against the card's buffers; the split phase-1 pair
(``kt_phase1_partial`` then ``kt_phase1_finish`` over column blocks)
against its plain twins and against the kernel on whole rows, and an
engine over a (2, 2) logical mesh on the card (each entry a column
block of every [B, C] plane) against the CPU engine;
the geometry keywords on the card; the native host library built on
the card's machine.

Every test here needs a CUDA card and skips without one.  The file
imports neither JAX nor the JAX package, so it also runs on a machine
without them (the repo's conftest imports JAX; skip it there):

    python -m pytest --noconftest -q -m cuda tests/test_torch_cuda.py
"""

import json
import math
import os
import pickle
import subprocess
import sys

import numpy as np
import pytest
import torch

from kubeadmiral_tpu_torch.convert import to_device, to_numpy
from kubeadmiral_tpu_torch.ops.phase1 import phase1, phase1_plain
from kubeadmiral_tpu_torch.ops import pipeline as P
from kubeadmiral_tpu_torch.ops.pipeline import schedule_tick
from kubeadmiral_tpu_torch.scheduler.engine import SchedulerEngine
from kubeadmiral_tpu_torch.testing.problems import (
    EDGE_SHAPES,
    edge_tick_inputs,
    random_tick_inputs,
    split_edge_inputs,
)
from kubeadmiral_tpu_torch.testing.sample_counts import recorded_dispatches
from kubeadmiral_tpu_torch.testing.syncs import first_chunk_syncs
from kubeadmiral_tpu_torch.testing.worlds import (
    SHAPES,
    build_world,
    churn,
    drift,
    drift_fitflip,
    drift_wide,
    drift_zero,
    webhook,
)

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernel has no CPU mode)")
    return torch.device("cuda")


CASES = [
    # b, c, webhook, invalid columns, byte-scale resources
    (16, 24, False, 0, False),
    (32, 12, True, 3, False),
    (13, 40, False, 0, False),   # odd B
    (8, 200, True, 7, False),
    (21, 64, True, 5, False),
    (24, 33, False, 2, True),    # byte-scale resources (range shift)
    (3, 1300, True, 11, False),  # C past one block's threads many times
]


@pytest.mark.parametrize("b,c,webhook,invalid,scale", CASES)
def test_kernel_matches_plain(cuda, b, c, webhook, invalid, scale):
    inp = to_device(random_tick_inputs(b, c, 4, webhook, invalid, scale), cuda)
    launches = phase1.launches
    got = phase1(inp)
    want = phase1_plain(inp)
    torch.cuda.synchronize()
    assert phase1.launches == launches + 1
    for name, g, w in zip(("feasible", "reasons", "totals"), got, want):
        assert g.dtype == w.dtype and torch.equal(g, w), name


# The kernel's edges (testing/problems.py:EDGE_SHAPES, the inputs
# tests/test_torch_phase1.py holds against JAX and chip_smoke.py runs).
def _assert_kernel_matches_plain(inp):
    launches = phase1.launches
    got = phase1(inp)
    want = phase1_plain(inp)
    torch.cuda.synchronize()
    assert phase1.launches == launches + 1
    for name, g, w in zip(("feasible", "reasons", "totals"), got, want):
        assert g.dtype == w.dtype and torch.equal(g, w), name


@pytest.mark.parametrize("b,c,r,invalid,seed", EDGE_SHAPES)
def test_kernel_matches_plain_on_edges(cuda, b, c, r, invalid, seed):
    _assert_kernel_matches_plain(to_device(edge_tick_inputs(b, c, r, invalid, seed), cuda))


@pytest.mark.parametrize("c", [36, 5124])
def test_kernel_matches_plain_on_unaligned_rows(cuda, c):
    # Every plane a view one row in: C % 4 == 0, but the planes do not
    # all start 16-byte aligned, so the kernel loads cell by cell.
    host = edge_tick_inputs(9, c, 3, 0.05, seed=9)
    full = to_device(host, cuda)
    per_row = {k for k, v in full._asdict().items() if v.shape[:1] == (9,)}
    inp = full._replace(**{k: getattr(full, k)[1:] for k in per_row})
    _assert_kernel_matches_plain(inp)


def test_kernel_refuses_int64_score_planes(cuda):
    inp = to_device(random_tick_inputs(8, 16), cuda)
    wide = inp._replace(taint_counts=inp.taint_counts.to(torch.int64))
    with pytest.raises(ValueError, match="taint_counts"):
        phase1(wide)


@pytest.mark.parametrize("b,c,webhook,invalid,scale", CASES)
def test_schedule_tick_on_card_matches_cpu(cuda, b, c, webhook, invalid, scale):
    host = random_tick_inputs(b, c, 4, webhook, invalid, scale, seed=1)
    got = to_numpy(schedule_tick(to_device(host, cuda)))
    want = to_numpy(schedule_tick(to_device(host, "cpu")))
    for name in want._fields:
        g, w = getattr(got, name), getattr(want, name)
        assert g.dtype == w.dtype and np.array_equal(g, w), name


@pytest.mark.parametrize("config", ["3", "5"])
def test_engine_on_card_matches_cpu(cuda, config, monkeypatch):
    units, clusters, _ = build_world(700, 600, config, seed=3)
    engine = SchedulerEngine(chunk_size=256)  # several chunks
    launches = phase1.launches
    got = engine.schedule(units, clusters)
    chunks = math.ceil(len(units) / engine._tick_geometry(len(clusters))[1])
    assert chunks > 1 and phase1.launches - launches == chunks
    want = SchedulerEngine(device="cpu", chunk_size=256).schedule(units, clusters)
    assert [r.clusters for r in got] == [r.clusters for r in want]


@pytest.mark.parametrize("config", ["3", "5"])
def test_warm_sequence_on_card_matches_cpu(cuda, config, monkeypatch):
    """Cold, churn, no-op, drift, back and churn ticks on one engine on
    the card and one on the CPU: equal results, cache, fetch, drift-gate
    and survivor counters and changed rows at every tick; every tick
    dispatch launches the kernel once and nothing else does; no-op ticks
    launch nothing, cold and churn ticks launch the kernel."""
    units, clusters, _ = build_world(700, 600, config, seed=3)
    # Several chunks.
    gpu, cpu = SchedulerEngine(chunk_size=256), SchedulerEngine(device="cpu", chunk_size=256)
    rng = np.random.default_rng(0)
    churned = churn(rng, units, fraction=0.02)
    drifted = drift(clusters)
    for kind, batch, cl in (
        ("cold", units, clusters),
        ("churn", churned, clusters),
        ("noop", churned, clusters),
        ("drift", churned, drifted),
        ("back", churned, clusters),
        ("churn", churn(rng, churned, fraction=0.02), clusters),
    ):
        with recorded_dispatches() as calls:
            launches = phase1.launches
            got = gpu.schedule(batch, cl)
            launched = phase1.launches - launches
        want = cpu.schedule(batch, cl)
        assert [r.clusters for r in got] == [r.clusters for r in want], kind
        for name in ("cache_stats", "fetch_stats", "drift_stats", "survivor_stats"):
            assert getattr(gpu, name) == getattr(cpu, name), (kind, name)
        assert gpu.last_changed == cpu.last_changed, kind
        assert launched == len(calls), kind
        if kind == "noop":
            assert launched == 0
        elif kind in ("cold", "churn"):
            assert launched > 0, kind


@pytest.mark.parametrize("shape", ["drift", "drift_zero", "drift_wide"])
@pytest.mark.parametrize("config", ["3", "5"])
def test_drift_tick_on_card_matches_cpu(cuda, config, shape, monkeypatch):
    """A drift tick and a tick back after a cold tick, on the card and on
    the CPU: equal results, ``last_changed``, drift-gate, survivor,
    narrow, cache and fetch counters; the kernel launches once per tick
    dispatch (recompute slabs, mass-change and ungated chunks,
    certificate fallbacks) and the drift uploads no per-object input."""
    units, clusters, _ = build_world(700, 600, config, seed=4)
    # Several chunks.
    gpu, cpu = SchedulerEngine(chunk_size=256), SchedulerEngine(device="cpu", chunk_size=256)
    drifted = {"drift": drift, "drift_zero": drift_zero, "drift_wide": drift_wide}[shape](clusters)
    for kind, cl in (("cold", clusters), (shape, drifted), ("back", clusters)):
        upload = gpu.upload_bytes["object"]
        with recorded_dispatches() as calls:
            launches = phase1.launches
            got = gpu.schedule(units, cl)
            launched = phase1.launches - launches
        want = cpu.schedule(units, cl)
        assert [r.clusters for r in got] == [r.clusters for r in want], kind
        for name in ("cache_stats", "fetch_stats", "drift_stats", "survivor_stats", "narrow_stats"):
            assert getattr(gpu, name) == getattr(cpu, name), (kind, name)
        assert gpu.last_changed == cpu.last_changed, kind
        assert launched == len(calls), kind
        if kind != "cold":
            assert gpu.upload_bytes["object"] == upload, kind
    if shape != "drift_wide":
        assert gpu.drift_stats["gated"] > 0


def test_c3_cold_tick_in_the_window_matches_cpu_at_depth_1(cuda, monkeypatch):
    """A c3-sample cold tick through the pipelined window on the card
    (the default depth 16, six chunks in one window) against the CPU
    engine's sequential dispatch: equal results, ``last_changed``, pack-K
    hints, overflow rows and narrow, cache and fetch counters; the kernel
    launches once per tick dispatch: chunks, certificate fallbacks and
    planner re-dispatches."""
    units, clusters, _ = build_world(3000, SHAPES["3"][1], "3", seed=5)
    gpu, cpu = SchedulerEngine(chunk_size=512), SchedulerEngine(device="cpu", chunk_size=512)
    assert gpu.pipeline_depth == 16
    cpu.pipeline_depth = 1
    with recorded_dispatches() as calls:
        launches = phase1.launches
        got = gpu.schedule(units, clusters)
        launched = phase1.launches - launches
    want = cpu.schedule(units, clusters)
    assert [r.clusters for r in got] == [r.clusters for r in want]
    for name in ("cache_stats", "fetch_stats", "narrow_stats", "drift_stats", "survivor_stats"):
        assert getattr(gpu, name) == getattr(cpu, name), name
    assert gpu.last_changed == cpu.last_changed
    assert gpu.overflow_rows_total == cpu.overflow_rows_total
    hints = [[e.pack_k_hint for _, e in sorted(x._chunk_cache.items())] for x in (gpu, cpu)]
    assert hints[0] == hints[1]
    chunks = math.ceil(len(units) / gpu._tick_geometry(len(clusters))[1])
    narrow = [c for c in calls if c[0] == "narrow"]
    assert chunks == 6 and len(narrow) == chunks + gpu.planner_reruns
    assert launched == len(calls)


@pytest.mark.parametrize("config", ["3", "5"])
def test_scores_and_webhook_ticks_on_card_match_cpu(cuda, config, monkeypatch):
    """A want_scores cold tick, a webhook tick with scores (dense planes,
    certificate fallbacks from huge webhook scores) and a plain tick
    after it, on the card and on the CPU: equal results and score
    dicts, equal narrow, cache and fetch counters; the kernel launches
    once per tick dispatch, and the plain tick launches nothing."""
    units, clusters, _ = build_world(700, 600, config, seed=7)
    # Several chunks.
    gpu, cpu = SchedulerEngine(chunk_size=256), SchedulerEngine(device="cpu", chunk_size=256)
    hook = webhook(seed=7, huge_every=16)
    for kind, batch, kw in (
        ("scores", units, {"want_scores": True}),
        ("webhook", units[:500], {"want_scores": True, "webhook_eval": hook}),
        ("plain", units, {}),
    ):
        with recorded_dispatches() as calls:
            launches = phase1.launches
            got = gpu.schedule(batch, clusters, **kw)
            launched = phase1.launches - launches
        want = cpu.schedule(batch, clusters, **kw)
        assert [(r.clusters, r.scores) for r in got] == [
            (r.clusters, r.scores) for r in want
        ], kind
        for name in ("cache_stats", "fetch_stats", "narrow_stats"):
            assert getattr(gpu, name) == getattr(cpu, name), (kind, name)
        assert launched == len(calls), kind
        if kind == "webhook":
            assert any(c[0] == "dense" for c in calls)  # certificate fallbacks
        if kind == "plain":
            assert launched == 0
        else:
            assert any(r.scores for r in got) and launched > 0, kind


@pytest.mark.parametrize("config", ["3", "5"])
def test_window_dispatch_makes_no_host_sync(cuda, config):
    """The window's dispatch of a chunk (uploads, expansion, the narrow
    tick under the planner's round budget) raises nothing under
    ``torch.cuda.set_sync_debug_mode("error")``.  The sequential
    dispatch reads the planner's loop condition once a round, and waits
    nowhere else."""
    units, clusters, _ = build_world(600, SHAPES[config][1], config, seed=6)
    assert first_chunk_syncs(units, clusters, windowed=True, mode="error")["sites"] == []
    sites = first_chunk_syncs(units, clusters, windowed=False)["sites"]
    assert sites and all("ops/planner.py" in site for site in sites), sites


def test_resume_from_snapshot_on_card(cuda, monkeypatch):
    """A cold tick on the card, its snapshot through pickle, then fresh
    engines on the card staged with it: the fresh resume's tick launches
    nothing and dispatches nothing, with the cold tick's results; a
    stale resume (cluster 0's available halved) rides the drift gate
    and equals a fresh engine's cold tick on that world."""
    units, clusters, _ = build_world(700, 600, "3", seed=8)
    cold = SchedulerEngine(chunk_size=256)  # several chunks
    want = cold.schedule(units, clusters)
    snap = pickle.loads(pickle.dumps(cold.snapshot_state()))
    assert len(snap["chunks"]) > 1
    fresh = SchedulerEngine(chunk_size=256)
    fresh.stage_restore(snap, assume_fresh=True)
    launches = phase1.launches
    got = fresh.schedule(list(units), clusters)
    assert phase1.launches == launches and fresh.dispatches_total == 0
    assert fresh.restore_info["result"] == "loaded" and fresh.restore_info["fresh"]
    assert fresh.fetch_stats["noop"] == len(snap["chunks"])
    assert [r.clusters for r in got] == [r.clusters for r in want]
    drifted = drift(clusters)
    stale = SchedulerEngine(chunk_size=256)
    stale.stage_restore(snap)
    got = stale.schedule(units, drifted)
    assert stale.restore_info["result"] == "loaded" and not stale.restore_info["fresh"]
    assert stale.drift_stats["gated"] >= 1
    want = SchedulerEngine(chunk_size=256).schedule(units, drifted)
    assert [r.clusters for r in got] == [r.clusters for r in want]


def test_kill_round_on_card(cuda, tmp_path):
    """The snapshot-write round of the kill matrix with every process on
    the card: the successor loads and converges to the reference's
    placements and flight-recorder reason counts."""
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

    def run(mode, workdir, *args):
        return subprocess.run(
            [sys.executable, "-m", "kubeadmiral_tpu_torch.testing.restart_driver",
             mode, "--dir", str(tmp_path / workdir), "--device", "cuda",
             "--objects", "600", "--clusters", "300", *args],
            cwd=repo, env=dict(os.environ, PYTHONPATH=repo),
            capture_output=True, text=True, timeout=600,
        )

    assert run("reference", "reference").returncode == 0
    assert run("victim", "kill", "--kill-phase", "snapshot-write").returncode == -9
    proc = run("successor", "kill")
    assert proc.returncode == 0, proc.stderr
    ref = json.load(open(tmp_path / "reference" / "reference.json"))
    succ = json.load(open(tmp_path / "kill" / "successor.json"))
    assert succ["restore_info"]["result"] == "loaded"
    assert succ["placements"] == ref["placements"]
    assert succ["reason_counts"] == ref["reason_counts"]
    assert succ["quarantined"] == []


def test_control_plane_on_card_matches_cpu(cuda):
    """The JAX manager's controller set over the card's engine (the
    plane's default) through the seven rounds of ``testing/cpworld.py``
    at 200 Deployments x 16 clusters: every round's host and member
    stores equal the same rounds' over the CPU engine, object for object
    (wall-clock fields masked), the cold, follow and migrate rounds'
    ticks launch the kernel, and auto-migration writes the stuck
    objects' capacity."""
    from kubeadmiral_tpu_torch.testing import cpworld

    card = cpworld.ControlPlane()
    assert card.engine.device.type == "cuda"
    got = cpworld.run_rounds(card, objects=200, clusters=16)
    want = cpworld.run_rounds(
        cpworld.ControlPlane(engine=SchedulerEngine(device="cpu")), objects=200, clusters=16
    )
    for name in cpworld.ROUNDS:
        assert cpworld.digest_diff(got[name]["digests"], want[name]["digests"]) == [], name
    assert got["cold"]["phase1_launches"] >= 1
    assert got["noop"]["phase1_launches"] == 0
    assert got["cold"]["pairs"] == want["cold"]["pairs"] == got["cold"]["member_objects"] > 0
    assert got["noop"]["member_writes"] == 0
    assert got["follow"]["phase1_launches"] >= 1 and got["migrate"]["phase1_launches"] >= 1
    assert got["migrate"]["estimated_capacity"] == want["migrate"]["estimated_capacity"] > 0


def test_stream_on_card_matches_cpu(cuda):
    """The streaming front end over the card's engine (the default) and
    over the CPU engine, fed one seeded event log (``testing/worlds.py``:
    arrivals, updates, a capacity drift) at 200 x 16 in 10 flushes of
    24 events: every flush's results are equal, every flush after the
    first hands the card's engine the dirty-row hint, and the churn
    flushes launch the kernel."""
    from kubeadmiral_tpu_torch.scheduler.streaming import StreamingScheduler
    from kubeadmiral_tpu_torch.testing.worlds import capacity_drift, stream_event

    units, clusters, _ = build_world(200, 16, config="3", seed=0)
    card = StreamingScheduler(SchedulerEngine(), clusters, units, slab_rows=24)
    host = StreamingScheduler(SchedulerEngine(device="cpu"), clusters, units, slab_rows=24)
    assert card.engine.device.type == "cuda"
    hints = []
    schedule = card.engine.schedule

    def spy(u, c, **kw):
        hints.append(kw.get("dirty_rows"))
        return schedule(u, c, **kw)

    card.engine.schedule = spy
    rng = np.random.default_rng(0)
    launches = []
    for flush in range(10):
        if flush:
            events = [stream_event(rng, units, 24 * flush + k) for k in range(24)]
            for s in (card, host):
                for ev in events:
                    s.offer(ev)
            if flush % 5 == 0:
                drifted = capacity_drift(rng, card.clusters)
                for s in (card, host):
                    s.update_cluster(drifted)
        phase1.launches = 0
        got = card.pump() if flush else card.flush()
        launches.append(phase1.launches)
        want = host.pump() if flush else host.flush()
        assert got is not None and want is not None
        assert [r.clusters for r in got] == [r.clusters for r in want]
    assert hints[0] is None and all(h is not None for h in hints[1:])
    assert launches[0] >= 1 and all(n >= 1 for n in launches[1:]), launches
    assert len(card.units) > len(units)  # the arrivals grew the placeholder block


def test_optin_programs_on_card_match_cpu(cuda):
    """drift_resolve (three changed columns in eight delta slots),
    drift_replan, the score-only solve (drift_survivor) and the f16
    compressor and upcast on CUDA tensors against the same calls on CPU
    tensors: every plane bit for bit."""
    b, c, d = 64, 40, 8
    old = random_tick_inputs(b, c, 3, webhook=True, invalid=2, seed=21)
    rng = np.random.default_rng(21)
    cols = np.sort(rng.choice(np.nonzero(old.cluster_valid)[0], 3, replace=False))
    used = np.array(old.used)
    used[cols] = used[cols] * 9 // 10
    new = old._replace(used=used)
    prev = to_numpy(schedule_tick(to_device(old, "cpu")))
    didx = np.full(d, 1 << 30, np.int32)
    didx[:3] = cols
    dvalid = np.zeros(d, bool)
    dvalid[:3] = True

    def sl(a):
        out = np.zeros((d,) + np.asarray(a).shape[1:], np.asarray(a).dtype)
        out[:3] = np.asarray(a)[cols]
        return out

    delta = (sl(old.alloc), sl(old.used), sl(new.alloc), sl(new.used), didx, dvalid)
    planes = np.array(prev.scores)
    planes[1, 2], planes[3, 4], planes[5] = 2049, 70_000, 3000

    def run(device):
        t = lambda x: torch.as_tensor(np.ascontiguousarray(x)).to(device)  # noqa: E731
        inp = to_device(new, device)
        outs = [
            P.drift_resolve(inp, t(prev.feasible), t(prev.scores), t(prev.reasons),
                            *(t(a) for a in delta), 16),
            P.drift_replan(inp, t(prev.reasons), t(prev.scores), 16),
            P.drift_survivor(inp, t(prev.reasons), 16, True),
        ]
        f16, exact = P.compress_scores(t(planes))
        flat = [x for out, cert in outs for x in (*out, cert)]
        return [x.cpu().numpy() for x in flat + [f16.view(torch.int16), exact,
                                                 P.upcast_scores(f16)]]

    for g, w in zip(run(cuda), run("cpu")):
        assert g.dtype == w.dtype and np.array_equal(g, w)


OPTIN_SWITCHES = [
    {"survivor_unified": False},
    {"score_f16": True},
    {"fetch_format": "dense"},
    {"narrow": False},
    {"phase1_i32": False},
    {"delta_feat": False},
    {"donate": False},
]


@pytest.mark.parametrize("switches", OPTIN_SWITCHES, ids=lambda sw: ",".join(sw))
@pytest.mark.parametrize("config", ["3", "5"])
def test_optin_engines_on_card_match_cpu(cuda, config, switches, monkeypatch):
    """Each opt-in switch on an engine on the card and on the CPU through
    cold, churn, fit-flip drift and back: equal results, counters and
    changed rows every tick."""
    units, clusters, _ = build_world(700, 600, config, seed=5)
    gpu = SchedulerEngine(chunk_size=256, **switches)  # several chunks
    cpu = SchedulerEngine(device="cpu", chunk_size=256, **switches)
    churned = churn(np.random.default_rng(0), units, fraction=0.02)
    for kind, batch, cl in (
        ("cold", units, clusters), ("churn", churned, clusters),
        ("fitflip", churned, drift_fitflip(clusters)), ("back", churned, clusters),
    ):
        got, want = gpu.schedule(batch, cl), cpu.schedule(batch, cl)
        assert [r.clusters for r in got] == [r.clusters for r in want], kind
        for name in ("cache_stats", "fetch_stats", "drift_stats", "survivor_stats",
                     "narrow_stats", "featurize_rows"):
            assert getattr(gpu, name) == getattr(cpu, name), (kind, name)
        assert gpu.last_changed == cpu.last_changed, kind


@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("config", ["3", "5"])
def test_meshed_engine_on_card_matches_cpu(cuda, config, n):
    """An engine over a mesh of n logical devices on the card (a stream
    each) through cold, churn, drift, fit-flip and back: results,
    counters and changed rows equal the CPU engine's every tick; the
    cold tick launches the kernel n times a chunk, each on its rows."""
    from kubeadmiral_tpu_torch.parallel.mesh import make_mesh

    units, clusters, _ = build_world(700, 600, config, seed=7)
    gpu = SchedulerEngine(chunk_size=256, mesh=make_mesh([cuda] * n))
    cpu = SchedulerEngine(device="cpu", chunk_size=256)
    churned = churn(np.random.default_rng(1), units, fraction=0.02)
    for kind, batch, cl in (
        ("cold", units, clusters), ("churn", churned, clusters),
        ("drift", churned, drift(clusters)), ("fitflip", churned, drift_fitflip(clusters)),
        ("back", churned, clusters),
    ):
        launches = phase1.launches
        with recorded_dispatches() as calls:
            got = gpu.schedule(batch, cl)
        launches = phase1.launches - launches
        want = cpu.schedule(batch, cl)
        assert [r.clusters for r in got] == [r.clusters for r in want], kind
        for name in ("cache_stats", "fetch_stats", "drift_stats", "survivor_stats",
                     "narrow_stats", "featurize_rows"):
            assert getattr(gpu, name) == getattr(cpu, name), (kind, name)
        assert gpu.last_changed == cpu.last_changed, kind
        assert launches == len(calls), kind
        if kind == "cold":
            chunks = math.ceil(len(units) / gpu._tick_geometry(len(clusters))[1])
            assert sum(1 for c in calls if c[0] == "narrow") == n * chunks
        lanes = gpu.resident_state_bytes()["prev_planes_by_device"]
        assert len(lanes) == n and len(set(lanes.values())) == 1, (kind, lanes)


def test_mesh_over_cards_keeps_each_lane_on_its_card(cuda):
    """A mesh over every card: each lane's pieces lie on its own card
    (lane 1 on cuda:1), the kernel launches there, and the results
    equal the CPU engine's."""
    from kubeadmiral_tpu_torch.parallel.mesh import RowShards, make_mesh

    cards = torch.cuda.device_count()
    if cards < 2:
        pytest.skip("needs two cards")
    units, clusters, _ = build_world(700, 600, "5", seed=7)
    gpu = SchedulerEngine(chunk_size=256)
    assert gpu.mesh is not None and gpu.mesh.shape[0] == 1 << (cards.bit_length() - 1)
    explicit = SchedulerEngine(chunk_size=256, mesh=make_mesh())
    cpu = SchedulerEngine(device="cpu", chunk_size=256)
    churned = churn(np.random.default_rng(1), units, fraction=0.02)
    for kind, batch, cl in (
        ("cold", units, clusters), ("churn", churned, clusters),
        ("drift", churned, drift(clusters)), ("back", churned, clusters),
    ):
        want = [r.clusters for r in cpu.schedule(batch, cl)]
        for eng in (gpu, explicit):
            assert [r.clusters for r in eng.schedule(batch, cl)] == want, kind
            for entry in eng._chunk_cache.values():
                for t in entry.prev_out + (entry.prev_feas, entry.prev_reasons):
                    assert isinstance(t, RowShards)
                    assert [p.device for p in t.pieces] == list(eng.mesh.devices[:, 0])
        lanes = explicit.resident_state_bytes()["by_device"]
        assert sorted(lanes) == [f"cuda:{i}" for i in range(cards)], lanes


def test_grid_over_cards_keeps_each_block_on_its_card(cuda):
    """A (2, 2) grid over four cards: entry (i, j)'s blocks of every
    [B, C] plane and its copy of the per-row inputs lie on card 2i + j,
    the [B] vectors on the lanes' cards, each card books its own bytes,
    and the results equal the CPU engine's."""
    from kubeadmiral_tpu_torch.parallel.mesh import (
        GridShards,
        RowReplicas,
        RowShards,
        make_mesh,
    )

    if torch.cuda.device_count() < 4:
        pytest.skip("needs four cards")
    mesh = make_mesh([torch.device("cuda", i) for i in range(4)], objects_axis=2)
    units, clusters, _ = build_world(700, 600, "5", seed=7)
    gpu = SchedulerEngine(chunk_size=256, mesh=mesh)
    cpu = SchedulerEngine(device="cpu", chunk_size=256)
    churned = churn(np.random.default_rng(1), units, fraction=0.02)
    for kind, batch, cl in (
        ("cold", units, clusters), ("churn", churned, clusters),
        ("drift", churned, drift(clusters)), ("back", churned, clusters),
    ):
        want = [r.clusters for r in cpu.schedule(batch, cl)]
        assert [r.clusters for r in gpu.schedule(batch, cl)] == want, kind
        for entry in gpu._chunk_cache.values():
            for t in entry.prev_out + (entry.prev_feas, entry.prev_reasons):
                assert isinstance(t, GridShards)
                assert [[p.device for p in row] for row in t.pieces] == mesh.devices.tolist()
            assert isinstance(entry.prev_nfeas, RowShards)
            assert [p.device for p in entry.prev_nfeas.pieces] == list(mesh.devices[:, 0])
            for t in entry.device_per_object.values():
                assert isinstance(t, (GridShards, RowReplicas))
                if isinstance(t, RowReplicas):
                    got = [[c[i].device for c in t.copies] for i in range(2)]
                    assert got == mesh.devices.tolist()
        by_card = gpu.resident_state_bytes()["prev_planes_by_device"]
        assert sorted(by_card) == [f"cuda:{i}" for i in range(4)], by_card
        assert len(set(by_card.values())) == 1, by_card


@pytest.mark.parametrize("n", [2, 4])
def test_meshed_window_dispatch_makes_no_host_sync(cuda, n):
    from kubeadmiral_tpu_torch.parallel.mesh import make_mesh

    units, clusters, _ = build_world(600, SHAPES["3"][1], "3", seed=6)
    got = first_chunk_syncs(units, clusters, windowed=True, mode="error",
                            mesh=make_mesh([cuda] * n))
    assert got["sites"] == []


def _one_row_in(inp):
    """Every [B, ...] plane of ``inp`` as a view one row into a copy with
    a row before it: contiguous, and off 16-byte alignment wherever a
    row's bytes are."""
    b = inp.api_ok.shape[0]
    return inp._replace(**{
        name: torch.cat([v[:1], v])[1:] for name, v in inp._asdict().items()
        if v.dim() and v.shape[0] == b
    })


def _check_split_pair(inp, blocks, view=False):
    """The split pair on every column block of ``inp`` against its plain
    twins, and the blocks joined against the kernel on the whole rows;
    with ``view``, each block's planes views one row in."""
    from kubeadmiral_tpu_torch.ops import phase1 as P1
    from kubeadmiral_tpu_torch.parallel.mesh import _FIELD_SPECS, CLUSTERS, col_bounds

    parts, plains, pieces = [], [], []
    for c0, c1 in col_bounds(inp.api_ok.shape[1], blocks):
        blk = inp._replace(**{
            name: v.narrow(_FIELD_SPECS[name].index(CLUSTERS), c0, c1 - c0).contiguous()
            for name, v in inp._asdict().items() if CLUSTERS in _FIELD_SPECS[name]
        })
        if view:
            blk = _one_row_in(blk)
        pieces.append(blk)
        parts.append(P1.phase1_partial(blk))
        plains.append(P1.phase1_partial_plain(blk))
        for g, w in zip(parts[-1], plains[-1]):
            assert torch.equal(g, w)
    maxima = torch.stack([p[3] for p in parts]).amax(dim=0)
    totals = []
    for blk, part, plain in zip(pieces, parts, plains):
        got = P1.phase1_finish(part[0], blk.score_enabled, blk.taint_counts,
                               blk.affinity_scores, maxima, part[2])
        want = P1.phase1_finish_plain(plain[0], blk.score_enabled, blk.taint_counts,
                                      blk.affinity_scores, maxima, plain[2])
        assert torch.equal(got, want)
        totals.append(got)
    whole = phase1(inp)
    assert torch.equal(torch.cat([p[0] for p in parts], 1), whole[0])
    assert torch.equal(torch.cat([p[1] for p in parts], 1), whole[1])
    assert torch.equal(torch.cat(totals, 1), whole[2])


@pytest.mark.parametrize("b,c,r,invalid,seed", EDGE_SHAPES)
@pytest.mark.parametrize("blocks", [2, 3, 4])
def test_split_pair_matches_plain_and_whole_rows(cuda, b, c, r, invalid, seed, blocks):
    """The split pair on every column block against its plain twins, and
    the blocks joined against the kernel on the whole rows."""
    _check_split_pair(to_device(edge_tick_inputs(b, c, r, invalid, seed), "cuda"), blocks)


# (b, c, column blocks, views one row in): the partial's tiles of rows x
# quads and the finish's row segments at their edges — B off any row
# tile, and B = 1; blocks wider than one column tile (5,124 and 5,125
# columns); blocks narrower than a quad, and of one column; planes one
# row into their storage (C % 4 == 0, the masks off 16-byte alignment).
# split_edge_inputs draws rows whose every cell is feasible with affinity
# values all below 0 (negative maxima) and rows that score neither
# normalised plugin.
SPLIT_TILING = [
    (37, 520, 2, False),
    (1, 600, 3, False),
    (6, 10248, 2, False),
    (5, 10250, 2, False),
    (9, 6, 3, False),
    (7, 3, 4, False),
    (23, 520, 2, True),
    (300, 1040, 4, True),
]


@pytest.mark.parametrize("b,c,blocks,view", SPLIT_TILING)
def test_split_pair_on_tiling_edges(cuda, b, c, blocks, view):
    _check_split_pair(to_device(split_edge_inputs(b, c, seed=b + c), "cuda"), blocks, view)


@pytest.mark.parametrize("config", ["3", "5"])
def test_grid_engine_on_card_matches_cpu(cuda, config):
    """An engine over a (2, 2) mesh of logical entries on the card:
    results and counters equal the CPU engine's every tick, every [B, C]
    plane lies in column blocks on the entries, the narrow ticks launch
    the split pair once a block and the no-op tick nothing."""
    from kubeadmiral_tpu_torch.ops import phase1 as P1
    from kubeadmiral_tpu_torch.parallel.mesh import GridShards, make_mesh

    units, clusters, _ = build_world(700, 600, config, seed=7)
    gpu = SchedulerEngine(chunk_size=256, mesh=make_mesh([cuda] * 4, objects_axis=2))
    cpu = SchedulerEngine(device="cpu", chunk_size=256)
    churned = churn(np.random.default_rng(1), units, fraction=0.02)
    for kind, batch, cl in (
        ("cold", units, clusters), ("churn", churned, clusters), ("noop", churned, clusters),
        ("drift", churned, drift(clusters)), ("fitflip", churned, drift_fitflip(clusters)),
        ("back", churned, clusters),
    ):
        split = P1.phase1_partial.launches
        finish = P1.phase1_finish.launches
        got = gpu.schedule(batch, cl)
        split = P1.phase1_partial.launches - split
        assert P1.phase1_finish.launches - finish == split, kind
        want = cpu.schedule(batch, cl)
        assert [r.clusters for r in got] == [r.clusters for r in want], kind
        for name in ("cache_stats", "fetch_stats", "drift_stats", "survivor_stats",
                     "narrow_stats"):
            assert getattr(gpu, name) == getattr(cpu, name), (kind, name)
        # Two column blocks a lane: the pair launches on both.
        assert split % 2 == 0 and (split > 0 if kind == "cold" else True), (kind, split)
        assert split == 0 or kind != "noop", (kind, split)
        for entry in gpu._chunk_cache.values():
            for t in entry.prev_out + (entry.prev_feas, entry.prev_reasons):
                assert isinstance(t, GridShards) and len(t.pieces[0]) == 2
        lanes = gpu.resident_state_bytes()["prev_planes_by_device"]
        assert len(lanes) == 4 and len(set(lanes.values())) == 1, (kind, lanes)


def test_census_validates_against_card_buffers(cuda):
    from kubeadmiral_tpu_torch.runtime import census

    v = census.validate(2048, 256)
    assert v["ok"] and v["prev_planes_err_pct"] == v["per_device_err_pct"] == 0.0, v


@pytest.mark.parametrize("config", ["3", "5"])
def test_geometry_keywords_on_card_match_cpu(cuda, config):
    """A non-pow2 chunk, a small candidate width and wire width on the
    card against the CPU engine with the same keywords."""
    kw = dict(chunk_size=96, min_bucket=32, narrow_m=8, pack_k_min=8, cache_bytes=1 << 22)
    units, clusters, _ = build_world(400, 600, config, seed=8)
    gpu, cpu = SchedulerEngine(**kw), SchedulerEngine(device="cpu", **kw)
    churned = churn(np.random.default_rng(2), units, fraction=0.02)
    for kind, batch, cl in (
        ("cold", units, clusters), ("churn", churned, clusters),
        ("drift", churned, drift(clusters)), ("back", churned, clusters),
    ):
        got, want = gpu.schedule(batch, cl), cpu.schedule(batch, cl)
        assert [r.clusters for r in got] == [r.clusters for r in want], kind
        for name in ("cache_stats", "fetch_stats", "drift_stats", "narrow_stats"):
            assert getattr(gpu, name) == getattr(cpu, name), (kind, name)


def test_native_library_builds_on_the_card_machine(cuda):
    """The FNV library builds with the machine's g++ (nvcc's host
    compiler); the copy extension builds where Python's headers are."""
    from kubeadmiral_tpu_torch import native
    from kubeadmiral_tpu_torch.utils import hashing, unstructured

    assert native.load() is not None, native.status()
    assert hashing.fnv32a(b"a") == hashing.fnv32a_py(b"a") == 0xE40C292C
    obj = {"a": [1, {"b": "c"}]}
    assert unstructured.copy_json(obj) == obj
    status = native.status()
    print(json.dumps(status))
    assert status["fnvhash"]["path"] == "native"
