"""The port on the card: the phase-1 CUDA kernel against its plain twin,
the whole dense tick on CUDA against the CPU, and the engine on CUDA
against the CPU engine (cold, warm and drift ticks, with their
counters; the pipelined window on the card against the CPU engine's
sequential dispatch; score-carrying and webhook ticks) — tolerance 0
(integer math) — and the window's
dispatch of a chunk making no host synchronisation.

Every test here needs a CUDA card and skips without one.  The file
imports neither JAX nor the JAX package, so it also runs on a machine
without them (the repo's conftest imports JAX; skip it there):

    python -m pytest --noconftest -q -m cuda tests/test_torch_cuda.py
"""

import math

import numpy as np
import pytest
import torch

from kubeadmiral_tpu_torch.convert import to_device, to_numpy
from kubeadmiral_tpu_torch.ops.phase1 import phase1, phase1_plain
from kubeadmiral_tpu_torch.ops.pipeline import schedule_tick
from kubeadmiral_tpu_torch.scheduler import engine as engine_mod
from kubeadmiral_tpu_torch.scheduler.engine import SchedulerEngine
from kubeadmiral_tpu_torch.testing.problems import (
    EDGE_SHAPES,
    edge_tick_inputs,
    random_tick_inputs,
)
from kubeadmiral_tpu_torch.testing.sample_counts import recorded_dispatches
from kubeadmiral_tpu_torch.testing.syncs import first_chunk_syncs
from kubeadmiral_tpu_torch.testing.worlds import (
    SHAPES,
    build_world,
    churn,
    drift,
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
    monkeypatch.setattr(engine_mod, "MEGACHUNK_ROWS", 256)  # several chunks
    engine = SchedulerEngine()
    launches = phase1.launches
    got = engine.schedule(units, clusters)
    chunks = math.ceil(len(units) / engine._tick_geometry(len(clusters))[1])
    assert chunks > 1 and phase1.launches - launches == chunks
    want = SchedulerEngine(device="cpu").schedule(units, clusters)
    assert [r.clusters for r in got] == [r.clusters for r in want]


@pytest.mark.parametrize("config", ["3", "5"])
def test_warm_sequence_on_card_matches_cpu(cuda, config, monkeypatch):
    """Cold, churn, no-op, drift, back and churn ticks on one engine on
    the card and one on the CPU: equal results, cache, fetch, drift-gate
    and survivor counters and changed rows at every tick; every tick
    dispatch launches the kernel once and nothing else does; no-op ticks
    launch nothing, cold and churn ticks launch the kernel."""
    units, clusters, _ = build_world(700, 600, config, seed=3)
    monkeypatch.setattr(engine_mod, "MEGACHUNK_ROWS", 256)  # several chunks
    gpu, cpu = SchedulerEngine(), SchedulerEngine(device="cpu")
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
    monkeypatch.setattr(engine_mod, "MEGACHUNK_ROWS", 256)  # several chunks
    gpu, cpu = SchedulerEngine(), SchedulerEngine(device="cpu")
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
    monkeypatch.setattr(engine_mod, "MEGACHUNK_ROWS", 512)
    gpu, cpu = SchedulerEngine(), SchedulerEngine(device="cpu")
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
    monkeypatch.setattr(engine_mod, "MEGACHUNK_ROWS", 256)  # several chunks
    gpu, cpu = SchedulerEngine(), SchedulerEngine(device="cpu")
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
