"""The plain reference equals the port's CPU engine, and its int32 control
does not."""

import numpy as np
import pytest

from benchmark import reference, traffic, world
from benchmark.adapter import Adapter
from benchmark.reference import replicas
from benchmark.reference.planes import Block, Clusters, Memo
from benchmark.tests.test_bench_world import small
from kubeadmiral_tpu_torch.scheduler.engine import SchedulerEngine

SHAPES = {"5": (700, 260), "3": (700, 120)}


def engine_placements(engine, units, clusters):
    return [dict(r.clusters) for r in engine.schedule(units, clusters)]


@pytest.mark.parametrize("config", sorted(SHAPES))
def test_reference_equals_cpu_engine(config):
    units, clusters, _ = world.build_world(small(config, *SHAPES[config]), 2**31 + 5)
    ad = Adapter()
    typed_clusters = [ad.cluster(c) for c in clusters]
    engine = SchedulerEngine(device="cpu", chunk_size=256)
    mix = traffic.Traffic({"churn_share": 0.05, "drift_members": 2}, units, clusters,
                          np.random.default_rng(3))
    typed = ad.units(units)
    for tick in range(4):
        got = engine_placements(engine, typed, typed_clusters)
        cl = Clusters(mix.clusters)
        assert got == reference.decide(mix.units, cl), f"tick {tick}"
        step = mix.step()
        typed = list(typed)
        for i, rec in step.changed.items():
            typed[i] = ad.unit(rec)
        typed_clusters = [ad.cluster(c) for c in step.clusters]
    second = world.respec(units)
    got = engine_placements(engine, ad.units(second), [ad.cluster(c) for c in clusters])
    assert got == reference.decide(second, Clusters(clusters))


@pytest.mark.parametrize("config", sorted(SHAPES))
def test_worlds_exercise_every_stage(config):
    """Taint and affinity reject somewhere (and the fit filter at c5,
    whose gpu requests fit only the gpu members), maxClusters cuts, both
    modes place, and an estimated capacity caps a placed cluster (the
    overflow's arithmetic: test_distribute_matches_round_by_round_loop)."""
    units, clusters, _ = world.build_world(small(config, *SHAPES[config]), 2**31 + 5)
    cl = Clusters(clusters)
    blk = Block(units, cl, Memo(cl))
    assert (~blk.taint_ok).any() and (~blk.selector).any()
    assert (~blk.fit).any() == (config == "5")
    n_feasible = blk.feasible.sum(1)
    cut = [i for i, u in enumerate(units) if u["max_clusters"] is not None and u["max_clusters"] < n_feasible[i]]
    assert cut
    placed = reference.decide(units, cl)
    assert any(p and all(v is None for v in p.values()) for p in placed)
    assert any(p and all(isinstance(v, int) for v in p.values()) for p in placed)
    assert any(name in placed[i] for i, u in enumerate(units)
               if u["mode"] == "Divide" for name in (u["capacity"] or {}))


def test_distribute_matches_round_by_round_loop():
    rng = np.random.default_rng(0)
    for _ in range(300):
        n = int(rng.integers(1, 30))
        w = rng.integers(-2, 50, n)
        cap = np.where(rng.random(n) < 0.3, rng.integers(0, 20, n), replicas.INF)
        total = int(rng.integers(0, 400))
        keep = bool(rng.integers(0, 2))
        assert [a.tolist() for a in replicas.distribute(w, cap, total, keep)] == \
            [a.tolist() for a in loop_distribute(w, cap, total, keep)]


def loop_distribute(weights, cap, total, keep):
    """planner_oracle._distribute without minimum or maximum replicas,
    cluster by cluster."""
    n = len(weights)
    out, over = np.zeros(n, np.int64), np.zeros(n, np.int64)
    remaining = total
    active = list(range(n))
    moved = True
    while moved and remaining > 0:
        moved = False
        ws = sum(max(int(weights[j]), 0) for j in active)
        if ws <= 0:
            break
        snap, survivors = remaining, []
        for j in active:
            start = int(out[j])
            extra = min((snap * max(int(weights[j]), 0) + ws - 1) // ws, remaining)
            tot, full = start + extra, False
            if tot > cap[j]:
                over[j] += tot - int(cap[j])
                tot, full = int(cap[j]), True
            if not full:
                survivors.append(j)
            remaining -= tot - start
            out[j] = tot
            moved |= tot > start
        active = survivors
    if not keep:
        over = np.array([min(int(v), remaining) if min(int(v), remaining) > 0 else 0 for v in over], np.int64)
    return out, over


@pytest.mark.parametrize("config", sorted(SHAPES))
def test_int32_control_is_caught(config):
    """The control: the reference with every quantity and score held in
    int32, in the program's place, fails the comparison."""
    units, clusters, _ = world.build_world(small(config, *SHAPES[config]), 2**31 + 5)
    cl = Clusters(clusters)
    want = reference.decide(units, cl)
    got = reference.decide(units, cl, itype=np.int32)
    assert sum(a != b for a, b in zip(got, want)) > len(units) // 10
