"""Counts of the engine's ticks on a CPU sample of a world.

Runs the port's engine on the CPU over the first ``n`` objects of a
config-3 or config-5 world and prints one JSON line per config.  Counts
only: a CPU run says nothing of the card's times.  A prediction of the
full worlds' counts scales these.

* The cold mode (default): the narrow width M, the certified and
  fallback rows, the rows that overflow the wire's K slots, the fetch
  bytes against the dense planes' 6 B per cell, and the planner's
  weighted rounds (``planner_rounds``): how many rounds each
  ``_distribute`` call's loop ran (its slowest row) and how many each
  row took, as {rounds: count} over the tick's calls (three a dispatch:
  the desired plan, then the scale-up and scale-down passes).
* ``--warm``: one engine through a cold tick, a 1 % churn tick
  (``testing/worlds.churn``), a no-op tick, a capacity drift
  (``testing/worlds.drift``) and a tick back, cluster 0's capacity cut
  to 0 (``drift_zero``) and back, and more than a quarter of the
  clusters halved (``drift_wide``) and back; per tick the cache and
  fetch paths, every tick dispatch's shape (narrow or dense, rows x
  clusters: the sub-batch slabs on the churn tick), the drift gate's
  row classes and the survivor program's groups, fallback and overflow
  rows, fetch and upload bytes against the dense planes, the changed
  rows and the chunks' adaptive wire widths.  ``full_size`` gives the churn tick's
  slabs at the world's full size (the first churn draw's distinct rows
  cut on the engine's ladder).

    python -m kubeadmiral_tpu_torch.testing.sample_counts [--c3 2000] [--c5 1024] [--warm]
"""

from __future__ import annotations

import argparse
import contextlib
import json
import math
from typing import Optional

import numpy as np

from kubeadmiral_tpu_torch.ops.planner import RoundBudget
from kubeadmiral_tpu_torch.scheduler import engine as engine_mod
from kubeadmiral_tpu_torch.scheduler.engine import SchedulerEngine
from kubeadmiral_tpu_torch.testing.worlds import (
    SHAPES,
    build_world,
    churn,
    drift,
    drift_wide,
    drift_zero,
)


def sample_counts(config: str, n_objects: int, seed: int = 0) -> dict:
    """One cold CPU tick over the first ``n_objects`` of the world."""
    n_clusters = SHAPES[config][1]
    units, clusters, _ = build_world(n_objects, n_clusters, config=config, seed=seed)
    engine = SchedulerEngine(device="cpu")
    with logged_rounds() as rounds:
        engine.schedule(units, clusters)
    c_bucket = engine._tick_geometry(n_clusters)[0]
    dense = 6 * n_objects * c_bucket
    return {
        "config": config,
        "objects": n_objects,
        "c_bucket": c_bucket,
        "narrow_m": engine.narrow_last_m,
        "narrow_stats": dict(engine.narrow_stats),
        "overflow_rows": engine.overflow_rows_total,
        "overflow_share": engine.overflow_rows_total / n_objects,
        "fetch_bytes": engine.fetch_bytes_total,
        "dense_plane_bytes": dense,
        "fetch_vs_dense": engine.fetch_bytes_total / dense,
        "planner_rounds": round_distribution(rounds),
    }


@contextlib.contextmanager
def logged_rounds():
    """Run every tick dispatch of the engine with the checked round loop
    under a recording ops.planner.RoundBudget (in place of the engine's
    own budget, if any) for the duration; yields the list that receives
    each round loop's rounds per row."""
    log: list = []
    real = {"narrow": engine_mod.schedule_tick_narrow, "dense": engine_mod.schedule_tick}

    def logged(fn):
        def call(*args, budget=None, **kwargs):
            recorder = RoundBudget(None, record=True)
            try:
                return fn(*args, budget=recorder, **kwargs)
            finally:
                log.extend(recorder.per_row)
        return call

    engine_mod.schedule_tick_narrow = logged(real["narrow"])
    engine_mod.schedule_tick = logged(real["dense"])
    try:
        yield log
    finally:
        engine_mod.schedule_tick_narrow = real["narrow"]
        engine_mod.schedule_tick = real["dense"]


def round_distribution(log: list) -> dict:
    """{"calls", "per_call", "per_row"}: the loops run, and {rounds: count}
    of each loop's round count (its slowest row's) and of each row's."""
    def histogram(values):
        keys, counts = np.unique(np.asarray(values, np.int64), return_counts=True)
        return {int(k): int(n) for k, n in zip(keys, counts)}

    per_call = [int(r.max(initial=0)) for r in log]
    rows = np.concatenate(log) if log else np.zeros(0, np.int32)
    return {"calls": len(log), "per_call": histogram(per_call), "per_row": histogram(rows)}


@contextlib.contextmanager
def recorded_dispatches(keep: Optional[list] = None):
    """Record every tick dispatch the engine makes as (kind, rows,
    clusters), kind "narrow" or "dense" (certificate fallbacks are the
    dense ones on a narrow path).  With a ``keep`` list, the first
    dispatch's expanded inputs are appended to it."""
    shapes = []
    real = {"narrow": engine_mod.schedule_tick_narrow, "dense": engine_mod.schedule_tick}

    def counted(kind):
        def fn(inp, *args, **kwargs):
            if keep is not None and not shapes:
                keep.append(inp)
            shapes.append((kind, *inp.api_ok.shape))
            return real[kind](inp, *args, **kwargs)
        return fn

    engine_mod.schedule_tick_narrow = counted("narrow")
    engine_mod.schedule_tick = counted("dense")
    try:
        yield shapes
    finally:
        engine_mod.schedule_tick_narrow = real["narrow"]
        engine_mod.schedule_tick = real["dense"]


def full_size_slabs(config: str, seed: int = 0, fraction: float = 0.01) -> dict:
    """The first churn tick's sub-batch slabs at the world's full size:
    its distinct churned rows (churn's first draw from the same seed)
    cut on the engine's ladder."""
    n, c = SHAPES[config]
    draw = np.random.default_rng(seed).integers(0, n, max(1, int(n * fraction)))
    rows = int(np.unique(draw).size)
    engine = SchedulerEngine(device="cpu")
    c_bucket, eff, ladder = engine._tick_geometry(c)
    cut = engine._slab_cut(rows, eff, ladder)
    slabs = [min(cut, rows - s) for s in range(0, rows, cut)]
    return {
        "churned_rows": rows,
        "slab_cut": cut,
        "slabs": [[engine._bucket_rows(r, ladder, eff, False), c_bucket] for r in slabs],
        "chunks": math.ceil(n / eff),
    }


def warm_counts(config: str, n_objects: int, seed: int = 0) -> dict:
    """Cold, 1 % churn, no-op and the three drifts (each with a tick
    back) of one CPU engine over the first ``n_objects`` of the world."""
    n_clusters = SHAPES[config][1]
    units, clusters, _ = build_world(n_objects, n_clusters, config=config, seed=seed)
    engine = SchedulerEngine(device="cpu")
    c_bucket = engine._tick_geometry(n_clusters)[0]
    dense = 6 * n_objects * c_bucket
    rng = np.random.default_rng(seed)
    churned = churn(rng, units)
    ticks = {}
    for kind, (u, cl) in (
        ("cold", (units, clusters)),
        ("churn", (churned, clusters)),
        ("noop", (churned, clusters)),
        ("drift", (churned, drift(clusters))),
        ("back", (churned, clusters)),
        ("drift-zero", (churned, drift_zero(clusters))),
        ("back-zero", (churned, clusters)),
        ("drift-wide", (churned, drift_wide(clusters))),
        ("back-wide", (churned, clusters)),
    ):
        cache0, fetch0 = dict(engine.cache_stats), dict(engine.fetch_stats)
        gate0, surv0 = dict(engine.drift_stats), dict(engine.survivor_stats)
        narrow0, over0 = dict(engine.narrow_stats), engine.overflow_rows_total
        bytes0, upload0 = engine.fetch_bytes_total, dict(engine.upload_bytes)
        with recorded_dispatches() as shapes:
            engine.schedule(u, cl)
        fetch_bytes = engine.fetch_bytes_total - bytes0
        ticks[kind] = {
            "cache": {k: v - cache0[k] for k, v in engine.cache_stats.items() if v - cache0[k]},
            "fetch_paths": {k: v - fetch0[k] for k, v in engine.fetch_stats.items() if v - fetch0[k]},
            "dispatches": shapes,
            "drift_stats": {k: v - gate0[k] for k, v in engine.drift_stats.items() if v - gate0[k]},
            "survivor_stats": {
                k: v - surv0[k] for k, v in engine.survivor_stats.items() if v - surv0[k]
            },
            "fallback_rows": engine.narrow_stats["fallback"] - narrow0["fallback"],
            "overflow_rows": engine.overflow_rows_total - over0,
            "fetch_bytes": fetch_bytes,
            "fetch_vs_dense": fetch_bytes / dense,
            "upload_bytes": {k: v - upload0[k] for k, v in engine.upload_bytes.items()},
            "changed_rows": None if engine.last_changed is None else len(engine.last_changed),
            "pack_k_hints": [e.pack_k_hint for _, e in sorted(engine._chunk_cache.items())],
        }
    return {
        "config": config,
        "objects": n_objects,
        "c_bucket": c_bucket,
        "dense_plane_bytes": dense,
        "ticks": ticks,
        "full_size": full_size_slabs(config, seed),
    }


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--c3", type=int, default=2000, help="config-3 objects")
    parser.add_argument("--c5", type=int, default=1024, help="config-5 objects")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument(
        "--warm", action="store_true", help="cold, churn, no-op and drift ticks"
    )
    args = parser.parse_args(argv)
    counts = warm_counts if args.warm else sample_counts
    for config, n in (("3", args.c3), ("5", args.c5)):
        print(json.dumps(counts(config, n, args.seed)), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
