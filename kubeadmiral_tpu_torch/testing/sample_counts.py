"""Narrow-path counts of one cold tick on a CPU sample of a world.

Runs the port's engine on the CPU over the first ``n`` objects of a
config-3 or config-5 world and prints, per config, one JSON line: the
narrow width M, the certified and fallback rows, the rows that overflow
the wire's K slots, and the fetch bytes against the dense planes' 6 B
per cell.  Counts only: a CPU run says nothing of the card's times.  A
prediction of the full worlds' counts scales these rates.

    python -m kubeadmiral_tpu_torch.testing.sample_counts [--c3 2000] [--c5 1024]
"""

from __future__ import annotations

import argparse
import json

from kubeadmiral_tpu_torch.scheduler.engine import SchedulerEngine
from kubeadmiral_tpu_torch.testing.worlds import SHAPES, build_world


def sample_counts(config: str, n_objects: int, seed: int = 0) -> dict:
    """One cold CPU tick over the first ``n_objects`` of the world."""
    n_clusters = SHAPES[config][1]
    units, clusters, _ = build_world(n_objects, n_clusters, config=config, seed=seed)
    engine = SchedulerEngine(device="cpu")
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
    }


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--c3", type=int, default=2000, help="config-3 objects")
    parser.add_argument("--c5", type=int, default=1024, help="config-5 objects")
    parser.add_argument("--seed", type=int, default=0)
    args = parser.parse_args(argv)
    for config, n in (("3", args.c3), ("5", args.c5)):
        print(json.dumps(sample_counts(config, n, args.seed)), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
