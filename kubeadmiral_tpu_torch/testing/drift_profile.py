"""Host profile of the engine's capacity-drift ticks.

Runs one engine through a cold tick of a config-3 or config-5 world
(``testing/worlds.py``, full size by default), then a drift (cluster
0's available halved), a tick back, ``drift_zero`` and a tick back, each
under ``cProfile``, and prints per tick the wall time, the engine's
stage split and its drift counters, then the functions with the most
time of their own and the most cumulative time.  On the card it shows
how much of a drift tick is the host queueing device work.

    python -m kubeadmiral_tpu_torch.testing.drift_profile [--config 5] [--objects N] [--top 25]
"""

from __future__ import annotations

import argparse
import cProfile
import gc
import io
import json
import pstats
import time

import torch

from kubeadmiral_tpu_torch.scheduler.engine import SchedulerEngine
from kubeadmiral_tpu_torch.testing.worlds import SHAPES, build_world, drift, drift_zero


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--config", default="5", choices=sorted(SHAPES))
    parser.add_argument("--objects", type=int, default=None, help="default: the world's")
    parser.add_argument("--top", type=int, default=25)
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)
    n, c = SHAPES[args.config]
    units, clusters, _ = build_world(args.objects or n, c, config=args.config, seed=0)
    engine = SchedulerEngine(device=args.device)
    sync = torch.cuda.synchronize if engine.device.type == "cuda" else (lambda: None)
    engine.schedule(units, clusters)
    sync()
    for label, cl in (
        ("drift", drift(clusters)),
        ("back", clusters),
        ("drift-zero", drift_zero(clusters)),
        ("back from drift-zero", clusters),
    ):
        gate0, surv0 = dict(engine.drift_stats), dict(engine.survivor_stats)
        gc.collect()
        prof = cProfile.Profile()
        t0 = time.perf_counter()
        prof.enable()
        engine.schedule(units, cl)
        sync()
        prof.disable()
        wall = time.perf_counter() - t0
        row = {
            "tick": label,
            "wall_ms": wall * 1e3,
            "stage_ms": {k: v * 1e3 for k, v in engine.timings.items()},
            "drift_stats": {k: v - gate0[k] for k, v in engine.drift_stats.items() if v - gate0[k]},
            "survivor_stats": {
                k: v - surv0[k] for k, v in engine.survivor_stats.items() if v - surv0[k]
            },
        }
        print(json.dumps(row), flush=True)
        for key in ("tottime", "cumulative"):
            out = io.StringIO()
            pstats.Stats(prof, stream=out).sort_stats(key).print_stats(args.top)
            print(out.getvalue().split("\n", 4)[-1], flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
