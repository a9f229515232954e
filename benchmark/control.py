"""The control: the plain reference in the program's place, computed one
step below the precision the configurations state (int64 quantities and
scores held in int32), judged by the same check as a run.

    python3 -m benchmark.control --workload <name> --ticks <n> --seeds <s> [<s> ...]

For each seed it builds the cell's world and traffic as a run does, plays
``--ticks`` ticks (as many as a run's window holds), draws the same
sample of rows and prints the check's numbers as JSON: a sound program
reads 0 wrong rows, so the control's count is the upper reading of the
``wrong_rows`` limit.  The benchmark's own runs never run it.
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np

from benchmark import harness, reference, traffic as traffic_mod, world
from benchmark.reference.planes import Clusters, Memo

CONTROL_TYPE = np.int32


class Answer:
    """A placement in the shape of the program's result, worked out by
    the control when the check reads it."""

    def __init__(self, record: dict, cl: Clusters, memo: Memo):
        self.record, self.cl, self.memo = record, cl, memo

    @property
    def clusters(self) -> dict:
        return reference.decide([self.record], self.cl, self.memo, CONTROL_TYPE)[0]


class ControlResults:
    """One tick's answers, row by row."""

    def __init__(self, records, cl: Clusters, memo: Memo):
        self.records, self.cl, self.memo = records, cl, memo

    def __len__(self):
        return len(self.records)

    def __getitem__(self, i):
        return Answer(self.records[i], self.cl, self.memo)


def control(cell: str, seed: int, ticks: int) -> dict:
    spec = harness.resolve(harness.load_spec(), cell)
    s = harness.seed_of(seed)
    units, clusters, _ = world.build_world(spec["config"]["world"], s)
    mix = traffic_mod.Traffic(spec["traffic"], units, clusters, np.random.default_rng([s, 1]))
    for _ in range(mix.period):  # the set-up's ticks
        mix.step()
    sampler = harness.Sampler(np.random.default_rng([s, 2]))
    tables: dict[int, tuple] = {}
    for t in range(ticks):
        step = mix.step()
        key = id(mix.clusters)
        if key not in tables:
            cl = Clusters(mix.clusters)
            tables[key] = (cl, Memo(cl), mix.clusters)
        cl, memo, _ = tables[key]
        sampler.take(t, step, mix.units, mix.clusters, ControlResults(mix.units, cl, memo), None)
    sample = sampler.sample(max(harness.MIN_ROWS, harness.CHECK_CELLS // len(clusters)))
    verdict = harness.check(sample)
    return {"cell": cell, "seed": seed, "ticks": ticks, "rows": verdict["rows"],
            "wrong_rows": verdict["wrong"], "failed_ticks": len(verdict["failed_ticks"])}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--ticks", type=int, required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    args = ap.parse_args(argv)
    for seed in args.seeds:
        t0 = time.perf_counter()
        out = control(args.workload, seed, args.ticks)
        out["seconds"] = time.perf_counter() - t0
        print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
