"""One run of one cell: set-up, the measured window, the traced ticks and
the check of the answers against the plain reference.

Everything a cell is made of is found by name from ``BENCHMARK.json``:
its configuration's file, its traffic mix (``benchmark/traffic/<mix>.json``)
and its per-layer metrics (``benchmark/metrics/<name>.py``), which read
every counter the engine keeps (``counters``) without the harness naming
it.  The program
under test is ``kubeadmiral_tpu_torch.scheduler.engine.SchedulerEngine``
with its default keywords, driven in a closed loop through ``schedule``
as the scheduler controller drives it.
"""

from __future__ import annotations

import gc
import importlib.util
import json
import sys
import time
from pathlib import Path

import numpy as np

from benchmark import reference, traffic as traffic_mod, world
from benchmark.reference.planes import Clusters, Memo
from benchmark.yardstick import devtrace, stats
from benchmark.yardstick.readings import Readings

ROOT = Path(__file__).resolve().parent.parent

# Rows judged a run: the sample's cells (rows x clusters) stay under
# CHECK_CELLS so the reference takes a few seconds; at least MIN_ROWS.
CHECK_CELLS = 4_000_000
MIN_ROWS = 100
# Rows drawn each tick for the sample: of the rows the traffic changed,
# of the rows the engine reports changed, and of all rows.
DRAW_CHANGED, DRAW_REPORTED, DRAW_ANY = 64, 64, 32
# Traced ticks: whole periods of the mix, at least TRACE_PERIODS of them
# and TRACE_S of tick wall, at most TRACE_MAX_TICKS.
TRACE_PERIODS, TRACE_S, TRACE_MAX_TICKS = 2, 1.0, 64


def load_spec(root: Path = ROOT) -> dict:
    with open(root / "BENCHMARK.json") as f:
        return json.load(f)


def resolve(spec: dict, cell: str, root: Path = ROOT) -> dict:
    """The cell's entry, configuration file, traffic parameters and the
    end-to-end and per-layer metric entries it reports."""
    cells = {w["name"]: w for w in spec["workloads"]}
    if cell not in cells:
        raise KeyError(f"no workload {cell!r}; known: {sorted(cells)}")
    entry = cells[cell]
    config = next(c for c in spec["configs"] if c["name"] == entry["config"])
    with open(root / config["file"]) as f:
        cfg = json.load(f)
    with open(root / "benchmark" / "traffic" / f"{entry['traffic']}.json") as f:
        mix = json.load(f)

    def mine(m):
        return cell in m["workloads"] if "workloads" in m else None

    e2e = [m for m in spec["end_to_end"] if mine(m) is not False]
    names = {m["name"] for m in e2e}
    layer = [m for m in spec["per_layer"]
             if mine(m) or (mine(m) is None and m["moves"] in names)]
    return {"entry": entry, "config": cfg, "traffic": mix, "end_to_end": e2e, "per_layer": layer}


def load_metric(name: str, root: Path = ROOT):
    """``benchmark/metrics/<name>.py``'s ``read``."""
    path = root / "benchmark" / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"benchmark_metric_{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def seed_of(seed: int) -> int:
    """Any whole number, as the non-negative integer numpy seeds with."""
    return int(seed) % (1 << 64)


class Program:
    """The program's view of the world: the engine, its unit and cluster
    objects, kept in step with the traffic's records.

    Each record is converted once, into a template that never reaches the
    engine; every tick hands the engine a fresh object for every row
    (``adapter.fresh``), as the scheduler controller builds a new unit
    for each object it reconciles (``federation/schedulerctl.py``
    ``_scheduling_unit``).  So the engine never meets an object it saw
    before, and every row takes its signature check as under the
    controller.  The fresh list is made in ``apply``, outside the tick's
    timer."""

    def __init__(self, engine, adapter, units, clusters, generations):
        self.engine = engine
        self.adapter = adapter
        self.templates = adapter.units(units)
        self.base_records = clusters
        self.base_clusters = [adapter.cluster(c) for c in clusters]
        self.clusters = self.base_clusters
        self.generations = None
        if generations:
            self.generations = [self.templates, adapter.units(generations[1])]
        self.batch = self._fresh()

    def _fresh(self) -> list:
        fresh = self.adapter.fresh
        return [fresh(u) for u in self.templates]

    def apply(self, step: traffic_mod.Step) -> None:
        if step.generation is not None:
            self.templates = self.generations[step.generation]
        elif step.changed:
            self.templates = list(self.templates)
            for i, rec in step.changed.items():
                self.templates[i] = self.adapter.unit(rec)
        if step.clusters is not None:
            self.clusters = [
                base if rec is base_rec else self.adapter.cluster(rec)
                for rec, base_rec, base in zip(step.clusters, self.base_records, self.base_clusters)
            ]
        self.batch = self._fresh()

    def tick(self):
        return self.engine.schedule(self.batch, self.clusters)


def counters(engine, launcher) -> dict:
    """Every number the engine and the phase-1 launcher keep, by name:
    each public int or float attribute (``fetch_bytes_total``,
    ``dispatches_total``, ...), each number of a public dict of numbers
    as ``<dict>.<key>`` (``cache_stats.hit``, ``upload_bytes.object``,
    ``drift_stats.recompute``, ...) and the launcher's as
    ``phase1.<name>`` (``phase1.launches``).  The engine's per-tick stage
    walls stay under ``timings``."""
    out = {}
    for prefix, obj in (("", engine), ("phase1.", launcher)):
        for name, value in vars(obj).items():
            if name.startswith("_") or name == "timings":
                continue
            if isinstance(value, (int, float)) and not isinstance(value, bool):
                out[prefix + name] = value
            elif isinstance(value, dict):
                for key, v in value.items():
                    if isinstance(key, str) and isinstance(v, (int, float)) and not isinstance(v, bool):
                        out[f"{prefix}{name}.{key}"] = v
    return out


class Sampler:
    """Rows of each tick kept for the check: (tick, row, record, cluster
    records, result), drawn from the seed."""

    def __init__(self, rng: np.random.Generator):
        self.rng = rng
        self.kept = []
        self.short_ticks = 0

    def _draw(self, rows, k):
        rows = np.asarray(rows, np.int64)
        if len(rows) <= k:
            return rows.tolist()
        return self.rng.choice(rows, k, replace=False).tolist()

    def take(self, tick: int, step, records, cluster_records, results, reported) -> bool:
        if len(results) != len(records):
            self.short_ticks += 1
            return False
        n = len(records)
        changed = range(n) if step.generation is not None else list(step.changed)
        rows = set(self._draw(changed, DRAW_CHANGED))
        if reported:
            rows.update(self._draw(reported, DRAW_REPORTED))
        rows.update(self._draw(range(n), DRAW_ANY))
        for i in sorted(rows):
            self.kept.append((tick, i, records[i], cluster_records, results[i]))
        return True

    def sample(self, budget: int):
        if len(self.kept) <= budget:
            return self.kept
        pick = np.sort(self.rng.choice(len(self.kept), budget, replace=False))
        return [self.kept[i] for i in pick]


class GcPauses:
    """Count and time the collector's passes by generation while open
    (``gc.callbacks``), for the log."""

    def __init__(self):
        self.count = [0, 0, 0]
        self.seconds = [0.0, 0.0, 0.0]
        self._t0 = None

    def _hook(self, phase, info):
        if phase == "start":
            self._t0 = time.perf_counter()
        elif self._t0 is not None:
            g = info["generation"]
            self.count[g] += 1
            self.seconds[g] += time.perf_counter() - self._t0
            self._t0 = None

    def __enter__(self):
        gc.callbacks.append(self._hook)
        return self

    def __exit__(self, *exc):
        gc.callbacks.remove(self._hook)

    def __str__(self):
        return ", ".join(f"gen{g} {n} passes {1e3 * s:.1f} ms"
                         for g, (n, s) in enumerate(zip(self.count, self.seconds)))


def check(sample) -> dict:
    """Judge each sampled answer against the reference's, decided at the
    int64 the configurations state; the tick of every wrong one is a
    failed tick."""
    by_world: dict[int, list] = {}
    for item in sample:
        by_world.setdefault(id(item[3]), []).append(item)
    wrong, failed = 0, set()
    for items in by_world.values():
        cl = Clusters(items[0][3])
        want = reference.decide([it[2] for it in items], cl, Memo(cl))
        for it, w in zip(items, want):
            if dict(it[4].clusters) != w:
                wrong += 1
                failed.add(it[0])
    return {"rows": len(sample), "wrong": wrong, "failed_ticks": failed}


def run(cell: str, seed: int, seconds: float, trace: bool, *, device: str = "cuda",
        t_start: float | None = None, world_override: dict | None = None,
        engine_factory=None, log=None, root: Path = ROOT) -> dict:
    """One run; returns the result line's object.  ``world_override``
    (tests) replaces sizes of the configuration's world,
    ``engine_factory(device)`` the engine, and ``root`` the checkout whose
    ``BENCHMARK.json`` and ``benchmark/`` files define the cell."""
    import torch

    from benchmark.adapter import Adapter
    from kubeadmiral_tpu_torch.ops import phase1 as p1
    from kubeadmiral_tpu_torch.runtime.gctune import tune_gc_for_service
    from kubeadmiral_tpu_torch.scheduler.engine import SchedulerEngine

    # The collector's thresholds the controller manager sets before its
    # first reconcile (runtime/manager.py: ControllerManager.run).
    tune_gc_for_service()

    log = log or (lambda msg: print(msg, file=sys.stderr, flush=True))
    t_start = time.perf_counter() if t_start is None else t_start
    cuda = torch.device(device).type == "cuda"
    spec = resolve(load_spec(root), cell, root)
    cfg = dict(spec["config"]["world"], **(world_override or {}))
    s = seed_of(seed)

    # --- set-up: the world, the engine, the cold tick, one period ---
    marks = [("start", time.perf_counter())]
    units, clusters, _followers = world.build_world(cfg, s)
    mix = traffic_mod.Traffic(spec["traffic"], units, clusters, np.random.default_rng([s, 1]))
    engine = (engine_factory or (lambda d: SchedulerEngine(device=d)))(device)
    prog = Program(engine, Adapter(), units, clusters, mix.generations)
    marks.append(("world", time.perf_counter()))
    prog.tick()
    marks.append(("cold tick", time.perf_counter()))
    for _ in range(mix.period):
        prog.apply(mix.step())
        prog.tick()
    if cuda:
        torch.cuda.synchronize()
    marks.append(("traffic", time.perf_counter()))
    # The set-up's objects go to the collector's oldest generation, where
    # a long-running controller's world has long been: every run starts
    # the window from the same state of the collector.
    gc.collect()
    marks.append(("collector", time.perf_counter()))
    setup_s = time.perf_counter() - t_start
    steps = ", ".join(f"{name} {b - a:.3f}" for (_, a), (name, b) in zip(marks, marks[1:]))
    log(f"set-up {setup_s:.3f} s: {len(units)} objects x {len(clusters)} clusters; "
        f"imports {marks[0][1] - t_start:.3f}, {steps}")

    sampler = Sampler(np.random.default_rng([s, 2]))
    tick_no = 0

    def one_tick(worlds=None):
        nonlocal tick_no
        step = mix.step()
        prog.apply(step)
        if worlds is not None:
            worlds.append((mix.units, mix.clusters))
        before = counters(engine, p1.phase1)
        ta = time.perf_counter()
        results = prog.tick()
        tb = time.perf_counter()
        after = counters(engine, p1.phase1)
        sampler.take(tick_no, step, mix.units, mix.clusters, results, engine.last_changed)
        tick_no += 1
        return {
            "start": ta, "end": tb, "wall_s": tb - ta, "objects": len(results),
            "timings": dict(engine.timings), "counters": after,
            "deltas": {k: v - before.get(k, 0) for k, v in after.items()},
        }

    # --- the window ---
    ticks = []
    pauses = GcPauses()
    deadline = time.perf_counter() + seconds
    with pauses:
        while not ticks or time.perf_counter() < deadline:
            ticks.append(one_tick())
    walls = sorted(t["wall_s"] * 1e3 for t in ticks)
    log(f"window: {len(ticks)} ticks in {ticks[-1]['end'] - ticks[0]['start']:.3f} s; tick ms "
        f"min {walls[0]:.1f} median {walls[len(walls) // 2]:.1f} max {walls[-1]:.1f}")
    log(f"collector in the window: {pauses}")
    for t in sorted(ticks, key=lambda t: -t["wall_s"])[:3]:
        stages = " ".join(f"{k} {v * 1e3:.1f}" for k, v in t["timings"].items() if v)
        log(f"slow tick: {t['wall_s'] * 1e3:.1f} ms ({stages}; "
            f"{t['deltas'].get('phase1.launches')} launches)")

    # --- traced ticks ---
    dtrace, traced_worlds = None, []
    if trace:
        def traced():
            spans = []
            walls = 0.0
            while len(spans) < TRACE_MAX_TICKS and (
                len(spans) < TRACE_PERIODS * mix.period or walls < TRACE_S or len(spans) % mix.period
            ):
                t = one_tick(traced_worlds)
                spans.append((t["start"], t["end"]))
                walls += t["wall_s"]
            if cuda:
                torch.cuda.synchronize()
            return spans
        dtrace = devtrace.capture(traced, cuda)
        log(f"traced {dtrace.ticks} ticks in {dtrace.window_s:.3f} s, {len(dtrace.device)} device events")

    peak = torch.cuda.max_memory_allocated() if cuda else 0
    kind = torch.cuda.get_device_name(0) if cuda else "cpu"

    # --- results, then the check with the program's state freed ---
    metrics = {}
    for m in spec["end_to_end"]:
        name = m["name"]
        if name == "setup_s":
            value = setup_s
        elif name == "tick_ms":
            value = 1e3 * sum(t["wall_s"] for t in ticks) / len(ticks)
        elif name == "tick_p95_ms":
            value = 1e3 * stats.percentile([t["wall_s"] for t in ticks], 95)
        elif name == "objects_per_s":
            value = stats.rate(sum(t["objects"] for t in ticks), sum(t["wall_s"] for t in ticks))
        else:
            raise KeyError(f"no reading for end-to-end metric {name!r}")
        metrics[name] = {"value": value, "unit": m["unit"]}
    layer = {}
    if trace:
        readings = Readings(ticks, dtrace, traced_worlds)
        for m in spec["per_layer"]:
            value = load_metric(m["name"], root)(readings)
            if value is not None:
                layer[m["name"]] = {"value": value, "unit": m["unit"]}

    del prog, engine
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    budget = max(MIN_ROWS, CHECK_CELLS // max(1, len(clusters)))
    sample = sampler.sample(budget)
    t_check = time.perf_counter()
    verdict = check(sample)
    log(f"check: {verdict['rows']} rows in {time.perf_counter() - t_check:.3f} s")

    checks = {
        "wrong_rows": {"value": verdict["wrong"], "limit": 0},
        "short_ticks": {"value": sampler.short_ticks, "limit": 0},
        "rows_checked": {"value": verdict["rows"], "min": MIN_ROWS},
    }
    correct = (verdict["wrong"] == 0 and sampler.short_ticks == 0
               and verdict["rows"] >= MIN_ROWS)
    device_info = {"platform": "gpu" if cuda else "cpu", "kind": kind, "count": 1,
                   "memory_peak_bytes": int(peak)}
    out = {"correct": correct, "attempted": tick_no,
           "failed": len(verdict["failed_ticks"]) + sampler.short_ticks,
           "metrics": layer if trace else metrics, "device": device_info}
    if cuda and trace:
        device_info["busy_s"] = dtrace.busy_s
        device_info["window_s"] = dtrace.window_s
        out["breakdown"] = dtrace.breakdown()
    out["checks"] = checks
    return out
