"""Kill-matrix driver for the port's crash recovery.

The port's counterpart of ``tools/restart_driver.py``: one deterministic
world, three processes, each a ``SchedulerEngine`` with a
``SnapshotManager`` over ``<dir>/snapshots`` (every tick persisted) and a
flight recorder:

* ``victim`` — runs tick 1 (cold) and tick 2 (churn) with per-tick
  durable snapshots, opens member ``m-001``'s circuit breaker and
  re-persists (the breaker registry rides in the snapshot), then starts
  tick 3 and SIGKILLs itself at the requested phase (``--kill-phase``):
  ``featurize``, ``dispatch`` (a tick queued on the device, its results
  never read), ``fetch`` (at the first device->host read),
  ``snapshot-write`` (the payload half written and fsynced, the temp
  file torn), ``snapshot-rename`` (the payload complete, the rename not
  performed), ``dispatch-flush`` (tick 3 and its snapshot complete,
  killed halfway through the member flush of its placements:
  :func:`flush_placements`).  The kill is installed by wrapping the
  engine's, the store's or the member client's method, so the cut is
  deterministic.
* ``successor`` — a fresh process over the same directory: restores the
  newest valid snapshot (the breakers with it), rebuilds the final
  (tick 3) world from the shared seed, runs one tick and writes an
  artifact with its placements, flight-recorder reason counts, restore
  outcome, fetch paths, the quarantined files, the tick's kernel
  launches, and ``m-001``'s breaker state and whether it admits a
  write.
* ``reference`` — a fresh process without snapshots that runs ticks 1..3
  uninterrupted and writes the same artifact.

A harness asserts successor placements and reason counts equal to the
reference's, whatever phase the victim died in.  Artifacts are JSON in
``--dir``.  Run as
``python -m kubeadmiral_tpu_torch.testing.restart_driver MODE --dir D
[--device cuda|cpu] [--objects N] [--clusters C] [--kill-phase P]
[--artifact NAME] [--breaker-open-s S]``; ``--breaker-open-s`` is the
breakers' cool-down (the JAX driver's ``KT_BREAKER_OPEN_S``, default
5 s): a harness sets it past the victim-to-successor gap so that the
pre-crash open breaker is still open when the successor asks.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import signal
import sys

import numpy as np

from kubeadmiral_tpu_torch.models import types as T
from kubeadmiral_tpu_torch.ops import phase1 as phase1_mod
from kubeadmiral_tpu_torch.runtime.flightrec import FlightRecorder
from kubeadmiral_tpu_torch.runtime.metrics import Metrics
from kubeadmiral_tpu_torch.runtime.snapshot import SnapshotManager, SnapshotStore
from kubeadmiral_tpu_torch.scheduler.engine import SchedulerEngine
from kubeadmiral_tpu_torch.transport.breaker import (
    OPEN_SECONDS,
    BreakerConfig,
    BreakerRegistry,
)

SEED = 20260804
PHASES = (
    "featurize", "dispatch", "fetch", "snapshot-write", "snapshot-rename", "dispatch-flush",
)


def build_world(n: int, c: int):
    rng = np.random.default_rng(SEED)
    clusters = [
        T.ClusterState(
            name=f"m-{j:03d}",
            labels={"region": ("us", "eu", "ap")[j % 3], "tier": str(j % 2)},
            taints=(T.Taint("dedicated", "batch", "NoSchedule"),)
            if j % 7 == 0
            else (),
            allocatable=T.parse_resources({"cpu": "64", "memory": "256Gi"}),
            available=T.parse_resources(
                {"cpu": f"{int(rng.integers(8, 60))}", "memory": "128Gi"}
            ),
            api_resources=frozenset({"apps/v1/Deployment"}),
        )
        for j in range(c)
    ]
    units = [
        T.SchedulingUnit(
            gvk="apps/v1/Deployment",
            namespace=f"ns-{i % 7}",
            name=f"w-{i:05d}",
            scheduling_mode=T.MODE_DIVIDE if i % 4 else "Duplicate",
            desired_replicas=int(rng.integers(1, 60)) if i % 4 else None,
            resource_request=T.parse_resources(
                {"cpu": f"{int(rng.integers(0, 6)) * 250}m"}
            ),
            tolerations=(T.Toleration(key="dedicated", operator="Exists"),)
            if i % 3 == 0
            else (),
            max_clusters=int(rng.integers(1, 5)) if i % 5 == 0 else None,
        )
        for i in range(n)
    ]
    return units, clusters


def churn(units, round_no: int):
    """Deterministic ~4% churn per round (the same function in every
    process, so victim, successor and reference worlds line up)."""
    rng = np.random.default_rng(SEED + round_no)
    out = list(units)
    for i in rng.integers(0, len(units), max(1, len(units) // 25)):
        su = units[int(i)]
        out[int(i)] = dataclasses.replace(
            su,
            desired_replicas=(su.desired_replicas or 1) + int(rng.integers(1, 9)),
        )
    return out


def world_at(tick: int, n: int, c: int):
    units, clusters = build_world(n, c)
    for r in range(1, tick):
        units = churn(units, r)
    return units, clusters


def make_stack(workdir: str, device: str, persist: bool = True,
               breaker_open_s: float = OPEN_SECONDS):
    """(engine, metrics, breakers, store, manager); without ``persist``
    the store and manager are None."""
    metrics = Metrics()
    recorder = FlightRecorder()
    engine = SchedulerEngine(device=device, metrics=metrics, flight_recorder=recorder)
    breakers = BreakerRegistry(
        metrics=metrics, config=BreakerConfig(open_seconds=breaker_open_s)
    )
    if not persist:
        return engine, metrics, breakers, None, None
    store = SnapshotStore(os.path.join(workdir, "snapshots"), metrics=metrics)
    mgr = SnapshotManager(engine, store, every=1, breakers=breakers)
    return engine, metrics, breakers, store, mgr


def artifact(engine, metrics, results, units, extra: dict) -> dict:
    placements = {
        u.key: {
            cl: (None if reps is None else int(reps))
            for cl, reps in sorted(r.clusters.items())
        }
        for u, r in zip(units, results)
    }
    reason_counts = {}
    for u in units:
        record = engine.flightrec.lookup(u.key)
        if record is not None:
            reason_counts[u.key] = [int(x) for x in record.reason_counts]
    counters = {
        k: v
        for k, v in metrics.snapshot()["counters"].items()
        if k.startswith("engine_snapshot_total")
    }
    return {
        "placements": placements,
        "reason_counts": reason_counts,
        "counters": counters,
        **extra,
    }


def _die(*_a, **_k):
    os.kill(os.getpid(), signal.SIGKILL)


def install_kill(engine, store, phase: str) -> None:
    if phase == "featurize":
        engine._featurize_chunk = _die
    elif phase == "dispatch":
        tick = engine._tick

        def kill_after_dispatch(*a, **k):
            tick(*a, **k)
            _die()

        engine._tick = kill_after_dispatch
    elif phase == "fetch":
        engine._read_np = _die
        engine._finish_read = _die
    elif phase == "snapshot-write":
        def torn_write(fh, blob):
            fh.write(blob[: len(blob) // 2])
            fh.flush()
            os.fsync(fh.fileno())
            _die()

        store._write_payload = torn_write
    elif phase == "snapshot-rename":
        store._publish = _die
    elif phase == "dispatch-flush":
        pass  # installed at the member client of flush_placements
    else:
        raise SystemExit(f"unknown kill phase {phase!r}")


class _KillingKube:
    """A member client that SIGKILLs the process once ``after`` ops of
    its bulk requests have been seen (``kill``), else passes them on."""

    def __init__(self, inner, after: int, kill: bool):
        self._inner = inner
        self._after = after
        self._kill = kill
        self._seen = 0

    def batch(self, ops):
        self._seen += len(ops)
        if self._kill and self._seen >= self._after:
            _die()
        return self._inner.batch(ops)


def flush_placements(results, units, kill: bool) -> None:
    """A member-flush stand-in: stage one write per scheduled object
    into a ``BatchSink`` over an in-process member and flush; with
    ``kill`` the member client SIGKILLs the process mid-batch (the
    ``dispatch-flush`` phase)."""
    from kubeadmiral_tpu_torch.federation.dispatch import BatchSink
    from kubeadmiral_tpu_torch.testing.fakekube import FakeKube

    client = _KillingKube(FakeKube("member-durable"), after=max(1, len(units) // 2), kill=kill)
    sink = BatchSink(lambda _c: client)
    for u, r in zip(units, results):
        if not r.clusters:
            continue
        sink.submit(
            "m-000",
            {
                "verb": "create",
                "resource": "v1/configmaps",
                "object": {
                    "apiVersion": "v1", "kind": "ConfigMap",
                    "metadata": {"namespace": u.namespace, "name": u.name},
                    "data": {k: str(v) for k, v in sorted(r.clusters.items())},
                },
            },
            lambda _res: None,
        )
    sink.flush()


def _write(workdir: str, name: str, doc: dict) -> None:
    with open(os.path.join(workdir, name), "w") as fh:
        json.dump(doc, fh)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("mode", choices=("victim", "successor", "reference"))
    ap.add_argument("--dir", required=True, help="work directory")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--objects", type=int, default=192)
    ap.add_argument("--clusters", type=int, default=10)
    ap.add_argument("--kill-phase", default="", choices=("",) + PHASES)
    ap.add_argument("--artifact", default="successor.json")
    ap.add_argument("--breaker-open-s", type=float, default=OPEN_SECONDS)
    args = ap.parse_args(argv)
    workdir, n, c = args.dir, args.objects, args.clusters
    os.makedirs(workdir, exist_ok=True)
    engine, metrics, breakers, store, mgr = make_stack(
        workdir, args.device, persist=args.mode != "reference",
        breaker_open_s=args.breaker_open_s,
    )

    if args.mode == "victim":
        units, clusters = world_at(1, n, c)
        engine.schedule(units, clusters)
        open(os.path.join(workdir, "tick1.done"), "w").write("1")
        units = churn(units, 1)
        engine.schedule(units, clusters)
        open(os.path.join(workdir, "tick2.done"), "w").write("1")
        # A breaker opened pre-crash: the successor must keep skipping
        # this member instead of probing it fresh.
        breakers.for_member("m-001").record_failure(timeout=True)
        mgr.snapshot()  # re-persist with the open breaker riding along
        if args.kill_phase:
            install_kill(engine, store, args.kill_phase)
        units = churn(units, 2)
        results = engine.schedule(units, clusters)
        open(os.path.join(workdir, "tick3.done"), "w").write("1")
        flush_placements(results, units, kill=args.kill_phase == "dispatch-flush")
        # Reaching here means the kill never fired: a harness treats a
        # 0 exit from a victim as a matrix failure.
        return 0

    if args.mode == "successor":
        restore_result = mgr.restore()
        units, clusters = world_at(3, n, c)
        launches0 = phase1_mod.phase1.launches
        results = engine.schedule(units, clusters)
        doc = artifact(
            engine, metrics, results, units,
            {
                "restore": restore_result,
                "restore_info": engine.restore_info,
                "fetch_paths": dict(engine.fetch_stats),
                "launches": phase1_mod.phase1.launches - launches0,
                "breaker_m001": breakers.for_member("m-001").state,
                "breaker_allows_m001": breakers.allow("m-001", consume_probe=False),
                "quarantined": sorted(
                    f for f in os.listdir(os.path.join(workdir, "snapshots"))
                    if f.endswith(".quarantined")
                ),
            },
        )
        _write(workdir, args.artifact, doc)
        return 0

    units, clusters = world_at(1, n, c)
    engine.schedule(units, clusters)
    units = churn(units, 1)
    engine.schedule(units, clusters)
    units = churn(units, 2)
    results = engine.schedule(units, clusters)
    _write(workdir, "reference.json", artifact(engine, metrics, results, units, {"restore": "none"}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
