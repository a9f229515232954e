"""Standalone sharded control-plane replica over the HTTP farm.

A copy of ``kubeadmiral_tpu/testing/shardreplica.py`` for the port's control
plane.

One process = one shard of the sharded control plane: it
builds the full per-FTC controller stack — federate, schedule,
override, sync, status — against the farm's HOST apiserver over real
HTTP, with every intake boundary filtered by the jump-hash ShardMap
(``--shard-count``/``--shard-index``; the JAX module reads
``KT_SHARD_COUNT``/``KT_SHARD_INDEX``), its scheduler on the engine of
``--device`` (``cuda`` by default; no fallback to the CPU).  The replica acquires its
``kt-shard-<i>`` lease before reporting ready, so N replicas own N
disjoint shards by construction.

Protocol (the kwokserver idiom): configuration on the command line
(``--host-url``, ``--host-token``, ``--shard-count``, ``--shard-index``,
``--ftc``, ``--device``; the JAX module's KT_REPLICA_HOST_URL,
KT_REPLICA_HOST_TOKEN, KT_SHARD_COUNT, KT_SHARD_INDEX and
KT_REPLICA_FTC); one JSON line
``{"ok": true, "shard": i, ...}`` on stdout once the controllers are
watching and the lease is held; then a line-oriented command loop:

* ``report`` → one JSON line with ``settled`` (no controller progressed
  for a full idle window), per-stage cumulative step seconds, the
  replica's owned-key count and its flight-recorder reason-count hash
  (stable_json_hash over {key: reason_counts} for owned keys — the
  parent compares it against the matching SUBSET of the unsharded
  oracle's map, so reason parity never ships 100k-key payloads);
* stdin EOF → graceful exit (parent death reaps the replica without
  pid bookkeeping).

Placements need no protocol: replicas persist them into the shared
host apiserver, where the parent reads the union directly.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import select
import sys
import time


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        prog="kubeadmiral-tpu-torch-shardreplica",
        description="one shard of the sharded control plane over HTTP",
    )
    parser.add_argument("--host-url", required=True, help="host apiserver URL")
    parser.add_argument("--host-token", default="", help="host bearer token")
    parser.add_argument("--shard-count", type=int, default=1)
    parser.add_argument("--shard-index", type=int, default=0)
    parser.add_argument("--ftc", default="deployments.apps", help="FederatedTypeConfig name")
    parser.add_argument(
        "--device", choices=("cuda", "cpu"), default="cuda",
        help="where the scheduling engine runs (no fallback to the CPU)",
    )
    return parser


def _build_controllers(fleet, ftc, engine):
    from kubeadmiral_tpu_torch.federation.federate import FederateController
    from kubeadmiral_tpu_torch.federation.overridectl import OverrideController
    from kubeadmiral_tpu_torch.federation.schedulerctl import SchedulerController
    from kubeadmiral_tpu_torch.federation.statusctl import StatusController
    from kubeadmiral_tpu_torch.federation.sync import SyncController

    return [
        ("federate", FederateController(fleet.host, ftc)),
        ("schedule", SchedulerController(fleet.host, ftc, engine=engine)),
        ("override", OverrideController(fleet.host, ftc)),
        ("sync", SyncController(fleet, ftc)),
        ("status", StatusController(fleet, ftc)),
    ]


def _reasons_hash(engine, host, resource, shard) -> tuple[str, int]:
    """stable_json_hash over {owned key: reason_counts list} from the
    replica's flight recorder (None-safe: disabled recorder → empty)."""
    from kubeadmiral_tpu_torch.utils.hashing import stable_json_hash

    rec = getattr(engine, "flightrec", None)
    out = {}
    if rec is not None and rec.enabled:
        for key in host.keys(resource):
            if not shard.owns(key):
                continue
            r = rec.lookup(key)
            if r is not None:
                out[key] = [int(n) for n in r.reason_counts]
    return stable_json_hash(out), len(out)


def main(argv=None) -> None:
    from kubeadmiral_tpu_torch.federation import shardmap
    from kubeadmiral_tpu_torch.models.ftc import default_ftcs
    from kubeadmiral_tpu_torch.runtime.leaderelection import shard_elector
    from kubeadmiral_tpu_torch.scheduler.engine import SchedulerEngine
    from kubeadmiral_tpu_torch.transport.client import HttpFleet, HttpKube

    args = build_parser().parse_args(argv)
    # Installed before any controller is built: workers resolve the
    # default map once, at construction.
    shardmap.set_default(shardmap.ShardMap(args.shard_count, args.shard_index))
    shard = shardmap.get_default()
    host_url = args.host_url
    token = args.host_token or None
    ftc_name = args.ftc

    host = HttpKube(host_url, token=token, name=f"shard-{shard.shard_index}")
    fleet = HttpFleet(host)
    ftc = next(f for f in default_ftcs() if f.name == ftc_name)
    ftc = dataclasses.replace(
        ftc,
        controllers=(
            ("kubeadmiral.io/global-scheduler",),
            ("kubeadmiral.io/overridepolicy-controller",),
        ),
    )

    # The shard lease first: a replica that reconciles before owning its
    # lease would race a not-yet-dead predecessor for the same keys.
    elector = shard_elector(
        host,
        identity=f"replica-{shard.shard_index}-{os.getpid()}",
        shard_index=shard.shard_index,
    )
    deadline = time.monotonic() + 60.0
    while not elector.try_acquire_or_renew():
        if time.monotonic() > deadline:
            print(json.dumps({"ok": False, "error": "lease acquisition timed out"}),
                  flush=True)
            return
        time.sleep(0.25)
    last_renew = time.monotonic()

    named = _build_controllers(fleet, ftc, SchedulerEngine(device=args.device))
    stages = {name: 0.0 for name, _ in named}
    print(
        json.dumps(
            {
                "ok": True,
                "shard": shard.shard_index,
                "shard_count": shard.shard_count,
                "pid": os.getpid(),
                "leader": elector.is_leader,
            }
        ),
        flush=True,
    )

    idle = 0
    engine = dict(named)["schedule"].engine
    try:
        while True:
            progressed = False
            for name, ctl in named:
                t0 = time.perf_counter()
                stepped = True
                while stepped:
                    stepped = ctl.worker.step()
                    progressed |= stepped
                stages[name] += time.perf_counter() - t0
            idle = 0 if progressed else idle + 1
            now = time.monotonic()
            if now - last_renew > elector.lease_seconds / 3:
                elector.try_acquire_or_renew()
                last_renew = now
            # Command poll; also the idle sleep (watch events arrive on
            # reflector threads, so blocking here costs nothing).
            ready, _, _ = select.select([sys.stdin], [], [], 0.05 if not progressed else 0.0)
            if not ready:
                continue
            line = sys.stdin.readline()
            if not line:  # EOF: parent is gone or tearing down
                return
            if line.strip() != "report":
                continue
            rhash, rkeys = _reasons_hash(
                engine, host, ftc.federated.resource, shard
            )
            owned = sum(
                1 for k in host.keys(ftc.federated.resource) if shard.owns(k)
            )
            print(
                json.dumps(
                    {
                        "type": "report",
                        "shard": shard.shard_index,
                        "settled": idle >= 12,
                        "leader": elector.is_leader,
                        "stages_s": {k: round(v, 3) for k, v in stages.items()},
                        "owned_keys": owned,
                        "reasons_hash": rhash,
                        "reasons_keys": rkeys,
                    }
                ),
                flush=True,
            )
    finally:
        elector.release()
        fleet.close()


if __name__ == "__main__":
    main()
