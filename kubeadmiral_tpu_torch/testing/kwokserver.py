"""Standalone member-apiserver process for the kwok-lite farm.

A copy of ``kubeadmiral_tpu/testing/kwokserver.py`` for the port's control
plane.

The reference's KWOK provider spawns each fake cluster as separate
processes (reference: test/e2e/framework/clusterprovider/kwokprovider.go:70-260
via kwokctl — one apiserver + etcd per cluster).  The single-process
farm serializes every member apiserver and every controller on one GIL,
which BASELINE.md identified as the remaining HTTP-e2e ceiling; running
members here, as real subprocesses, removes that artifact from the
measurement.

Protocol: configuration arrives on the command line (``--name``,
``--token``, ``--port``, ``--telemetry-dir``; the JAX module reads
KWOK_NAME, KWOK_TOKEN, KWOK_PORT and KT_TELEMETRY_DIR); once the server is listening, one JSON line {"url": ...} is
printed to stdout; the process exits when stdin reaches EOF (the parent
holds the pipe, so farm teardown — or a parent crash — reaps the child
without pid bookkeeping).

Observability: each member carries its own Metrics registry (request
counts by verb, served at GET /metrics with the rest of the /debug
surface) — the per-instance page the manager's fleet scraper merges
into /debug/fleet — and, given ``--telemetry-dir``, a telemetry
spiller (runtime/telespill.py) persisting the member's span ring (the
server-side halves of propagated traces) so tools/trace_assemble.py
can rebuild cross-process traces even after the member dies.
"""

from __future__ import annotations

import argparse
import json
import sys


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        prog="kubeadmiral-tpu-torch-kwokserver",
        description="one member apiserver of the kwok-lite farm",
    )
    parser.add_argument("--name", default="member", help="member (store) name")
    parser.add_argument("--token", default="", help="admin bearer token ('' = no auth)")
    parser.add_argument("--port", type=int, default=0, help="listen port (0 = ephemeral)")
    parser.add_argument(
        "--telemetry-dir", default=None,
        help="spill the member's telemetry here (default: no spilling)",
    )
    return parser


def main(argv=None) -> None:
    from kubeadmiral_tpu_torch.runtime import telespill
    from kubeadmiral_tpu_torch.runtime.metrics import Metrics
    from kubeadmiral_tpu_torch.testing.fakekube import FakeKube
    from kubeadmiral_tpu_torch.transport.apiserver import KubeApiServer
    from kubeadmiral_tpu_torch.transport.faults import FaultInjector

    args = build_parser().parse_args(argv)
    name = args.name
    token = args.token or None
    port = args.port
    store = FakeKube(name)
    metrics = Metrics()
    # The child's own injector, driven over the wire by the parent's
    # farm.set_fault/clear_fault via POST /faultz — subprocess members
    # are chaos-injectable exactly like in-process ones.
    server = KubeApiServer(
        store, admin_token=token, port=port, mint_sa_tokens=True,
        fault_injector=FaultInjector(), fault_name=name,
        metrics=metrics,
    )
    spiller = telespill.TelemetrySpiller(
        directory=args.telemetry_dir, instance=name, metrics=metrics
    )
    spiller.start()
    print(json.dumps({"url": server.url}), flush=True)
    try:
        sys.stdin.read()  # block until the parent closes the pipe
    finally:
        spiller.stop()  # final spill: the ring's tail outlives teardown
        server.close()


if __name__ == "__main__":
    main()
