"""CLI entry: ``python -m kubeadmiral_tpu_torch``.

A copy of ``kubeadmiral_tpu/__main__.py`` over the port, with one more
flag, ``--device {cuda,cpu}`` (default ``cuda``): the scheduling engine
runs on the card unless the caller asks for the CPU, and without CUDA
the default fails at engine construction with a nonzero exit, never
falling back to the CPU.  ``--transport http`` serves the control plane
over a kwok-lite farm of real apiserver sockets (``testing/kwoklite.py``):
a host apiserver on ``--host-port`` and one member apiserver per
``--members``, each with one Ready Node and a FederatedCluster, so the
cluster controller performs the real join handshake.  Every line it
prints is flushed, so a parent process can read the ports and tokens.

Mirrors the reference controller-manager's flag surface (reference:
cmd/controller-manager/main.go:32-46,
cmd/controller-manager/app/options/options.go:34-130) over the in-memory
control plane: build a fleet, install the default FederatedTypeConfigs,
start the controller manager behind leader election, and serve
/livez + /readyz.  This is the ``make dev-up`` analogue — a
self-contained control plane for local exploration; a real-apiserver
transport drops in behind the same ClusterFleet interface.
"""

from __future__ import annotations

import argparse
import os
import sys
import time


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        prog="kubeadmiral-tpu-torch-controller-manager",
        description="KubeAdmiral controller manager on the PyTorch/CUDA engine",
    )
    parser.add_argument(
        "--port", type=int, default=11257,
        help="health probe port (0 = ephemeral)",
    )
    parser.add_argument(
        "--controllers", default="*",
        help="comma list of always-on controllers; '-name' disables, '*' = defaults",
    )
    parser.add_argument(
        "--worker-count", type=int, default=1,
        help="reconcile worker threads per controller",
    )
    parser.add_argument("--leader-elect", action="store_true", default=True)
    parser.add_argument("--no-leader-elect", dest="leader_elect", action="store_false")
    parser.add_argument(
        "--cluster-join-timeout", type=float, default=600.0,
        help="seconds before an unjoinable cluster is marked timed out",
    )
    parser.add_argument(
        "--nsautoprop-exclude-regexp", default="",
        help="namespaces matching this regexp are not auto-propagated",
    )
    parser.add_argument(
        "--create-crds-for-ftcs", action="store_true",
        help="install the default FederatedTypeConfig set at startup",
    )
    parser.add_argument(
        "--members", type=int, default=3,
        help="number of member clusters to create",
    )
    parser.add_argument(
        "--host-port", type=int, default=0,
        help="host apiserver port for --transport http (0 = ephemeral)",
    )
    parser.add_argument(
        "--transport", choices=("memory", "http"), default="memory",
        help="memory = in-process stores (demo); http = a kwok-lite farm "
        "of real apiserver sockets",
    )
    parser.add_argument("--run-seconds", type=float, default=0.0,
        help="exit after this many seconds (0 = run forever)")
    parser.add_argument(
        "--max-pod-listers", type=int, default=4,
        help="bound on concurrent member pod LISTs (pod informer)",
    )
    parser.add_argument(
        "--enable-pod-pruning", action=argparse.BooleanOptionalAction,
        default=True,
        help="strip cached pods to scheduling-relevant fields (default on)",
    )
    parser.add_argument(
        "--enable-profiling", action="store_true",
        help="serve pprof-style endpoints on --profiling-port "
        "(/debug/profile, /debug/stacks, /debug/threads); the health "
        "port always serves them too",
    )
    parser.add_argument(
        "--profiling-port", type=int, default=6060,
        help="standalone profiling port (reference's :6060)",
    )
    parser.add_argument(
        "--device", choices=("cuda", "cpu"), default="cuda",
        help="where the scheduling engine runs (cuda = the card; no "
        "fallback to the CPU when CUDA is missing)",
    )
    return parser


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    sys.stdout.reconfigure(line_buffering=True)

    from kubeadmiral_tpu_torch.runtime.logconf import setup_logging

    setup_logging()  # logconf.LEVEL / JSON_LINES

    from kubeadmiral_tpu_torch.models.ftc import FEDERATED_TYPE_CONFIGS, default_ftcs, ftc_to_object
    from kubeadmiral_tpu_torch.runtime.healthcheck import HealthCheckRegistry, HealthServer
    from kubeadmiral_tpu_torch.runtime.leaderelection import LeaderElector
    from kubeadmiral_tpu_torch.runtime.manager import ControllerManager
    from kubeadmiral_tpu_torch.runtime.metrics import Metrics
    from kubeadmiral_tpu_torch.scheduler.engine import SchedulerEngine
    from kubeadmiral_tpu_torch.testing.fakekube import AlreadyExists, ClusterFleet

    farm = None
    if args.transport == "http":
        # Real sockets: a kwok-lite farm (host + member apiservers with
        # REST/watch/auth), FederatedCluster CRs registered so the
        # cluster controller performs the real join handshake.
        from kubeadmiral_tpu_torch.federation.common import FEDERATED_CLUSTERS
        from kubeadmiral_tpu_torch.testing.kwoklite import KwokLiteFarm

        farm = KwokLiteFarm(host_port=args.host_port)
        fleet = farm.fleet
        for i in range(args.members):
            name = f"member-{i + 1}"
            member = farm.add_member(name)
            member.create(
                "v1/nodes",
                {
                    "apiVersion": "v1",
                    "kind": "Node",
                    "metadata": {"name": f"{name}-node"},
                    "spec": {},
                    "status": {
                        "allocatable": {"cpu": "32", "memory": "128Gi"},
                        "conditions": [{"type": "Ready", "status": "True"}],
                    },
                },
            )
            fleet.host.create(
                FEDERATED_CLUSTERS,
                {
                    "apiVersion": "core.kubeadmiral.io/v1alpha1",
                    "kind": "FederatedCluster",
                    "metadata": {"name": name},
                    "spec": farm.cluster_spec(name),
                },
            )
        print(f"host apiserver on {farm.host_server.url}")
        for name, member_server in farm.member_servers.items():
            # Demo farm: print the member admin token so quickstart curls
            # can read the propagated objects (member apiservers require
            # bearer auth, exactly like real clusters).
            print(
                f"member {name} apiserver on {member_server.url} "
                f"(admin token: {member_server.admin_token})"
            )
    else:
        fleet = ClusterFleet()
        for i in range(args.members):
            fleet.add_member(f"member-{i + 1}")

    health = HealthCheckRegistry()
    # ONE registry shared by the manager's controllers, the engine
    # and the HTTP exposition (docs/observability.md).
    metrics = Metrics()
    server = HealthServer(health, port=args.port, metrics=metrics)
    port = server.start()
    print(
        f"health endpoints on :{port} (/livez, /readyz, /metrics, /debug/*)"
    )

    if args.enable_profiling:
        from kubeadmiral_tpu_torch.runtime.profiling import ProfilingServer

        prof_server = ProfilingServer(port=args.profiling_port, metrics=metrics)
        print(
            f"profiling endpoints on :{prof_server.start()} (/metrics, /debug/*)"
        )

    elector = LeaderElector(fleet.host, identity=f"manager-{os.getpid()}")
    if args.leader_elect:
        while not elector.try_acquire_or_renew():
            time.sleep(1.0)
        print(f"leader election won as {elector.identity}")

    manager = ControllerManager(
        fleet,
        enabled=[c for c in args.controllers.split(",") if c],
        metrics=metrics,
        health=health,
        engine=SchedulerEngine(device=args.device, metrics=metrics),
        cluster_controller_kwargs={"join_timeout": args.cluster_join_timeout},
        max_pod_listers=args.max_pod_listers,
        enable_pod_pruning=args.enable_pod_pruning,
    )
    if args.create_crds_for_ftcs:
        for ftc in default_ftcs():
            try:
                fleet.host.create(FEDERATED_TYPE_CONFIGS, ftc_to_object(ftc))
            except AlreadyExists:
                pass
        print(f"installed {len(default_ftcs())} FederatedTypeConfigs")

    manager.run(args.worker_count)
    print("controller manager running; Ctrl-C to stop")

    # SIGTERM = graceful failover (docs/operations.md § Restart &
    # failover runbook): drain in-flight dispatch flushes under the
    # manager's bounded shutdown deadline, write a final engine
    # snapshot, release leadership so a standby acquires immediately.
    # SIGKILL gets none of this — which is exactly what the snapshot
    # store's atomic-write + quarantine design (and make restart-smoke)
    # exists for.
    import signal
    import threading

    stop_event = threading.Event()

    def _on_sigterm(signum, frame):
        print("SIGTERM: draining for graceful failover")
        stop_event.set()

    try:
        signal.signal(signal.SIGTERM, _on_sigterm)
    except ValueError:
        pass  # not the main thread (embedded use)

    deadline = time.monotonic() + args.run_seconds if args.run_seconds else None
    try:
        while not stop_event.is_set() and (
            deadline is None or time.monotonic() < deadline
        ):
            if args.leader_elect and not elector.try_acquire_or_renew():
                print("lost leader election; exiting")  # fatal, as in the reference
                return 1
            stop_event.wait(min(elector.lease_seconds / 3, 5.0))
    except KeyboardInterrupt:
        pass
    finally:
        summary = manager.shutdown()
        if args.leader_elect and elector.release():
            print("leadership released")
        print(
            f"shutdown: shed_writes={summary['shed_writes']} "
            f"snapshot={summary['snapshot']}"
        )
        server.stop()
        if farm is not None:
            farm.close()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
