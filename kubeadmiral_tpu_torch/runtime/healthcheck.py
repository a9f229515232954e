"""Mutable health-check registry + HTTP endpoints.

Mirrors the reference's controller-manager health surface (reference:
pkg/controllermanager/healthcheck/handler.go, served from
cmd/controller-manager/app/controllermanager.go:55-121): a mutable set of
named liveness/readiness checks — controllers register an
``IsControllerReady``-style predicate as they start — exposed at
``/livez`` and ``/readyz`` (200 when every check passes, 500 with the
failing names otherwise; ``?verbose`` lists each check).
"""

from __future__ import annotations

import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Callable, Optional

Check = Callable[[], bool]


class HealthCheckRegistry:
    def __init__(self):
        self._lock = threading.Lock()
        self._liveness: dict[str, Check] = {}
        self._readiness: dict[str, Check] = {}

    def add_liveness(self, name: str, check: Check) -> None:
        with self._lock:
            self._liveness[name] = check

    def add_readiness(self, name: str, check: Check) -> None:
        with self._lock:
            self._readiness[name] = check

    def remove(self, name: str) -> None:
        with self._lock:
            self._liveness.pop(name, None)
            self._readiness.pop(name, None)

    def _run(self, checks: dict[str, Check]) -> dict[str, bool]:
        with self._lock:
            snapshot = dict(checks)
        results = {}
        for name, check in snapshot.items():
            try:
                results[name] = bool(check())
            except Exception:
                results[name] = False
        return results

    def livez(self) -> dict[str, bool]:
        return self._run(self._liveness)

    def readyz(self) -> dict[str, bool]:
        # Readiness implies liveness, as the reference wires both into
        # the same mutable handler.
        return {**self._run(self._liveness), **self._run(self._readiness)}


class HealthServer:
    """Serves the registry at /livez + /readyz (controllermanager.go's
    health HTTP server, default port 11257).  When given a ``metrics``
    registry / ``tracer`` it additionally serves ``/metrics`` (Prometheus
    text format) and ``/debug/trace`` (Chrome trace JSON) alongside the
    pprof-analogue ``/debug/*`` routes, the decision-audit routes
    ``/debug/decisions`` / ``/debug/explain`` / ``/debug/drift``
    (runtime/flightrec.py), the member-health route
    ``/debug/members`` (transport/breaker.py), the end-to-end SLO
    route ``/debug/slo`` (runtime/slo.py), the telemetry timeline
    ``/debug/timeline`` (runtime/timeline.py), the tenant attribution
    route ``/debug/tenants`` (runtime/tenancy.py) and the bare
    ``/debug`` index — one port for the whole operability surface."""

    def __init__(
        self,
        registry: HealthCheckRegistry,
        host: str = "127.0.0.1",
        port: int = 0,
        metrics=None,
        tracer=None,
        flightrec=None,
        drift=None,
        members=None,
        slo=None,
        timeline=None,
        tenants=None,
    ):
        self.registry = registry
        self.metrics = metrics
        self.tracer = tracer
        self.flightrec = flightrec
        self.drift = drift
        self.members = members
        self.slo = slo
        self.timeline = timeline
        self.tenants = tenants
        self._host = host
        self._port = port
        self._server: Optional[ThreadingHTTPServer] = None
        self._thread: Optional[threading.Thread] = None

    @property
    def port(self) -> int:
        assert self._server is not None, "server not started"
        return self._server.server_address[1]

    def start(self) -> int:
        registry = self.registry
        outer = self

        class Handler(BaseHTTPRequestHandler):
            def do_GET(self) -> None:  # noqa: N802 (http.server API)
                path, _, raw_query = self.path.partition("?")
                if (
                    path == "/debug"
                    or path.startswith("/debug/")
                    or path == "/metrics"
                ):
                    # Shared operability routes (profiling.py): metrics
                    # exposition, trace export, profile/stacks/threads.
                    from kubeadmiral_tpu_torch.runtime import profiling

                    if not profiling.respond_debug(
                        self, path, raw_query,
                        metrics=outer.metrics, tracer=outer.tracer,
                        flightrec=outer.flightrec, drift=outer.drift,
                        members=outer.members, slo=outer.slo,
                        timeline=outer.timeline, tenants=outer.tenants,
                    ):
                        self.send_error(404)
                    return
                if path == "/livez":
                    results = registry.livez()
                elif path == "/readyz":
                    results = registry.readyz()
                else:
                    self.send_error(404)
                    return
                healthy = all(results.values())
                body = json.dumps(
                    {"healthy": healthy, "checks": results}
                ).encode()
                self.send_response(200 if healthy else 500)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def log_message(self, *args) -> None:
                pass

        self._server = ThreadingHTTPServer((self._host, self._port), Handler)
        self._thread = threading.Thread(
            target=self._server.serve_forever, name="health-server", daemon=True
        )
        self._thread.start()
        return self.port

    def stop(self) -> None:
        if self._server is not None:
            self._server.shutdown()
            self._server.server_close()
            self._server = None
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None
