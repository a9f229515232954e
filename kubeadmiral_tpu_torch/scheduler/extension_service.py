"""ExtensionService: host a scheduler webhook plugin over HTTP.

A copy of ``kubeadmiral_tpu/scheduler/extension_service.py`` for the port's control
plane.

The serving side of the webhook protocol (reference precedent:
examples/scheduler/webhook/main.go — a standalone HTTP server
implementing filter/score/select against the JSON payload schema of
pkg/apis/schedulerwebhook/v1alpha1).  Plug in Python callables:

    service = ExtensionService(
        filter_fn=lambda req: {"selected": ...},
        score_fn=lambda req: {"score": ...},
        select_fn=lambda req: {"selectedClusterNames": [...]},
    )
    port = service.start()

Each callable receives the decoded request dict ({schedulingUnit,
cluster} for filter/score, {schedulingUnit, clusterScores} for select)
and returns the response dict; raising maps to the protocol's ``error``
field.  This is also how a TPU-backed scoring sidecar is exposed to a
non-TPU control plane: run the engine inside ``score_fn``/``select_fn``.
"""

from __future__ import annotations

import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Callable, Optional

Handler = Callable[[dict], dict]


def _batch_wrap(fn: Handler, pair_field: str, batch_field: str) -> Handler:
    """Serve the batch protocol on top of a per-pair handler: the whole
    (units x clusters) grid is evaluated server-side in ONE HTTP round
    trip instead of O(B x C) requests."""

    def handler(request: dict) -> dict:
        units = request.get("schedulingUnits", [])
        clusters = request.get("clusters", [])
        rows = [
            [
                fn({"schedulingUnit": su, "cluster": cluster}).get(pair_field)
                for cluster in clusters
            ]
            for su in units
        ]
        return {batch_field: rows}

    return handler


class ExtensionService:
    FILTER_PATH = "/filter"
    SCORE_PATH = "/score"
    SELECT_PATH = "/select"
    FILTER_BATCH_PATH = "/filter-batch"
    SCORE_BATCH_PATH = "/score-batch"

    def __init__(
        self,
        filter_fn: Optional[Handler] = None,
        score_fn: Optional[Handler] = None,
        select_fn: Optional[Handler] = None,
        filter_batch_fn: Optional[Handler] = None,
        score_batch_fn: Optional[Handler] = None,
        host: str = "127.0.0.1",
        port: int = 0,
        serve_batch: bool = True,
        tls_cert_file: str = "",
        tls_key_file: str = "",
        tls_client_ca_file: str = "",
    ):
        """With ``serve_batch`` (default), per-pair handlers also serve
        their "-batch" sibling endpoints; pass explicit
        ``filter_batch_fn``/``score_batch_fn`` for a vectorized
        implementation (e.g. a TPU-backed scorer evaluating the whole
        grid in one dispatch).  ``serve_batch=False`` emulates a
        reference-protocol server (per-pair endpoints only)."""
        self.handlers: dict[str, Handler] = {}
        if filter_fn:
            self.handlers[self.FILTER_PATH] = filter_fn
        if score_fn:
            self.handlers[self.SCORE_PATH] = score_fn
        if select_fn:
            self.handlers[self.SELECT_PATH] = select_fn
        if filter_batch_fn:
            self.handlers[self.FILTER_BATCH_PATH] = filter_batch_fn
        elif filter_fn and serve_batch:
            self.handlers[self.FILTER_BATCH_PATH] = _batch_wrap(
                filter_fn, "selected", "selected"
            )
        if score_batch_fn:
            self.handlers[self.SCORE_BATCH_PATH] = score_batch_fn
        elif score_fn and serve_batch:
            self.handlers[self.SCORE_BATCH_PATH] = _batch_wrap(
                score_fn, "score", "scores"
            )
        self._host = host
        self._port = port
        # TLS serving (the server half of the webhook TLSConfig round
        # trip): cert+key enable https; a client CA additionally demands
        # a client certificate (mTLS, TLSConfig.CertData/KeyData).
        self._tls_cert_file = tls_cert_file
        self._tls_key_file = tls_key_file
        self._tls_client_ca_file = tls_client_ca_file
        self._server: Optional[ThreadingHTTPServer] = None
        self._thread: Optional[threading.Thread] = None

    @property
    def url_prefix(self) -> str:
        assert self._server is not None, "service not started"
        scheme = "https" if self._tls_cert_file else "http"
        return f"{scheme}://{self._host}:{self._server.server_address[1]}"

    def start(self) -> int:
        handlers = self.handlers

        class RequestHandler(BaseHTTPRequestHandler):
            def do_POST(self) -> None:  # noqa: N802 (http.server API)
                handler = handlers.get(self.path)
                if handler is None:
                    self.send_error(404)
                    return
                length = int(self.headers.get("Content-Length", 0))
                try:
                    request = json.loads(self.rfile.read(length) or b"{}")
                    response = handler(request)
                except Exception as e:  # -> protocol error field
                    response = {"error": str(e)}
                body = json.dumps(response).encode()
                self.send_response(200)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def log_message(self, *args) -> None:  # quiet
                pass

        self._server = ThreadingHTTPServer((self._host, self._port), RequestHandler)
        if self._tls_cert_file:
            import ssl

            ctx = ssl.SSLContext(ssl.PROTOCOL_TLS_SERVER)
            ctx.load_cert_chain(self._tls_cert_file, self._tls_key_file or None)
            if self._tls_client_ca_file:
                ctx.load_verify_locations(self._tls_client_ca_file)
                ctx.verify_mode = ssl.CERT_REQUIRED
            # Handshake on the HANDLER thread, not in accept(): with
            # do_handshake_on_connect a stalled client (port scanner,
            # plain-HTTP probe) would block the single accept loop and
            # starve every other webhook call.
            self._server.socket = ctx.wrap_socket(
                self._server.socket,
                server_side=True,
                do_handshake_on_connect=False,
            )

            server = self._server

            class _HandshakeHandler(RequestHandler):
                def setup(self) -> None:
                    # self.request is the raw (wrapped, un-handshaken)
                    # SSL socket; self.connection only exists after
                    # super().setup().
                    self.request.settimeout(10.0)
                    self.request.do_handshake()
                    super().setup()

            server.RequestHandlerClass = _HandshakeHandler
        self._thread = threading.Thread(
            target=self._server.serve_forever, name="extension-service", daemon=True
        )
        self._thread.start()
        return self._server.server_address[1]

    def stop(self) -> None:
        if self._server is not None:
            self._server.shutdown()
            self._server.server_close()
            self._server = None
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None

    def webhook_configuration(self, name: str) -> dict:
        """The SchedulerPluginWebhookConfiguration object registering this
        service (for tests and local setups)."""
        spec: dict = {
            "urlPrefix": self.url_prefix,
            "payloadVersions": ["v1alpha1"],
        }
        if self.FILTER_PATH in self.handlers:
            spec["filterPath"] = self.FILTER_PATH
        if self.SCORE_PATH in self.handlers:
            spec["scorePath"] = self.SCORE_PATH
        if self.SELECT_PATH in self.handlers:
            spec["selectPath"] = self.SELECT_PATH
        return {
            "apiVersion": "core.kubeadmiral.io/v1alpha1",
            "kind": "SchedulerPluginWebhookConfiguration",
            "metadata": {"name": name},
            "spec": spec,
        }
