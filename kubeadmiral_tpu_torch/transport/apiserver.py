"""HTTP apiserver: Kubernetes-style REST + watch over a FakeKube store.

A copy of ``kubeadmiral_tpu/transport/apiserver.py`` for the port's control
plane.

This is the server half of the real transport (SURVEY.md §2.2 "generated
clients / apiserver transport"): it serves a :class:`FakeKube` store —
which already implements the semantics the control plane depends on
(optimistic concurrency, finalizer-gated deletion, generation bumps,
status subresource) — over real sockets with the protocol shape of an
apiserver:

* ``GET/POST/PUT/DELETE`` on ``/api/...`` / ``/apis/...`` paths
  (:mod:`kubeadmiral_tpu_torch.transport.paths`), JSON bodies, k8s-style
  ``Status`` error objects with ``reason`` Conflict/NotFound/AlreadyExists.
* ``GET ...?watch=true&resourceVersion=N`` — chunked-transfer watch
  stream of ``{"type": ..., "object": ...}`` lines resuming after N,
  backed by a bounded per-resource event log; a too-old N gets 410 Gone
  and the client must relist (exactly client-go's contract).
* ``PUT .../{name}/status`` — status subresource.
* ``GET /healthz`` — respects ``store.healthy`` so tests can fail probes.
* Optional bearer-token auth: an admin token plus any service-account
  token minted by the server (see ``mint_sa_tokens``), which is how the
  cluster-join handshake's credentials become real
  (reference: pkg/controllers/federatedcluster/clusterjoin.go:241-580).
"""

from __future__ import annotations

import bisect
import hashlib
import hmac
import json
import secrets as pysecrets
import socket
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional
from urllib.parse import parse_qs, urlsplit

from kubeadmiral_tpu_torch.runtime import trace
from kubeadmiral_tpu_torch.testing.fakekube import (
    ADDED,
    AlreadyExists,
    Conflict,
    FakeKube,
    NotFound,
    obj_key as fk_obj_key,
)
from kubeadmiral_tpu_torch.transport.paths import parse_path

SERVICE_ACCOUNTS = "v1/serviceaccounts"
SECRETS = "v1/secrets"

# Watch streams send a heartbeat line when idle so dead peers are
# detected; clients ignore it (k8s uses BOOKMARK events similarly).
HEARTBEAT = b'{"type":"HEARTBEAT"}\n'


class _ResourceLog:
    """One resource's event history: parallel (seqs, lines) lists with
    front-eviction by compaction, so resume is a bisect + slice instead
    of an O(cap) scan per watcher wakeup.  ``lines`` entries are either
    rendered ``bytes`` or a pending ``(event, obj)`` tuple — see
    :meth:`_EventLog.since`."""

    __slots__ = ("seqs", "lines", "evicted")

    def __init__(self):
        self.seqs: list[int] = []
        self.lines: list = []
        self.evicted = False


class _EventLog:
    """Per-resource bounded event logs with resourceVersion resume.

    Serialization is LAZY: the write path (which runs as a store
    observer, under the store lock) appends ``(event, obj)`` tuples;
    a line is rendered to JSON bytes on first watcher read and memoized
    in place, so a resource nobody watches never pays ``json.dumps`` at
    all, N watchers of one resource pay it once, and the store lock
    never holds serialization work.  Safe because the COW store's
    committed nodes are immutable — the obj captured at append time is
    the exact state the event described."""

    def __init__(self, cap: int = 100_000):
        self.cap = cap
        self.cond = threading.Condition()
        self.logs: dict[str, _ResourceLog] = {}

    def append(self, resource: str, event: str, obj: dict, seq: int) -> None:
        with self.cond:
            log = self.logs.setdefault(resource, _ResourceLog())
            log.seqs.append(seq)
            log.lines.append((event, obj))
            if len(log.seqs) > 2 * self.cap:  # amortized O(1) eviction
                drop = len(log.seqs) - self.cap
                del log.seqs[:drop]
                del log.lines[:drop]
                log.evicted = True
            self.cond.notify_all()

    def append_many(self, items: list) -> None:
        """Append one committed store flush ``[(resource, event, obj,
        seq), ...]`` under ONE cond hold with ONE wakeup, instead of a
        lock/notify_all cycle per event (the store-side analogue of the
        write-coalescing that batches the writes themselves).  No
        per-op ``json.dumps`` here — rendering is deferred to first
        read (one serialization pass per coalesced batch, and only for
        watched resources)."""
        with self.cond:
            for resource, event, obj, seq in items:
                log = self.logs.setdefault(resource, _ResourceLog())
                log.seqs.append(seq)
                log.lines.append((event, obj))
                if len(log.seqs) > 2 * self.cap:
                    drop = len(log.seqs) - self.cap
                    del log.seqs[:drop]
                    del log.lines[:drop]
                    log.evicted = True
            self.cond.notify_all()

    def since(self, resource: str, rv: int) -> tuple[Optional[list[bytes]], int]:
        """(lines after rv, latest seq); lines is None when rv is too old
        (already evicted from the log) and the watcher must relist.
        Pending entries are rendered here, once, and memoized in place
        for every later reader."""
        with self.cond:
            log = self.logs.get(resource)
            if log is None or not log.seqs:
                return [], rv
            latest = log.seqs[-1]
            if log.evicted and rv < log.seqs[0] - 1:
                return None, latest  # history truncated: 410 Gone
            idx = bisect.bisect_right(log.seqs, rv)
            out = []
            lines = log.lines
            for i in range(idx, len(lines)):
                line = lines[i]
                if type(line) is not bytes:
                    line = (
                        json.dumps({"type": line[0], "object": line[1]}).encode()
                        + b"\n"
                    )
                    lines[i] = line
                out.append(line)
            return out, latest


class KubeApiServer:
    """One apiserver process-equivalent serving ``store`` on localhost."""

    def __init__(
        self,
        store: FakeKube,
        host: str = "127.0.0.1",
        port: int = 0,
        admin_token: Optional[str] = None,
        mint_sa_tokens: bool = False,
        event_log_cap: int = 100_000,
        sa_signing_key: Optional[str] = None,
        fault_injector=None,
        fault_name: Optional[str] = None,
        metrics=None,
    ):
        self.store = store
        self.admin_token = admin_token
        # Optional per-server registry: request counts by verb, served
        # at GET /metrics (with the rest of the /debug surface) so the
        # fleet scraper can aggregate member apiservers too.
        self.metrics = metrics
        # Fault-injection seam (transport/faults.py): when given, every
        # request and watch stream resolves this member's FaultPolicy
        # first — added latency, injected 500s, severed connections,
        # connect-timeout partitions, silent watch streams.
        self.fault_injector = fault_injector
        self.fault_name = fault_name or store.name
        self._tokens: set[str] = set()
        # Minted tokens are self-authenticating: HMAC(signing key,
        # secret key + SA name) — the analogue of the real apiserver's
        # JWT signature.  The type string, annotation and data.token of
        # a secret are all client-settable (sync can propagate workload
        # Secrets claiming anything), but a valid HMAC cannot be forged
        # without the signing key; and because trust is recomputed from
        # the value itself, a server restarted over a resumed store
        # (given the same sa_signing_key, like the real apiserver's
        # --service-account-key-file) re-grants exactly the tokens it
        # minted and nothing an attacker planted meanwhile.
        self._sa_key = (sa_signing_key or pysecrets.token_hex(16)).encode()
        # secret key -> token currently granted, so rotation/annotation
        # changes revoke the stale value instead of leaking it forever.
        self._granted: dict[str, str] = {}
        self._log = _EventLog(event_log_cap)
        self._closed = threading.Event()
        self._mint_sa_tokens = mint_sa_tokens

        for secret in store.list_view(SECRETS):
            self._regrant(secret)
        store.watch_all(self._on_store_event, batch=self._on_store_events)

        class _TrackingServer(ThreadingHTTPServer):
            """Tracks live per-connection sockets so close() can sever
            kept-alive connections — shutdown() alone only stops NEW
            accepts, and a crashed/"unreachable" member must look dead
            to clients holding pooled connections too."""

            # http.server's default backlog of 5 resets fresh
            # connections under a mutation storm (every write rides a
            # new connection by design; an overflowed accept queue +
            # syncookies RSTs the first payload).  A control plane's
            # apiserver must absorb bursts.
            request_queue_size = 128

            def __init__(self_srv, *a, **kw):
                self_srv.live_sockets = set()
                self_srv.live_lock = threading.Lock()
                super().__init__(*a, **kw)

            def process_request(self_srv, request, client_address):
                with self_srv.live_lock:
                    self_srv.live_sockets.add(request)
                super().process_request(request, client_address)

            def close_request(self_srv, request):
                with self_srv.live_lock:
                    self_srv.live_sockets.discard(request)
                super().close_request(request)

        server = _TrackingServer((host, port), _Handler)
        server.daemon_threads = True
        server.api = self  # type: ignore[attr-defined]
        self._server = server
        self.host = host
        self.port = server.server_address[1]
        self.url = f"http://{self.host}:{self.port}"
        self._thread = threading.Thread(
            target=server.serve_forever, name=f"apiserver-{store.name}",
            daemon=True,
        )
        self._thread.start()

    def _mint_value(self, secret_key: str, sa_name: str) -> str:
        """The (deterministic, unforgeable) token for one SA's secret."""
        msg = f"{secret_key}\x00{sa_name}".encode()
        return hmac.new(self._sa_key, msg, hashlib.sha256).hexdigest()

    def _trusted_token(self, secret: dict) -> Optional[str]:
        """The token this secret legitimately carries, or None.

        Mirrors the real token controller's contract: the secret is
        token-typed, its kubernetes.io/service-account.name annotation
        references a ServiceAccount that exists, and data.token
        verifies against the signing key for exactly this (secret, SA)
        pair.  A federated workload Secret propagated by sync can fake
        the type, the annotation and the value — but not the HMAC."""
        if secret.get("type") != "kubernetes.io/service-account-token":
            return None
        meta = secret.get("metadata") or {}
        sa_name = (meta.get("annotations") or {}).get(
            "kubernetes.io/service-account.name"
        )
        if not sa_name:
            return None
        namespace = meta.get("namespace", "")
        sa_key = f"{namespace}/{sa_name}" if namespace else sa_name
        if self.store.try_get(SERVICE_ACCOUNTS, sa_key) is None:
            return None
        token = (secret.get("data") or {}).get("token")
        # data.token is client-settable: a non-str / non-ASCII value must
        # read as "untrusted", not raise out of the store event feed (and
        # permanently crash server restarts over the resumed store).
        if not isinstance(token, str) or not token:
            return None
        expected = self._mint_value(fk_obj_key(secret), sa_name)
        try:
            if not hmac.compare_digest(token, expected):
                return None
        except TypeError:
            return None
        return token

    def _regrant(self, secret: dict, deleted: bool = False) -> None:
        """Recompute one secret's grant, revoking any stale value: the
        single transition point for grant state, so rotation, annotation
        changes, SA appearance/disappearance and deletion all converge
        (no path can leak a previously granted token)."""
        key = fk_obj_key(secret)
        new = None if deleted else self._trusted_token(secret)
        old = self._granted.get(key)
        if old is not None and old != new:
            self._tokens.discard(old)
        if new is None:
            self._granted.pop(key, None)
        else:
            self._granted[key] = new
            self._tokens.add(new)

    def _secrets_referencing(self, sa: dict) -> list[dict]:
        """Token-typed secrets annotated with this SA's name."""
        meta = sa.get("metadata", {})
        out = []
        for secret in self.store.list_view(SECRETS):
            if secret.get("type") != "kubernetes.io/service-account-token":
                continue
            smeta = secret.get("metadata") or {}
            if smeta.get("namespace", "") != meta.get("namespace", ""):
                continue
            if (smeta.get("annotations") or {}).get(
                "kubernetes.io/service-account.name"
            ) == meta.get("name"):
                out.append(secret)
        return out

    # -- store event feed (runs under the store lock) --------------------
    def _on_store_events(self, flush: list) -> None:
        """Coalesced feed of one committed store flush.  Event-log lines
        land FIRST, all of them, under one cond hold: the SA/secret side
        effects below write back into the store, and those nested events
        must append strictly AFTER this flush's lines or per-resource
        log seqs stop being sorted and watch-resume bisect breaks."""
        self._log.append_many(flush)
        for resource, event, obj, _ in flush:
            if resource in (SECRETS, SERVICE_ACCOUNTS):
                self._on_credential_event(resource, event, obj)

    def _on_store_event(self, resource: str, event: str, obj: dict, seq: int) -> None:
        self._log.append(resource, event, obj, seq)
        if resource in (SECRETS, SERVICE_ACCOUNTS):
            self._on_credential_event(resource, event, obj)

    def _on_credential_event(self, resource: str, event: str, obj: dict) -> None:
        if resource == SECRETS:
            self._regrant(obj, deleted=event == "DELETED")
        elif resource == SERVICE_ACCOUNTS:
            if event == ADDED and self._mint_sa_tokens:
                self._mint_token(obj)
            if event == "DELETED" and self._mint_sa_tokens:
                # Token-controller garbage collection: a deleted SA's
                # token secrets go with it (k8s's legacy token cleanup).
                # Without this, unjoin cleanup could never remove the
                # credential it is itself authenticating with — deleting
                # the SA first revokes the token and every subsequent
                # member call 401s.  Matched by type + SA annotation
                # (never by name convention: a sync-propagated workload
                # secret named "<sa>-token" must survive).
                for secret in self._secrets_referencing(obj):
                    try:
                        self.store.delete(SECRETS, fk_obj_key(secret))
                    except NotFound:
                        pass
            # Re-evaluate grants of secrets referencing this SA: its
            # appearance enables boot-trusted secrets that landed first;
            # its deletion revokes their tokens even while a secret
            # lingers (crash between SA handling and secret GC, or a
            # non-minting server — no live credential either way).
            for secret in self._secrets_referencing(obj):
                self._regrant(secret)

    def _mint_token(self, sa: dict) -> None:
        """Create a token Secret for a new ServiceAccount — the member-
        side token controller the join handshake waits on (the reference
        reads the SA's token secret, clusterjoin.go:449-529)."""
        meta = sa["metadata"]
        name = f"{meta['name']}-token"
        namespace = meta.get("namespace", "")
        key = f"{namespace}/{name}" if namespace else name
        try:
            self.store.create(
                SECRETS,
                {
                    "apiVersion": "v1",
                    "kind": "Secret",
                    "type": "kubernetes.io/service-account-token",
                    "metadata": {
                        "name": name,
                        "namespace": namespace,
                        "annotations": {
                            "kubernetes.io/service-account.name": meta["name"]
                        },
                    },
                    "data": {"token": self._mint_value(key, meta["name"])},
                },
            )
        except AlreadyExists:
            # A lingering secret from a previous SA incarnation carries
            # the same deterministic value; the caller's regrant loop
            # re-grants it now that the SA exists again.
            pass

    # -- auth ------------------------------------------------------------
    def authorized(self, header: Optional[str]) -> bool:
        if self.admin_token is None:
            return True
        if not header or not header.startswith("Bearer "):
            return False
        token = header[len("Bearer "):]
        return token == self.admin_token or token in self._tokens

    def close(self) -> None:
        self._closed.set()
        with self._log.cond:
            self._log.cond.notify_all()  # release idle watch streams
        self._server.shutdown()
        self._server.server_close()
        # Sever kept-alive connections: a closed server must be
        # unreachable, not half-alive through pooled client sockets.
        with self._server.live_lock:
            sockets = list(self._server.live_sockets)
            self._server.live_sockets.clear()
        for sock in sockets:
            try:
                sock.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
            try:
                sock.close()
            except OSError:
                pass


class _Handler(BaseHTTPRequestHandler):
    protocol_version = "HTTP/1.1"
    # Nagle + delayed ACK turns every response on a kept-alive
    # connection into a ~40 ms stall (the response spans multiple small
    # writes); an apiserver's latency budget is microseconds.
    disable_nagle_algorithm = True

    @property
    def api(self) -> KubeApiServer:
        return self.server.api  # type: ignore[attr-defined]

    def log_message(self, *args):  # silence request logging
        pass

    # -- plumbing --------------------------------------------------------
    def _send_json(self, code: int, payload: dict, extra: Optional[dict] = None) -> None:
        body = json.dumps(payload).encode()
        try:
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            for k, v in (extra or {}).items():
                self.send_header(k, v)
            self.end_headers()
            self.wfile.write(body)
        except (BrokenPipeError, ConnectionResetError):
            # The client gave up mid-response (e.g. its timeout fired
            # while a fault held this request): a vanished peer is a
            # closed connection, not a handler crash to traceback.
            self.close_connection = True

    def _send_status(self, code: int, reason: str, message: str) -> None:
        self._send_json(
            code,
            {
                "kind": "Status",
                "apiVersion": "v1",
                "status": "Failure",
                "reason": reason,
                "message": message,
                "code": code,
            },
        )

    def _read_body(self) -> Optional[dict]:
        length = int(self.headers.get("Content-Length", 0))
        data = self.rfile.read(length) if length else b""
        if not data:
            return {}
        try:
            return json.loads(data)
        except ValueError:
            return None

    def _route(self):
        split = urlsplit(self.path)
        if split.path == "/healthz":
            return None
        parsed = parse_path(split.path)
        query = {k: v[-1] for k, v in parse_qs(split.query).items()}
        return parsed, query

    def _object_key(self, parsed) -> str:
        return f"{parsed.namespace}/{parsed.name}" if parsed.namespace else parsed.name

    # -- fault injection (transport/faults.py seam) ----------------------
    def _fault_gate(self) -> bool:
        """Resolve this member's fault policy for one request; True when
        the request was consumed by the fault (severed or 500'd)."""
        inj = self.api.fault_injector
        if inj is None:
            return False
        act = inj.action(self.api.fault_name)
        if act is None:
            return False
        if act.latency_s:
            time.sleep(act.latency_s)
        if act.partition:
            # Connect-timeout partition: hold the request unanswered —
            # the client's own socket timeout fires first — until the
            # fault clears or the hang cap elapses, then sever.
            deadline = time.monotonic() + inj.partition_hang_s
            while time.monotonic() < deadline and not self.api._closed.is_set():
                if not inj.partitioned(self.api.fault_name):
                    return False  # flap cleared mid-request: serve it late
                time.sleep(0.05)
            self._sever()
            return True
        if act.drop:
            self._sever()
            return True
        if act.error:
            self._send_status(500, "InternalError", "injected fault")
            return True
        return False

    def _sever(self) -> None:
        """Close the connection without a response: the client sees EOF
        / connection reset, never an HTTP status."""
        self.close_connection = True
        try:
            self.connection.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass

    def _watch_stalled(self) -> bool:
        inj = self.api.fault_injector
        if inj is None:
            return False
        return inj.watch_stalled(self.api.fault_name)

    # -- observability ---------------------------------------------------
    def _count(self, verb: str) -> None:
        m = self.api.metrics
        if m is not None:
            m.counter("apiserver_requests_total", verb=verb)

    def _server_span(self, name: str, **args):
        """A server-side span in THIS process's ring, adopting the
        caller's traceparent header when present — the member half of
        cross-process trace propagation."""
        return trace.get_default().server_span(
            name, self.headers.get("traceparent"), **args
        )

    # -- verbs -----------------------------------------------------------
    def do_GET(self):
        if self._fault_gate():
            return
        split = urlsplit(self.path)
        if split.path == "/healthz":
            if self.api.store.healthy:
                self._send_json(200, {"status": "ok"})
            else:
                self._send_status(500, "InternalError", "unhealthy")
            return
        if not self._check_auth():
            return
        # The /debug surface (and /metrics when a registry was given):
        # member apiservers expose the same observability routes as the
        # manager, which is what the fleet scraper aggregates.  Mounted
        # after auth, before parse_path (which would 404 them).
        if split.path == "/metrics" or split.path == "/debug" or (
            split.path.startswith("/debug/")
        ):
            from kubeadmiral_tpu_torch.runtime import profiling

            if not profiling.respond_debug(
                self, split.path, split.query, metrics=self.api.metrics
            ):
                self.send_error(404)
            return
        try:
            parsed, query = self._route()
        except ValueError as e:
            self._send_status(404, "NotFound", str(e))
            return
        try:
            if parsed.name is None:
                if query.get("watch") in ("true", "1"):
                    self._count("watch")
                    self._serve_watch(parsed.resource, int(query.get("resourceVersion", 0)))
                else:
                    self._count("list")
                    self._serve_list(parsed, query)
            else:
                self._count("get")
                obj = self.api.store.get(parsed.resource, self._object_key(parsed))
                self._send_json(200, obj)
        except NotFound as e:
            self._send_status(404, "NotFound", str(e))

    def _serve_batch(self, body: dict) -> None:
        """POST /batch — one request, many operations (the bulk-write
        protocol the per-member sync fan-out amortizes its round trips
        through; extends the apiserver the way the webhook "-batch"
        endpoints extended the reference's per-pair calls).

        Body: {"operations": [{"verb": create|update|update_status|
        delete|get, "resource": ..., "object": ...|"key": ...}, ...]}.
        Response: {"results": [{"code": ..., "object"|"status": ...}]}
        — one entry per operation, order preserved; each operation
        succeeds or fails independently (per-object conflict retry stays
        with the caller)."""
        # The store's bulk verb does the work — one columnar lock pass,
        # one coalesced watch flush (FakeKube's ``coalesce``) — and op objects
        # are adopted by reference, which is safe here because they are
        # this request's fresh JSON parse.  Result objects are store
        # views: serialized into the response immediately, never
        # retained or mutated.  This handler only reshapes the store's
        # plain results into the wire's Status envelopes.
        results = []
        for entry in self.api.store.batch(body.get("operations", ())):
            if "object" in entry:
                results.append(entry)
            elif entry["code"] == 200:
                results.append({"code": 200, "status": {"kind": "Status", "status": "Success"}})
            else:
                st = entry.get("status", {})
                results.append(
                    self._status_entry(
                        entry["code"],
                        st.get("reason", "BadRequest"),
                        st.get("message", ""),
                    )
                )
        self._send_json(200, {"results": results})

    def _serve_faultz(self, body: dict) -> None:
        """POST /faultz — the fault-control endpoint (transport/faults.py
        seam over the wire): lets a parent process drive fault injection
        on a member apiserver running in ANOTHER process (the kwok-lite
        subprocess farm), so `farm.set_fault` works for every member
        shape.  Routed BEFORE the fault gate — a partitioned member must
        still accept the request that clears its partition.

        Body: {"policy": {FaultPolicy fields...} | null, "member": ...?}
        — null clears; "member" defaults to this server's fault name."""
        import dataclasses

        from kubeadmiral_tpu_torch.transport.faults import FaultInjector, FaultPolicy

        api = self.api
        if api.fault_injector is None:
            api.fault_injector = FaultInjector()
        member = body.get("member") or api.fault_name
        policy = body.get("policy")
        if policy is None:
            api.fault_injector.clear(member)
            self._send_json(200, {"status": "cleared", "member": member})
            return
        names = {f.name for f in dataclasses.fields(FaultPolicy)}
        unknown = set(policy) - names
        if unknown:
            self._send_status(
                400, "BadRequest", f"unknown FaultPolicy fields: {sorted(unknown)}"
            )
            return
        try:
            parsed = FaultPolicy(**policy)
        except (TypeError, ValueError) as e:
            self._send_status(400, "BadRequest", f"invalid FaultPolicy: {e}")
            return
        api.fault_injector.set_fault(member, parsed)
        self._send_json(200, {"status": "ok", "member": member})

    @staticmethod
    def _status_entry(code: int, reason: str, message: str) -> dict:
        return {
            "code": code,
            "status": {
                "kind": "Status",
                "apiVersion": "v1",
                "status": "Failure",
                "reason": reason,
                "message": message,
                "code": code,
            },
        }

    def do_POST(self):
        # Drain the body before any error response: leftover body bytes
        # would be parsed as the next request line on this keep-alive
        # connection, corrupting the client's pooled connection.
        obj = self._read_body()
        # Fault control is exempt from the fault gate by construction:
        # clearing a partition must not hang on the partition itself.
        if urlsplit(self.path).path == "/faultz":
            if not self._check_auth():
                return
            if obj is None:
                self._send_status(400, "BadRequest", "invalid JSON body")
                return
            self._serve_faultz(obj)
            return
        if self._fault_gate():
            return
        if not self._check_auth():
            return
        if obj is None:
            self._send_status(400, "BadRequest", "invalid JSON body")
            return
        if urlsplit(self.path).path == "/batch":
            self._count("batch")
            with self._server_span(
                "apiserver.batch", ops=len(obj.get("operations", ()))
            ):
                self._serve_batch(obj)
            return
        try:
            parsed, _ = self._route()
        except ValueError as e:
            self._send_status(404, "NotFound", str(e))
            return
        if parsed.namespace:
            obj.setdefault("metadata", {}).setdefault("namespace", parsed.namespace)
        self._count("create")
        try:
            with self._server_span("apiserver.create", resource=parsed.resource):
                created = self.api.store.create(parsed.resource, obj)
            self._send_json(201, created)
        except AlreadyExists as e:
            self._send_status(409, "AlreadyExists", str(e))

    def do_PUT(self):
        obj = self._read_body()  # drain before any error response
        if self._fault_gate():
            return
        if not self._check_auth():
            return
        if obj is None:
            self._send_status(400, "BadRequest", "invalid JSON body")
            return
        try:
            parsed, _ = self._route()
        except ValueError as e:
            self._send_status(404, "NotFound", str(e))
            return
        store = self.api.store
        try:
            if parsed.subresource == "status":
                self._count("update_status")
                with self._server_span(
                    "apiserver.update_status", resource=parsed.resource
                ):
                    updated = store.update_status(parsed.resource, obj)
            elif parsed.subresource is None:
                self._count("update")
                with self._server_span(
                    "apiserver.update", resource=parsed.resource
                ):
                    updated = store.update(parsed.resource, obj)
            else:
                self._send_status(404, "NotFound", f"subresource {parsed.subresource}")
                return
            self._send_json(200, updated)
        except Conflict as e:
            self._send_status(409, "Conflict", str(e))
        except NotFound as e:
            self._send_status(404, "NotFound", str(e))

    def do_DELETE(self):
        if self._fault_gate():
            return
        if not self._check_auth():
            return
        try:
            parsed, _ = self._route()
        except ValueError as e:
            self._send_status(404, "NotFound", str(e))
            return
        self._count("delete")
        try:
            with self._server_span("apiserver.delete", resource=parsed.resource):
                self.api.store.delete(parsed.resource, self._object_key(parsed))
            self._send_json(200, {"kind": "Status", "status": "Success"})
        except NotFound as e:
            self._send_status(404, "NotFound", str(e))

    def _check_auth(self) -> bool:
        if self.api.authorized(self.headers.get("Authorization")):
            return True
        self._send_status(401, "Unauthorized", "invalid bearer token")
        return False

    # -- list + watch ----------------------------------------------------
    def _serve_list(self, parsed, query) -> None:
        selector = None
        if "labelSelector" in query:
            selector = dict(
                part.split("=", 1)
                for part in query["labelSelector"].split(",")
                if "=" in part
            )
        items, rv = self.api.store.list_with_rv(
            parsed.resource, parsed.namespace or None, selector
        )
        self._send_json(
            200,
            {"kind": "List", "items": items, "metadata": {"resourceVersion": str(rv)}},
            extra={"X-Resource-Version": str(rv)},
        )

    def _serve_watch(self, resource: str, since_rv: int) -> None:
        log = self.api._log
        lines, cursor = log.since(resource, since_rv)
        if lines is None:
            self._send_status(410, "Expired", f"resourceVersion {since_rv} is too old")
            return
        self.send_response(200)
        self.send_header("Content-Type", "application/json")
        self.send_header("Transfer-Encoding", "chunked")
        self.end_headers()
        try:
            while not self.api._closed.is_set():
                heartbeat = False
                # Watch-stall fault: hold delivery (lines AND heartbeats)
                # until the stall clears — the client sees a silent,
                # still-open stream, times out as a dead peer and
                # reconnects with backoff; events deliver late, never
                # lost (the log keeps them, resume rv catches up).
                while self._watch_stalled() and not self.api._closed.is_set():
                    time.sleep(0.05)
                for line in lines:
                    self._write_chunk(line)
                # cursor from since() is the latest logged seq at query
                # time, i.e. the resume point after the lines just sent.
                with log.cond:
                    while True:
                        if self.api._closed.is_set():
                            return
                        lines, cursor = log.since(resource, cursor)
                        if lines is None:
                            return  # truncated under us: client relists
                        if lines:
                            break
                        if not log.cond.wait(timeout=15.0):
                            heartbeat = True
                            break
                if heartbeat and not self._watch_stalled():
                    self._write_chunk(HEARTBEAT)
        except (BrokenPipeError, ConnectionResetError):
            return
        finally:
            try:
                self.wfile.write(b"0\r\n\r\n")
            except OSError:
                pass

    def _write_chunk(self, data: bytes) -> None:
        self.wfile.write(f"{len(data):X}\r\n".encode() + data + b"\r\n")
        self.wfile.flush()
