"""Out-of-process scheduler plugins over HTTP (webhook plugins).

A copy of ``kubeadmiral_tpu/scheduler/webhook.py`` for the port's control
plane.

A SchedulerPluginWebhookConfiguration registers an external service that
participates in scheduling at the filter/score/select extension points
(reference: pkg/apis/core/v1alpha1/types_schedulerpluginwebhookconfiguration.go,
payload schema pkg/apis/schedulerwebhook/v1alpha1/types.go:29-102, HTTP
adapter pkg/controllers/scheduler/extensions/webhook/v1alpha1/plugin.go).

Request/response wire format (one POST per call, JSON both ways):

* filter: {schedulingUnit, cluster} -> {selected, error}
* score:  {schedulingUnit, cluster} -> {score, error}
* select: {schedulingUnit, clusterScores: [{cluster, score}]}
          -> {selectedClusterNames, error}

In the batch engine, filter/score results are evaluated host-side (they
are network calls) and enter the fused XLA tick as an extra mask / score
plane; select plugins narrow the tick's output afterwards.

``HTTPClient`` is injectable so tests run against a fake transport, as
the reference's plugin tests do (plugin.go:42-44).
"""

from __future__ import annotations

import base64
import http.client
import json
import socket
import ssl
import tempfile
import urllib.error
import urllib.request
from dataclasses import dataclass
from typing import Optional, Protocol
from urllib.parse import urlsplit

from kubeadmiral_tpu_torch.models import types as T

SCHEDULER_WEBHOOK_CONFIGS = (
    "core.kubeadmiral.io/v1alpha1/schedulerpluginwebhookconfigurations"
)

PAYLOAD_VERSION = "v1alpha1"
SUPPORTED_PAYLOAD_VERSIONS = frozenset({PAYLOAD_VERSION})

DEFAULT_TIMEOUT_SECONDS = 5.0


class WebhookError(Exception):
    pass


class WebhookStatusError(Exception):
    """Non-200 HTTP status from the webhook server.  Deliberately NOT a
    WebhookError: a 404 on a "-batch" endpoint means "reference-protocol
    server, fall back to per-pair calls", not a protocol failure."""

    def __init__(self, code: int):
        super().__init__(f"unexpected status code: {code}")
        self.code = code


@dataclass(frozen=True)
class WebhookTLSConfig:
    """spec.tlsConfig (reference:
    types_schedulerpluginwebhookconfiguration.go:68-90, consumed by
    scheduler/webhook.go:117-119): CA bundle + optional client cert for
    mTLS, insecure skip-verify for testing, SNI/verify name override.
    PEM fields arrive base64-encoded ([]byte JSON encoding)."""

    insecure: bool = False
    server_name: str = ""
    ca_data: str = ""    # PEM
    cert_data: str = ""  # PEM (client certificate)
    key_data: str = ""   # PEM (client key)


def parse_tls_config(raw: Optional[dict]) -> Optional[WebhookTLSConfig]:
    if not raw:
        return None

    def pem(field: str) -> str:
        value = raw.get(field, "")
        if not value:
            return ""
        if "-----BEGIN" in value:
            return value  # already PEM (convenience for tests/manifests)
        try:
            return base64.b64decode(value).decode()
        except Exception as e:
            # Silent "" would downgrade to system CAs / no client cert
            # and every call would fail as a generic transport error;
            # fail loudly at parse time instead (the config watcher
            # counts the parse error and skips the plugin).
            raise ValueError(f"tlsConfig.{field} is not valid base64 PEM: {e}")

    return WebhookTLSConfig(
        insecure=bool(raw.get("insecure", False)),
        server_name=raw.get("serverName", ""),
        ca_data=pem("caData"),
        cert_data=pem("certData"),
        key_data=pem("keyData"),
    )


class HTTPClient(Protocol):
    def post(
        self,
        url: str,
        body: bytes,
        timeout: float,
        tls: Optional[WebhookTLSConfig] = None,
    ) -> bytes: ...


class UrllibClient:
    """Default transport: stdlib http.client with the reference's
    headers and per-webhook TLS (CA bundle / client cert / insecure /
    SNI override — webhook.go:117-119 builds the equivalent
    http.Transport from the config's TLSClientConfig)."""

    def __init__(self):
        self._ctx_cache: dict[WebhookTLSConfig, ssl.SSLContext] = {}

    def _context(self, tls: Optional[WebhookTLSConfig]) -> ssl.SSLContext:
        key = tls or WebhookTLSConfig()
        ctx = self._ctx_cache.get(key)
        if ctx is not None:
            return ctx
        ctx = ssl.create_default_context(
            cadata=key.ca_data if key.ca_data else None
        )
        if key.insecure:
            ctx.check_hostname = False
            ctx.verify_mode = ssl.CERT_NONE
        if key.cert_data and key.key_data:
            # load_cert_chain only takes paths; stage the PEM through a
            # private temp file.
            with tempfile.NamedTemporaryFile("w", suffix=".pem") as f:
                f.write(key.cert_data)
                f.write("\n")
                f.write(key.key_data)
                f.flush()
                ctx.load_cert_chain(f.name)
        self._ctx_cache[key] = ctx
        return ctx

    def post(
        self,
        url: str,
        body: bytes,
        timeout: float,
        tls: Optional[WebhookTLSConfig] = None,
    ) -> bytes:
        split = urlsplit(url)
        headers = {
            "Content-Type": "application/json",
            "Accept": "application/json",
            "User-Agent": "kubeadmiral-tpu-scheduler",
        }
        if split.scheme == "https":
            ctx = self._context(tls)
            server_name = (tls.server_name if tls else "") or split.hostname
            conn = http.client.HTTPSConnection(
                split.hostname, split.port, timeout=timeout, context=ctx
            )
            # SNI / verification-name override (TLSConfig.ServerName):
            # wrap the socket ourselves so the name presented to the
            # server (and checked against its cert) is the configured
            # one, not the dial host.
            def connect(_conn=conn, _ctx=ctx, _name=server_name):
                sock = socket.create_connection(
                    (_conn.host, _conn.port), _conn.timeout
                )
                _conn.sock = _ctx.wrap_socket(sock, server_hostname=_name)

            conn.connect = connect
        else:
            conn = http.client.HTTPConnection(
                split.hostname, split.port, timeout=timeout
            )
        try:
            path = split.path or "/"
            if split.query:
                path += "?" + split.query
            conn.request("POST", path, body=body, headers=headers)
            resp = conn.getresponse()
            data = resp.read()
            if resp.status != 200:
                raise WebhookStatusError(resp.status)
            return data
        finally:
            conn.close()


# -- payload conversion (adapter.go ConvertSchedulingUnit) ---------------

def scheduling_unit_payload(su: T.SchedulingUnit) -> dict:
    parts = su.gvk.split("/")  # "group/version/Kind" ("" group collapsed)
    if len(parts) == 3:
        group, version, kind = parts
    else:
        group, (version, kind) = "", parts
    payload: dict = {
        "apiVersion": f"{group}/{version}" if group else version,
        "kind": kind,
        "resource": kind.lower() + "s",
        "name": su.name,
        "schedulingMode": su.scheduling_mode,
        "currentClusters": sorted(su.current_clusters),
    }
    if su.namespace:
        payload["namespace"] = su.namespace
    if su.labels:
        payload["labels"] = dict(su.labels)
    if su.annotations:
        payload["annotations"] = dict(su.annotations)
    if su.desired_replicas is not None:
        payload["desiredReplicas"] = int(su.desired_replicas)
    if su.resource_request:
        payload["resourceRequest"] = {
            name: str(q) for name, q in sorted(su.resource_request.items())
        }
    distribution = {
        c: int(r) for c, r in su.current_clusters.items() if r is not None
    }
    if distribution:
        payload["currentReplicaDistribution"] = distribution
    if su.cluster_selector:
        payload["clusterSelector"] = dict(su.cluster_selector)
    if su.tolerations:
        payload["tolerations"] = [
            {
                k: v
                for k, v in (
                    ("key", t.key),
                    ("operator", t.operator),
                    ("value", t.value),
                    ("effect", t.effect),
                )
                if v
            }
            for t in su.tolerations
        ]
    if su.max_clusters is not None:
        payload["maxClusters"] = int(su.max_clusters)
    return payload


def cluster_payload(cluster: T.ClusterState) -> dict:
    """ClusterState -> FederatedCluster-shaped JSON."""
    return {
        "metadata": {"name": cluster.name, "labels": dict(cluster.labels)},
        "spec": {
            "taints": [
                {"key": t.key, "value": t.value, "effect": t.effect}
                for t in cluster.taints
            ]
        },
        "status": {
            "resources": {
                "allocatable": {
                    name: str(q) for name, q in sorted(cluster.allocatable.items())
                },
                "available": {
                    name: str(q) for name, q in sorted(cluster.available.items())
                },
            },
            "apiResourceTypes": sorted(cluster.api_resources),
        },
    }


@dataclass(frozen=True)
class WebhookConfig:
    """Parsed SchedulerPluginWebhookConfiguration."""

    name: str
    url_prefix: str
    filter_path: str = ""
    score_path: str = ""
    select_path: str = ""
    payload_versions: tuple[str, ...] = (PAYLOAD_VERSION,)
    timeout: float = DEFAULT_TIMEOUT_SECONDS
    generation: int = 1
    tls: Optional[WebhookTLSConfig] = None


_DURATION_UNITS = {"h": 3600.0, "m": 60.0, "s": 1.0, "ms": 1e-3, "us": 1e-6, "ns": 1e-9}


def parse_duration(raw) -> Optional[float]:
    """metav1.Duration-style string ("5s", "500ms", "1m30s") or bare
    number -> seconds; None when absent or unparseable."""
    if raw is None:
        return None
    if isinstance(raw, (int, float)):
        return float(raw)
    total, number = 0.0, ""
    i, s = 0, str(raw).strip()
    try:
        while i < len(s):
            ch = s[i]
            if ch.isdigit() or ch in ".+-":
                number += ch
                i += 1
                continue
            unit = ch
            if s[i : i + 2] in _DURATION_UNITS:
                unit = s[i : i + 2]
            if unit not in _DURATION_UNITS:
                return None
            total += float(number) * _DURATION_UNITS[unit]
            number = ""
            i += len(unit)
        if number:  # bare trailing number
            total += float(number)
        return total
    except ValueError:
        return None


def parse_webhook_config(obj: dict) -> WebhookConfig:
    spec = obj.get("spec", {})
    timeout = parse_duration(spec.get("httpTimeout"))
    return WebhookConfig(
        name=obj["metadata"]["name"],
        url_prefix=spec.get("urlPrefix", ""),
        filter_path=spec.get("filterPath", ""),
        score_path=spec.get("scorePath", ""),
        select_path=spec.get("selectPath", ""),
        payload_versions=tuple(spec.get("payloadVersions", (PAYLOAD_VERSION,))),
        timeout=timeout if timeout else DEFAULT_TIMEOUT_SECONDS,
        generation=obj["metadata"].get("generation", 1),
        tls=parse_tls_config(spec.get("tlsConfig")),
    )


class WebhookPlugin:
    """One registered webhook, callable at its configured extension
    points (plugin.go:46-251)."""

    def __init__(self, config: WebhookConfig, client: Optional[HTTPClient] = None):
        self.config = config
        self.name = config.name
        self.client = client or UrllibClient()
        # Extension points whose "-batch" sibling endpoint turned out to
        # be unavailable (reference-protocol server): fall back to
        # per-pair calls for this plugin instance's lifetime (instances
        # are rebuilt on config generation changes).
        self._batch_unsupported: set[str] = set()

    @property
    def has_filter(self) -> bool:
        return bool(self.config.filter_path)

    @property
    def has_score(self) -> bool:
        return bool(self.config.score_path)

    @property
    def has_select(self) -> bool:
        return bool(self.config.select_path)

    def _call(self, path: str, body: dict) -> dict:
        url = self.config.url_prefix.rstrip("/") + "/" + path.lstrip("/")
        # tls is passed only when configured, so injected fake clients
        # with the bare (url, body, timeout) signature keep working.
        kwargs = {"tls": self.config.tls} if self.config.tls is not None else {}
        raw = self.client.post(
            url, json.dumps(body).encode(), timeout=self.config.timeout, **kwargs
        )
        response = json.loads(raw)
        if response.get("error"):
            raise WebhookError(response["error"])
        return response

    def filter(self, su: T.SchedulingUnit, cluster: T.ClusterState) -> bool:
        response = self._call(
            self.config.filter_path,
            {
                "schedulingUnit": scheduling_unit_payload(su),
                "cluster": cluster_payload(cluster),
            },
        )
        return bool(response.get("selected"))

    def score(self, su: T.SchedulingUnit, cluster: T.ClusterState) -> int:
        response = self._call(
            self.config.score_path,
            {
                "schedulingUnit": scheduling_unit_payload(su),
                "cluster": cluster_payload(cluster),
            },
        )
        return int(response.get("score", 0))

    # -- batched protocol -------------------------------------------------
    # One POST per plugin per tick carrying the whole (units x clusters)
    # problem — the batch-native extension of the reference's per-pair
    # protocol (which makes O(B x C) HTTP calls per tick,
    # plugin.go:77-251).  Servers opt in by serving "<path>-batch";
    # anything else transparently degrades to per-pair calls.

    def _batch_call(self, kind: str, path: str, units, clusters) -> Optional[dict]:
        if kind in self._batch_unsupported:
            return None
        body = {
            "schedulingUnits": [scheduling_unit_payload(su) for su in units],
            "clusters": [cluster_payload(c) for c in clusters],
        }
        try:
            return self._call(path.rstrip("/") + "-batch", body)
        except WebhookError:
            raise  # the server answered with a protocol error
        except (urllib.error.HTTPError, WebhookStatusError) as e:
            if e.code in (404, 405, 501):
                # The endpoint genuinely doesn't exist (reference-
                # protocol server): remember permanently.
                self._batch_unsupported.add(kind)
            return None  # transient HTTP failure: per-pair this tick
        except Exception:
            # Transient transport error (timeout, reset) or a fake test
            # client that doesn't know the URL: fall back to per-pair
            # calls for THIS tick only and probe again next tick.
            return None

    @staticmethod
    def _validated_rows(rows, n_units: int, n_clusters: int, context: str) -> list:
        """A malformed grid (wrong row count / ragged rows) is a protocol
        error, not a crash: callers contain WebhookError per plugin."""
        if len(rows) != n_units or any(len(row) != n_clusters for row in rows):
            raise WebhookError(
                f"{context}: bad batch response shape "
                f"(want {n_units}x{n_clusters})"
            )
        return rows

    def filter_batch(
        self, units: list[T.SchedulingUnit], clusters: list[T.ClusterState]
    ) -> Optional[list[list[bool]]]:
        """[len(units)][len(clusters)] feasibility, or None when the
        server doesn't speak the batch protocol."""
        response = self._batch_call("filter", self.config.filter_path, units, clusters)
        if response is None:
            return None
        rows = self._validated_rows(
            response.get("selected", []), len(units), len(clusters),
            f"{self.name} filter-batch",
        )
        return [[bool(x) for x in row] for row in rows]

    def score_batch(
        self, units: list[T.SchedulingUnit], clusters: list[T.ClusterState]
    ) -> Optional[list[list[int]]]:
        response = self._batch_call("score", self.config.score_path, units, clusters)
        if response is None:
            return None
        rows = self._validated_rows(
            response.get("scores", []), len(units), len(clusters),
            f"{self.name} score-batch",
        )
        return [[int(x) for x in row] for row in rows]

    def select(
        self, su: T.SchedulingUnit, cluster_scores: list[tuple[T.ClusterState, int]]
    ) -> list[str]:
        response = self._call(
            self.config.select_path,
            {
                "schedulingUnit": scheduling_unit_payload(su),
                "clusterScores": [
                    {"cluster": cluster_payload(c), "score": int(s)}
                    for c, s in cluster_scores
                ],
            },
        )
        return list(response.get("selectedClusterNames", ()))
