"""Profiling endpoints — the pprof analogue.

The reference starts ``net/http/pprof`` on :6060 behind
``--enable-profiling`` (reference:
cmd/controller-manager/app/controllermanager.go:61-71, blank import
main.go:21).  The Python control plane's equivalent serves:

* ``GET /debug/profile?seconds=N`` — a SAMPLING profile of every thread
  in the process (pprof's CPU-profile role): stacks are sampled from
  ``sys._current_frames()`` at ~100Hz for N seconds (default 5, max
  120) and aggregated into per-function self/cumulative sample counts.
  Sampling, not tracing, because a tracer (cProfile) only sees the
  installing thread — useless for worker-thread controllers — and adds
  overhead to the very loops being measured.
* ``GET /debug/profile?seconds=N&mode=device`` — an on-demand
  ``torch.profiler`` capture (CPU and CUDA activities) around whatever
  the process is doing (live ticks included): the Chrome trace is
  written to a fresh timestamped subdirectory of ``devprof.PROFILE_DIR``
  (or ``&dir=``) and the response carries its path.  One capture at a
  time (runtime/devprof.capture_device_profile).  The JAX package's
  ``mode=jax`` is answered with an error that names ``mode=device``.
* ``GET /debug/waterfall`` — the dispatch ledger's per-tick waterfall
  (runtime/devprof.py): ordered device-dispatch records with the
  chain-model device/queue attribution and the host-side stage split,
  for the most recent ticks (``?tick=``/``?ticks=``/``?records=``
  narrow it).  See docs/observability.md § Device-time attribution.
* ``GET /debug/stacks`` — current stack of every thread (pprof's
  ``goroutine?debug=2`` role) — the first thing to pull from a wedged
  control plane.
* ``GET /debug/threads`` — thread names/ids/daemon flags.
* ``GET /metrics`` — the metrics registry in Prometheus text format
  (runtime/metrics.py), the pkg/stats exposition analogue.
* ``GET /debug/trace`` — completed reconcile-path spans as Chrome
  trace-event JSON (runtime/trace.py) MERGED with the dispatch ledger's
  device records on per-device lanes (one timeline, correlated by tick
  id; ``?device=0`` for host spans only); load in chrome://tracing.
* ``GET /debug/decisions`` — the scheduling flight recorder's ring
  summary (runtime/flightrec.py): recent ticks, record volumes.
* ``GET /debug/explain?key=<ns/name>`` — per-cluster verdicts for one
  object's latest recorded scheduling decision (which filter rejected
  each infeasible cluster, score/rank for select-stage cuts, the chosen
  clusters + replica split).
* ``GET /debug/drift`` — desired-vs-observed placement drift, from the
  providers registered with the flight recorder module (the monitor
  controller's drift detector).
* ``GET /debug/members`` — per-member circuit-breaker health
  (transport/breaker.py): state, consecutive failures, latency EWMA,
  shed-write and dispatch-retry tallies, and the per-member write
  latency reservoir (p50/p99) the SLO layer joins in — the
  degraded-member runbook's first stop (docs/operations.md).
* ``GET /debug/slo`` — the end-to-end SLO surface (runtime/slo.py):
  per-stage event→placement-written percentiles, the slowest-N
  exemplars fully decomposed, freshness gauges, and the burn-rate
  evaluator's red/green objective status.
* ``GET /debug/timeline`` — the continuous telemetry timeline
  (runtime/timeline.py): multi-tier downsampled series of every
  registry counter/gauge plus the sampler's synthesized SLO-burn,
  breaker, queue-depth, and process gauges; ``?series=`` (comma list
  of substrings) and ``?tier=`` narrow the payload.
* ``GET /debug/tenants`` — the per-tenant attribution ledger
  (runtime/tenancy.py): per-tenant SLO burn, stage latencies, member
  writes, shed writes, admission deferrals, flushed rows.
* ``GET /debug`` — the index: every debug provider this process
  serves, with one-line descriptions.

``respond_debug`` is the shared route handler: the health server mounts
it so one port serves livez/readyz/metrics/debug, and
``ProfilingServer`` runs the same routes standalone on a dedicated port
(the :6060 layout).
"""

from __future__ import annotations

import json
import sys
import threading
import time
import traceback
from collections import Counter
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Callable, Optional
from urllib.parse import parse_qs, urlsplit

_profile_lock = threading.Lock()


def collect_profile(
    seconds: float = 5.0, top: int = 40, hz: float = 100.0
) -> dict:
    """Sample every thread's stack for ``seconds``; one profile at a
    time (overlapping samplers would double-count each other)."""
    seconds = max(0.1, min(float(seconds), 120.0))
    if not _profile_lock.acquire(blocking=False):
        return {"error": "a profile is already running"}
    try:
        interval = 1.0 / hz
        me = threading.get_ident()
        self_counts: Counter = Counter()
        cum_counts: Counter = Counter()
        samples = 0
        deadline = time.perf_counter() + seconds
        while time.perf_counter() < deadline:
            for ident, frame in sys._current_frames().items():
                if ident == me:
                    continue  # the sampler itself is noise
                samples += 1
                leaf = True
                seen = set()
                while frame is not None:
                    code = frame.f_code
                    key = f"{code.co_filename}:{code.co_firstlineno}({code.co_name})"
                    if leaf:
                        self_counts[key] += 1
                        leaf = False
                    if key not in seen:  # count recursion once
                        seen.add(key)
                        cum_counts[key] += 1
                    frame = frame.f_back
            time.sleep(interval)
        rows = [
            {
                "function": key,
                "self": self_counts.get(key, 0),
                "cumulative": cum,
            }
            for key, cum in cum_counts.most_common(top)
        ]
        return {"seconds": seconds, "samples": samples, "top": rows}
    finally:
        _profile_lock.release()


def collect_stacks() -> dict:
    frames = sys._current_frames()
    names = {t.ident: t.name for t in threading.enumerate()}
    stacks = {}
    for ident, frame in frames.items():
        stacks[f"{names.get(ident, '?')}-{ident}"] = traceback.format_stack(frame)
    return {"threads": stacks}


def collect_threads() -> dict:
    return {
        "threads": [
            {"name": t.name, "ident": t.ident, "daemon": t.daemon,
             "alive": t.is_alive()}
            for t in threading.enumerate()
        ]
    }


# Process-default /debug/shards provider (last manager wins, like the
# SLO recorder and dispatch-ledger attach): a callable returning the
# shard-ownership report — ShardMap identity/epoch, per-shard lease
# holder + freshness, owned-key counts.
_shards_provider: Optional[Callable[[], dict]] = None


def set_shards_provider(fn: Optional[Callable[[], dict]]) -> None:
    global _shards_provider
    _shards_provider = fn


def shards_report() -> Optional[dict]:
    return _shards_provider() if _shards_provider is not None else None


def handle_debug_path(path: str, query: dict) -> Optional[dict]:
    """Route a /debug/* request; None = not a debug path."""
    if path == "/debug/profile":
        try:
            seconds = float(query.get("seconds", 5))
        except (TypeError, ValueError):
            return {"error": f"bad seconds value: {query.get('seconds')!r}"}
        mode = query.get("mode", "stack")
        if mode == "jax":
            return {
                "error": "mode=jax needs the JAX package's profiler; this "
                "process captures the card with mode=device"
            }
        if mode == "device":
            from kubeadmiral_tpu_torch.runtime import devprof

            return devprof.capture_device_profile(
                seconds, out_dir=query.get("dir") or None
            )
        return collect_profile(seconds)
    if path == "/debug/waterfall":
        from kubeadmiral_tpu_torch.runtime import devprof

        try:
            tick = int(query["tick"]) if "tick" in query else None
            max_ticks = int(query.get("ticks", 4))
            max_records = int(query.get("records", 512))
        except (TypeError, ValueError):
            return {"error": "bad tick/ticks/records value"}
        return devprof.get_default().waterfall(
            tick=tick, max_ticks=max_ticks, max_records=max_records
        )
    if path == "/debug/stacks":
        return collect_stacks()
    if path == "/debug/threads":
        return collect_threads()
    return None


# The /debug index: route -> one-line description.  Kept static (not
# reflected from the router) so the index documents intent, including
# query parameters the route dispatch alone can't express.
DEBUG_INDEX = {
    "/metrics": "metrics registry, Prometheus text format",
    "/debug/trace": "reconcile spans + device lanes, Chrome trace JSON"
    " (?device=0 host only)",
    "/debug/slo": "end-to-end SLO: stage percentiles, exemplars,"
    " freshness, burn-rate status",
    "/debug/timeline": "continuous telemetry timeline, multi-tier"
    " downsampled series (?series=,&tier=)",
    "/debug/tenants": "per-tenant attribution: SLO burn, writes, sheds,"
    " admission deferrals",
    "/debug/fleet": "fleet-merged telemetry: per-instance metrics +"
    " scrape health + manager snapshots",
    "/debug/members": "per-member circuit-breaker health and write"
    " latency reservoirs",
    "/debug/waterfall": "per-tick device-dispatch waterfall"
    " (?tick=&ticks=&records=)",
    "/debug/decisions": "scheduling flight recorder ring summary",
    "/debug/explain": "per-cluster verdicts for one object"
    " (?key=<ns/name>)",
    "/debug/drift": "desired-vs-observed placement drift",
    "/debug/shards": "sharded control plane: shard ownership, lease"
    " holders/freshness, epoch, owned-key counts",
    "/debug/profile": "sampling profile of every thread"
    " (?seconds=&mode=device for a torch.profiler capture)",
    "/debug/stacks": "current stack of every thread",
    "/debug/threads": "thread names/ids/daemon flags",
}


def _send(http_handler, body: bytes, content_type: str) -> None:
    http_handler.send_response(200)
    http_handler.send_header("Content-Type", content_type)
    http_handler.send_header("Content-Length", str(len(body)))
    http_handler.end_headers()
    http_handler.wfile.write(body)


def respond_debug(
    http_handler, path: str, raw_query: str, metrics=None, tracer=None,
    flightrec=None, drift=None, members=None, slo=None, timeline=None,
    tenants=None, fleet=None,
) -> bool:
    """Serve a /metrics or /debug/* route on any BaseHTTPRequestHandler;
    returns False when the path isn't one of ours (caller handles it).
    The single implementation shared by the health server and the
    standalone profiling server.

    ``metrics`` is the registry to expose (no default: the caller owns
    its registry); ``tracer`` defaults to the process-wide span tracer
    the reconcile path records into; ``flightrec`` defaults to the
    process-wide decision flight recorder the engine feeds; ``drift``
    (a callable returning the drift listing) defaults to the registered
    drift providers (flightrec.drift_report); ``members`` (a callable
    returning the member-health listing) defaults to the aggregated
    circuit-breaker registries (transport/breaker.members_report);
    ``timeline``/``tenants``/``fleet`` default to the process-wide
    timeline ring, tenant ledger and fleet scraper (each opt-in: 404
    when none is installed)."""
    if path in ("/debug", "/debug/"):
        _send(
            http_handler,
            json.dumps({"endpoints": DEBUG_INDEX}, indent=2).encode(),
            "application/json",
        )
        return True
    if path == "/metrics":
        if metrics is None:
            return False
        _send(
            http_handler,
            metrics.render_prometheus().encode(),
            "text/plain; version=0.0.4; charset=utf-8",
        )
        return True
    if path == "/debug/trace":
        from kubeadmiral_tpu_torch.runtime import trace as trace_mod

        active = tracer or trace_mod.get_default()
        doc = active.chrome_trace()
        # Merge the dispatch ledger's device records as their own
        # per-device lanes (timestamps share the span tracer's epoch, so
        # one trace load shows host + device timelines correlated by
        # tick id).  ?device=0 yields the host-only trace.
        query = {k: v[-1] for k, v in parse_qs(raw_query).items()}
        if query.get("device", "1") not in ("0", "false", "no"):
            try:
                from kubeadmiral_tpu_torch.runtime import devprof

                doc["traceEvents"].extend(
                    devprof.get_default().chrome_events(trace_mod.epoch())
                )
            except Exception:
                pass  # a wedged ledger must not take the trace down
        _send(http_handler, json.dumps(doc).encode(), "application/json")
        return True
    if path == "/debug/slo":
        from kubeadmiral_tpu_torch.runtime import slo as slo_mod

        recorder = slo if slo is not None else slo_mod.get_default()
        _send(
            http_handler,
            json.dumps(recorder.summary()).encode(),
            "application/json",
        )
        return True
    if path == "/debug/timeline":
        from kubeadmiral_tpu_torch.runtime import timeline as timeline_mod

        ring = timeline if timeline is not None else timeline_mod.get_default()
        if ring is None:
            http_handler.send_error(
                404, explain="no timeline installed (timeline.ENABLED off?)"
            )
            return True
        query = {k: v[-1] for k, v in parse_qs(raw_query).items()}
        doc = ring.to_doc(
            series=query.get("series") or None,
            tier=query.get("tier") or None,
        )
        _send(http_handler, json.dumps(doc).encode(), "application/json")
        return True
    if path == "/debug/tenants":
        from kubeadmiral_tpu_torch.runtime import tenancy as tenancy_mod

        ledger = tenants if tenants is not None else tenancy_mod.get_default()
        if ledger is None:
            http_handler.send_error(
                404, explain="no tenant ledger installed"
            )
            return True
        _send(
            http_handler,
            json.dumps(ledger.summary()).encode(),
            "application/json",
        )
        return True
    if path == "/debug/fleet":
        from kubeadmiral_tpu_torch.runtime import fleetscrape

        scraper = fleet if fleet is not None else fleetscrape.get_default()
        if scraper is None:
            http_handler.send_error(
                404, explain="no fleet scraper installed"
            )
            return True
        _send(
            http_handler,
            json.dumps(scraper.summary()).encode(),
            "application/json",
        )
        return True
    if path == "/debug/members":
        from kubeadmiral_tpu_torch.transport import breaker as breaker_mod

        report = members() if members is not None else breaker_mod.members_report()
        _send(http_handler, json.dumps(report).encode(), "application/json")
        return True
    if path == "/debug/shards":
        report = shards_report()
        if report is None:
            http_handler.send_error(
                404, explain="no shard report provider installed"
            )
            return True
        _send(http_handler, json.dumps(report).encode(), "application/json")
        return True
    if path in ("/debug/decisions", "/debug/explain", "/debug/drift"):
        from kubeadmiral_tpu_torch.runtime import flightrec as flightrec_mod

        recorder = flightrec or flightrec_mod.get_default()
        if path == "/debug/decisions":
            body = json.dumps(recorder.decisions()).encode()
        elif path == "/debug/explain":
            query = {k: v[-1] for k, v in parse_qs(raw_query).items()}
            key = query.get("key", "")
            if not key:
                http_handler.send_error(
                    400, explain="missing ?key=<namespace/name>"
                )
                return True
            result = recorder.explain(key)
            if result is None:
                http_handler.send_error(
                    404, explain=f"no recorded decision for {key!r}"
                )
                return True
            body = json.dumps(result).encode()
        else:
            report = drift() if drift is not None else flightrec_mod.drift_report()
            body = json.dumps(report).encode()
        _send(http_handler, body, "application/json")
        return True
    query = {k: v[-1] for k, v in parse_qs(raw_query).items()}
    result = handle_debug_path(path, query)
    if result is None:
        return False
    _send(http_handler, json.dumps(result).encode(), "application/json")
    return True


class ProfilingServer:
    """Standalone profiling HTTP server (the reference's :6060)."""

    def __init__(
        self, host: str = "127.0.0.1", port: int = 0, metrics=None,
        tracer=None, flightrec=None, drift=None, members=None, slo=None,
        timeline=None, tenants=None, fleet=None,
    ):
        self._host = host
        self._port = port
        self.metrics = metrics
        self.tracer = tracer
        self.flightrec = flightrec
        self.drift = drift
        self.members = members
        self.slo = slo
        self.timeline = timeline
        self.tenants = tenants
        self.fleet = fleet
        self._server: Optional[ThreadingHTTPServer] = None
        self._thread: Optional[threading.Thread] = None

    @property
    def port(self) -> int:
        assert self._server is not None
        return self._server.server_address[1]

    def start(self) -> int:
        outer = self

        class Handler(BaseHTTPRequestHandler):
            def do_GET(self) -> None:  # noqa: N802 (http.server API)
                split = urlsplit(self.path)
                if not respond_debug(
                    self, split.path, split.query,
                    metrics=outer.metrics, tracer=outer.tracer,
                    flightrec=outer.flightrec, drift=outer.drift,
                    members=outer.members, slo=outer.slo,
                    timeline=outer.timeline, tenants=outer.tenants,
                    fleet=outer.fleet,
                ):
                    self.send_error(404)

            def log_message(self, *args) -> None:
                pass

        self._server = ThreadingHTTPServer((self._host, self._port), Handler)
        self._thread = threading.Thread(
            target=self._server.serve_forever, name="profiling-server", daemon=True
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
