"""The metric catalog: every metric name this control plane may emit.

A copy of ``kubeadmiral_tpu/runtime/metric_catalog.py`` for the port's control
plane.

One source of truth shared by three consumers:

* ``tools/metrics_lint.py`` (``make metrics-lint``) walks the source for
  emission calls and FAILS on names not listed here — new metrics must
  be cataloged before they ship, so the exposition never drifts from
  the documentation;
* ``docs/observability.md`` renders this as the operator-facing metric
  reference;
* ``bench.py`` embeds engine series under these names in its BENCH
  artifact, so the perf trajectory and live ``/metrics`` scrapes share
  one vocabulary.

``CATALOG`` holds the labeled, Prometheus-shaped families.  The
``LEGACY_PATTERNS`` grandfather the pre-exposition dotted names (worker
``<name>.panic`` counters, ``monitor.<ftc>.*`` gauges, per-controller
``scheduler-<ftc>.*`` counters): they still render (sanitized) in the
exposition and existing tests read them, but new emissions should use
the labeled families.
"""

from __future__ import annotations

from fnmatch import fnmatch
from typing import NamedTuple


class MetricSpec(NamedTuple):
    type: str  # counter | gauge | histogram
    unit: str
    labels: tuple[str, ...]
    help: str


CATALOG: dict[str, MetricSpec] = {
    # -- reconcile workers (runtime/worker.py) ---------------------------
    "worker_reconciles_total": MetricSpec(
        "counter", "reconciles", ("controller",),
        "Keys reconciled, per controller worker."),
    "worker_exceptions_total": MetricSpec(
        "counter", "exceptions", ("controller",),
        "Reconciles that escaped with an exception (the panic analogue)."),
    "worker_retries_total": MetricSpec(
        "counter", "retries", ("controller",),
        "Keys requeued with exponential backoff after a failed reconcile."),
    "worker_requeues_total": MetricSpec(
        "counter", "requeues", ("controller",),
        "Successful reconciles that scheduled a fixed-delay revisit."),
    "worker_process_seconds": MetricSpec(
        "histogram", "seconds", ("controller",),
        "Per-key reconcile latency (single-key workers)."),
    "worker_tick_seconds": MetricSpec(
        "histogram", "seconds", ("controller",),
        "Whole-batch tick latency (batch workers)."),
    "worker_queue_wait_seconds": MetricSpec(
        "histogram", "seconds", ("controller",),
        "Enqueue-to-drain wait of dequeued keys (sampled per drain)."),
    "worker_queue_depth": MetricSpec(
        "gauge", "keys", ("controller",),
        "Pending keys in the controller's dirty queue."),
    "worker_admission_total": MetricSpec(
        "counter", "enqueues", ("controller",),
        "Enqueues deferred by queue-depth-driven admission "
        "(KT_ADMIT_DEPTH / KT_ADMIT_DELAY_MS): past the depth "
        "threshold, new keys coalesce behind a short delay so an event "
        "flood drains as bigger amortized ticks (freshness gauges "
        "degrade gracefully) instead of thrashing per-event p99."),
    "worker_queue_oldest_age_seconds": MetricSpec(
        "gauge", "seconds", ("controller",),
        "Age of the longest-pending key; the first stuck-controller signal."),
    "member_watch_flushes_total": MetricSpec(
        "counter", "flushes", ("controller",),
        "Coalesced member-watch deliveries received by sync "
        "(KT_STORE_COALESCE): one committed store flush per count."),
    "member_watch_flush_events_total": MetricSpec(
        "counter", "events", ("controller",),
        "Member-watch events carried by coalesced deliveries; divided "
        "by member_watch_flushes_total this is the store-side "
        "coalescing factor."),
    # -- XLA scheduling engine (scheduler/engine.py, ops/pipeline.py) ----
    "engine_ticks_total": MetricSpec(
        "counter", "ticks", (),
        "schedule() calls (any fast path included)."),
    "engine_tick_objects": MetricSpec(
        "gauge", "objects", (),
        "Batch size of the last scheduling tick."),
    "engine_tick_seconds": MetricSpec(
        "histogram", "seconds", (),
        "Wall time of one whole scheduling tick."),
    "engine_tick_stage_seconds": MetricSpec(
        "histogram", "seconds", ("stage",),
        "Per-tick wall time of one stage: featurize, device, fetch, "
        "decode (+ follower when a FollowerIndex is applied), plus "
        "sub-phase splits — gate_wait and overflow_fetch overlap the "
        "fetch stage (drift-gate compute blocked on, and wide [n, C] "
        "K-overflow re-fetches), narrow_fallback is the dense re-solve "
        "+ repair of certificate-failed narrow rows."),
    "engine_chunk_cache_total": MetricSpec(
        "counter", "chunks", ("result",),
        "Incremental-featurization outcomes per chunk: hit, patch, miss."),
    "engine_fetch_total": MetricSpec(
        "counter", "chunks", ("path",),
        "Result-fetch path per chunk: noop, subbatch, skip, delta, full."),
    "engine_fetch_bytes_total": MetricSpec(
        "counter", "bytes", ("format",),
        "Device->host result-transfer volume, labeled by the engine's "
        "fetch wire format (packed = [B,K] top-k-compacted rows, dense "
        "= full [B,C] planes; KT_FETCH_FORMAT)."),
    "engine_fetch_overflow_rows_total": MetricSpec(
        "counter", "rows", (),
        "Packed-export K-overflow rows (selected set exceeded the K "
        "bucket) re-fetched through the dense row-gather fallback."),
    "engine_upload_bytes_total": MetricSpec(
        "counter", "bytes", ("plane",),
        "Host->device input-transfer volume: object = cached per-object "
        "tensors (full uploads, row scatter-repairs, sub-batch slabs), "
        "cluster = the shared once-per-tick cluster-axis planes and "
        "vocabulary tables.  A drift tick must move cluster bytes only."),
    "engine_drift_rows_total": MetricSpec(
        "counter", "rows", ("kind",),
        "Drift-gate row classification on cluster-capacity drift ticks: "
        "skip = provably identical outputs, wcheck = dynamic-weight "
        "comparison rows, wcheck_changed = weight comparisons that "
        "found a difference, unified = survivors settled by the ONE "
        "unified survivor kernel (the default path — subsumes the "
        "resolve/replan/score_only specializations, KT_SURVIVOR_"
        "UNIFIED), resolve = survivors settled by the sort-free "
        "drift-resolve program, replan = kinf fit-flip survivors "
        "settled by the selection-known replan (no select sort), "
        "score_only = finite-K fit-flip survivors settled by the "
        "stored-plane score-only narrow solve (the latter three engage "
        "only under KT_SURVIVOR_UNIFIED=0), *_fallback = rows of those "
        "paths whose certificate failed (slab re-solve), recompute = "
        "rows re-scheduled through the sub-batch slabs."),
    "engine_stale_rows_total": MetricSpec(
        "counter", "rows", ("phase",),
        "Stale device-input rows scatter-repaired, by phase: churn = "
        "repaired EAGERLY inside the tick that made them stale (the "
        "default), drift = repaired on a drift gate's critical path "
        "(the backstop — must stay 0 under eager repair; nonzero means "
        "a churn path left rows it could not reach eagerly), dispatch "
        "= repaired at a full-dispatch upload."),
    "engine_featurize_rows_total": MetricSpec(
        "counter", "rows", ("path",),
        "Rows featurized per path: full = whole-chunk rebuilds (cold "
        "boot, topology change, vocabulary overflow, webhook ticks, "
        "snapshot restore), delta = row-wise patches of cached chunks. "
        "A steady/churn tick must move delta rows only — full rows "
        "outside cold/topology transitions mean the O(changed-rows) "
        "featurization contract regressed (KT_DELTA_FEAT)."),
    "engine_gate_inflight": MetricSpec(
        "gauge", "gates", (),
        "Drift-gate programs currently in flight on the device (set at "
        "gate-drain entry, cleared when every gated chunk settles)."),
    # -- dispatch ledger (runtime/devprof.py) -----------------------------
    "engine_device_seconds": MetricSpec(
        "histogram", "seconds", ("program", "device"),
        "Measured device occupancy per dispatched program (the dispatch "
        "ledger's in-order chain model: ready_i - max(dispatch_i, "
        "ready_{i-1})), labeled by program kind (tick, tick_narrow, "
        "gate, resolve, pack, ...) and device lane (d<id> for a single "
        "committed device, mesh<N> for a GSPMD program spanning N "
        "devices).  Pure execution time — jit tracing happens host-side "
        "before the observation and never lands here."),
    "engine_queue_wait_seconds": MetricSpec(
        "histogram", "seconds", ("program", "device"),
        "Time each dispatched program sat enqueued behind earlier "
        "device work before executing — the dispatch backpressure the "
        "host-side stage timers misattribute to fetch/decode.  Same "
        "device-lane label as engine_device_seconds."),
    "engine_resident_bytes": MetricSpec(
        "gauge", "bytes", ("family",),
        "Device bytes of the engine's resident working set, by plane "
        "family (prev_planes = the six [B, C] output planes, per_object "
        "= cached input tensors, tiebreak = precomputed planner "
        "tie-break planes, vectors = [B] nfeas / score-exactness "
        "companions) — the live half of the c6 memory census "
        "(runtime/census.py; bench --scenario census)."),
    "engine_resident_bytes_per_device": MetricSpec(
        "gauge", "bytes", (),
        "Resident working-set bytes on the busiest device, summed from "
        "where each tensor lies (the engine joins every objects shard's "
        "outputs on its own device) — the number the census's budget "
        "is compared against."),
    "engine_dispatch_inflight": MetricSpec(
        "gauge", "dispatches", (),
        "Dispatched programs whose readiness the ledger has not yet "
        "observed (the device queue depth as the ledger sees it)."),
    "engine_stream_stage_seconds": MetricSpec(
        "histogram", "seconds", ("stage",),
        "Streaming event latency decomposed by stage: queued (event "
        "enqueue -> its slab's flush start, per event), apply (event "
        "application + world snapshot, per flush), engine (the flush's "
        "engine tick, per flush).  queued+apply+engine bounds the "
        "event->placement-visible latency histogram.  Extended bucket "
        "ladder (to 120s): the queued stage legitimately reaches "
        "seconds under slab-age coalescing and must not saturate +Inf."),
    "engine_stream_events_total": MetricSpec(
        "counter", "events", ("kind",),
        "Streaming-scheduler events flushed, by kind: upsert (object "
        "add/update), delete, capacity (cluster drift snapshot)."),
    "engine_stream_flushes_total": MetricSpec(
        "counter", "flushes", ("trigger",),
        "Row-slab flushes by watermark trigger: rows (KT_SLAB_ROWS "
        "reached), age (KT_SLAB_AGE_MS exceeded), manual."),
    "engine_stream_slab_depth": MetricSpec(
        "gauge", "events", (),
        "Events currently coalescing in the pending row slab."),
    "engine_stream_slab_rows": MetricSpec(
        "gauge", "rows", (),
        "Object rows carried by the most recent slab flush."),
    "engine_stream_world_rows": MetricSpec(
        "gauge", "rows", (),
        "Total unit-list rows owned by the streaming scheduler "
        "(placeholder slots included)."),
    "engine_stream_latency_seconds": MetricSpec(
        "histogram", "seconds", (),
        "Event enqueue to placement-visible latency (per event, "
        "recorded at its slab's flush)."),
    "engine_stream_flush_seconds": MetricSpec(
        "histogram", "seconds", (),
        "Wall time of one slab flush (apply events + engine tick)."),
    "engine_narrow_rows_total": MetricSpec(
        "counter", "rows", ("path",),
        "Narrow-solve (KT_NARROW) row outcomes: narrow = rows whose "
        "per-row exactness certificate held (solved over the top-M "
        "candidate columns), fallback = uncertified rows re-solved "
        "through the full-width dense program (bit-identical by "
        "construction either way)."),
    "engine_aot_programs_total": MetricSpec(
        "counter", "programs", ("result",),
        "AOT program-store resolutions per (program, shape signature): "
        "loaded = deserialized from the jax.export manifest under "
        "KT_COMPILE_CACHE_DIR (no Python trace), traced = live trace "
        "(exported too when the prewarm ladder is running), rejected = "
        "a manifest entry existed but failed its guard (jax/platform/"
        "code-hash mismatch, CRC, deserialize or first-call error) and "
        "fell back to a live trace."),
    "engine_snapshot_total": MetricSpec(
        "counter", "snapshots", ("result",),
        "Durable engine-snapshot outcomes (KT_SNAPSHOT_DIR): written, "
        "loaded_fresh (restore rode the no-op replay — cluster tensors "
        "and row signatures bit-identical), loaded_stale (restore "
        "resumed through the drift-gate/sub-batch revalidation), "
        "rejected (config/topology/geometry mismatch -> cold), "
        "quarantined (torn/corrupt/version-mismatched file renamed "
        "aside, never loaded), skipped (nothing coherent to persist), "
        "shard_mismatch (snapshot stamped for a different shard "
        "identity/epoch than this replica's ShardMap -> cold)."),
    "engine_snapshot_bytes": MetricSpec(
        "gauge", "bytes", (),
        "Payload size of the most recent durable engine snapshot."),
    "engine_snapshot_write_seconds": MetricSpec(
        "histogram", "seconds", (),
        "Wall time of one atomic snapshot persist (serialize + fsync + "
        "rename), inside the post-tick hook."),
    "engine_persistent_cache_total": MetricSpec(
        "counter", "traces", ("result",),
        "Persistent XLA compilation-cache outcome per observed trace: "
        "miss wrote a new on-disk entry (a real compile), hit loaded "
        "the program from KT_COMPILE_CACHE_DIR."),
    "engine_compile_cache_total": MetricSpec(
        "counter", "dispatches", ("result", "shape"),
        "Program-shape cache outcome per device dispatch: a shape's "
        "first dispatch is the miss that traces a new XLA program."),
    "engine_dispatches_total": MetricSpec(
        "counter", "dispatches", ("shape",),
        "Device dispatches per (format, rows, clusters) shape bucket."),
    "engine_xla_compiles_total": MetricSpec(
        "counter", "compiles", ("program", "shape"),
        "True XLA traces observed in ops.pipeline (the jitted body ran), "
        "per program and shape."),
    "engine_vocab_overflow_total": MetricSpec(
        "counter", "overflows", ("scope",),
        "Compact-vocabulary cap overflows forcing the dense fallback: "
        "topology (vocabulary build), chunk (full featurize), patch "
        "(row re-featurize)."),
    "engine_program_shapes": MetricSpec(
        "gauge", "programs", (),
        "Distinct program shapes dispatched since engine construction."),
    # -- decision flight recorder (runtime/flightrec.py) -----------------
    "flightrec_records": MetricSpec(
        "gauge", "objects", (),
        "Per-object decision records currently held by the flight "
        "recorder's ring (the /debug/explain working set)."),
    "flightrec_bytes": MetricSpec(
        "gauge", "bytes", (),
        "Memory held by flight-recorder decision records (bounded by "
        "KT_FLIGHTREC_BYTES, oldest ticks evicted first)."),
    "flightrec_ring_ticks": MetricSpec(
        "gauge", "ticks", (),
        "Tick entries in the flight recorder's bounded ring."),
    # -- controllers (federation/) ---------------------------------------
    "scheduler_scheduled_total": MetricSpec(
        "counter", "objects", ("ftc",),
        "Objects pushed through the engine by the scheduler controller."),
    "pending_controllers_depth": MetricSpec(
        "gauge", "objects", ("ftc", "controller"),
        "Objects whose FIRST pending-controllers group names the "
        "controller — each pipeline stage's backlog."),
    "placement_drift_objects": MetricSpec(
        "gauge", "objects", ("ftc", "kind"),
        "Desired-vs-observed placement drift found by the monitor "
        "controller's detector, per kind: missing (desired placement "
        "absent from the member), orphan (member object outside the "
        "desired set), replicas (member replicas != scheduler override), "
        "decision (persisted placement != flight-recorder decision)."),
    # -- member fault tolerance (transport/breaker.py, federation/) ------
    "member_breaker_state": MetricSpec(
        "gauge", "state", ("cluster",),
        "Per-member circuit-breaker state: 0 closed (healthy), 1 "
        "half-open (cooled down, probing), 2 open (short-circuiting). "
        "Surfaced with full detail at GET /debug/members."),
    "member_dispatch_retries_total": MetricSpec(
        "counter", "retries", ("cluster",),
        "Member-write operations re-sent by the dispatch retry budget "
        "(transport failures, 5xx results, 409-after-conflict-refresh) "
        "with bounded exponential backoff + jitter under the per-tick "
        "deadline (KT_RETRY_*, KT_DISPATCH_DEADLINE_S)."),
    "member_shed_writes_total": MetricSpec(
        "counter", "writes", ("cluster",),
        "Member writes shed off the tick's critical path: breaker-open "
        "short-circuits (recorded as ClusterNotReady immediately) and "
        "flush-deadline expiries (statuses stay *_TIMED_OUT); the "
        "owning worker's backoff requeue re-drives them."),
    "member_probe_latency": MetricSpec(
        "histogram", "seconds", ("cluster",),
        "Member /healthz heartbeat probe latency (the cluster "
        "controller's reachability probe, which doubles as the "
        "breaker's half-open probe)."),
    # -- end-to-end SLO layer (runtime/slo.py) ----------------------------
    "slo_event_to_written_seconds": MetricSpec(
        "histogram", "seconds", ("stage",),
        "Event→placement-written latency decomposed by pipeline stage "
        "(the provenance-token decomposition; stages in SLO_STAGES "
        "order plus 'total').  Consecutive intervals of one clock — the "
        "stage sum equals the measured end-to-end latency by "
        "construction.  Extended buckets (to 300s) so outage-scale "
        "latencies land in finite buckets."),
    "slo_oldest_pending_event_seconds": MetricSpec(
        "gauge", "seconds", (),
        "Age of the oldest watch event whose expected member writes "
        "have not all acked — how stale the written world is versus the "
        "observed world.  Rises monotonically while a dispatch path is "
        "wedged, even when no new events flow; sampled by the monitor "
        "tick."),
    "slo_unwritten_placements": MetricSpec(
        "gauge", "placements", (),
        "Expected (object, member) placement writes not yet acked "
        "across all pending provenance tokens — the freshness gauge's "
        "volume companion."),
    "slo_burn_rate": MetricSpec(
        "gauge", "ratio", ("objective", "window"),
        "Error-budget burn rate per declared SLO objective "
        "(SLO_OBJECTIVES) and window: 1.0 = spending budget exactly as "
        "fast as allowed; an objective is RED when every window burns "
        "≥ 1.  Served with red/green detail at GET /debug/slo."),
    "slo_events_total": MetricSpec(
        "counter", "events", ("result",),
        "Provenance-token lifecycle outcomes: minted (new token), "
        "superseded (newer event replaced an in-flight token), echo "
        "(MODIFIED without a generation bump — our own write echo, no "
        "token), dropped (pending cap hit), written (finalized on full "
        "ack), settled (no-op sync round, dropped without a sample), "
        "forgotten (object deleted mid-flight), expired "
        "(KT_SLO_MAX_AGE_S aged out)."),
    "member_write_seconds": MetricSpec(
        "histogram", "seconds", ("cluster",),
        "Per-member write-batch round-trip latency (retries included) "
        "as dispatch observed it — joined with breaker state and "
        "shed/retry tallies in GET /debug/members, so a slow member is "
        "distinguishable from a slow engine."),
    "member_bulk_writes_total": MetricSpec(
        "counter", "requests", ("cluster", "result"),
        "Coalesced bulk member-write requests (dispatch.run_member_"
        "batches; KT_WRITE_COALESCE/KT_MEMBER_BATCH/KT_MEMBER_INFLIGHT) "
        "by outcome: ok (every op landed), partial (per-op failures in "
        "the results — retried per item), transport (the whole request "
        "failed at the transport after retries).  Joined with the "
        "batch-size reservoir in GET /debug/members."),
    "member_batch_ops": MetricSpec(
        "histogram", "ops", (),
        "Operations per coalesced bulk member-write request — the "
        "batch-size distribution of the write-path coalescing window "
        "(1 everywhere means KT_WRITE_COALESCE=0 or nothing to "
        "amortize)."),
    # -- per-tenant attribution (runtime/tenancy.py) ----------------------
    # The tenant label is namespace-derived (KT_TENANT_LABEL overrides)
    # and BOUNDED: at most KT_TENANT_MAX distinct values, later
    # arrivals collapse into "~other" — so these families can never
    # blow up the registry.  Full report at GET /debug/tenants.
    "tenant_events_total": MetricSpec(
        "counter", "events", ("tenant", "result"),
        "Finalized event→placement-written provenance tokens per "
        "tenant: good (within the event_to_written_p99 threshold) vs "
        "bad (breached it) — the per-tenant numerator/denominator of "
        "the error-budget burn."),
    "tenant_slo_burn": MetricSpec(
        "gauge", "ratio", ("tenant",),
        "Whole-run event_to_written_p99 error-budget burn per tenant "
        "(bad fraction / allowed bad fraction; 1.0 = spending exactly "
        "as fast as allowed) — WHICH tenant is burning the budget, "
        "where slo_burn_rate only says the control plane is."),
    "tenant_stage_seconds": MetricSpec(
        "histogram", "seconds", ("tenant", "stage"),
        "Per-tenant share of the provenance stage decomposition "
        "(queued/slab/engine/fetch/dispatch/write) — a tenant whose "
        "latency lives in `write` has slow members, one in `queued` is "
        "being back-pressured."),
    "tenant_write_seconds": MetricSpec(
        "histogram", "seconds", ("tenant",),
        "Member-write round-trip latency attributed to the written "
        "ops' tenant (retries included) — member_write_seconds sliced "
        "by who, not where."),
    "tenant_shed_writes_total": MetricSpec(
        "counter", "writes", ("tenant",),
        "Member writes shed by an open circuit breaker, attributed to "
        "the shed ops' tenant — whose freshness a degraded member is "
        "costing."),
    "tenant_admission_deferrals_total": MetricSpec(
        "counter", "deferrals", ("tenant",),
        "Worker-queue admission deferrals (KT_ADMISSION depth gate) "
        "per tenant of the deferred key — who is driving queue-depth "
        "backpressure."),
    "tenant_rows_flushed_total": MetricSpec(
        "counter", "rows", ("tenant",),
        "Streaming-slab rows flushed into engine ticks per tenant — "
        "the scheduling-demand side of the attribution (arrival "
        "volume, pre-placement)."),
    "tenant_scheduled_total": MetricSpec(
        "counter", "objects", ("tenant",),
        "Objects pushed through the batch scheduler per tenant "
        "(rescheduling included) — the demand denominator for weighted "
        "fair admission (ROADMAP item 4)."),
    # -- fleet observatory ---------------------------------------------
    # Member-apiserver request accounting (transport/apiserver.py) plus
    # the crash-durable telemetry spill (runtime/telespill.py) and the
    # manager-side fleet scraper (runtime/fleetscrape.py) feeding
    # GET /debug/fleet.  See docs/observability.md § Fleet observatory.
    "apiserver_requests_total": MetricSpec(
        "counter", "requests", ("verb",),
        "Requests served by a member apiserver, by verb (get/list/"
        "watch/create/update/update_status/delete/batch) — scraped "
        "from every member's /metrics by the fleet scraper, so the "
        "merged pane shows who the managers are actually hammering."),
    "telespill_records_total": MetricSpec(
        "counter", "records", ("kind",),
        "Telemetry records spilled to the crash-durable segment log "
        "(KT_TELEMETRY_DIR), by kind (spans/timeline/flightrec)."),
    "telespill_bytes_written_total": MetricSpec(
        "counter", "bytes", (),
        "Framed bytes appended to spill segments (frame headers "
        "included) — the spill's disk-rate denominator against "
        "KT_SPILL_BYTES."),
    "telespill_segment_rotations_total": MetricSpec(
        "counter", "rotations", (),
        "Spill segment files opened (first open included): rotation "
        "grain is max_bytes/8, so a fast-rotating spill means the "
        "telemetry volume outruns the byte budget."),
    "telespill_segments_deleted_total": MetricSpec(
        "counter", "segments", (),
        "Oldest spill segments pruned to keep one instance under "
        "KT_SPILL_BYTES — history lost to the byte bound, visible."),
    "telespill_quarantined_total": MetricSpec(
        "counter", "segments", (),
        "Damaged spill segments renamed *.quarantined on read (bad "
        "magic, torn frame, CRC mismatch): the fully-framed prefix is "
        "salvaged, the file is never re-read."),
    "fleet_scrapes_total": MetricSpec(
        "counter", "scrapes", (),
        "Whole-roster fleet scrapes (GET /debug/fleet refreshes plus "
        "KT_FLEET_SCRAPE_S background refreshes)."),
    "fleet_scrape_errors_total": MetricSpec(
        "counter", "errors", (),
        "Per-instance scrape failures across fleet scrapes (an "
        "unreachable or non-200 member /metrics) — nonzero means the "
        "merged pane is PARTIAL, the down members are named in the "
        "payload."),
    "fleet_instances": MetricSpec(
        "gauge", "instances", (),
        "Roster size of the last fleet scrape (manager's own registry "
        "included when attached)."),
    # -- sharded control plane (federation/shardmap.py) -----------------
    "shard_epoch": MetricSpec(
        "gauge", "epoch", ("shard",),
        "Routing generation this replica's ShardMap snapshot was built "
        "under, labeled by shard index — shard-skew triage correlates "
        "per-shard metrics with the resize epoch they were produced "
        "under (GET /debug/shards carries the same value)."),
}

# -- end-to-end SLO catalog ------------------------------------------------
# Provenance stage vocabulary (runtime/slo.py STAGES): metrics-lint fails
# when the recorder's stages drift from this documented order.
SLO_STAGES: tuple[str, ...] = (
    "queued", "slab", "engine", "fetch", "dispatch", "write",
)


class SLOObjectiveSpec(NamedTuple):
    kind: str         # "ratio" (latency-threshold) | "gauge" (freshness)
    target: float     # required good-event fraction (ratio kinds)
    threshold_s: float  # default threshold; env overrides
    env: str          # KT_SLO_* env var overriding threshold_s
    help: str


# The declared objectives the in-process evaluator runs (runtime/slo.py
# SLOEvaluator builds exactly these; metrics-lint cross-checks both
# directions so the burn-rate label vocabulary never drifts from docs).
SLO_OBJECTIVES: dict[str, SLOObjectiveSpec] = {
    "event_to_written_p99": SLOObjectiveSpec(
        "ratio", 0.99, 5.0, "KT_SLO_E2E_P99_S",
        "99% of watch events reach an acked member placement write "
        "within the threshold (the end-to-end latency SLO items 4/5 "
        "gate on)."),
    "member_write_p99": SLOObjectiveSpec(
        "ratio", 0.99, 2.0, "KT_SLO_WRITE_P99_S",
        "99% of per-member write batches (retries included) complete "
        "within the threshold — the member-side half of the "
        "member-vs-engine triage."),
    "freshness": SLOObjectiveSpec(
        "gauge", 0.0, 30.0, "KT_SLO_FRESHNESS_S",
        "The oldest pending event stays younger than the threshold: "
        "the written world may not silently fall behind the observed "
        "world."),
}

# -- decision audit vocabulary -------------------------------------------
# Kubernetes Event reasons this control plane may record
# (runtime/eventsink.py recorders).  tools/metrics_lint.py walks
# ``.event(obj, type, reason, message)`` calls and fails on literal
# reasons not listed here — like metric names, the event vocabulary is
# documented (docs/observability.md) before it ships.
EVENT_REASONS: frozenset[str] = frozenset({
    "Scheduled",        # scheduler: placement decided (message: clusters + replicas)
    "ScheduleFailed",   # scheduler: no cluster selected (message: reason summary)
    "PropagationFailed",  # sync: member writes failed (message: clusters)
})

# Rejection-reason slugs served by /debug/explain and embedded in
# ScheduleFailed messages — must stay in lockstep with
# ops.reasons.REASON_NAMES (metrics-lint cross-checks both directions).
DECISION_REASONS: frozenset[str] = frozenset({
    "api_resources",
    "taint_toleration",
    "resources_fit",
    "placement",
    "cluster_affinity",
    "webhook_filter",
    "cluster_invalid",
    "max_clusters",
    "zero_replicas",
    "sticky_cluster",
})

# The flight-recorder record schema (runtime/flightrec.py
# DecisionRecord.__slots__): metrics-lint fails when the record grows or
# renames a field without this catalog (and docs/observability.md)
# following along.
FLIGHT_RECORDER_FIELDS: tuple[str, ...] = (
    "key", "tick", "when", "program", "placements", "reasons",
    "reason_counts", "feasible_n", "topk_idx", "topk_scores", "names",
)

# Pre-exposition dotted names, matched with fnmatch.  "*" also stands in
# for f-string interpolations in the linter's extracted names (e.g.
# f"scheduler-{ftc}.scheduled" lints as "scheduler-*.scheduled").
LEGACY_PATTERNS: tuple[str, ...] = (
    # runtime/worker.py per-worker counters/timers (worker name prefix).
    "*.panic",
    "*.throughput",
    "*.latency",
    "*.tick_latency",
    # federation controllers' per-FTC counters.
    "scheduler-*.scheduled",
    "scheduler-*.unit_errors",
    "scheduler-*.webhook_errors",
    "scheduler-*.webhook_config_errors",
    "scheduler-*.webhook_unsupported_payload",
    "scheduler-*.persist_panic",
    "scheduler-*.engine_latency",
    "sync-*.plan_panic",
    "sync-*.finish_panic",
    "sync-*.host_write_panic",
    "sync-*.plan_rollout_failed",
    "status.plan_panic",
    "statusagg.plan_panic",
    "ftc-manager.parse_errors",
    # federation/monitor.py gauges (monitor.<ftc>.<field> via a prefix
    # variable, so the linter sees "*.<field>").
    "monitor.*",
    "*.total",
    "*.propagated",
    "*.unpropagated",
    "*.out_of_sync_seconds",
    "*.sync_latency",
    "*.worker_exceptions",
    "*.worker_retries",
)


def is_cataloged(name: str) -> bool:
    """True when an emitted metric name (possibly containing "*" where
    an f-string interpolated) is covered by the catalog."""
    if name in CATALOG:
        return True
    return any(fnmatch(name, pattern) for pattern in LEGACY_PATTERNS)
