"""The engine's opt-in paths on the port, beside the JAX engine.

``SchedulerEngine``'s keyword switches (``survivor_unified``,
``drift_resolve``, ``replan``, ``score_f16``, ``fetch_format``,
``narrow``, ``phase1_i32``, ``delta_feat``, ``donate``) against the JAX
engine with the same switch set (its constructor keywords, or the
attributes its environment variables set), tick by tick through a
``Twin``: results equal, ``drift_stats``, ``survivor_stats``,
``narrow_stats``, ``fetch_stats``, ``cache_stats``, ``featurize_rows``
and ``last_changed`` equal after every tick, and every flight-recorder
record equal (the dense format's per-cluster reason rows included).
``run_case`` runs a JAX test case with its module's engine and stream
globals pointed at the Twin and the port's stream, so the case's own
assertions hold on the port.

Here: int64 select keys and full featurization (tests/test_drift_replan.py's
cases), the f16 score planes (tests/test_multidevice.py's
``test_score_f16_parity`` on one device: planes and exactness vectors
equal to JAX's after every tick, the snapshot round trip; the compressor
against JAX's past f16's range; a port-only world whose totals run past
65,504), the dense fetch format (tests/test_explain.py's cold-tick
records, tests/test_packed_export.py's packed-vs-dense cases; dense
fetch bytes equal JAX's), the dense solve (tests/test_narrow.py's
``narrow=False`` cases), and donation (the default against
``donate=False``, bit for bit, planner re-dispatches included, and the
previous planes released at dispatch).
"""

import dataclasses
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_drift_replan
import test_explain
import test_narrow
import test_packed_export
from test_drift_replan import _fitflip_world, _quarter_cpu
from test_engine_cache import make_world, results_equal
from test_multidevice import _drifts, _world
from test_torch_engine import _port
from test_torch_flightrec import record_fields

import kubeadmiral_tpu.runtime.flightrec as jax_flightrec
import kubeadmiral_tpu.scheduler.engine as jax_engine_mod
from kubeadmiral_tpu.runtime.flightrec import FlightRecorder as JaxRecorder
from kubeadmiral_tpu.scheduler.engine import SchedulerEngine as JaxEngine
from kubeadmiral_tpu_torch.ops import pipeline as TPipe
from kubeadmiral_tpu_torch.ops import scores as S
from kubeadmiral_tpu_torch.runtime.flightrec import FlightRecorder
from kubeadmiral_tpu_torch.scheduler import engine as engine_mod
from kubeadmiral_tpu_torch.scheduler import streaming

# The port's switches and their defaults (the JAX engine's).
OPTIN = {
    "survivor_unified": True, "drift_resolve": True, "replan": True,
    "score_f16": False, "fetch_format": "packed", "narrow": True,
    "phase1_i32": True, "delta_feat": True, "donate": True,
}
# The JAX engine's environment switch for each attribute it reads at
# use time (the others are its constructor keywords).
ENV = {
    "survivor_unified": "KT_SURVIVOR_UNIFIED", "drift_resolve": "KT_DRIFT_RESOLVE",
    "replan": "KT_REPLAN", "score_f16": "KT_SCORE_F16",
    "phase1_i32": "KT_PHASE1_I32", "delta_feat": "KT_DELTA_FEAT",
}
COUNTERS = (
    "drift_stats", "survivor_stats", "narrow_stats", "fetch_stats", "cache_stats",
    "featurize_rows",
)


def _env_switches() -> dict:
    """The switches the JAX engine's environment sets now."""
    out = {}
    for name, var in ENV.items():
        raw = os.environ.get(var)
        if raw is not None:
            on = raw in ("1", "true", "yes")
            out[name] = on if name == "score_f16" else raw not in ("0", "false", "no")
    return out


def record_core(rec) -> tuple:
    """A record's fields, its dense reason row included."""
    reasons = None if rec.reasons is None else rec.reasons.tolist()
    return record_fields(rec) + (reasons,)


class Snapshot(dict):
    """The port's snapshot payload, carrying the JAX engine's beside it."""

    jax_payload = None


class Twin:
    """The port's CPU engine and a JAX engine (no mesh, no ledger) taking
    the same calls with the same switches.  ``schedule`` returns the
    port's results after checking them, the counters, ``last_changed``
    and the recorders against the JAX engine's; other attributes are the
    port engine's, and setting a switch sets it on both.

    The JAX engine is built at the second tick (or at the first under a
    switch that changes a cold tick or the state it stores: the dense
    solve, int64 keys, the dense format, f16 scores, no donation), and
    the first tick is then replayed on it and held
    against the port's saved state: an engine that only ever takes one
    default cold tick, a case's fresh stop-the-world oracle, costs no
    JAX compile."""

    _SHARED = set(OPTIN) | {"pipeline_depth"}
    _COLD = {
        "narrow": True, "phase1_i32": True, "fetch_format": "packed",
        "score_f16": False, "donate": True,
    }

    def __init__(self, monkeypatch, flight_recorder=None, mesh=None, metrics=None,
                 devprof=None, **kw):
        del mesh, devprof
        switches = {**_env_switches(), **{k: kw.pop(k) for k in list(kw) if k in OPTIN}}
        port = _port(**kw)
        if isinstance(flight_recorder, JaxRecorder):
            flight_recorder = FlightRecorder(
                max_ticks=flight_recorder.max_ticks, max_bytes=flight_recorder.max_bytes,
                topk=flight_recorder.topk, enabled=flight_recorder.enabled,
            )
        port.flightrec = flight_recorder
        # The JAX engine's depth comes from its environment.
        port.pipeline_depth = int(os.environ.get("KT_PIPELINE_DEPTH", "16"))
        for name, value in switches.items():
            setattr(port, name, value)
        if metrics is not None:
            port.metrics = metrics
        vars(self).update(
            port=port, ref=None, ref_rec=None, jax_kw=kw, switches=switches,
            pending=[],
        )

    def __getattr__(self, name):
        return getattr(self.port, name)

    def __setattr__(self, name, value):
        if name in self._SHARED:
            self.switches[name] = value
            if self.ref is not None:
                setattr(self.ref, name, value)
        setattr(self.port, name, value)

    def _build_ref(self) -> None:
        """The JAX engine, with the switches so far, and the first tick
        replayed on it against the port's saved state."""
        sw = self.switches
        rec = self.port.flightrec
        ref_rec = None if rec is None else JaxRecorder(
            max_ticks=rec.max_ticks, max_bytes=rec.max_bytes, topk=rec.topk, enabled=rec.enabled,
        )
        ref = JaxEngine(
            mesh=None, devprof=None, flight_recorder=ref_rec,
            **{k: sw[k] for k in ("fetch_format", "narrow", "donate") if k in sw},
            **self.jax_kw,
        )
        for name, value in sw.items():
            setattr(ref, name, value)
        vars(self).update(ref=ref, ref_rec=ref_rec)
        for units, clusters, kw, state in self.pending:
            want = ref.schedule(units, clusters, **kw)
            self.check(state, want, units, kw.get("want_scores", False))
        self.pending.clear()

    def _state(self, got) -> dict:
        port = self.port
        return {
            "results": got,
            "counters": {name: dict(getattr(port, name)) for name in COUNTERS},
            "last_changed": port.last_changed,
            "overflow": port.overflow_rows_total,
        }

    def schedule(self, units, clusters, **kw):
        cold_switch = any(self.switches.get(k, v) != v for k, v in self._COLD.items())
        if self.ref is None and (self.pending or cold_switch):
            self._build_ref()
        got = self.port.schedule(units, clusters, **kw)
        state = self._state(got)
        if self.ref is None:
            self.pending.append((units, clusters, kw, state))
            return got
        want = self.ref.schedule(units, clusters, **kw)
        self.check(state, want, units, kw.get("want_scores", False))
        return got

    def check(self, state, want, units, want_scores=False):
        got = state["results"]
        results_equal(got, want)
        if want_scores:
            assert [dict(g.scores) for g in got] == [dict(w.scores) for w in want]
        for name in COUNTERS:
            assert state["counters"][name] == getattr(self.ref, name), name
        assert state["last_changed"] == self.ref.last_changed
        assert state["overflow"] == self.ref.overflow_rows_total
        rec = self.port.flightrec
        if rec is not None:
            for u in units:
                mine, theirs = rec.lookup(u.key), self.ref_rec.lookup(u.key)
                assert (mine is None) == (theirs is None), u.key
                if theirs is not None:
                    assert record_core(mine) == record_core(theirs), u.key

    def snapshot_state(self):
        payload = self.port.snapshot_state()
        if payload is None:
            return None
        if self.ref is None:
            self._build_ref()
        out = Snapshot(payload)
        out.jax_payload = self.ref.snapshot_state()
        return out

    def stage_restore(self, payload, assume_fresh=False):
        if self.ref is None:
            self._build_ref()
        self.port.stage_restore(payload, assume_fresh)
        self.ref.stage_restore(getattr(payload, "jax_payload", None), assume_fresh)


def run_case(monkeypatch, module, cls_name, name):
    """JAX test ``module.cls_name.name`` with the module's
    ``SchedulerEngine`` a Twin factory and its ``FlightRecorder`` and
    streaming classes the port's (its units stay in the JAX package's
    types: the port's engine takes them as they are)."""
    monkeypatch.setattr(module, "SchedulerEngine", lambda **kw: Twin(monkeypatch, **kw))
    if hasattr(module, "FlightRecorder"):
        monkeypatch.setattr(module, "FlightRecorder", FlightRecorder)
    for attr in ("StreamingScheduler", "is_placeholder", "make_placeholder"):
        if hasattr(module, attr):
            monkeypatch.setattr(module, attr, getattr(streaming, attr))
    case = getattr(getattr(module, cls_name)(), name)
    params = case.__code__.co_varnames[1 : case.__code__.co_argcount]
    if "monkeypatch" in params:
        case(monkeypatch)
    else:
        case()


def run_lazy_case(monkeypatch, module, cls_name, name, *params):
    """A JAX case that imports the engine and recorder inside its body:
    the JAX package's module attributes point at the Twin factory and
    the port's recorder while it runs."""
    monkeypatch.setattr(jax_engine_mod, "SchedulerEngine", lambda **kw: Twin(monkeypatch, **kw))
    monkeypatch.setattr(jax_flightrec, "FlightRecorder", FlightRecorder)
    getattr(getattr(module, cls_name)(), name)(*params)


# -- i64 select keys and full featurization (tests/test_drift_replan.py) ----------

ENGINE_CASES = [
    ("TestPhase1I32", "test_i32_keys_match_i64_on_random_worlds"),
    ("TestPhase1I32", "test_webhook_score_overflow_falls_back_exactly"),
    ("TestPhase1I32", "test_wcheck_i32_matches_i64"),
    ("TestDeltaFeaturization", "test_dirty_hint_flushes_equal_full_walk"),
    ("TestDeltaFeaturization", "test_full_featurize_only_on_cold_and_topology_change"),
    ("TestDeltaFeaturization", "test_hint_ignored_when_another_caller_ticked"),
]


@pytest.mark.parametrize("cls,name", ENGINE_CASES, ids=[n for _c, n in ENGINE_CASES])
def test_drift_replan_case(monkeypatch, cls, name):
    run_case(monkeypatch, test_drift_replan, cls, name)


def test_switches_reach_the_paths(monkeypatch):
    """i64 keys reach the narrow tick and the survivors; full
    featurization patches no row and ignores the dirty-row hint."""
    calls = []
    real = engine_mod.schedule_tick_narrow

    def spy(inp, m, i32_keys=True, budget=None):
        calls.append(i32_keys)
        return real(inp, m, i32_keys=i32_keys, budget=budget)

    monkeypatch.setattr(engine_mod, "schedule_tick_narrow", spy)
    units, clusters = _fitflip_world(b=64, c=20)
    engine = _port(chunk_size=64, min_bucket=32, narrow_m=16)
    engine.phase1_i32 = engine.delta_feat = False
    engine.schedule(units, clusters)
    churned = list(units)
    churned[3] = dataclasses.replace(units[3], desired_replicas=55)
    engine.schedule(churned, clusters, dirty_rows=[3])
    engine.schedule(churned, _quarter_cpu(clusters, 2))
    assert calls and not any(calls)
    assert engine.cache_stats["patch"] == 0 and engine.featurize_rows["delta"] == 0
    assert engine.featurize_rows["full"] == 2 * len(units)


# -- f16 score planes --------------------------------------------------------------

def _f16_state(engine):
    """Per cached chunk: the f16 plane's bits and the exactness vector."""
    out = {}
    for idx, e in sorted(engine._chunk_cache.items()):
        if e.prev_out is None:
            continue
        plane = np.asarray(e.prev_out[3])
        vec = None if e.prev_sco_exact is None else np.asarray(e.prev_sco_exact)
        out[idx] = (plane.view(np.uint16).tolist(), None if vec is None else vec.tolist())
    return out


def test_score_f16_parity(monkeypatch):
    """tests/test_multidevice.py's test_score_f16_parity on one device:
    cold, churn and two drifts on an f16 engine beside JAX's (planes and
    exactness vectors equal after every tick) and beside a default port
    engine; the snapshot carries the plane and vector and restores into
    an f16 engine."""
    units, clusters = _world()
    kw = dict(min_bucket=32, narrow_m=8)
    twin = Twin(monkeypatch, score_f16=True, **kw)
    plain = _port(**kw)
    plain.flightrec = None

    def tick(batch, world):
        results_equal(twin.schedule(batch, world), plain.schedule(batch, world))
        assert _f16_state(twin.port) == _f16_state(twin.ref)

    tick(units, clusters)
    entry = twin._chunk_cache[0]
    assert entry.prev_out[3].dtype == torch.float16 and entry.prev_sco_exact is not None
    churned = list(units)
    churned[5] = dataclasses.replace(churned[5], desired_replicas=83)
    tick(churned, clusters)
    halved, squeezed, _ = _drifts(clusters)
    for world in (halved, squeezed):
        tick(churned, world)
    assert twin.drift_stats["gated"] >= 1
    assert twin.resident_state_bytes()["score_dtype"] == "f16"
    payload = twin.snapshot_state()
    assert payload["config"]["score_f16"] is True
    assert all(c["sco"].dtype == np.float16 and c["sco_exact"] is not None
               for c in payload["chunks"].values())
    fresh = Twin(monkeypatch, score_f16=True, **kw)
    fresh.stage_restore(payload, assume_fresh=True)
    results_equal(fresh.schedule(churned, squeezed), plain.schedule(churned, squeezed))
    assert fresh.restore_info["result"] == "loaded"
    assert fresh.fetch_stats["noop"] > 0


def test_compressor_matches_jax_past_f16_range():
    """The compressor and the upcast against the JAX engine's programs on
    totals over 2,048 and over 65,504 (+-inf in f16) and at the int32
    bounds, where the JAX conversion saturates."""
    rng = np.random.default_rng(3)
    plane = rng.integers(0, 500, (64, 48)).astype(np.int32)
    plane[1, 3] = 2049          # over 2,048: not every integer is an f16
    plane[2, 4] = 4096          # exact
    plane[3, 5] = 65_504        # the largest f16
    plane[4, 6] = 65_520        # rounds to inf
    plane[5, 7] = -70_000       # -inf
    plane[6, 8] = 2**31 - 1     # inf, and back to itself under saturation
    plane[7, 9] = -(2**31)      # -inf, likewise
    plane[8] = rng.integers(2_049, 60_000, 48)
    ref = JaxEngine(mesh=None, flight_recorder=None, devprof=None)
    old = (rng.random(64) < 0.8).astype(np.int8)
    f16, exact = TPipe.compress_scores(torch.from_numpy(plane))
    j16, jexact = ref._sco_compress_program(False)(jnp.asarray(plane))
    np.testing.assert_array_equal(f16.numpy().view(np.uint16), np.asarray(j16).view(np.uint16))
    np.testing.assert_array_equal(exact.numpy(), np.asarray(jexact))
    assert exact.numpy()[[0, 2, 3, 6, 7]].all() and not exact.numpy()[[1, 4, 5, 8]].any()
    _, both = TPipe.compress_scores(torch.from_numpy(plane), torch.from_numpy(old))
    _, jboth = ref._sco_compress_program(True)(jnp.asarray(plane), jnp.asarray(old))
    np.testing.assert_array_equal(both.numpy(), np.asarray(jboth))
    np.testing.assert_array_equal(
        TPipe.upcast_scores(f16).numpy(), np.asarray(ref._sco_upcast_program()(j16))
    )


def test_f16_totals_past_the_range_force_recomputes(monkeypatch):
    """Every plugin score scaled by 300 (rankings, and so placements,
    unchanged; the gate's refresh scales alike): stored totals run past
    2,048 and 65,504, inexact rows leave every score-trusting path, and
    the f16 engine equals the default engine after every tick, its plane
    and vector the CPU conversion of the default engine's i32 plane."""
    for name in ("balanced_allocation_score", "least_allocated_score",
                 "most_allocated_score", "normalize"):
        real = getattr(S, name)
        monkeypatch.setattr(
            S, name, lambda *a, _real=real, **k: _real(*a, **k) * 300
        )
    units, clusters = _fitflip_world(b=96, c=24)
    kw = dict(chunk_size=128, min_bucket=32, narrow_m=16)
    f16, plain = _port(**kw), _port(**kw)
    f16.score_f16 = True
    f16.flightrec = plain.flightrec = None
    churned = list(units)
    churned[7] = dataclasses.replace(units[7], desired_replicas=61)
    forced_seen = 0
    for batch, world in (
        (units, clusters), (churned, clusters), (churned, _quarter_cpu(clusters, 3)),
        (churned, _quarter_cpu(_quarter_cpu(clusters, 3), 9)), (churned, clusters),
    ):
        inexact = sum(len(f16._sco_inexact_rows(e)) for e in f16._chunk_cache.values()
                      if e.prev_out is not None)
        forced_seen = max(forced_seen, inexact)
        results_equal(f16.schedule(batch, world), plain.schedule(batch, world))
        for idx, e in f16._chunk_cache.items():
            want = plain._chunk_cache[idx].prev_out[3]
            got16, got_vec = e.prev_out[3], e.prev_sco_exact
            np.testing.assert_array_equal(
                got16.numpy().view(np.uint16), want.to(torch.float16).numpy().view(np.uint16)
            )
            np.testing.assert_array_equal(got_vec.numpy(), TPipe.exact_rows(want).numpy())
    plane = plain._chunk_cache[0].prev_out[3].numpy()
    assert plane.max() > 65_504 and ((plane > 2_048) & (plane <= 65_504)).any()
    assert forced_seen > 0 and f16.drift_stats["gated"] >= 1


# -- the dense fetch format ---------------------------------------------------------

@pytest.mark.parametrize(
    "cls,name,params",
    [
        ("TestEnginePackedVsDense", "test_all_paths_identical", (16,)),
        ("TestEnginePackedVsDense", "test_all_paths_identical", (2,)),
        ("TestEnginePackedVsDense", "test_want_scores_identical", ()),
        ("TestEnginePackedVsDense", "test_explain_covers_placements_and_rejected_summary", ()),
        ("TestEnginePackedVsDense", "test_fetch_bytes_accounting", ()),
    ],
    ids=["all_paths_k16", "all_paths_k2", "want_scores", "explain", "fetch_bytes"],
)
def test_packed_export_case(monkeypatch, cls, name, params):
    run_lazy_case(monkeypatch, test_packed_export, cls, name, *params)


def test_explain_dense_cold_records(monkeypatch):
    """tests/test_explain.py's cold tick in the dense format: every
    cluster's verdict named."""
    run_lazy_case(monkeypatch, test_explain, "TestEngineFlightRecorder",
                  "test_cold_tick_records_every_object", "dense")


@pytest.mark.parametrize("depth", [1, 16])
def test_dense_fetch_bytes_equal_jax(monkeypatch, depth):
    """Cold and churn ticks in the dense format read what the JAX
    engine reads, byte for byte, with and without the recorder — but at
    depth 16 the planner flags of each windowed chunk, one byte a padded
    row, that the JAX engine (no round budget) does not read — and the
    fetch-bytes counter takes the format's label."""
    monkeypatch.setenv("KT_PIPELINE_DEPTH", str(depth))
    units, clusters = make_world(b=100, c=12)
    churned = list(units)
    for i in (3, 40, 77):
        churned[i] = dataclasses.replace(units[i], desired_replicas=71)
    flags = 0 if depth == 1 else 32 * 3 + 8  # the chunks' padded rows
    for rec in (None, JaxRecorder(max_ticks=4, max_bytes=64 << 20, topk=4, enabled=True)):
        twin = Twin(monkeypatch, chunk_size=32, min_bucket=8, fetch_format="dense",
                    flight_recorder=rec)
        for batch in (units, churned):
            twin.schedule(batch, clusters)
            assert twin.port.fetch_bytes_total == twin.ref.fetch_bytes_total + flags
        assert twin.fetch_stats["full"] == 4 and twin.fetch_stats["subbatch"] == 3
    fam = twin.metrics.counter_family("engine_fetch_bytes_total")
    assert {dict(k)["format"] for k in fam} == {"dense"}


def test_dense_format_runs_no_survivor(monkeypatch):
    units, clusters = _fitflip_world()
    twin = Twin(monkeypatch, chunk_size=128, min_bucket=32, narrow_m=16, fetch_format="dense")
    twin.schedule(units, clusters)
    twin.schedule(list(units), clusters)
    twin.schedule(units, _quarter_cpu(clusters, 3))
    stats = twin.drift_stats
    assert stats["gated"] >= 1 and stats["recompute"] + stats["fallback"] > 0, stats
    assert stats["unified"] == 0 and twin.survivor_stats["rows"] == 0


# -- the dense solve (tests/test_narrow.py's narrow=False cases) ------------------

NARROW_CASES = [
    ("TestAdversarialFallback", "test_spill_chain_deeper_than_m_forces_fallback"),
    ("TestAdversarialFallback", "test_dynamic_weight_redistribution_into_low_ranked_clusters"),
    ("TestRandomizedEngineDifferential", "test_cold_churn_drift_sequence_matches_dense"),
    ("TestRandomizedEngineDifferential", "test_kt_narrow_off_reverts_to_dense_programs"),
]


@pytest.mark.parametrize("cls,name", NARROW_CASES, ids=[n for _c, n in NARROW_CASES])
def test_narrow_case(monkeypatch, cls, name):
    run_case(monkeypatch, test_narrow, cls, name)


# -- donation ------------------------------------------------------------------------

def _warm_sequence(units, clusters):
    churned = list(units)
    for i in range(0, len(units), 9):
        churned[i] = dataclasses.replace(units[i], desired_replicas=(i % 23) + 3)
    mass = [dataclasses.replace(u, desired_replicas=(i % 7) + 40) if i % 3 else u
            for i, u in enumerate(units)]
    drifted = _quarter_cpu(clusters, 3)
    return [
        (units, clusters), (list(units), clusters), (churned, clusters),
        (churned, drifted), (churned, clusters), (mass, clusters), (mass, drifted),
    ]


def test_donation_is_bit_identical(monkeypatch):
    """The default (a warm dispatch's previous planes released once its
    diff is queued) against donate=False (they live until the drain),
    which is held against JAX's donate=False engine: equal results,
    counters and last_changed every tick, planner re-dispatches
    included, at the window's default depth.  Every delta-capable
    dispatch reaches its drain with the entry's planes released under
    donation and kept without it."""
    depth = 16
    monkeypatch.setenv("KT_PIPELINE_DEPTH", str(depth))
    units, clusters = _fitflip_world(b=200, c=24)
    kw = dict(chunk_size=64, min_bucket=32, narrow_m=16)
    off = Twin(monkeypatch, donate=False, **kw)
    on = _port(**kw)
    on.flightrec, on.pipeline_depth = None, depth
    seen = {True: [], False: []}
    for engine in (on, off.port):
        drain = engine._drain_window

        def spy(items, *args, _drain=drain, _donate=engine.donate):
            seen[_donate].extend(it.entry.prev_out is None for it in items if it.delta_ok)
            return _drain(items, *args)

        monkeypatch.setattr(engine, "_drain_window", spy)
    for batch, world in _warm_sequence(units, clusters):
        results_equal(on.schedule(batch, world), off.schedule(batch, world))
        for name in COUNTERS:
            assert getattr(on, name) == getattr(off, name), name
        assert on.last_changed == off.last_changed
    assert seen[True] and all(seen[True])
    assert seen[False] and not any(seen[False])
    assert on.planner_reruns > 0


def test_donation_with_planner_reruns(monkeypatch):
    """A round budget of 0 re-dispatches every windowed chunk, warm ones
    included: the late rows are diffed again against the cached decode,
    so a donating engine equals JAX's tick for tick, counters and
    changed rows included."""
    monkeypatch.setattr(engine_mod, "PLANNER_ROUNDS", 0)
    monkeypatch.setenv("KT_PIPELINE_DEPTH", "16")
    units, clusters = _fitflip_world(b=200, c=24)
    twin = Twin(monkeypatch, chunk_size=64, min_bucket=32, narrow_m=16)
    rediffed = []
    real = twin.port._rediff_late_rows

    def spy(it, late, names):
        rediffed.append(late.size)
        return real(it, late, names)

    monkeypatch.setattr(twin.port, "_rediff_late_rows", spy)
    churned = list(units)
    for i in range(0, len(units), 5):
        churned[i] = dataclasses.replace(units[i], desired_replicas=(i % 11) + 30)
    relabeled = [dataclasses.replace(c, labels={**c.labels, "x": "y"}) if j == 2 else c
                 for j, c in enumerate(clusters)]
    for batch, world in ((units, clusters), (churned, _quarter_cpu(clusters, 3)),
                         (churned, relabeled)):
        twin.schedule(batch, world)
    assert twin.planner_reruns > 0 and twin.fetch_stats["delta"] > 0
    assert rediffed and max(rediffed) > 0
