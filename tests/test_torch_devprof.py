"""The port's dispatch ledger (``runtime/devprof.py``) against the JAX one.

* The chain model, with injected dispatch and ready times: the same
  records (queue and device seconds) from both packages' ledgers, and
  the values worked out by hand.  The JAX ledger waits on a stand-in
  leaf's ``block_until_ready``, the port's on a stand-in CUDA event's
  ``synchronize``; a clock stand-in gives both the scripted times.
* The disabled ledger, the tick and untracked rings, the summaries and
  the metrics, beside the JAX ledger fed the same calls on CPU arrays.
* ``tests/test_devprof.py``'s engine waterfall cases on the port's CPU
  engine: records ordered and tick-scoped, the churn tick's repair, a
  no-op tick with no record, a drift tick attributing ``gate`` and
  ``wcheck``; ``last_tick_id`` is the ledger's tick id.
* The program kinds of each tick of a cold / churn / no-op / drift
  sequence against the JAX engine's on the same world: equal but for
  the kinds the port has no program for (NO_PROGRAM, ROADMAP queue 3
  item 5) and its ``tiebreak`` records, one per compact dispatch (the
  port builds the FNV plane inside each dispatch; JAX builds it at
  upload and patches it); the same for a fit-flip drift tick of the
  three-stream survivor revert (``resolve``, ``replan``, ``scoreonly``)
  and for the ticks of an f16 engine (``score_pack``).
"""

import dataclasses
import threading
import time
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_drift_replan import _fitflip_world, _quarter_cpu
from test_engine_cache import make_world
from test_torch_engine import _port

from kubeadmiral_tpu.runtime import devprof as jax_devprof
from kubeadmiral_tpu.runtime.metrics import Metrics as JaxMetrics
from kubeadmiral_tpu.scheduler.engine import SchedulerEngine as JaxEngine
from kubeadmiral_tpu_torch.runtime import devprof
from kubeadmiral_tpu_torch.runtime.devprof import DispatchLedger
from kubeadmiral_tpu_torch.runtime.metrics import Metrics

# JAX program kinds the port has no program for.
NO_PROGRAM = ("nfeas", "zeros", "stack")


# -- the chain model ------------------------------------------------------------

class Clock:
    """perf_counter stand-in: the next scripted dispatch time on the
    thread that observes, the ready time of the record being retired on
    the watcher thread."""

    def __init__(self, dispatch):
        self.dispatch = iter(dispatch)
        self.ready = None

    def perf_counter(self):
        if threading.current_thread().name == "devprof-watcher":
            return self.ready
        return next(self.dispatch)

    def module(self):
        return types.SimpleNamespace(
            perf_counter=self.perf_counter, monotonic=time.monotonic,
            strftime=time.strftime, sleep=time.sleep,
        )


class Leaf:
    """A dispatched output that becomes ready at a scripted time."""

    shape = (3,)
    nbytes = 12
    sharding = None

    def __init__(self, clock, t):
        self.clock, self.t = clock, t

    def block_until_ready(self):
        self.clock.ready = self.t
        return self


# (dispatch, ready) per record: back to back with queueing, an idle gap,
# and a ready stamp before its start (clamped: device 0).
TIMES = [(0.0, 5.0), (1.0, 6.0), (2.0, 7.5), (10.0, 12.0), (20.0, 12.5)]
WANT = [  # (queue_s, device_s)
    (0.0, 5.0), (4.0, 1.0), (4.0, 1.5), (0.0, 2.0), (0.0, 0.0),
]


def _chain_records(monkeypatch, module, observe):
    clock = Clock([d for d, _ in TIMES])
    monkeypatch.setattr(module, "time", clock.module())
    ledger = module.DispatchLedger(enabled=True)
    observe(ledger, clock)
    assert ledger.drain(10.0)
    return sorted(ledger._untracked, key=lambda r: r.seq)


def test_chain_model_with_injected_ready_times(monkeypatch):
    def jax_observe(ledger, clock):
        for _, ready in TIMES:
            ledger.observe("tick", Leaf(clock, ready))

    readies = iter(r for _, r in TIMES)

    class Event:
        def __init__(self, clock, t):
            self.clock, self.t = clock, t

        def synchronize(self):
            self.clock.ready = self.t

    def port_observe(ledger, clock):
        monkeypatch.setattr(devprof, "_ready_marker", lambda leaf: Event(clock, next(readies)))
        for _ in TIMES:
            ledger.observe("tick", torch.zeros(3))

    want = _chain_records(monkeypatch, jax_devprof, jax_observe)
    got = _chain_records(monkeypatch, devprof, port_observe)
    assert [(r.queue_s, r.device_s) for r in want] == WANT
    assert [(r.queue_s, r.device_s) for r in got] == WANT
    assert [r.t_ready for r in got] == [r.t_ready for r in want]
    assert [r.shape for r in got] == [r.shape for r in want] == ["3"] * len(TIMES)


def test_cpu_output_is_ready_when_observed():
    ledger = DispatchLedger(enabled=True)
    ledger.observe("tick", torch.ones(4, 2))
    ledger.observe("pack", {"wire": torch.zeros(7, dtype=torch.int32)})
    assert ledger.drain(10.0)
    recs = sorted(ledger._untracked, key=lambda r: r.seq)
    assert [(r.kind, r.shape, r.device) for r in recs] == [("tick", "4x2", "d0"), ("pack", "7", "d0")]
    assert all(r.device_s == 0.0 and r.t_ready == r.t_dispatch for r in recs)


def test_pick_leaf_walks_outputs():
    from kubeadmiral_tpu_torch.ops.pipeline import TickOutputs

    small = torch.zeros(2)
    out = (TickOutputs(*[torch.zeros(5, 3)] * len(TickOutputs._fields)), {"cert": small})
    assert devprof._pick_leaf(out) is small
    assert devprof._pick_leaf(([1, 2], "x", None)) is None

    @dataclasses.dataclass
    class Holder:
        a: object
        b: object

    assert devprof._pick_leaf(Holder(torch.zeros(9), torch.zeros(1, 1))).shape == (1, 1)


# -- disabled ledger, rings, summaries, metrics ---------------------------------------

def _drive(ledger, array, ticks=3, per_tick=("tick", "pack")):
    """The same calls on either package's ledger: ``ticks`` bracketed
    ticks of ``per_tick`` dispatches and a host-only output each, then
    one dispatch outside any tick."""
    ids = []
    for i in range(ticks):
        ids.append(ledger.begin_tick(engine_tick=i + 1, objects=10, clusters=3))
        for kind in per_tick:
            ledger.observe(kind, array(np.arange(i + 2)))
        ledger.observe("pack", [1, 2, 3])  # host-only: no record
        ledger.end_tick({"device": 0.5, "decode": 0.25})
        # Retired while the tick is still in the ring.
        assert ledger.drain(10.0)
    ledger.observe("gate", array(np.ones((2, 2))))
    return ids


def _shape_of(wf):
    return {
        "enabled": wf["enabled"],
        "inflight": wf.get("inflight"),
        "ticks": [
            (t["tick"], t["meta"], t["stage_ms"],
             [(r["seq"], r["kind"], r["shape"], r["device"]) for r in t["records"]],
             {k: v["n"] for k, v in t["by_program"].items()})
            for t in wf["ticks"]
        ],
        "untracked": wf.get("untracked", {}).get("records"),
    }


@pytest.mark.parametrize("enabled", [True, False], ids=["enabled", "disabled"])
def test_ledger_surface_against_jax(enabled):
    jax_ledger = jax_devprof.DispatchLedger(enabled=enabled, ring_ticks=2)
    ledger = DispatchLedger(enabled=enabled, ring_ticks=2)
    want_ids = _drive(jax_ledger, jnp.asarray)
    got_ids = _drive(ledger, torch.as_tensor)
    assert got_ids == want_ids == ([1, 2, 3] if enabled else [0, 0, 0])
    assert _shape_of(ledger.waterfall()) == _shape_of(jax_ledger.waterfall())
    want, got = jax_ledger.tick_summary(), ledger.tick_summary()
    if enabled:
        for s in (want, got):
            s.pop("wall_ms")
            s["by_program"] = {k: v["n"] for k, v in s["by_program"].items()}
            s["by_device"] = {k: v["n"] for k, v in s["by_device"].items()}
            s.pop("device_ms"), s.pop("queue_ms")
        # Ticks before the ring's two are gone.
        assert ledger.tick_summary(1) == jax_ledger.tick_summary(1)
        assert ledger.tick_summary(1)["tick"] is None
    assert got == want
    def slices(events):
        # A queue:<kind> slice rides a record that waited: timing.
        return [(e["name"], e["ph"]) for e in events if not e["name"].startswith("queue:")]

    assert slices(ledger.chrome_events(0.0)) == slices(jax_ledger.chrome_events(0.0))
    assert ledger.inflight == jax_ledger.inflight == 0


def test_disabled_ledger_records_nothing():
    ledger = DispatchLedger(enabled=False)
    ledger.observe("tick", torch.zeros(3))
    assert ledger.begin_tick() == 0
    ledger.end_tick()
    assert ledger.waterfall() == {"enabled": False, "ticks": []}
    assert ledger.tick_summary() == {"enabled": False}
    assert ledger.chrome_events(0.0) == []
    assert ledger.drain() is True
    assert ledger._thread is None


def test_untracked_ring_and_metrics():
    m, jm = Metrics(), JaxMetrics()
    ledger = DispatchLedger(enabled=True, metrics=m)
    jax_ledger = jax_devprof.DispatchLedger(enabled=True, metrics=jm)
    for i in range(devprof._UNTRACKED_RING + 5):
        ledger.observe("tick", torch.zeros(1))
    jax_ledger.observe("tick", jnp.zeros(1))
    assert ledger.drain(30.0) and jax_ledger.drain(30.0)
    assert len(ledger._untracked) == devprof._UNTRACKED_RING
    assert sorted(m.snapshot()["histograms"]) == sorted(jm.snapshot()["histograms"]) == [
        "engine_device_seconds{device=d0,program=tick}",
        "engine_queue_wait_seconds{device=d0,program=tick}",
    ]
    assert m.snapshot()["histograms"]["engine_device_seconds{device=d0,program=tick}"][
        "count"] == devprof._UNTRACKED_RING + 5
    assert m.snapshot()["gauges"]["engine_dispatch_inflight"] == 0


def test_module_constants_are_the_jax_defaults():
    assert devprof.ENABLED is True and devprof.RING_TICKS == 8
    assert devprof.PROGRAM_KINDS == jax_devprof.PROGRAM_KINDS
    ledger = DispatchLedger()
    assert ledger.enabled and ledger._ticks.maxlen == 8


def test_capture_device_profile_on_the_cpu(tmp_path):
    ready = threading.Event()
    out = devprof.capture_device_profile(0.1, out_dir=str(tmp_path), ready=ready)
    assert "error" not in out, out
    assert ready.is_set() and out["files"] == 1
    assert out["trace"].startswith(str(tmp_path)) and out["trace"].endswith("trace.json")
    import json

    with open(out["trace"]) as f:
        assert "traceEvents" in json.load(f)
    assert devprof.profile_dir() == devprof.PROFILE_DIR == "/tmp/kt-torch-profile"
    stop = threading.Event()
    stop.set()
    out = devprof.capture_device_profile(60.0, out_dir=str(tmp_path), stop=stop)
    assert "error" not in out and out["wall_s"] < 30.0


def test_one_capture_at_a_time(tmp_path):
    assert devprof._capture_lock.acquire(blocking=False)
    try:
        assert devprof.capture_device_profile(0.1, out_dir=str(tmp_path)) == {
            "error": "a profiler capture is already running"
        }
    finally:
        devprof._capture_lock.release()


# -- the engine's waterfalls (tests/test_devprof.py's cases) ----------------------

def _engine(monkeypatch, **kw):
    engine = _port(chunk_size=64, **kw)
    engine.devprof = DispatchLedger(enabled=True)
    return engine, engine.devprof


def test_waterfall_records_ordered_and_tick_scoped(monkeypatch):
    units, clusters = make_world(b=64, c=8)
    engine, ledger = _engine(monkeypatch)
    engine.schedule(units, clusters)
    first = engine.last_tick_id
    churned = list(units)
    churned[3] = dataclasses.replace(churned[3], desired_replicas=77)
    engine.schedule(churned, clusters)
    second = engine.last_tick_id
    assert (first, second) == (1, 2)
    wf = ledger.waterfall()
    ticks = {t["tick"]: t for t in wf["ticks"]}
    assert first in ticks and second in ticks
    for entry in ticks.values():
        seqs = [r["seq"] for r in entry["records"]]
        assert seqs == sorted(seqs)
        for r in entry["records"]:
            assert r["ready_ms"] >= r["t_ms"]
            assert r["device_ms"] >= 0 and r["queue_ms"] >= 0
        assert set(entry["by_program"]) <= set(devprof.PROGRAM_KINDS)
    assert ticks[first]["meta"] == {"engine_tick": 1, "objects": 64, "clusters": 8}
    assert set(ticks[first]["stage_ms"]) >= {"featurize", "device", "fetch", "decode"}
    # The sub-batch churn tick repairs prev planes in place.
    assert "repair" in ticks[second]["by_program"]
    assert ledger.tick_summary()["tick"] == engine.last_tick_id


def test_noop_replay_dispatches_nothing(monkeypatch):
    units, clusters = make_world(b=48, c=8)
    engine, ledger = _engine(monkeypatch)
    engine.schedule(units, clusters)
    engine.schedule(units, clusters)  # no-op replay
    s = ledger.tick_summary()
    assert s["tick"] == engine.last_tick_id == 2
    assert s["records"] == 0


def test_drift_tick_attributes_gate_programs(monkeypatch):
    units, clusters = make_world(b=64, c=12)
    engine, ledger = _engine(monkeypatch)
    engine.schedule(units, clusters)
    drifted = list(clusters)
    drifted[0] = dataclasses.replace(
        drifted[0], available={k: max(0, v // 2) for k, v in drifted[0].available.items()}
    )
    engine.schedule(units, drifted)
    assert engine.drift_stats["gated"]
    s = ledger.tick_summary()
    assert "gate" in s["by_program"], s["by_program"]
    assert "wcheck" in s["by_program"], s["by_program"]


def test_last_tick_id_is_the_ledger_tick_id(monkeypatch):
    """Two engines on one ledger take interleaved ids, as JAX's do; a
    disabled ledger leaves ``last_tick_id`` at ``tick_seq``."""
    units, clusters = make_world(b=24, c=6)
    monkeypatch.setenv("KT_PIPELINE_DEPTH", "1")
    shared, jax_shared = DispatchLedger(), jax_devprof.DispatchLedger(enabled=True)
    ports = [_port(chunk_size=32) for _ in range(2)]
    refs = [JaxEngine(mesh=None, flight_recorder=None, devprof=jax_shared, chunk_size=32)
            for _ in range(2)]
    for engine in ports:
        engine.devprof = shared
    ids, want = [], []
    for i in (0, 1, 0, 0, 1):
        ports[i].schedule(units, clusters)
        refs[i].schedule(units, clusters)
        ids.append(ports[i].last_tick_id)
        want.append(refs[i].last_tick_id)
    assert ids == want == [1, 2, 3, 4, 5]
    off = _port(chunk_size=32)
    off.devprof = DispatchLedger(enabled=False)
    ref_off = JaxEngine(mesh=None, flight_recorder=None, devprof=None, chunk_size=32)
    for _ in range(2):
        off.schedule(units, clusters)
        ref_off.schedule(units, clusters)
    assert off.last_tick_id == ref_off.last_tick_id == off.tick_seq == 2


# -- program kinds per tick against the JAX engine --------------------------------

def _kinds(ledger, tick):
    return set(ledger.tick_summary(tick)["by_program"])


@pytest.mark.parametrize("depth", [1, 16], ids=["depth1", "depth16"])
def test_tick_kinds_against_jax(monkeypatch, depth):
    monkeypatch.setenv("KT_PIPELINE_DEPTH", str(depth))
    units, clusters = make_world(b=96, c=12)
    jax_ledger = jax_devprof.DispatchLedger(enabled=True)
    ref = JaxEngine(mesh=None, flight_recorder=None, devprof=jax_ledger, chunk_size=64)
    port, ledger = _engine(monkeypatch)
    port.pipeline_depth = depth
    churned = list(units)
    churned[3] = dataclasses.replace(churned[3], desired_replicas=77)
    drifted = list(clusters)
    drifted[0] = dataclasses.replace(
        drifted[0], available={k: max(0, v // 2) for k, v in drifted[0].available.items()}
    )
    seen = {}
    for label, batch, cl in (
        ("cold", units, clusters), ("churn", churned, clusters),
        ("noop", churned, clusters), ("drift", churned, drifted),
    ):
        port.schedule(batch, cl)
        ref.schedule(batch, cl)
        assert port.last_tick_id == ref.last_tick_id
        got = _kinds(ledger, port.last_tick_id)
        want = _kinds(jax_ledger, ref.last_tick_id) - set(NO_PROGRAM)
        if got & {"tick", "tick_narrow"}:
            want.add("tiebreak")
        assert got == want, (label, got, want)
        seen[label] = got
    assert seen["noop"] == set()
    assert {"gate", "wcheck"} <= seen["drift"]
    assert {"repair", "patch"} <= seen["churn"]


@pytest.mark.parametrize(
    "switches,env",
    [({"survivor_unified": False}, {"KT_SURVIVOR_UNIFIED": "0"}),
     ({"score_f16": True}, {"KT_SCORE_F16": "1"})],
    ids=["three-stream", "f16"],
)
def test_optin_tick_kinds_against_jax(monkeypatch, switches, env):
    """The per-tick kinds of a three-stream engine's drift tick (its
    resolve, replan and score-only programs, each with its fused wire
    pack) and of an f16 engine's ticks (``score_pack``: compress at
    every store, upcast for each diff and gate; the unified survivor
    groups with their packs) equal the JAX engine's with the same
    switch."""
    for name, value in env.items():
        monkeypatch.setenv(name, value)
    monkeypatch.setenv("KT_PIPELINE_DEPTH", "16")
    units, clusters = _fitflip_world()
    kw = dict(chunk_size=128, min_bucket=32, min_cluster_bucket=8, narrow_m=16)
    jax_ledger = jax_devprof.DispatchLedger(enabled=True)
    ref = JaxEngine(mesh=None, flight_recorder=None, devprof=jax_ledger, **kw)
    port = _port(**kw)
    port.devprof = ledger = DispatchLedger(enabled=True)
    for name, value in switches.items():
        setattr(port, name, value)
    seen = {}
    # Fit flips at member 3, rank moves at member 7 (fully free).
    drifted = [
        dataclasses.replace(c, available=dict(c.allocatable)) if j == 7 else c
        for j, c in enumerate(_quarter_cpu(clusters, 3))
    ]
    for label, cl in (("cold", clusters), ("drift", drifted), ("back", clusters)):
        port.schedule(units, cl)
        ref.schedule(units, cl)
        got = _kinds(ledger, port.last_tick_id)
        want = _kinds(jax_ledger, ref.last_tick_id) - set(NO_PROGRAM)
        if got & {"tick", "tick_narrow"} or "scoreonly" in got:
            want.add("tiebreak")
        assert got == want, (label, got, want)
        seen[label] = got
    if "score_f16" in switches:
        assert all("score_pack" in kinds for kinds in seen.values())
    else:
        assert {"resolve", "replan", "scoreonly"} <= seen["drift"], seen["drift"]
