"""The port's store, queue, worker and host helpers against the JAX
package's.

* The store cases of ``tests/test_store_rewrite.py`` (copy-on-write
  nodes, columnar batch ordering, coalesced delivery, the lock-field
  declaration) and the queue, worker, pending and store cases of
  ``tests/test_runtime.py`` run unchanged over each package's modules:
  the JAX test module's globals are pointed at the port's classes.
* One op script (``test_store_rewrite._drive``) gives the same watch
  streams, per-op results and store image on both packages' stores,
  and on the port's store with coalescing on and off (the JAX module's
  ``KT_STORE_COALESCE`` A/B as the ``coalesce=`` argument).
* The lock check, off by default on the port, turned on with
  ``lockcheck.enable()`` in a fresh interpreter, sees the columnar
  commit clean and flags an unguarded rebind.
* Each environment read of the JAX modules that the port turned into
  an argument or module constant (admission, the shard map) gives the
  same behaviour at the same setting, and the same default when unset.
* The parts of the SLO recorder, the tenant ledger, the tracer and the
  member breakers that the scheduling path calls behave as JAX's at
  JAX's defaults: the same tokens and marks, tenant counts, sampled
  spans, and breaker states and transitions.
* ``copy_json``, ``create_merge_patch`` and ``stable_json_hash`` (the
  JAX package's native paths) equal the port's pure-Python copies on
  seeded random JSON.
"""

import itertools
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

import test_runtime as RT
import test_store_rewrite as SR

from kubeadmiral_tpu.federation import shardmap as jax_shardmap
from kubeadmiral_tpu.runtime import slo as jax_slo
from kubeadmiral_tpu.runtime import tenancy as jax_tenancy
from kubeadmiral_tpu.runtime import trace as jax_trace
from kubeadmiral_tpu.runtime import worker as jax_worker
from kubeadmiral_tpu.testing import fakekube as jax_fk
from kubeadmiral_tpu.transport import breaker as jax_breaker
from kubeadmiral_tpu.utils import hashing as jax_hashing
from kubeadmiral_tpu.utils import jsonpatch as jax_jsonpatch
from kubeadmiral_tpu.utils import unstructured as jax_unstructured
from kubeadmiral_tpu_torch.federation import shardmap
from kubeadmiral_tpu_torch.runtime import pending, queue, slo, tenancy, trace, worker
from kubeadmiral_tpu_torch.testing import fakekube as fk
from kubeadmiral_tpu_torch.transport import breaker
from kubeadmiral_tpu_torch.utils import hashing, jsonpatch, unstructured

PORT_NAMES = {
    "FakeKube": fk.FakeKube,
    "ClusterFleet": fk.ClusterFleet,
    "ADDED": fk.ADDED,
    "MODIFIED": fk.MODIFIED,
    "DELETED": fk.DELETED,
    "Conflict": fk.Conflict,
    "NotFound": fk.NotFound,
    "Backoff": queue.Backoff,
    "DirtyQueue": queue.DirtyQueue,
    "Worker": worker.Worker,
    "BatchWorker": worker.BatchWorker,
    "Result": worker.Result,
    "dependencies_fulfilled": pending.dependencies_fulfilled,
    "get_pending": pending.get_pending,
    "set_pending": pending.set_pending,
    "update_pending": pending.update_pending,
}

STORE_CASES = [
    (SR.TestCopyOnWrite, "test_retained_view_survives_later_writes"),
    (SR.TestCopyOnWrite, "test_metadata_only_update_shares_spec_subtree"),
    (SR.TestCopyOnWrite, "test_status_update_shares_everything_but_status"),
    (SR.TestCopyOnWrite, "test_delivered_event_is_the_stored_node"),
    (SR.TestCopyOnWrite, "test_batch_results_are_version_nodes"),
    (SR.TestBatchOrdering, "test_event_order_and_codes"),
    (SR.TestBatchOrdering, "test_failed_ops_do_not_emit_events_or_burn_rv"),
    (SR.TestBatchOrdering, "test_conflict_mid_batch_isolated"),
    (SR.TestBatchOrdering, "test_finalizer_gated_delete_through_batch"),
    (SR.TestCoalescedDelivery, "test_one_batch_call_per_flush"),
    (SR.TestCoalescedDelivery, "test_direct_verbs_use_per_event_callable"),
    (SR.TestCoalescedDelivery, "test_predicate_filters_batchwise"),
    (SR.TestCoalescedDelivery, "test_replay_batches"),
    (SR.TestCoalescedDelivery, "test_watch_all_batch_observer"),
    (SR.TestCoalescedDelivery, "test_named_fleet_batch_and_unwatch_owner"),
    (SR.TestLockDiscipline, "test_shared_fields_declaration"),
]

RUNTIME_CASES = [
    "test_dirty_queue_dedups_and_delays",
    "test_dirty_queue_earliest_wins",
    "test_backoff_doubles_and_resets",
    "test_worker_retry_uses_backoff",
    "test_batch_worker_drains_everything_due",
    "test_pending_controllers_pipeline",
    "test_pending_missing_annotation_raises",
    "test_fakekube_crud_and_conflict",
    "test_fakekube_finalizers_gate_deletion",
    "test_fakekube_list_filters",
]


@pytest.fixture(params=("jax", "port"))
def package(request, monkeypatch):
    """The JAX test modules' globals pointed at one package's modules."""
    if request.param == "port":
        for module in (SR, RT):
            for name, obj in PORT_NAMES.items():
                if hasattr(module, name):
                    monkeypatch.setattr(module, name, obj)
    return request.param


@pytest.mark.parametrize(
    "case", STORE_CASES, ids=[f"{c.__name__}.{m}" for c, m in STORE_CASES]
)
def test_store_case(package, case):
    assert SR.FakeKube is (fk.FakeKube if package == "port" else jax_fk.FakeKube)
    cls, method = case
    getattr(cls(), method)()


@pytest.mark.parametrize("case", RUNTIME_CASES)
def test_runtime_case(package, case):
    assert RT.Worker is (worker.Worker if package == "port" else jax_worker.Worker)
    getattr(RT, case)()


def _drive(kube):
    streams, results, dump = SR._drive(kube)
    norm = [
        {"code": r["code"],
         **({"object": json.dumps(r["object"], sort_keys=True)}
            if "object" in r else {"status": r.get("status")})}
        for r in results
    ]
    return streams, norm, dump


def test_op_script_equal_across_packages():
    jax_out = _drive(jax_fk.FakeKube("ab"))
    port_out = _drive(fk.FakeKube("ab"))
    assert port_out == jax_out
    assert len(port_out[0]["watch"]) >= 8


@pytest.mark.parametrize("coalesce", (True, False))
def test_coalesce_argument_matches_the_jax_knob(monkeypatch, coalesce):
    monkeypatch.setenv("KT_STORE_COALESCE", "1" if coalesce else "0")
    jax_kube = jax_fk.FakeKube("ab")
    kube = fk.FakeKube("ab", coalesce=coalesce)
    assert kube._coalesce is jax_kube._coalesce is coalesce
    assert fk.ClusterFleet(coalesce=coalesce).add_member("m")._coalesce is coalesce
    assert _drive(kube) == _drive(jax_kube)


def test_coalesced_and_per_op_stores_bit_identical():
    on, off = _drive(fk.FakeKube("ab")), _drive(fk.FakeKube("ab", coalesce=False))
    assert on == off
    assert any(e == fk.DELETED for e, _ in on[0]["watch"])


LOCKCHECK_SCRIPT = """
from kubeadmiral_tpu_torch.runtime import lockcheck
assert not lockcheck.enabled()
lockcheck.enable()
from kubeadmiral_tpu_torch.testing.fakekube import FakeKube
RES = "apps/v1/deployments"
def obj(name):
    return {"apiVersion": "apps/v1", "kind": "Deployment",
            "metadata": {"name": name, "namespace": "default"}, "spec": {}}
k = FakeKube("m")
k.watch(RES, lambda e, o: None)
k.batch([{"verb": "create", "resource": RES, "object": obj(f"o{i}")} for i in range(10)])
k.batch([{"verb": "delete", "resource": RES, "key": "default/o0"}])
k.create(RES, obj("direct"))
assert FakeKube.restore(k.dump()).current_rv() == k.current_rv()
assert [v for v in lockcheck.violations() if "FakeKube" in v] == []
k._rv = 99
assert [v for v in lockcheck.violations() if "FakeKube._rv" in v], "guard not armed"
print("ok")
"""


def test_lockcheck_enable_arms_the_store_guard():
    out = subprocess.run(
        [sys.executable, "-c", LOCKCHECK_SCRIPT],
        capture_output=True, text=True, timeout=120,
        cwd=Path(__file__).resolve().parent.parent,
    )
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr


# -- environment reads turned into arguments ----------------------------------

def test_admission_constants_match_the_jax_knobs(monkeypatch):
    monkeypatch.setenv("KT_ADMIT_DEPTH", "3")
    monkeypatch.setenv("KT_ADMIT_DELAY_MS", "40")
    monkeypatch.setenv("KT_ADMIT_BATCH", "2")
    monkeypatch.setattr(worker, "ADMIT_DEPTH", 3)
    monkeypatch.setattr(worker, "ADMIT_DELAY_MS", 40)
    monkeypatch.setattr(worker, "ADMIT_BATCH", 2)
    clock = RT.FakeClock()
    jw = jax_worker.BatchWorker("t", lambda keys: {}, clock=clock)
    pw = worker.BatchWorker("t", lambda keys: {}, clock=clock)
    for w in (jw, pw):
        for i in range(6):
            w.enqueue(f"ns/k{i}")
    assert pw.queue.drain_due() == jw.queue.drain_due()
    assert pw.queue.next_due_in() == jw.queue.next_due_in()
    assert (pw._admit_depth, pw._admit_delay, pw._admit_batch) == (3, 0.04, 2)


def test_admission_defaults_match():
    jw = jax_worker.Worker("t", lambda key: None)
    pw = worker.Worker("t", lambda key: None)
    got = (pw._admit_depth, pw._admit_delay, pw._admit_batch)
    assert got == (jw._admit_depth, jw._admit_delay, jw._admit_batch) == (10000, 0.05, 0)


def test_shard_map_arguments_match_the_jax_knobs(monkeypatch):
    monkeypatch.setenv("KT_SHARD_COUNT", "3")
    monkeypatch.setenv("KT_SHARD_INDEX", "1")
    keys = [f"ns/obj-{i}" for i in range(300)] + ["cluster::pool-a"]
    jm, pm = jax_shardmap.ShardMap(), shardmap.ShardMap(3, 1)
    assert [pm.owns(k) for k in keys] == [jm.owns(k) for k in keys]
    assert pm.describe() == jm.describe()
    monkeypatch.delenv("KT_SHARD_COUNT")
    monkeypatch.delenv("KT_SHARD_INDEX")
    assert shardmap.ShardMap().describe() == jax_shardmap.ShardMap().describe()
    assert shardmap.reset_default().describe()["identity"] is True


def test_tenant_ledger_matches_jax(monkeypatch):
    """The worker's and the scheduler's tenant hooks: the same keys give
    the same tenants, and a ledger fed past its MAX_TENANTS named
    tenants collapses the rest into "~other" as JAX's does."""
    monkeypatch.delenv("KT_TENANT_MAX", raising=False)
    monkeypatch.delenv("KT_TENANT_LABEL", raising=False)
    keys = ["ns/a", "a", "/a", "ns/", "kube-system/x/y"]
    assert [tenancy.tenant_of_key(k) for k in keys] == [jax_tenancy.tenant_of_key(k) for k in keys]
    jl, pl = jax_tenancy.TenantLedger(), tenancy.TenantLedger()
    assert tenancy.MAX_TENANTS == jl.max_tenants
    for ledger in (jl, pl):
        for i in range(tenancy.MAX_TENANTS + 6):
            ledger.note_scheduled(f"t{i % 70}", i + 1)
            ledger.note_admission(tenancy.tenant_of_key(f"t{i}/obj"))
    want = {
        name: (t["admission_deferrals"], t["scheduled"])
        for name, t in jl.summary()["tenants"].items()
    }
    got = {name: (t.admissions, t.scheduled) for name, t in pl._tenants.items()}
    assert got == want and tenancy.OTHER in got
    for family in ("tenant_scheduled_total", "tenant_admission_deferrals_total"):
        assert pl.metrics.counter_family(family) == jl.metrics.counter_family(family)


class _Store:
    """A weak-referenceable stand-in for a store the recorder tracks."""


def test_slo_tokens_match_jax(monkeypatch):
    """The store's ingest, the federate controller's track and the
    scheduler's stage marks: the same events give the same tokens,
    generations, marks and counters on both recorders, the pending cap
    included."""
    monkeypatch.delenv("KT_SLO", raising=False)
    monkeypatch.delenv("KT_SLO_PENDING_CAP", raising=False)
    assert slo.PENDING_CAP == jax_slo.SLORecorder().pending_cap
    monkeypatch.setattr(slo, "PENDING_CAP", 3)
    ticks = {"jax": itertools.count(), "port": itertools.count()}
    jr = jax_slo.SLORecorder(clock=lambda: next(ticks["jax"]), pending_cap=3)
    pr = slo.SLORecorder(clock=lambda: next(ticks["port"]))
    res = "apps/v1/deployments"

    def obj(name, gen=None, ns="default"):
        meta = {"name": name, "namespace": ns}
        if gen is not None:
            meta["generation"] = gen
        return {"metadata": meta}

    script = [
        ("ADDED", obj("a", 1)), ("ADDED", obj("b", 1)), ("MODIFIED", obj("a", 1)),
        ("MODIFIED", obj("a", 2)), ("ADDED", obj("c")), ("ADDED", obj("d", 1)),
        ("ADDED", obj("", 1)), ("DELETED", obj("b", 1)), ("ADDED", obj("e", 1, ns="")),
    ]
    for side, rec in (("jax", jr), ("port", pr)):
        ticks[side] = itertools.count()  # JAX's evaluator read the clock at birth
        store, other = _Store(), _Store()
        rec.track(store, res)
        for i, (event, o) in enumerate(script):
            rec.ingest(store, res, event, o)
            rec.ingest(other, res, event, o)  # untracked store: no token
            rec.ingest(store, "v1/pods", event, o)  # untracked resource
            if i == 4:
                rec.mark_many(["default/a", "default/zz"], "queued")
        rec.mark_many(["default/a", "default/c"], "queued")
        rec.mark_many(["default/a", "e"], "slab", t=100)

    def image(rec):
        pending = {k: (e.key, e.birth, e.gen, list(e.marks)) for k, e in rec._pending.items()}
        return pending, dict(rec._gen), rec.metrics.counter_family("slo_events_total")

    assert image(pr) == image(jr)
    assert len(pr._pending) == 3


def test_hot_span_samples_like_jax(monkeypatch):
    """``hot_span`` keeps 1 in SAMPLE_N calls (the JAX module's
    ``KT_TRACE_SAMPLE_N`` default) on the default tracer, as JAX's."""
    monkeypatch.delenv("KT_TRACE_SAMPLE_N", raising=False)
    assert jax_trace.reset_sampling() == trace.SAMPLE_N
    got = []
    for mod in (jax_trace, trace):
        mod.get_default().clear()
        for i in range(4 * trace.SAMPLE_N):
            with mod.hot_span("t.hot", i=i) as sp:
                sp.set(done=True)
        got.append([
            (sp.name, sp.args["sampled_1_in"], sp.args["done"])
            for sp in mod.get_default().spans()
        ])
        mod.get_default().clear()
    assert got[0] == got[1] == [("t.hot", trace.SAMPLE_N, True)] * 4


def test_breaker_matches_jax(monkeypatch):
    """The cluster controller's breaker calls: the thresholds are JAX's
    defaults, and one script of failures, stalls, slow successes,
    probes and cool-downs gives the same states and transitions."""
    for name in ("KT_BREAKER_FAILURES", "KT_BREAKER_OPEN_S",
                 "KT_BREAKER_LATENCY_S", "KT_BREAKER_STALL_S"):
        monkeypatch.delenv(name, raising=False)
    fields = ("failure_threshold", "open_seconds", "latency_threshold_s",
              "stall_threshold_s", "ewma_alpha")
    jcfg, pcfg = jax_breaker.BreakerConfig(), breaker.BreakerConfig()
    assert [getattr(pcfg, f) for f in fields] == [getattr(jcfg, f) for f in fields]

    def run(registry, now):
        seen = []
        registry.on_transition(lambda *t: seen.append(t))
        b = registry.for_member("m1")
        steps = []
        for op, arg in (
            ("fail", None), ("fail", None), ("allow", False), ("fail", None),
            ("allow", False), ("tick", 4.9), ("allow", True), ("tick", 0.2),
            ("allow", True), ("allow", True), ("fail", None), ("tick", 5.0),
            ("ok_probe", 0.01), ("ok", 9.0), ("ok", 9.0), ("tick", 6.0),
            ("allow", True), ("ok", 0.01), ("fail_slow", 1.5), ("tick", 2.0),
            ("ok_probe", 0.01), ("tick", 3.5), ("ok_probe", 0.01),
        ):
            if op == "tick":
                now[0] += arg
            elif op == "fail":
                b.record_failure()
            elif op == "fail_slow":
                b.record_failure(latency_s=arg)
            elif op == "ok":
                b.record_success(arg)
            elif op == "ok_probe":
                b.record_success(arg, probe=True)
            else:
                steps.append(b.allow(consume_probe=arg))
            steps.append(b.state)
        return steps, seen

    clocks = ([0.0], [0.0])
    jreg = jax_breaker.BreakerRegistry(clock=lambda: clocks[0][0])
    preg = breaker.BreakerRegistry(clock=lambda: clocks[1][0])
    want, got = run(jreg, clocks[0]), run(preg, clocks[1])
    assert got == want
    assert {s for s in got[0] if isinstance(s, str)} == {"closed", "open", "half_open"}


# -- host helpers: the JAX package's native paths against the port's copies --

def _random_json(rng, depth=0):
    kind = rng.integers(0, 7 if depth < 4 else 4)
    if kind == 0:
        return int(rng.integers(-10**6, 10**6))
    if kind == 1:
        return "".join(chr(c) for c in rng.integers(32, 0x2FF, rng.integers(0, 12)))
    if kind == 2:
        return bool(rng.integers(0, 2))
    if kind == 3:
        return None if rng.integers(0, 2) else float(rng.normal())
    if kind == 4:
        return [_random_json(rng, depth + 1) for _ in range(rng.integers(0, 5))]
    return {f"k{int(rng.integers(0, 40))}": _random_json(rng, depth + 1)
            for _ in range(rng.integers(0, 6))}


@pytest.mark.parametrize("seed", range(4))
def test_host_helpers_equal_jax(seed):
    rng = np.random.default_rng(seed)
    for _ in range(60):
        a, b = _random_json(rng), _random_json(rng)
        copied = unstructured.copy_json(a)
        assert copied == jax_unstructured.copy_json(a) == a
        if isinstance(a, (dict, list)) and a:
            assert copied is not a
        assert hashing.stable_json_hash(a) == jax_hashing.stable_json_hash(a)
        assert hashing.fnv32a(json.dumps(a).encode()) == jax_hashing.fnv32a(json.dumps(a).encode())
        if isinstance(a, dict) and isinstance(b, dict):
            assert jsonpatch.create_merge_patch(a, b) == jax_jsonpatch.create_merge_patch(a, b)
    assert hashing.stable_json_hash({"s": {3, 1}, "t": (1, 2)}) == jax_hashing.stable_json_hash(
        {"s": {3, 1}, "t": (1, 2)}
    )
