"""The port's observability surface against the JAX package's.

* The timeline cases of ``tests/test_soak_observatory.py``
  (downsampling, the byte bound, the disabled timeline, the sampler
  thread) and its ``/debug`` endpoint cases (the index, the timeline and
  tenant routes, the 404s) run over JAX and over the port, with the
  test module's globals pointed at the port's and ``KT_TIMELINE``
  becoming the port's ``timeline.ENABLED``.
* End to end, on each package: a reconcile round (cluster, federate,
  scheduler and sync controllers and the member simulator, the
  scheduler's engine on the CPU with a dispatch ledger of its own)
  followed by the health server's ``/metrics`` (every line a valid
  exposition line; the engine's stage histograms, compile-cache and
  device-seconds series; the workers' series) and ``/debug/trace``
  (the reconcile spans: ``engine.schedule`` nested under ``worker.tick``;
  the ledger's device lanes merged in, tick ids in their args; gone
  under ``?device=0``).  The span names and metric families the two
  packages serve are compared: the port's are JAX's but for the engine's
  stage spans (the port's engine traces ``engine.schedule`` only) and
  the XLA families.
"""

import dataclasses
import importlib
import json
import re
import urllib.request

import pytest

import test_soak_observatory as SO
from test_e2e_slice import make_deployment, make_node
from test_torch_dispatch import ConstantsPatch
from test_torch_sync import method_cases, point_at_port

from kubeadmiral_tpu_torch.runtime import timeline

ENV_CONSTANTS = {
    "KT_TIMELINE": (timeline, "ENABLED", lambda v: v not in ("0", "false", "no")),
}


def run_case(monkeypatch, cls, name, port: bool):
    with monkeypatch.context() as mp:
        if port:
            point_at_port(mp, SO)
        obj = cls()
        method = getattr(obj, name)
        params = method.__code__.co_varnames[1: method.__code__.co_argcount]
        if "monkeypatch" in params:
            method(ConstantsPatch(mp, ENV_CONSTANTS) if port else mp)
        else:
            method()


CASES = method_cases(SO.TestTimelineDownsampling, SO.TestDebugEndpoints)


@pytest.mark.parametrize("cls,name", CASES, ids=[f"{c.__name__}.{n}" for c, n in CASES])
def test_observatory_case(monkeypatch, cls, name):
    run_case(monkeypatch, cls, name, port=False)
    run_case(monkeypatch, cls, name, port=True)


def test_timeline_constants_are_the_jax_defaults():
    assert timeline.ENABLED is True
    tl = timeline.Timeline()
    assert tl.interval_s == 1.0 and tl.max_bytes == 2 << 20 and tl.enabled


# -- end to end -------------------------------------------------------------------

# A valid exposition line: comment, or name{labels} value.
_PROM_LINE = re.compile(
    r"^(# (TYPE|HELP) .*"
    r"|[a-zA-Z_:][a-zA-Z0-9_:]*(\{[^{}]*\})? -?[0-9.e+-]+(inf|nan)?)$"
)
# The JAX engine's stage spans inside engine.schedule; the port's engine
# traces the tick only.
JAX_ONLY_SPANS = {
    "engine.featurize", "engine.device_dispatch", "engine.fetch_window",
    "engine.drift_gate", "engine.sub_batch",
}
# No XLA behind the port (tests/test_torch_metrics.py UNEQUAL).
JAX_ONLY_FAMILIES = {
    "engine_xla_compiles_total", "engine_persistent_cache_total", "engine_aot_programs_total",
}


def _fetch(port, path):
    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}", timeout=30) as r:
        return r.status, dict(r.headers), r.read()


def _round(root: str, monkeypatch):
    """One reconcile round on ``root``'s package; returns (span names,
    metric families, device-lane slices, host-only lane count)."""
    mod = lambda name: importlib.import_module(f"{root}.{name}")  # noqa: E731
    clusterctl = mod("federation.clusterctl")
    trace = mod("runtime.trace")
    metrics_mod = mod("runtime.metrics")
    health = mod("runtime.healthcheck")
    devprof = mod("runtime.devprof")
    fk = mod("testing.fakekube")
    trace.get_default().clear()
    if root == "kubeadmiral_tpu":
        monkeypatch.setenv("KT_TRACE_SAMPLE_N", "1")
        trace.reset_sampling()
        engine = mod("scheduler.engine").SchedulerEngine(
            mesh=None, devprof=devprof.DispatchLedger(enabled=True)
        )
    else:
        monkeypatch.setattr(trace, "SAMPLE_N", 1)
        engine = mod("scheduler.engine").SchedulerEngine(
            device="cpu", devprof=devprof.DispatchLedger(enabled=True)
        )
    monkeypatch.setattr(devprof, "_default", engine.devprof)
    ftc = next(f for f in mod("models.ftc").default_ftcs() if f.name == "deployments.apps")
    ftc = dataclasses.replace(ftc, controllers=(("kubeadmiral.io/global-scheduler",),))
    fleet = fk.ClusterFleet()
    m = metrics_mod.Metrics()
    engine.metrics = m
    engine.devprof.attach(m)
    controllers = (
        clusterctl.FederatedClusterController(fleet, api_resource_probe=["apps/v1/Deployment"], metrics=m),
        mod("federation.federate").FederateController(fleet.host, ftc, metrics=m),
        mod("federation.schedulerctl").SchedulerController(fleet.host, ftc, engine=engine, metrics=m),
        mod("federation.sync").SyncController(fleet, ftc, metrics=m),
    )
    sim = mod("testing.membersim").MemberDeploymentSimulator(fleet)
    for name in ("c1", "c2", "c3"):
        member = fleet.add_member(name)
        member.create(clusterctl.NODES, make_node("n1", "64", "128Gi"))
        fleet.host.create(clusterctl.FEDERATED_CLUSTERS, {
            "apiVersion": "core.kubeadmiral.io/v1alpha1", "kind": "FederatedCluster",
            "metadata": {"name": name}, "spec": {},
        })
    fleet.host.create(mod("models.policy").PROPAGATION_POLICIES, {
        "apiVersion": "core.kubeadmiral.io/v1alpha1", "kind": "PropagationPolicy",
        "metadata": {"name": "pp", "namespace": "default"}, "spec": {"schedulingMode": "Divide"},
    })
    fleet.host.create(ftc.source.resource, make_deployment())
    for _ in range(60):
        progressed = False
        for c in controllers:
            progressed |= c.worker.step()
        progressed |= sim.step()
        if not progressed:
            break
    server = health.HealthServer(health.HealthCheckRegistry(), metrics=m)
    port = server.start()
    try:
        status, headers, body = _fetch(port, "/metrics")
        assert status == 200 and headers["Content-Type"].startswith("text/plain")
        text = body.decode()
        for line in text.splitlines():
            assert _PROM_LINE.match(line), f"bad exposition line: {line!r}"
        families = {
            re.split(r"[{ ]", line, 1)[0].removesuffix("_bucket").removesuffix("_sum")
            .removesuffix("_count")
            for line in text.splitlines() if line and not line.startswith("#")
        }
        status, _, body = _fetch(port, "/debug/trace")
        doc = json.loads(body)
        spans = [e for e in doc["traceEvents"]
                 if e.get("ph") == "X" and "span_id" in e.get("args", {})]
        by_id = {e["args"]["span_id"]: e for e in spans}
        tick = next(e for e in spans if e["name"] == "engine.schedule")
        chain, e = [], tick
        while e is not None and "parent_id" in e["args"]:
            e = by_id.get(e["args"]["parent_id"])
            chain += [e["name"]] if e is not None else []
        assert "worker.tick" in chain, chain
        lanes = {e["tid"] for e in doc["traceEvents"]
                 if e.get("ph") == "M" and str(e["args"].get("name", "")).startswith("device ")}
        device = [e for e in doc["traceEvents"] if e.get("ph") == "X" and e.get("tid") in lanes]
        assert device and all(e["args"]["tick"] == tick["args"]["tick"] for e in device)
        _, _, body = _fetch(port, "/debug/trace?device=0")
        host_only = [e for e in json.loads(body)["traceEvents"]
                     if e.get("ph") == "M" and str(e["args"].get("name", "")).startswith("device ")]
    finally:
        server.stop()
    return {e["name"] for e in spans}, families, {e["name"] for e in device}, len(host_only)


def test_metrics_and_trace_against_jax(monkeypatch):
    with monkeypatch.context() as mp:
        want = _round("kubeadmiral_tpu", mp)
    with monkeypatch.context() as mp:
        got = _round("kubeadmiral_tpu_torch", mp)
    spans, families, device, host_only = got
    assert spans == want[0] - JAX_ONLY_SPANS
    assert {"worker.tick", "engine.schedule", "dispatch.member_flush"} <= spans
    assert families == want[1] - JAX_ONLY_FAMILIES
    for family in ("engine_tick_stage_seconds", "engine_compile_cache_total",
                   "engine_device_seconds", "worker_queue_depth", "worker_reconciles_total"):
        assert family in families, family
    assert device and device <= set(importlib.import_module(
        "kubeadmiral_tpu_torch.runtime.devprof").PROGRAM_KINDS)
    assert host_only == want[3] == 0
