"""The port's profiling routes (``runtime/profiling.py``) against the JAX ones.

* The cases of ``tests/test_profiling.py`` (the stack sampler, the
  standalone server, the health server mounting ``/debug``) run over JAX
  and over the port.
* Route by route, a JAX and a port ``ProfilingServer`` over registries
  fed the same series answer every route of the ``/debug`` index with
  the same status and the same JSON keys; the index is JAX's but for the
  profile route's description.
* ``/debug/profile?mode=device`` runs a ``torch.profiler`` capture into
  the ``dir`` it is given; ``mode=jax`` answers with an error that names
  ``mode=device``.
* ``/debug/waterfall`` serves the process ledger's ticks and
  ``/debug/shards`` the last manager's shard report, as JAX's do.
"""

import json
import os
import urllib.error
import urllib.request

import pytest

import test_profiling as TP
from test_torch_status import run_both, run_method
from test_torch_sync import method_cases

from kubeadmiral_tpu.runtime import profiling as jax_profiling
from kubeadmiral_tpu.runtime.metrics import Metrics as JaxMetrics
from kubeadmiral_tpu_torch.runtime import devprof, profiling
from kubeadmiral_tpu_torch.runtime.metrics import Metrics

CASES = method_cases(TP.TestProfiling)


@pytest.mark.parametrize("cls,name", CASES, ids=[f"{c.__name__}.{n}" for c, n in CASES])
def test_profiling_case(monkeypatch, cls, name):
    run_both(monkeypatch, (TP,), run_method(cls, name))


def fetch(port, path):
    try:
        with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}", timeout=60) as r:
            return r.status, r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


def _keys(status, body):
    try:
        doc = json.loads(body)
    except ValueError:
        return status, "text"
    return status, sorted(doc) if isinstance(doc, dict) else type(doc).__name__


# Routes whose reply depends on what else the process has done (recorded
# decisions, shard providers, breaker registries, SLO events): compared
# by status only.
STATUS_ONLY = ("/debug/decisions", "/debug/drift", "/debug/members", "/debug/slo",
               "/debug/shards", "/debug/explain", "/debug/trace")


def test_routes_against_jax(monkeypatch):
    assert {k: v for k, v in profiling.DEBUG_INDEX.items() if k != "/debug/profile"} == {
        k: v for k, v in jax_profiling.DEBUG_INDEX.items() if k != "/debug/profile"
    }
    monkeypatch.setattr(profiling, "_shards_provider", None)
    monkeypatch.setattr(jax_profiling, "_shards_provider", None)
    servers = []
    for mod, metrics in ((jax_profiling, JaxMetrics()), (profiling, Metrics())):
        metrics.counter("worker_reconciles_total", 3, controller="sync")
        metrics.store("engine_tick_objects", 7)
        server = mod.ProfilingServer(metrics=metrics)
        servers.append((server, server.start()))
    try:
        (_, jax_port), (_, port) = servers
        routes = ["/metrics", "/debug", "/debug/threads", "/debug/stacks",
                  "/debug/waterfall?records=4", "/debug/profile?seconds=0.1",
                  "/debug/nothing", *profiling.DEBUG_INDEX]
        for route in routes:
            if route in ("/metrics", "/debug/profile"):
                continue
            want, got = fetch(jax_port, route), fetch(port, route)
            if route in STATUS_ONLY or route.startswith(("/debug/timeline", "/debug/tenants",
                                                         "/debug/fleet")):
                assert got[0] == want[0], route
            else:
                assert _keys(*got) == _keys(*want), route
        status, body = fetch(port, "/metrics")
        assert status == 200
        assert body == fetch(jax_port, "/metrics")[1]
    finally:
        for server, _ in servers:
            server.stop()


def test_device_profile_and_jax_mode(tmp_path):
    server = profiling.ProfilingServer()
    port = server.start()
    try:
        status, body = fetch(port, f"/debug/profile?mode=device&seconds=0.1&dir={tmp_path}")
        assert status == 200
        out = json.loads(body)
        assert "error" not in out, out
        assert out["dir"].startswith(str(tmp_path)) and os.path.isfile(out["trace"])
        status, body = fetch(port, "/debug/profile?mode=jax&seconds=0.1")
        assert status == 200
        assert "mode=device" in json.loads(body)["error"]
        status, body = fetch(port, "/debug/profile?seconds=bad")
        assert json.loads(body) == json.loads(jax_profiling.json.dumps(
            jax_profiling.handle_debug_path("/debug/profile", {"seconds": "bad"})))
    finally:
        server.stop()


def test_waterfall_serves_the_process_ledger(monkeypatch):
    ledger = devprof.DispatchLedger(enabled=True)
    monkeypatch.setattr(devprof, "_default", ledger)
    import torch

    tick = ledger.begin_tick(engine_tick=1)
    ledger.observe("tick_narrow", torch.zeros(4, 3))
    ledger.end_tick({"device": 0.1})
    out = profiling.handle_debug_path("/debug/waterfall", {"records": "8"})
    assert out["enabled"] and [t["tick"] for t in out["ticks"]] == [tick]
    assert [r["kind"] for r in out["ticks"][0]["records"]] == ["tick_narrow"]
    assert profiling.handle_debug_path("/debug/waterfall", {"tick": "x"}) == {
        "error": "bad tick/ticks/records value"
    }


def test_shards_report_from_the_last_manager(monkeypatch):
    from test_torch_manager import CpuControllerManager

    from kubeadmiral_tpu_torch.testing.fakekube import ClusterFleet

    monkeypatch.setattr(profiling, "_shards_provider", None)
    assert profiling.shards_report() is None
    manager = CpuControllerManager(ClusterFleet())
    report = profiling.shards_report()
    assert report["owned_keys"] == {} and report["snapshot"] is None
    assert report == manager.shard_report()
