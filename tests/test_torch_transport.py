"""The port's HTTP transport against the JAX package's.

* The cases of ``tests/test_transport.py`` (``TestPaths`` through
  ``TestBatchEndpoint``: the path codec, REST semantics, watch streams
  with resume and 410 relist, bearer-token auth and service-account
  token minting, the join-secret client factory, the token trust
  boundary and the bulk endpoint) run with the test module's globals
  and the modules its cases import in their bodies pointed at the
  port's (:func:`run_on_port`).  The log-truncation case runs as its
  port copy here (:func:`test_delete_during_log_truncation_synthesizes_deleted`):
  it waits until the watch stream's own list has delivered the victim
  before it truncates the log, where the JAX case waits only for the
  replay, so a stream whose first list comes after the delete never
  saw the victim and has nothing to tombstone.
* Wire parity: one fixed request script (CRUD, the status subresource,
  a finalizer-gated delete, a list with a label selector, the bulk
  endpoint, a watch from a resourceVersion, 410 after log truncation,
  401, ``/faultz``) replayed against the JAX ``KubeApiServer`` and the
  port's: equal status codes and bodies, minted token values masked.
* Cross clients: each package's ``HttpKube`` against the other
  package's server gives what it gives against its own.
* The client's ``traceparent`` header and the server span adopting it
  (``runtime/trace.py``), as the JAX package's.
"""

import http.client
import importlib
import inspect
import json
import sys
import threading
import time
import types

import pytest

import test_transport as TT
from test_torch_dispatch import ConstantsPatch
from test_torch_sync import cpu_scheduler_controller, method_cases, point_at_port

from kubeadmiral_tpu.runtime import slo as jax_slo
from kubeadmiral_tpu.runtime import trace as jax_trace
from kubeadmiral_tpu.testing import fakekube as jax_fk
from kubeadmiral_tpu.transport import apiserver as jax_api
from kubeadmiral_tpu.transport import client as jax_client
from kubeadmiral_tpu_torch.federation import dispatch, schedulerctl
from kubeadmiral_tpu_torch.runtime import slo as port_slo
from kubeadmiral_tpu_torch.runtime import trace as port_trace
from kubeadmiral_tpu_torch.testing import fakekube as port_fk
from kubeadmiral_tpu_torch.transport import apiserver as port_api
from kubeadmiral_tpu_torch.transport import breaker
from kubeadmiral_tpu_torch.transport import client as port_client

JAX_ROOT, PORT_ROOT = "kubeadmiral_tpu", "kubeadmiral_tpu_torch"

# The modules the JAX transport, fault and end-to-end cases import in
# their bodies.
LAZY = (
    "kubeadmiral_tpu.federation.common",
    "kubeadmiral_tpu.federation.clusterctl",
    "kubeadmiral_tpu.federation.federate",
    "kubeadmiral_tpu.federation.schedulerctl",
    "kubeadmiral_tpu.federation.statusctl",
    "kubeadmiral_tpu.federation.sync",
    "kubeadmiral_tpu.models.ftc",
    "kubeadmiral_tpu.models.policy",
    "kubeadmiral_tpu.models.types",
    "kubeadmiral_tpu.runtime.healthcheck",
    "kubeadmiral_tpu.runtime.metrics",
    "kubeadmiral_tpu.scheduler.extension_service",
    "kubeadmiral_tpu.scheduler.webhook",
    "kubeadmiral_tpu.testing.fakekube",
    "kubeadmiral_tpu.testing.kwoklite",
    "kubeadmiral_tpu.transport.apiserver",
    "kubeadmiral_tpu.transport.client",
    "kubeadmiral_tpu.transport.faults",
)

# The JAX knobs the transport and fault cases set, and the port's
# constants in their place.
ENV_CONSTANTS = {
    "KT_RETRY_BASE_S": (dispatch, "RETRY_BASE_S", float),
    "KT_RETRY_CAP_S": (dispatch, "RETRY_CAP_S", float),
    "KT_RETRY_MAX": (dispatch, "RETRY_MAX", int),
    "KT_DISPATCH_POOL": (dispatch, "DISPATCH_POOL", int),
    "KT_DISPATCH_DEADLINE_S": (dispatch, "DISPATCH_DEADLINE_S", float),
    "KT_WRITE_COALESCE": (dispatch, "WRITE_COALESCE", lambda v: v not in ("0", "false", "no")),
    "KT_BREAKER_OPEN_S": (breaker, "OPEN_SECONDS", float),
    "KT_BREAKER_STALL_S": (breaker, "STALL_THRESHOLD_S", float),
    "KT_BREAKER_FAILURES": (breaker, "FAILURE_THRESHOLD", int),
}


def _port_module(name: str):
    port = importlib.import_module(PORT_ROOT + name[len(JAX_ROOT):])
    if port is schedulerctl:
        # The scheduler controller's default engine on the CPU.
        shim = types.ModuleType(port.__name__)
        shim.__dict__.update(vars(port))
        shim.SchedulerController = cpu_scheduler_controller
        return shim
    return port


def point_lazy(mp, names=LAZY) -> None:
    """``import``/``from ... import`` of ``names`` inside a case body give
    the port's module (``sys.modules`` and the parent's attribute).  All
    are imported first, so that no JAX module is first imported against
    an already swapped one."""
    for name in names:
        importlib.import_module(name)
    for name in names:
        port = _port_module(name)
        mp.setitem(sys.modules, name, port)
        parent, _, leaf = name.rpartition(".")
        mp.setattr(sys.modules[parent], leaf, port)


def call_case(module, cls, name, mp, port: bool, fixtures=None) -> None:
    """One case of a test class, its ``server``/``kube``/``monkeypatch``
    fixtures built here from the module's (possibly pointed) globals,
    any other from ``fixtures``."""
    obj = cls()
    if hasattr(obj, "setup_method"):
        obj.setup_method()
    method = getattr(obj, name)
    params = inspect.signature(method).parameters
    kwargs, cleanup = {}, []
    if "server" in params or "kube" in params:
        srv = module.KubeApiServer(module.FakeKube("test"))
        cleanup.append(srv.close)
        if "server" in params:
            kwargs["server"] = srv
        if "kube" in params:
            client = module.HttpKube(srv.url, name="test")
            cleanup.insert(0, client.close)
            kwargs["kube"] = client
    if "monkeypatch" in params:
        kwargs["monkeypatch"] = ConstantsPatch(mp, ENV_CONSTANTS) if port else mp
    for key, value in (fixtures or {}).items():
        if key in params:
            kwargs[key] = value
    try:
        method(**kwargs)
    finally:
        for fn in cleanup:
            fn()
        if hasattr(obj, "teardown_method"):
            obj.teardown_method()


def run_on_port(monkeypatch, module, cls, name, extra=(), fixtures=None) -> None:
    """The case with ``module``'s (and ``extra``'s) globals and the LAZY
    imports pointed at the port's."""
    with monkeypatch.context() as mp:
        jax_slo.reset_default()
        port_slo.reset_default()
        point_at_port(mp, module, *extra)
        point_lazy(mp)
        call_case(module, cls, name, mp, port=True, fixtures=fixtures)


def case_ids(cases):
    return [f"{c.__name__}.{n}" for c, n in cases]


TRANSPORT_CASES = [
    case
    for case in method_cases(
        TT.TestPaths, TT.TestCrud, TT.TestWatch, TT.TestAuth, TT.TestFactory,
        TT.TestTokenTrustBoundary, TT.TestBatchEndpoint,
    )
    if case[1] != "test_delete_during_log_truncation_synthesizes_deleted"
]


@pytest.mark.parametrize("cls,name", TRANSPORT_CASES, ids=case_ids(TRANSPORT_CASES))
def test_transport_case(monkeypatch, cls, name):
    run_on_port(monkeypatch, TT, cls, name)


def test_cases_reach_the_port(monkeypatch):
    with monkeypatch.context() as mp:
        point_at_port(mp, TT)
        point_lazy(mp)
        assert TT.KubeApiServer is port_api.KubeApiServer
        assert TT.HttpKube is port_client.HttpKube
        assert TT.FakeKube is port_fk.FakeKube
        from kubeadmiral_tpu.testing.kwoklite import KwokLiteFarm

        assert KwokLiteFarm.__module__ == "kubeadmiral_tpu_torch.testing.kwoklite"


def wait_for(predicate, timeout=10.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if predicate():
            return True
        time.sleep(0.01)
    return False


def test_delete_during_log_truncation_synthesizes_deleted():
    """An object deleted while the watch log is truncated surfaces as
    DELETED: the reflector relists after 410 Gone and tombstones keys
    missing from the relist.  The truncation waits until the stream's
    own list has delivered the victim (its second ADDED, after the
    replay's)."""
    store = port_fk.FakeKube("tiny")
    srv = port_api.KubeApiServer(store, event_log_cap=4)
    client = port_client.HttpKube(srv.url, name="tiny")
    try:
        store.create(TT.CONFIGMAPS, {"apiVersion": "v1", "kind": "ConfigMap",
                                     "metadata": {"name": "victim", "namespace": "d"}})
        events = []
        client.watch(TT.CONFIGMAPS, lambda e, o: events.append((e, o["metadata"]["name"])),
                     replay=True)
        assert wait_for(lambda: events.count(("ADDED", "victim")) >= 2), events
        # The log's condition held (reentrant): the stream cannot drain
        # the delete before the overflow evicts it.
        with srv._log.cond:
            store.delete(TT.CONFIGMAPS, "d/victim")
            for i in range(20):
                store.create(TT.CONFIGMAPS, {"apiVersion": "v1", "kind": "ConfigMap",
                                             "metadata": {"name": f"f-{i}", "namespace": "d"}})
        assert wait_for(lambda: ("DELETED", "victim") in events), events[-5:]
        mux = client._mux[TT.CONFIGMAPS]
        assert wait_for(lambda: mux.relists >= 1)
    finally:
        client.close()
        srv.close()


# -- wire parity ------------------------------------------------------------
ADMIN = "admin-token"
DEPS = "/apis/apps/v1/namespaces/d/deployments"


def _dep(name, labels=None, finalizers=None, replicas=1):
    meta = {"name": name, "namespace": "d", "labels": labels or {}}
    if finalizers:
        meta["finalizers"] = finalizers
    return {"apiVersion": "apps/v1", "kind": "Deployment", "metadata": meta,
            "spec": {"replicas": replicas}}


def _mask(body):
    """Minted service-account token values masked (their HMAC key is
    each server's own random one)."""
    if isinstance(body, dict):
        out = {}
        for k, v in body.items():
            if k == "data" and isinstance(v, dict) and "token" in v:
                v = dict(v, token="<minted>")
            out[k] = _mask(v)
        return out
    if isinstance(body, (list, tuple)):
        return type(body)(_mask(v) for v in body)
    return body


def _request(url, method, path, body=None, token=ADMIN):
    host = url.split("//", 1)[1]
    conn = http.client.HTTPConnection(host, timeout=10)
    headers = {"Content-Type": "application/json"}
    if token:
        headers["Authorization"] = f"Bearer {token}"
    try:
        conn.request(method, path, body=json.dumps(body).encode() if body is not None else None,
                     headers=headers)
        resp = conn.getresponse()
        data = resp.read()
        return resp.status, json.loads(data) if data else None
    finally:
        conn.close()


def _watch_lines(url, path, n, token=ADMIN):
    """The first ``n`` lines of a watch stream (or its error answer)."""
    host = url.split("//", 1)[1]
    conn = http.client.HTTPConnection(host, timeout=10)
    try:
        conn.request("GET", path, headers={"Authorization": f"Bearer {token}"})
        resp = conn.getresponse()
        if resp.status != 200:
            return resp.status, json.loads(resp.read())
        return 200, [json.loads(resp.readline()) for _ in range(n)]
    finally:
        conn.close()


def wire_script(url, store) -> list:
    out = []

    def call(method, path, body=None, token=ADMIN):
        out.append((method, path, _mask(_request(url, method, path, body, token))))
        return out[-1][2]

    call("GET", "/healthz", token=None)
    call("GET", DEPS, token=None)
    call("GET", DEPS, token="wrong")
    _, created = call("POST", DEPS, _dep("a"))
    call("POST", DEPS, _dep("a"))
    call("GET", DEPS + "/a")
    call("GET", DEPS + "/missing")
    stale = json.loads(json.dumps(created))
    created["spec"]["replicas"] = 3
    call("PUT", DEPS + "/a", created)
    call("PUT", DEPS + "/a", stale)
    _, got = call("GET", DEPS + "/a")
    got["status"] = {"replicas": 3, "readyReplicas": 1}
    got["spec"]["replicas"] = 99  # the status subresource ignores spec
    call("PUT", DEPS + "/a/status", got)
    call("POST", DEPS, _dep("b", labels={"app": "x"}, finalizers=["example.io/hold"]))
    call("GET", "/apis/apps/v1/deployments?labelSelector=app=x")
    call("GET", DEPS + "?labelSelector=app=y")
    call("DELETE", DEPS + "/b")
    _, held = call("GET", DEPS + "/b")
    held["metadata"]["finalizers"] = []
    call("PUT", DEPS + "/b", held)
    call("GET", DEPS + "/b")
    call("POST", "/batch", {"operations": [
        {"verb": "create", "resource": "apps/v1/deployments", "object": _dep("c")},
        {"verb": "create", "resource": "apps/v1/deployments", "object": _dep("c")},
        {"verb": "get", "resource": "apps/v1/deployments", "key": "d/c"},
        {"verb": "delete", "resource": "apps/v1/deployments", "key": "d/missing"},
        {"verb": "bogus"},
    ]})
    call("POST", "/api/v1/namespaces/sys/serviceaccounts",
         {"apiVersion": "v1", "kind": "ServiceAccount", "metadata": {"name": "bot", "namespace": "sys"}})
    _, secret = call("GET", "/api/v1/namespaces/sys/secrets/bot-token")
    minted = store.get("v1/secrets", "sys/bot-token")["data"]["token"]
    call("GET", DEPS, token=minted)
    call("POST", "/faultz", {"policy": {"error_rate": 1.0}})
    call("GET", DEPS + "/a")
    call("POST", "/faultz", {"policy": {"bogus": 1}})
    call("POST", "/faultz", {"policy": None})
    call("GET", DEPS + "/a")
    call("GET", "/apis/apps/v1/namespaces/d/deployments/a/scale")
    out.append(("WATCH", "rv=2", _watch_lines(url, "/apis/apps/v1/deployments?watch=true&resourceVersion=2", 3)))
    for i in range(12):
        store.create("v1/configmaps", {"apiVersion": "v1", "kind": "ConfigMap",
                                       "metadata": {"name": f"cm-{i}", "namespace": "d"}})
    out.append(("WATCH", "rv=1 after truncation",
                _watch_lines(url, "/api/v1/configmaps?watch=true&resourceVersion=1", 1)))
    return out


def _server(api, fk):
    store = fk.FakeKube("wire")
    return store, api.KubeApiServer(store, admin_token=ADMIN, mint_sa_tokens=True, event_log_cap=4)


def test_wire_parity():
    """One request script against both packages' apiservers: equal
    status codes and bodies, minted tokens masked."""
    results = []
    for api, fk in ((jax_api, jax_fk), (port_api, port_fk)):
        store, srv = _server(api, fk)
        try:
            results.append(wire_script(srv.url, store))
        finally:
            srv.close()
    want, got = results
    assert [r[:2] for r in got] == [r[:2] for r in want]
    for w, g in zip(want, got):
        assert g == w, w[:2]
    codes = [r[2][0] for r in got]
    assert 401 in codes and 410 in codes and 500 in codes and 409 in codes


def client_script(client_mod, url) -> list:
    """A client's view of a server: results, or the exception's class
    name, per call; a watch's events."""
    kube = client_mod.HttpKube(url, token=ADMIN, name="x")
    out = []

    def call(fn, *args):
        try:
            out.append(_mask(fn(*args)))
        except Exception as e:  # noqa: BLE001 - the class name is the result
            out.append(type(e).__name__)

    events = []
    cond = threading.Condition()

    def handler(event, obj):
        with cond:
            events.append((event, obj["metadata"]["name"], obj["spec"].get("replicas")))
            cond.notify_all()

    try:
        kube.watch("apps/v1/deployments", handler, replay=True)
        call(kube.create, "apps/v1/deployments", _dep("a"))
        call(kube.create, "apps/v1/deployments", _dep("a"))
        call(kube.get, "apps/v1/deployments", "d/a")
        call(kube.try_get, "apps/v1/deployments", "d/nope")
        call(kube.get, "apps/v1/deployments", "d/nope")
        obj = kube.get("apps/v1/deployments", "d/a")
        stale = json.loads(json.dumps(obj))
        obj["spec"]["replicas"] = 4
        call(kube.update, "apps/v1/deployments", obj)
        call(kube.update, "apps/v1/deployments", stale)
        obj = kube.get("apps/v1/deployments", "d/a")
        obj["status"] = {"replicas": 4}
        call(kube.update_status, "apps/v1/deployments", obj)
        call(kube.create, "apps/v1/deployments", _dep("b", labels={"app": "x"}))
        call(kube.list, "apps/v1/deployments", None, {"app": "x"})
        call(kube.list, "apps/v1/deployments", "d")
        call(kube.keys, "apps/v1/deployments")
        call(kube.batch, [
            {"verb": "create", "resource": "apps/v1/deployments", "object": _dep("c")},
            {"verb": "delete", "resource": "apps/v1/deployments", "key": "d/b"},
            {"verb": "get", "resource": "apps/v1/deployments", "key": "d/missing"},
        ])
        call(kube.delete, "apps/v1/deployments", "d/a")
        call(kube.delete, "apps/v1/deployments", "d/a")
        out.append(kube.healthy)
        with cond:
            cond.wait_for(lambda: ("DELETED", "a", 4) in events, timeout=10)
        # Stream order per object; the replay may add a duplicate ADDED.
        out.append(sorted(set(events)))
    finally:
        kube.close()
    return out


@pytest.mark.parametrize("client_pkg", ["jax", "port"])
def test_cross_clients(client_pkg):
    """Each package's client against the other package's server gives
    what it gives against its own."""
    client_mod = jax_client if client_pkg == "jax" else port_client
    results = {}
    for name, (api, fk) in (("jax", (jax_api, jax_fk)), ("port", (port_api, port_fk))):
        srv = api.KubeApiServer(fk.FakeKube("x"), admin_token=ADMIN)
        try:
            results[name] = client_script(client_mod, srv.url)
        finally:
            srv.close()
    assert results["port"] == results["jax"]
    assert "AlreadyExists" in results["port"] and "Conflict" in results["port"]


def test_traceparent_propagates_as_jax():
    """The header the client sends under an open span, and the span the
    server records from it, as the JAX package's: the server span is a
    child of the caller's span in the caller's trace."""
    assert port_trace.format_traceparent("ab" * 16, 7) == jax_trace.format_traceparent("ab" * 16, 7)
    for header in (None, "", "00-" + "0" * 32 + "-" + "1" * 16 + "-01", "junk",
                   "00-" + "ab" * 16 + "-" + "00000000000000ff" + "-01",
                   "01-" + "ab" * 16 + "-" + "1" * 16 + "-01"):
        assert port_trace.parse_traceparent(header) == jax_trace.parse_traceparent(header)
    store = port_fk.FakeKube("t")
    srv = port_api.KubeApiServer(store)
    client = port_client.HttpKube(srv.url)
    tracer = port_trace.get_default()
    try:
        assert port_trace.current_traceparent() is None
        with tracer.span("caller") as caller:
            header = port_trace.current_traceparent()
            assert header == caller.traceparent()
            client.create("v1/configmaps", {"apiVersion": "v1", "kind": "ConfigMap",
                                            "metadata": {"name": "c", "namespace": "d"}})
        spans = [s for s in tracer._ring if s.name == "apiserver.create"]
        assert spans and spans[-1].trace_id == caller.trace_id
        assert spans[-1].parent_id == caller.span_id and spans[-1].args.get("remote_parent")
    finally:
        client.close()
        srv.close()
