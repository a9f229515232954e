"""``python -m kubeadmiral_tpu_torch``: the port's process.

* On the CPU (``--device cpu``) it serves ``/livez``, ``/readyz``,
  ``/metrics``, ``/debug`` and the dispatch-ledger routes, and a SIGTERM
  drains it: exit 0, leadership released (when elected), no write shed.
* Without CUDA and without ``--device cpu`` it exits nonzero at engine
  construction: the process never falls back to the CPU.
* ``--transport http --device cpu --members 3`` serves the control plane
  over a kwok-lite farm of apiserver sockets: the members join (read
  from the host apiserver's socket), a Deployment created through that
  socket is divided over the member sockets (read with the printed
  admin tokens), and a SIGTERM drains it with exit 0 and no write shed;
  the transport no longer exits 2.
* The parser has the JAX entry point's options and defaults, plus
  ``--device``.
"""

import json
import re
import signal
import subprocess
import sys
import time
import urllib.request
from pathlib import Path

import pytest
import torch

from kubeadmiral_tpu.__main__ import build_parser as jax_parser
from kubeadmiral_tpu_torch.__main__ import build_parser

ROOT = Path(__file__).resolve().parent.parent


def start(*args):
    return subprocess.Popen(
        [sys.executable, "-m", "kubeadmiral_tpu_torch", *args],
        cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
    )


def read_until(proc, pattern: str, lines: list, timeout: float = 120.0) -> re.Match:
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        line = proc.stdout.readline()
        if not line:
            break
        lines.append(line)
        found = re.search(pattern, line)
        if found:
            return found
    raise AssertionError(f"no line matching {pattern!r}: {lines}")


def get(port, route):
    with urllib.request.urlopen(f"http://127.0.0.1:{port}{route}", timeout=60) as resp:
        return resp.status, resp.read()


@pytest.mark.parametrize("leader_elect", [False, True], ids=["no-leader-elect", "leader-elect"])
def test_cpu_process_serves_and_drains(leader_elect):
    args = ["--device", "cpu", "--port", "0", "--members", "2", "--create-crds-for-ftcs"]
    if not leader_elect:
        args.append("--no-leader-elect")
    proc = start(*args)
    lines = []
    try:
        port = read_until(proc, r"health endpoints on :(\d+)", lines).group(1)
        read_until(proc, r"installed 21 FederatedTypeConfigs", lines)
        read_until(proc, r"controller manager running", lines)
        for route in ("/livez", "/readyz", "/metrics", "/debug", "/debug/waterfall",
                      "/debug/trace", "/debug/threads"):
            status, body = get(port, route)
            assert status == 200, route
        ready = json.loads(get(port, "/readyz")[1])
        assert ready["healthy"] and "deployments.apps/scheduler" in ready["checks"]
        assert json.loads(get(port, "/debug/waterfall")[1])["enabled"] is True
        # The prewarm's warm dispatch reaches the ledger and /metrics.
        deadline = time.monotonic() + 60
        while b"engine_device_seconds" not in get(port, "/metrics")[1]:
            assert time.monotonic() < deadline
            time.sleep(0.2)
        proc.send_signal(signal.SIGTERM)
        out, _ = proc.communicate(timeout=60)
        lines.append(out)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    text = "".join(lines)
    assert proc.returncode == 0, text
    assert "shutdown: shed_writes=0 snapshot=None" in text
    assert ("leadership released" in text) == leader_elect


def test_default_device_without_cuda_exits_nonzero():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default engine is valid here")
    proc = start("--port", "0", "--no-leader-elect", "--members", "1")
    try:
        out, _ = proc.communicate(timeout=120)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    assert proc.returncode not in (0, None)
    assert "CUDA is not available" in out
    assert "controller manager running" not in out


def test_http_transport_exits_2():
    """Until the HTTP transport was ported ``--transport http`` exited
    2; now it serves, and ends 0 when its run time is up."""
    proc = subprocess.run(
        [sys.executable, "-m", "kubeadmiral_tpu_torch", "--transport", "http", "--port", "0",
         "--device", "cpu", "--members", "1", "--no-leader-elect", "--run-seconds", "1"],
        cwd=ROOT, capture_output=True, text=True, timeout=120,
    )
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert re.search(r"host apiserver on http://127\.0\.0\.1:\d+", proc.stdout)
    assert "health endpoints" in proc.stdout
    assert "shutdown: shed_writes=0" in proc.stdout


def test_http_transport_joins_propagates_and_drains():
    from kubeadmiral_tpu_torch.federation.clusterctl import (
        FEDERATED_CLUSTERS,
        JOINED,
        READY,
        get_condition,
    )
    from kubeadmiral_tpu_torch.models.policy import PROPAGATION_POLICIES, PROPAGATION_POLICY_LABEL
    from kubeadmiral_tpu_torch.transport.client import HttpKube

    proc = start("--transport", "http", "--device", "cpu", "--port", "0", "--members", "3",
                 "--create-crds-for-ftcs")
    lines, clients = [], []
    try:
        host_url = read_until(proc, r"host apiserver on (\S+)", lines).group(1)
        members = {}
        for _ in range(3):
            m = read_until(proc, r"member (\S+) apiserver on (\S+) \(admin token: (\S+)\)", lines)
            members[m.group(1)] = (m.group(2), m.group(3))
        read_until(proc, r"controller manager running", lines)
        host = HttpKube(host_url)
        clients.append(host)

        def until(check, timeout=60.0):
            deadline = time.monotonic() + timeout
            while not check():
                assert time.monotonic() < deadline, lines
                time.sleep(0.1)

        until(lambda: len([
            o for o in host.list(FEDERATED_CLUSTERS)
            if all((get_condition(o, c) or {}).get("status") == "True" for c in (JOINED, READY))
        ]) == 3)
        host.create(PROPAGATION_POLICIES, {
            "apiVersion": "core.kubeadmiral.io/v1alpha1", "kind": "PropagationPolicy",
            "metadata": {"name": "pp", "namespace": "default"}, "spec": {"schedulingMode": "Divide"}})
        host.create("apps/v1/deployments", {
            "apiVersion": "apps/v1", "kind": "Deployment",
            "metadata": {"name": "web", "namespace": "default",
                         "labels": {PROPAGATION_POLICY_LABEL: "pp"}},
            "spec": {"replicas": 6, "selector": {"matchLabels": {"app": "web"}},
                     "template": {"metadata": {"labels": {"app": "web"}}, "spec": {"containers": [
                         {"name": "c", "image": "nginx", "resources": {"requests": {"cpu": "50m"}}}]}}}})
        member_clients = [HttpKube(url, token=token) for url, token in members.values()]
        clients.extend(member_clients)

        def replicas():
            objs = [c.try_get("apps/v1/deployments", "default/web") for c in member_clients]
            return sum(o["spec"]["replicas"] for o in objs if o is not None)

        until(lambda: replicas() == 6)
        proc.send_signal(signal.SIGTERM)
        out, _ = proc.communicate(timeout=60)
        lines.append(out)
    finally:
        for client in clients:
            client.close()
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    text = "".join(lines)
    assert proc.returncode == 0, text
    assert "shutdown: shed_writes=0" in text


def _options(parser):
    return {
        a.dest: (tuple(a.option_strings), a.default, a.choices, a.type)
        for a in parser._actions
        if a.dest != "help"
    }


def test_parser_has_the_jax_options_and_device():
    mine, theirs = _options(build_parser()), _options(jax_parser())
    assert {k: v for k, v in mine.items() if k != "device"} == theirs
    assert mine["device"] == (("--device",), "cuda", ("cuda", "cpu"), None)
    assert vars(build_parser().parse_args([])) == {**vars(jax_parser().parse_args([])),
                                                   "device": "cuda"}
