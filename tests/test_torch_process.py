"""``python -m kubeadmiral_tpu_torch``: the port's process.

* On the CPU (``--device cpu``) it serves ``/livez``, ``/readyz``,
  ``/metrics``, ``/debug`` and the dispatch-ledger routes, and a SIGTERM
  drains it: exit 0, leadership released (when elected), no write shed.
* Without CUDA and without ``--device cpu`` it exits nonzero at engine
  construction: the process never falls back to the CPU.
* ``--transport http`` exits 2: the port has no HTTP transport yet.
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
    proc = subprocess.run(
        [sys.executable, "-m", "kubeadmiral_tpu_torch", "--transport", "http", "--port", "0"],
        cwd=ROOT, capture_output=True, text=True, timeout=120,
    )
    assert proc.returncode == 2
    assert "HTTP transport" in proc.stderr
    assert "health endpoints" not in proc.stdout


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
