"""The command: it fails without a card, and in a directory that holds only
the benchmark; on a card (the ``cuda`` marker) a short run is correct."""

import json
import shutil
import subprocess
import sys

import pytest

from benchmark import harness

ARGS = ["-m", "benchmark.run", "--workload", "c3-churn", "--seed", str(2**31 + 3),
        "--seconds", "2", "--trace", "0"]


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


@pytest.fixture
def no_card():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")


def test_fails_without_a_card(no_card):
    p = subprocess.run([sys.executable, *ARGS], cwd=harness.ROOT, capture_output=True, text=True)
    assert p.returncode != 0
    assert p.stdout.strip() == ""
    assert "needs 1 CUDA card" in p.stderr


def test_fails_with_only_the_benchmark(tmp_path):
    shutil.copy(harness.ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(harness.ROOT / "benchmark", tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    p = subprocess.run([sys.executable, *ARGS], cwd=tmp_path, capture_output=True, text=True)
    assert p.returncode != 0
    assert p.stdout.strip() == ""
    assert "kubeadmiral_tpu_torch is not this checkout's" in p.stderr


@pytest.mark.cuda
def test_short_run_on_the_card(card):
    p = subprocess.run([sys.executable, *ARGS], cwd=harness.ROOT, capture_output=True, text=True)
    assert p.returncode == 0, p.stderr[-3000:]
    out = json.loads(p.stdout.strip().splitlines()[-1])
    assert out["correct"] and out["device"]["platform"] == "gpu"
    assert "H100" in out["device"]["kind"]
    assert set(out["metrics"]) == {"tick_ms", "tick_p95_ms", "setup_s"}
    assert list(out)[-1] == "checks"
