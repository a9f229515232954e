"""Kill matrix on the port: a victim process SIGKILLs itself mid-tick and
a successor converges bit-identically.

Each round runs ``kubeadmiral_tpu_torch.testing.restart_driver`` (the
port's counterpart of tools/restart_driver.py) in subprocesses on
``--device cpu``: an uninterrupted reference, a victim killed at a phase
of its third tick, and a successor that restores the newest valid
snapshot and ticks once over the final world.  Its placements and
flight-recorder reason counts must equal the reference's, nothing valid
may be quarantined, the restore must load, and the breaker the victim
opened on ``m-001`` before tick 3 is still open and admits nothing
(tests/test_restart.py's breaker asserts; the breakers' cool-down at
300 s, as the JAX harness sets ``KT_BREAKER_OPEN_S``).  The world is
the driver's default, 192 x 10.  ``snapshot-write`` (the payload torn
mid-write) and ``dispatch-flush`` (tick 3 persisted, killed halfway
through the member flush of its placements) are tier-1 rounds; the
other phases are marked slow, as in tests/test_restart.py.
"""

import json
import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def run_driver(mode, workdir, *args, expect_kill=False):
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run(
        [sys.executable, "-m", "kubeadmiral_tpu_torch.testing.restart_driver",
         mode, "--dir", str(workdir), "--device", "cpu",
         "--breaker-open-s", "300", *args],
        env=env, cwd=REPO, capture_output=True, text=True, timeout=600,
    )
    if expect_kill:
        assert proc.returncode == -9, (
            f"victim exited {proc.returncode} (kill never fired)\n"
            f"{proc.stdout}\n{proc.stderr}"
        )
    else:
        assert proc.returncode == 0, f"{proc.stdout}\n{proc.stderr}"


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    workdir = tmp_path_factory.mktemp("port-restart-ref")
    run_driver("reference", workdir)
    return json.load(open(os.path.join(workdir, "reference.json")))


def kill_round(tmp_path_factory, phase, reference):
    workdir = tmp_path_factory.mktemp(f"port-restart-{phase}")
    run_driver("victim", workdir, "--kill-phase", phase, expect_kill=True)
    assert os.path.exists(os.path.join(workdir, "tick2.done"))
    flushed = os.path.exists(os.path.join(workdir, "tick3.done"))
    assert flushed == (phase == "dispatch-flush")
    run_driver("successor", workdir)
    succ = json.load(open(os.path.join(workdir, "successor.json")))
    assert succ["restore"] == "staged"
    assert succ["restore_info"]["result"] == "loaded"
    assert succ["placements"] == reference["placements"]
    assert succ["reason_counts"] == reference["reason_counts"]
    assert len(succ["reason_counts"]) == len(reference["placements"])
    assert succ["quarantined"] == []
    assert succ["breaker_m001"] == "open"
    assert succ["breaker_allows_m001"] is False
    return succ


class TestKillMatrix:
    def test_sigkill_mid_snapshot_write(self, tmp_path_factory, reference):
        """The tier-1 round: the tick-3 snapshot torn mid-write; the
        successor loads tick 2's and re-decides tick 3's churned rows
        through the sub-batch slabs."""
        succ = kill_round(tmp_path_factory, "snapshot-write", reference)
        assert succ["restore_info"]["fresh"] is True
        assert succ["fetch_paths"]["subbatch"] >= 1
        assert succ["counters"] == {
            "engine_snapshot_total{result=loaded_fresh}": 1.0,
            "engine_snapshot_total{result=written}": 1.0,
        }

    def test_sigkill_mid_dispatch_flush(self, tmp_path_factory, reference):
        """Tick 3 and its snapshot complete, the victim dies halfway
        through the member flush: the successor resumes the tick-3
        snapshot (a no-op replay, nothing launched)."""
        succ = kill_round(tmp_path_factory, "dispatch-flush", reference)
        assert succ["restore_info"]["fresh"] is True
        assert succ["launches"] == 0

    @pytest.mark.slow
    @pytest.mark.parametrize(
        "phase", ["featurize", "dispatch", "fetch", "snapshot-rename"],
    )
    def test_sigkill_phase(self, tmp_path_factory, reference, phase):
        kill_round(tmp_path_factory, phase, reference)
