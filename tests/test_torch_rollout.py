"""The port's rollout planner and member simulator against the JAX
package's.

* The cases of ``tests/test_rollout.py`` — the fencepost arithmetic,
  the planner's budget cases, and the end-to-end image rollout across
  three members driven by ``testing/membersim.py``'s
  ``MemberDeploymentSimulator`` through the cluster, federate, scheduler
  and sync controllers — run over JAX and over the port (the test
  module's globals pointed at the port's; the port's scheduler on
  ``SchedulerEngine(device="cpu")``), and every store the case makes is
  equal between the two runs.
* The reference planner goldens of ``tests/test_rollout_goldens.py``
  (85 suites of ``rolloutplan_test.go``): the port's planner gives the
  golden plans, as JAX's does.
"""

import pytest

import test_e2e_slice as E2E
import test_rollout as RO
import test_rollout_goldens as GO
from test_torch_sync import method_cases, run_both, run_method

from kubeadmiral_tpu.federation import rollout as jax_rollout
from kubeadmiral_tpu_torch.federation import rollout

ROLLOUT_CASES = method_cases(RO.TestResolveFenceposts, RO.TestRolloutPlanner, RO.TestRolloutEndToEnd)


@pytest.mark.parametrize(
    "cls,name", ROLLOUT_CASES, ids=[f"{c.__name__}.{n}" for c, n in ROLLOUT_CASES]
)
def test_rollout_case(monkeypatch, cls, name):
    stores = run_both(monkeypatch, (RO, E2E), run_method(cls, name))
    if cls is RO.TestRolloutEndToEnd:
        assert stores


def _plan(mod, func, suite, monkeypatch):
    """The golden suite through ``mod``'s planner (the golden module's
    target builder pointed at ``mod``'s classes)."""
    for name in ("Target", "TargetStatus"):
        monkeypatch.setattr(GO, name, getattr(mod, name))
    planner = mod.RolloutPlanner.from_params(
        suite["replicas"], suite["max_surge"], suite["max_unavailable"]
    )
    for spec in suite["targets"]:
        planner.register(GO.build_target(spec))
    return planner.plan()


@pytest.mark.parametrize(
    "func,suite", GO.CASES, ids=[f"{f}::{s['name']}" for f, s in GO.CASES]
)
def test_reference_golden(monkeypatch, func, suite):
    got = _plan(rollout, func, suite, monkeypatch)
    want = {
        cluster: rollout.RolloutPlan(
            replicas=v[0], max_surge=v[1], max_unavailable=v[2], only_patch_replicas=v[3],
        )
        for cluster, v in suite["plans"].items()
    }
    assert got == want, f"{func}:{suite['name']}\n got: {got}\nwant: {want}"
    ref = _plan(jax_rollout, func, suite, monkeypatch)
    assert {k: vars(v) for k, v in got.items()} == {k: vars(v) for k, v in ref.items()}


def test_empty_targets_literal_planners():
    """TestPlanEmptyTargets: no targets, no plans, on the port."""
    assert rollout.RolloutPlanner.from_params(100, 0, 25).plan() == {}
    assert rollout.RolloutPlanner.from_params(0, 0, 0).plan() == {}
