"""The port's auto-migration, pod informer and monitor against JAX's.

The cases of ``tests/test_automigration.py`` (unschedulable-pod
counting, the ``AutoMigrationController``'s estimated capacity, and
``TestFeedbackLoop``: the scheduler, over the port's
``SchedulerEngine(device="cpu")``, capping the stuck cluster),
``tests/test_podinformer.py`` (pruning, the cache, auto-migration
through the informer, the staged cold replay) and
``tests/test_monitor.py`` (the periodic tick, propagation, latency and
cluster gauges, and the event sink) run over JAX and over the port, the
test modules' globals and lazy imports pointed at the port's
(``test_torch_status.run_both``): every store a case creates, and the
gauges of the ``Metrics`` a monitor case keeps, are equal between the
two runs.  No case is left out.
"""

import pytest

import test_automigration as AM
import test_monitor as MO
import test_podinformer as PI
from test_torch_status import case_ids, method_cases, run_both, run_method

AUTOMIGRATION_CASES = method_cases(
    AM.TestCounting, AM.TestAutoMigrationController, AM.TestFeedbackLoop
)
PODINFORMER_CASES = method_cases(
    PI.TestPrunePod, PI.TestPodInformer, PI.TestAutoMigrationWithInformer,
    PI.TestColdReplayStaging,
)
MONITOR_CASES = method_cases(MO.TestMonitor, MO.TestEventSink)


@pytest.mark.parametrize("cls,name", AUTOMIGRATION_CASES, ids=case_ids(AUTOMIGRATION_CASES))
def test_automigration_case(monkeypatch, cls, name):
    stores = run_both(monkeypatch, (AM,), run_method(cls, name))
    if cls is not AM.TestCounting:
        assert stores


@pytest.mark.parametrize("cls,name", PODINFORMER_CASES, ids=case_ids(PODINFORMER_CASES))
def test_podinformer_case(monkeypatch, cls, name):
    stores = run_both(monkeypatch, (PI,), run_method(cls, name))
    if cls in (PI.TestPodInformer, PI.TestAutoMigrationWithInformer):
        assert stores


@pytest.mark.parametrize("cls,name", MONITOR_CASES, ids=case_ids(MONITOR_CASES))
def test_monitor_case(monkeypatch, cls, name):
    stores = run_both(monkeypatch, (MO,), run_method(cls, name))
    assert stores

