"""The port's policyrc, follower and nsautoprop controllers against JAX's.

The cases of ``tests/test_policyrc.py`` (the ``Counter`` and the
``PolicyRCController``'s count and persist stages),
``tests/test_follower.py`` (follower inference from pod specs and
annotations, and the ``FollowerController``'s placement union) and
``tests/test_nsautoprop.py`` (the ``NamespaceAutoPropagationController``
alone and end to end with federate and sync) run over JAX and over the
port, the test modules' globals and lazy imports pointed at the port's
(``test_torch_status.run_both``); every store a case creates is equal
between the two runs.  No case is left out.
"""

import pytest

import test_follower as FO
import test_nsautoprop as NS
import test_policyrc as PRC
from test_torch_status import case_ids, method_cases, run_both, run_method

POLICYRC_CASES = method_cases(PRC.TestCounter, PRC.TestPolicyRCController)
FOLLOWER_CASES = method_cases(FO.TestInference, FO.TestFollowerController)
NSAUTOPROP_CASES = method_cases(NS.TestNSAutoProp, NS.TestNSAutoPropEndToEnd)


@pytest.mark.parametrize("cls,name", POLICYRC_CASES, ids=case_ids(POLICYRC_CASES))
def test_policyrc_case(monkeypatch, cls, name):
    stores = run_both(monkeypatch, (PRC,), run_method(cls, name))
    if cls is PRC.TestPolicyRCController:
        assert stores


@pytest.mark.parametrize("cls,name", FOLLOWER_CASES, ids=case_ids(FOLLOWER_CASES))
def test_follower_case(monkeypatch, cls, name):
    stores = run_both(monkeypatch, (FO,), run_method(cls, name))
    if cls is FO.TestFollowerController:
        assert stores


@pytest.mark.parametrize("cls,name", NSAUTOPROP_CASES, ids=case_ids(NSAUTOPROP_CASES))
def test_nsautoprop_case(monkeypatch, cls, name):
    stores = run_both(monkeypatch, (NS,), run_method(cls, name))
    assert stores
