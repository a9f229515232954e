"""The port's fault injection against the JAX package's.

* ``FaultInjector``: for the same seed, policies and clock, the port's
  injector resolves the same action sequence as the JAX one (latency,
  injected errors, dropped connections, partitions, flaps, watch
  stalls, scheduled start and expiry).
* The cases of ``tests/test_faults.py`` but its ``slow`` classes (fault
  policies, ``FaultyKube``, the breakers, the dispatch retry budget and
  deadlines, watch recovery through a stall, a 410 relist and a
  partition's reconnect backoff, the one-member-down acceptance
  scenario over the kwok-lite farm, the ``/faultz`` endpoint) run with
  the test module's globals and the modules its cases import pointed at
  the port's; where a case sets a ``KT_*`` variable, the port's run sets
  the module constant that took its place
  (``test_torch_transport.ENV_CONSTANTS``).
"""

import dataclasses

import pytest

import test_faults as TF
from test_torch_sync import method_cases
from test_torch_transport import case_ids, run_on_port

from kubeadmiral_tpu.transport import faults as jax_faults
from kubeadmiral_tpu_torch.transport import faults as port_faults


class Clock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


POLICIES = [
    dict(latency_s=0.01, jitter_s=0.05),
    dict(error_rate=0.3, drop_rate=0.2),
    dict(partition=True, start_s=0.5, duration_s=2.0),
    dict(flap_period_s=0.4, flap_duty=0.25, error_rate=0.1),
    dict(watch_stall=True, jitter_s=0.02, duration_s=1.5),
]


def action_sequence(mod, seed: int, policy: dict) -> list:
    clock = Clock()
    inj = mod.FaultInjector(clock=clock, seed=seed)
    inj.set_fault("m", mod.FaultPolicy(**policy))
    out = []
    for step in range(60):
        clock.t = step * 0.05
        act = inj.action("m")
        out.append(None if act is None else dataclasses.asdict(act))
        out.append((inj.partitioned("m"), inj.watch_stalled("m")))
        out.append(inj.policy("m") is not None)
    return out


@pytest.mark.parametrize("seed", [0, 7, 20260806])
@pytest.mark.parametrize("index", range(len(POLICIES)))
def test_injector_sequences_equal_jax(seed, index):
    want = action_sequence(jax_faults, seed, POLICIES[index])
    got = action_sequence(port_faults, seed, POLICIES[index])
    assert got == want
    assert any(a is not None for a in got[::3])


def test_policy_fields_equal_jax():
    assert [f.name for f in dataclasses.fields(port_faults.FaultPolicy)] == [
        f.name for f in dataclasses.fields(jax_faults.FaultPolicy)
    ]
    assert port_faults.FaultInjector().partition_hang_s == jax_faults.FaultInjector().partition_hang_s


FAULT_CASES = method_cases(
    TF.TestFaultPolicy, TF.TestFaultyKube, TF.TestBreaker, TF.TestDispatchRetry,
    TF.TestDeadlines, TF.TestWatchRecovery, TF.TestMemberFaultToleranceE2E,
    TF.TestFaultControlEndpoint,
)


@pytest.mark.parametrize("cls,name", FAULT_CASES, ids=case_ids(FAULT_CASES))
def test_fault_case(monkeypatch, cls, name):
    run_on_port(monkeypatch, TF, cls, name)
