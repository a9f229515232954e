"""Parity of the port's narrow solve with the JAX package.

* ``schedule_tick_narrow``: every TickOutputs plane and the cert plane,
  uncertified rows included (both sides are deterministic), against JAX
  ``schedule_tick_narrow`` for (C, M) from 19 x 8 up to 5120 x 128, with
  ``i32_keys`` both ways; once more against JAX fed the Pallas kernel's
  phase 1 in interpret mode.
* Certified rows equal the port's dense ``schedule_tick`` on every plane.
* ``plan_batch_narrow`` (plan, overflow and certificate) against JAX's.
* The adversaries of tests/test_narrow.py: a spill chain deeper than M,
  maxClusters beyond M, score ties at the M boundary and dynamic-weight
  redistribution fail the certificate exactly where JAX's does; through
  the engine, ``narrow_stats`` equals the JAX engine's and the results
  equal its dense solve.

Tolerance 0 everywhere (integer math).
"""

import dataclasses

import numpy as np
import pytest
import torch

from test_engine_cache import make_world
from test_narrow import random_batch, spill_world
from test_pipeline import to_tick_inputs
from test_torch_engine import _check
from test_torch_pipeline import same_planes

from kubeadmiral_tpu.models.types import MODE_DIVIDE
from kubeadmiral_tpu.ops import pipeline as JPipe
from kubeadmiral_tpu.ops import planner as JPlan
from kubeadmiral_tpu.ops.pallas_slab import phase1_slab
from kubeadmiral_tpu_torch.convert import tensor, to_device, to_numpy
from kubeadmiral_tpu_torch.ops import pipeline as TPipe
from kubeadmiral_tpu_torch.ops import planner as TPlan

# (C, M, rows): a few rows at the wide axes, where the planner key drops
# 1 (C = 2048) and 3 (C = 5120) low tiebreak bits.
CASES = [
    (19, 8, 60),
    (64, 16, 60),
    (128, 32, 40),
    (512, 128, 12),
    (2048, 64, 6),
    (5120, 128, 4),
]


def _inputs(c, n, seed):
    return to_tick_inputs(random_batch(np.random.default_rng(seed), c, n=n), c)


def _narrow_both(inp, m, i32_keys, jax_phase1=None):
    """Port and JAX narrow ticks on the same inputs; asserts every plane
    and the cert plane equal and returns the port's (outputs, cert)."""
    want, want_cert = JPipe.schedule_tick_narrow(
        inp, m, i32_keys=i32_keys, phase1=jax_phase1
    )
    got, cert = TPipe.schedule_tick_narrow(to_device(inp, "cpu"), m, i32_keys=i32_keys)
    got = to_numpy(got)
    same_planes(got, want, f"narrow m={m}")
    assert cert.dtype == torch.int8
    np.testing.assert_array_equal(cert.numpy(), np.asarray(want_cert))
    return got, cert.numpy().astype(bool)


@pytest.mark.parametrize("c,m,n", CASES)
@pytest.mark.parametrize("i32_keys", [False, True])
def test_narrow_tick_matches_jax(c, m, n, i32_keys):
    inp = _inputs(c, n, 7000 + c + m)
    _, cert = _narrow_both(inp, m, i32_keys)
    assert cert.any(), "no row certified: the narrow path never engages"


def test_narrow_tick_matches_jax_fed_the_pallas_kernel():
    inp = _inputs(128, 40, 7128)
    _narrow_both(inp, 32, True, jax_phase1=phase1_slab(inp, interpret=True))


@pytest.mark.parametrize("c,m,n", [(19, 8, 60), (64, 8, 60), (128, 32, 40), (2048, 64, 6)])
def test_certified_rows_equal_the_dense_tick(c, m, n):
    inp = _inputs(c, n, 7100 + c)
    got, cert = _narrow_both(inp, m, True)
    dense = to_numpy(TPipe.schedule_tick(to_device(inp, "cpu")))
    assert cert.any()
    for name in dense._fields:
        np.testing.assert_array_equal(
            getattr(got, name)[cert], getattr(dense, name)[cert], err_msg=name
        )


def _planner_case(seed, b=48, m=16):
    """Random narrow planner inputs: [B, M] slots with capacity, min/max
    and current structure, a phantom tail weight and a best tail key."""
    rng = np.random.default_rng(seed)
    inf = int(JPlan.INT32_INF)
    shape = (b, m)
    member = rng.random(shape) < 0.8
    weight = rng.integers(0, 60, shape).astype(np.int32)
    tiebreak = rng.integers(-(2**31), 2**31, shape).astype(np.int32)
    inp = JPlan.PlannerInputs(
        weight=weight,
        min_replicas=np.where(rng.random(shape) < 0.1, rng.integers(0, 4, shape), 0).astype(np.int32),
        max_replicas=np.where(rng.random(shape) < 0.15, rng.integers(0, 9, shape), inf).astype(np.int32),
        scale_max=np.where(rng.random(shape) < 0.1, rng.integers(0, 9, shape), inf).astype(np.int32),
        capacity=np.where(rng.random(shape) < 0.2, rng.integers(0, 6, shape), inf).astype(np.int32),
        tiebreak=tiebreak,
        member=member,
        total=rng.integers(0, 120, b).astype(np.int32),
        current=np.where(rng.random(shape) < 0.2, rng.integers(0, 10, shape), 0).astype(np.int32),
        avoid_disruption=rng.random(b) < 0.5,
        keep_unschedulable=rng.random(b) < 0.3,
    )
    tail_weight = np.where(rng.random(b) < 0.3, 0, rng.integers(1, 200, b)).astype(np.int32)
    comp = np.asarray(JPlan.processing_key(weight, tiebreak, np.zeros(shape, bool)))
    # Best tail keys around the slots' own: some rows order the tail
    # first, some last, some in between.
    best_tail = np.where(
        tail_weight > 0, comp[np.arange(b), rng.integers(0, m, b)] + rng.integers(-3, 4, b), -1
    ).astype(np.int64)
    return inp, tail_weight, best_tail, comp


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_plan_batch_narrow_matches_jax(seed):
    inp, tail_weight, best_tail, comp = _planner_case(seed)
    want, want_cert = JPlan.plan_batch_narrow(inp, tail_weight, best_tail, comp)
    t = lambda x: tensor(x, "cpu")  # noqa: E731
    got, cert = TPlan.plan_batch_narrow(to_device(inp, "cpu"), t(tail_weight), t(best_tail), t(comp))
    np.testing.assert_array_equal(got.plan.numpy(), np.asarray(want.plan))
    np.testing.assert_array_equal(got.overflow.numpy(), np.asarray(want.overflow))
    np.testing.assert_array_equal(cert.numpy(), np.asarray(want_cert))
    assert cert.numpy().any() and not cert.numpy().all()
    np.testing.assert_array_equal(
        TPlan.processing_key(t(inp.weight), t(inp.tiebreak), t(inp.member)).numpy(),
        np.asarray(JPlan.processing_key(inp.weight, inp.tiebreak, inp.member)),
    )


# -- adversaries (tests/test_narrow.py) -----------------------------------


def test_max_clusters_beyond_m_fails_the_certificate_as_jax():
    problems = random_batch(np.random.default_rng(7300), 32, n=40)
    for p in problems:
        p.max_clusters = 20
    _, cert = _narrow_both(to_tick_inputs(problems, 32), 8, True)
    assert (~cert).any(), "max_clusters > M never tripped the certificate"


def test_score_ties_at_the_m_boundary_match_jax():
    rng = np.random.default_rng(7400)
    c = 32
    problems = random_batch(rng, c, n=40)
    for p in problems:
        p.score_enabled = [False] * 5
        p.taint_counts = [0] * c
        p.affinity_scores = [0] * c
        p.max_clusters = int(rng.integers(1, 8))
    for i32_keys in (False, True):
        _narrow_both(to_tick_inputs(problems, c), 8, i32_keys)


def _dynamic_weight_world():
    units, clusters = make_world(b=24, c=48)
    units = [
        dataclasses.replace(u, scheduling_mode=MODE_DIVIDE, desired_replicas=97, weights={})
        for u in units
    ]
    return units, clusters


@pytest.mark.parametrize(
    "world", [spill_world, _dynamic_weight_world], ids=["spill-chain", "dynamic-weights"]
)
def test_adversaries_fall_back_through_the_engine_as_jax(world, monkeypatch):
    """A spill chain deeper than M and dynamic weights pushing replicas
    past M slots: the engine's certificate rejects the rows, the dense
    re-solve fills them in, and narrow_stats equals the JAX engine's."""
    units, clusters = world()
    port, _ = _check(monkeypatch, units, clusters, chunk_size=64, narrow_m=8)
    assert port.narrow_last_m == 8
    assert port.narrow_stats["fallback"] > 0, port.narrow_stats
