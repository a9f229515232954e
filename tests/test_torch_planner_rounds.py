"""The dispatch's two former host waits in their new forms, against JAX.

* The FNV tie-break plane scans to a byte count given by the host (the
  keys' lengths before the upload) or to the padded width, instead of
  reading the longest key back from the device: bit for bit with JAX's
  ``fnv_tiebreak_plane`` on keys of mixed lengths, empty keys included,
  and ``expand_compact`` with the bound equals JAX's expansion (its
  planes contiguous, as the phase-1 kernel takes them).
* The planner's weighted rounds under a ``RoundBudget`` (a fixed number
  of rounds, no read of the loop condition): against JAX's
  ``plan_batch`` and ``plan_batch_narrow`` and the port's checked loop,
  under hypothesis over weights, capacities, min/max/scale-max and
  current replicas and phantom tails, with rows that take many rounds.
  Every row the budget settles equals JAX's, certificate included; the
  rows it reports unsettled are exactly those whose checked loop ran
  more rounds than the budget.

Tolerance 0 everywhere (integer math).
"""

import jax
import numpy as np
import pytest
from hypothesis import given, settings, strategies as st

from test_compact import rich_world

from kubeadmiral_tpu.ops import pipeline as JPipe
from kubeadmiral_tpu.ops import planner as JPlan
from kubeadmiral_tpu.scheduler import compact as JCmp
from kubeadmiral_tpu.scheduler import featurize as JFeat
from kubeadmiral_tpu_torch.convert import tensor, to_device, to_numpy
from kubeadmiral_tpu_torch.ops import pipeline as TPipe
from kubeadmiral_tpu_torch.ops import planner as TPlan
from kubeadmiral_tpu_torch.scheduler import engine as engine_mod

INF = int(np.iinfo(np.int32).max)


# -- the FNV plane ------------------------------------------------------------


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_fnv_plane_with_host_byte_count_matches_jax(seed):
    rng = np.random.default_rng(seed)
    b, c, width = 11, 13, 64
    key_bytes = rng.integers(0, 256, (b, width)).astype(np.uint8)
    key_len = rng.integers(0, width + 1, b).astype(np.int32)
    key_len[:3] = 0  # empty keys
    key_len[3] = width
    state = rng.integers(0, 2**32, c, dtype=np.uint64).astype(np.uint32)
    want = np.asarray(JPipe.fnv_tiebreak_plane(key_bytes, key_len, state))
    longest = int(key_len.max())
    for n_bytes in (None, longest, width, longest + 5):
        got = TPipe.fnv_tiebreak_plane(
            tensor(key_bytes, "cpu"), tensor(key_len, "cpu"), tensor(state, "cpu"), n_bytes
        )
        np.testing.assert_array_equal(got.numpy(), want, err_msg=f"n_bytes={n_bytes}")


def test_fnv_plane_of_empty_keys_is_the_names_hash():
    state = np.array([1, 2**31, 2**32 - 1], np.uint32)
    key_bytes = np.zeros((2, 64), np.uint8)
    key_len = np.zeros(2, np.int32)
    want = np.asarray(JPipe.fnv_tiebreak_plane(key_bytes, key_len, state))
    got = TPipe.fnv_tiebreak_plane(
        tensor(key_bytes, "cpu"), tensor(key_len, "cpu"), tensor(state, "cpu"), 0
    )
    np.testing.assert_array_equal(got.numpy(), want)


def test_expand_compact_with_the_host_key_bound_matches_jax():
    units, clusters = rich_world(b=48, c=14, seed=7)
    view = JFeat._build_cluster_view(clusters, units)
    ci = JCmp.featurize_compact(units, view, JCmp.CompactVocab(view))
    ci = JCmp.pad_axis1(JCmp.pad_rows(ci, 64), {"key_bytes": 0}, 128)
    want = JPipe.expand_compact(ci)
    longest = int(np.asarray(ci.key_len).max())
    assert 0 < longest < np.asarray(ci.key_bytes).shape[1]
    for bound in (longest, None):
        expanded = TPipe.expand_compact(to_device(ci, "cpu"), bound)
        # The phase-1 kernel takes contiguous planes only.
        assert all(x.is_contiguous() for x in expanded), bound
        got = to_numpy(expanded)
        for name in want._fields:
            np.testing.assert_array_equal(
                np.asarray(getattr(got, name)), np.asarray(getattr(want, name)), err_msg=name
            )


# -- the planner's rounds -------------------------------------------------------

B, C = 8, 12
_jax_plan = jax.jit(JPlan.plan_batch_jit)
_jax_narrow = jax.jit(JPlan.plan_batch_narrow)


def _problem(seed: int, regime: str):
    """One [B, C] planner batch.  ``ladder``: equal weights over
    capacities 1..C and large totals, so rounds saturate clusters and
    rows take several rounds; ``tight``: small max replicas and
    capacities everywhere; ``random``: a mix of every structure."""
    rng = np.random.default_rng(seed)
    shape = (B, C)

    def some(p, lo, hi, fill):
        return np.where(rng.random(shape) < p, rng.integers(lo, hi, shape), fill).astype(np.int32)

    member = rng.random(shape) < 0.85
    if regime == "ladder":
        weight = np.full(shape, int(rng.integers(1, 9)), np.int32)
        capacity = np.stack([rng.permutation(C) + 1 for _ in range(B)]).astype(np.int32)
        max_replicas = np.full(shape, INF, np.int32)
        total = rng.integers(40, 120, B).astype(np.int32)
    elif regime == "tight":
        weight = rng.integers(0, 40, shape).astype(np.int32)
        capacity = some(0.7, 0, 6, INF)
        max_replicas = some(0.7, 0, 8, INF)
        total = rng.integers(0, 150, B).astype(np.int32)
    else:
        weight = rng.integers(-3, 60, shape).astype(np.int32)
        capacity = some(0.25, 0, 9, INF)
        max_replicas = some(0.2, 0, 12, INF)
        total = rng.integers(0, 200, B).astype(np.int32)
    return JPlan.PlannerInputs(
        weight=weight,
        min_replicas=some(0.15, 0, 5, 0),
        max_replicas=max_replicas,
        scale_max=some(0.15, 0, 12, INF),
        capacity=capacity,
        tiebreak=rng.integers(-(2**31), 2**31, shape).astype(np.int32),
        member=member,
        total=total,
        current=some(0.3, 0, 15, 0),
        avoid_disruption=rng.random(B) < 0.5,
        keep_unschedulable=rng.random(B) < 0.3,
    )


def _flat(result) -> list:
    """The tensors of a planner result: outputs, or (outputs, cert)."""
    if isinstance(result, TPlan.PlannerOutputs):
        return list(result)
    outputs, cert = result
    return [*outputs, cert]


def _checked_and_budgeted(solve, rounds: int):
    """(checked result, rounds per row of each loop, budgeted result,
    unsettled rows) of ``solve(budget)``.  The rounds come from a
    recording budget, which runs the checked loop: its result must equal
    the plain checked loop's, with no row unsettled."""
    checked = solve(None)
    recorder = TPlan.RoundBudget(None, record=True)
    recorded = solve(recorder)
    for a, b in zip(_flat(checked), _flat(recorded)):
        np.testing.assert_array_equal(a.numpy(), b.numpy())
    assert not recorder.unsettled.any()
    log = recorder.per_row
    budget = TPlan.RoundBudget(rounds)
    budgeted = solve(budget)
    late = np.zeros(B, bool) if budget.unsettled is None else budget.unsettled.numpy()
    return checked, log, budgeted, late


def _late_by_log(log, rounds: int) -> np.ndarray:
    return np.logical_or.reduce([r > rounds for r in log])


REGIMES = st.sampled_from(["random", "ladder", "tight"])


@settings(max_examples=60, deadline=None)
@given(seed=st.integers(0, 2**32 - 1), regime=REGIMES, rounds=st.integers(0, 6))
def test_budgeted_plan_batch_matches_jax_and_the_checked_loop(seed, regime, rounds):
    inp = _problem(seed, regime)
    want = _jax_plan(inp)
    t_inp = to_device(inp, "cpu")
    checked, log, got, late = _checked_and_budgeted(
        lambda budget: TPlan.plan_batch(t_inp, budget=budget), rounds
    )
    for name in ("plan", "overflow"):
        w = np.asarray(getattr(want, name))
        np.testing.assert_array_equal(getattr(checked, name).numpy(), w, err_msg=name)
        np.testing.assert_array_equal(getattr(got, name).numpy()[~late], w[~late], err_msg=name)
    assert len(log) == 3  # desired, scale up, scale down
    np.testing.assert_array_equal(late, _late_by_log(log, rounds))


@settings(max_examples=60, deadline=None)
@given(seed=st.integers(0, 2**32 - 1), regime=REGIMES, rounds=st.integers(0, 6))
def test_budgeted_narrow_planner_matches_jax_and_the_checked_loop(seed, regime, rounds):
    inp = _problem(seed, regime)
    rng = np.random.default_rng(seed ^ 0x5EED)
    tail_weight = np.where(rng.random(B) < 0.3, 0, rng.integers(1, 300, B)).astype(np.int32)
    comp = np.asarray(
        JPlan.processing_key(inp.weight, inp.tiebreak, np.zeros((B, C), bool))
    )
    best_tail = np.where(
        tail_weight > 0, comp[np.arange(B), rng.integers(0, C, B)] + rng.integers(-3, 4, B), -1
    ).astype(np.int64)
    want, want_cert = _jax_narrow(inp, tail_weight, best_tail, comp)
    t_inp = to_device(inp, "cpu")
    t = lambda x: tensor(x, "cpu")  # noqa: E731

    def solve(budget):
        return TPlan.plan_batch_narrow(t_inp, t(tail_weight), t(best_tail), t(comp), budget)

    (checked, cert), log, (got, got_cert), late = _checked_and_budgeted(solve, rounds)
    want_cert = np.asarray(want_cert)
    np.testing.assert_array_equal(cert.numpy(), want_cert)
    np.testing.assert_array_equal(got_cert.numpy()[~late], want_cert[~late])
    for name in ("plan", "overflow"):
        w = np.asarray(getattr(want, name))
        np.testing.assert_array_equal(getattr(checked, name).numpy(), w, err_msg=name)
        np.testing.assert_array_equal(getattr(got, name).numpy()[~late], w[~late], err_msg=name)
    np.testing.assert_array_equal(late, _late_by_log(log, rounds))


@pytest.mark.parametrize("seed", range(4))
def test_heavy_tail_rows_take_many_rounds_and_settle_under_a_long_budget(seed):
    """A phantom tail far heavier than the slots gives each slot one
    replica a round, so rows run more rounds than the engine's
    PLANNER_ROUNDS (its re-dispatch is reachable); a budget of 64 rounds
    settles them all with JAX's result and certificate."""
    rng = np.random.default_rng(seed)
    inp = _problem(seed, "random")._replace(
        weight=np.ones((B, C), np.int32),
        member=np.ones((B, C), bool),
        min_replicas=np.zeros((B, C), np.int32),
        max_replicas=np.full((B, C), INF, np.int32),
        capacity=np.full((B, C), INF, np.int32),
        total=rng.integers(60, 120, B).astype(np.int32),
    )
    tail_weight = np.full(B, 1000, np.int32)
    comp = np.asarray(JPlan.processing_key(inp.weight, inp.tiebreak, np.zeros((B, C), bool)))
    best_tail = comp.min(axis=1) - 1
    t_inp = to_device(inp, "cpu")
    t = lambda x: tensor(x, "cpu")  # noqa: E731

    def solve(budget):
        return TPlan.plan_batch_narrow(t_inp, t(tail_weight), t(best_tail), t(comp), budget)

    _, log, (got, cert), late = _checked_and_budgeted(solve, 64)
    assert max(int(r.max()) for r in log) > engine_mod.PLANNER_ROUNDS
    assert not late.any()
    want, want_cert = _jax_narrow(inp, tail_weight, best_tail, comp)
    np.testing.assert_array_equal(cert.numpy(), np.asarray(want_cert))
    for name in ("plan", "overflow"):
        np.testing.assert_array_equal(getattr(got, name).numpy(), np.asarray(getattr(want, name)))
