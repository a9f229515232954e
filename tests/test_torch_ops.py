"""Op-level parity: every torch op of the port's dense tick against its
JAX counterpart on the same numpy inputs (tolerance 0: integer math).

Worlds come from tests/test_pipeline.py (random_problem/to_tick_inputs)
and tests/test_planner_device.py (build_case/to_batch); inputs cross
over through ``kubeadmiral_tpu_torch.convert``.  JAX runs on the CPU.
"""

import jax
import numpy as np
import pytest
import torch

from test_pipeline import random_problem, to_tick_inputs
from test_planner_device import build_case, to_batch

from kubeadmiral_tpu.ops import filters as JF
from kubeadmiral_tpu.ops import pipeline as JPipe
from kubeadmiral_tpu.ops import reasons as JR
from kubeadmiral_tpu.ops import planner as JP
from kubeadmiral_tpu.ops import scores as JS
from kubeadmiral_tpu.ops import select as JSel
from kubeadmiral_tpu.ops import weights as JW
from kubeadmiral_tpu.ops.planner_oracle import ClusterPref, PlanInput, plan as oracle_plan
from kubeadmiral_tpu.utils import hashing as JH
from kubeadmiral_tpu.utils.hashing import fnv32_batch, uint32_to_sortable_int32
from kubeadmiral_tpu_torch.convert import tensor, to_device, to_numpy
from kubeadmiral_tpu_torch.ops import filters as TF
from kubeadmiral_tpu_torch.ops import planner as TP
from kubeadmiral_tpu_torch.ops import reasons as TR
from kubeadmiral_tpu_torch.ops import scores as TS
from kubeadmiral_tpu_torch.ops import select as TSel
from kubeadmiral_tpu_torch.ops import weights as TW
from kubeadmiral_tpu_torch.utils import hashing as TH

INF = int(JP.INT32_INF)


def same(got, want, what=""):
    g = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    w = np.asarray(want)
    assert g.dtype == w.dtype, f"{what}: dtype {g.dtype} != {w.dtype}"
    assert g.shape == w.shape, f"{what}: shape {g.shape} != {w.shape}"
    assert np.array_equal(g, w), f"{what}: values differ at {np.argwhere(g != w)[:5]}"


def world(c, b=40, seed=0, scale=False):
    """(numpy TickInputs, port TickInputs on CPU).  ``scale`` multiplies
    each resource column by a random power of two up to 2^39 so the
    balanced score's range shift and the 64-bit divisions are exercised
    at byte-sized quantities."""
    rng = np.random.default_rng(1000 * c + seed)
    names = [f"member-{j}" for j in range(c)]
    inp = to_tick_inputs(
        [random_problem(rng, c, f"ns-{i}/w-{i}", names) for i in range(b)], c
    )
    if scale:
        r = inp.request.shape[1]
        mult = np.int64(1) << rng.integers(0, 40, r).astype(np.int64)
        inp = inp._replace(
            request=inp.request * mult, alloc=inp.alloc * mult, used=inp.used * mult
        )
    return inp, to_device(inp, "cpu")


CASES = [(1, False), (3, False), (8, False), (19, True), (40, True)]


def test_hashing_copy_matches_jax():
    """The port's pure-numpy FNV-1 copy against the JAX package's
    (native-library or numpy) implementation."""
    names = [f"member-{j:05d}" for j in range(37)] + ["", "a"]
    for key in ("ns-1/workload-000001", "", "x" * 70):
        want = JH.fnv32_batch(names, key)
        same(TH.fnv32_batch(names, key), want, f"fnv32_batch({key!r})")
        state = JH.fnv32_batch(names, "")
        same(TH.fnv32_extend(state, key.encode()), want, "fnv32_extend")
        assert TH.fnv32((names[0] + key).encode()) == int(want[0])
        assert TH.fnv32_extend(int(state[1]), key.encode()) == int(want[1])
        same(TH.uint32_to_sortable_int32(want), JH.uint32_to_sortable_int32(want),
             "uint32_to_sortable_int32")


def test_reason_vocabulary_matches_jax():
    names = [n for n in dir(JR) if n.startswith("REASON_") or n.endswith("_MASK")]
    assert names and all(getattr(TR, n) == getattr(JR, n) for n in names)
    assert TR.REASON_NAMES == JR.REASON_NAMES
    assert TR.describe(0b1000100101) == JR.describe(0b1000100101)


@pytest.mark.parametrize("c,scale", CASES)
def test_filters_match_jax(c, scale):
    inp, t = world(c, scale=scale)
    same(TF.resources_fit(t.request, t.alloc, t.used),
         JF.resources_fit(inp.request, inp.alloc, inp.used), "resources_fit")
    fit = JF.resources_fit(inp.request, inp.alloc, inp.used)
    args = (inp.filter_enabled, inp.api_ok, inp.taint_ok_new, inp.taint_ok_cur,
            inp.current_mask, np.asarray(fit), inp.placement_has, inp.placement_ok,
            inp.selector_ok)
    got = TF.combine_filters_explain(*(tensor(a, "cpu") for a in args))
    want = JF.combine_filters_explain(*args)
    same(got[0], want[0], "feasible")
    same(got[1], want[1], "reasons")


@pytest.mark.parametrize("c,scale", CASES)
def test_score_plugins_match_jax(c, scale):
    inp, t = world(c, scale=scale)
    for name in ("balanced_allocation_score", "least_allocated_score",
                 "most_allocated_score"):
        same(getattr(TS, name)(t.request, t.alloc, t.used),
             getattr(JS, name)(inp.request, inp.alloc, inp.used), name)
    feasible, _, _ = JPipe._phase1(inp)
    feasible = np.asarray(feasible)
    tf = tensor(feasible, "cpu")
    for plane in ("taint_counts", "affinity_scores"):
        for reverse in (True, False):
            same(TS.normalize(getattr(t, plane), tf, reverse),
                 JS.normalize(getattr(inp, plane), feasible, reverse),
                 f"normalize({plane}, {reverse})")
    same(TS.total_scores(t.score_enabled, tf, t.request, t.alloc, t.used,
                         t.taint_counts, t.affinity_scores),
         JS.total_scores(inp.score_enabled, feasible, inp.request, inp.alloc,
                         inp.used, inp.taint_counts, inp.affinity_scores),
         "total_scores")


def test_normalize_negative_and_int32_planes_match_jax():
    """Normalization edge rows: all-zero (untouched branch), negative
    maxima (divisor clamped to 1), int32 planes as expand_compact
    produces them."""
    rng = np.random.default_rng(3)
    scores = rng.integers(-30, 30, (24, 17)).astype(np.int32)
    scores[0] = 0
    scores[1] = -np.abs(scores[1]) - 1
    feasible = rng.random((24, 17)) < 0.7
    feasible[1] = True
    for reverse in (True, False):
        same(TS.normalize(tensor(scores, "cpu"), tensor(feasible, "cpu"), reverse),
             JS.normalize(scores, feasible, reverse), f"normalize {reverse}")


@pytest.mark.parametrize("c", [1, 5, 19, 40])
def test_dynamic_weights_match_jax(c):
    inp, t = world(c)
    rng = np.random.default_rng(c)
    selected = rng.random((inp.total.shape[0], c)) < 0.6
    selected[0] = False
    same(TW.dynamic_weights(tensor(selected, "cpu"), t.cpu_alloc, t.cpu_avail),
         JW.dynamic_weights(selected, inp.cpu_alloc, inp.cpu_avail), "dynamic_weights")


@pytest.mark.parametrize("c", [1, 5, 19, 40])
def test_select_topk_matches_jax(c):
    inp, t = world(c)
    feasible, _, totals = (np.asarray(x) for x in JPipe._phase1(inp))
    # Ties at the top-K boundary: coarsen the totals.
    for sco in (totals, totals // 50):
        same(TSel.select_topk(tensor(sco, "cpu"), tensor(feasible, "cpu"), t.max_clusters),
             JSel.select_topk(sco, feasible, inp.max_clusters), "select_topk")


def test_running_remainder_matches_jax():
    rng = np.random.default_rng(11)
    takes = rng.integers(-5, 12, (64, 23)).astype(np.int32)
    r0 = rng.integers(0, 60, 64).astype(np.int32)
    want = jax.vmap(JP._running_remainder)(r0, takes)
    same(TP._running_remainder(tensor(r0, "cpu")[:, None], tensor(takes, "cpu")),
         want, "_running_remainder")


def _plan_both(inp):
    got = TP.plan_batch(to_device(inp, "cpu"))
    want = JP.plan_batch(inp)
    same(got.plan, want.plan, "plan")
    same(got.overflow, want.overflow, "overflow")
    return to_numpy(got)


@pytest.mark.parametrize("n_clusters", [1, 2, 5, 8, 17])
def test_plan_batch_matches_jax_random(n_clusters):
    rng = np.random.default_rng(1234 + n_clusters)
    cases = [build_case(rng, n_clusters, f"ns-{i}/obj-{i}")[3] for i in range(60)]
    _plan_both(to_batch(cases, n_clusters))


def test_plan_batch_wildcard_scale_max_matches_jax_and_oracle():
    names = ["a", "b"]
    key = "ns/wild"
    want_plan, _ = oracle_plan(
        PlanInput(
            prefs={"*": ClusterPref(weight=1, max_replicas=6)}, total=10,
            clusters=names, current={"a": 0, "b": 0}, capacity={}, key=key,
            avoid_disruption=True, keep_unschedulable=False,
        )
    )
    inp = JP.make_inputs(
        1, 2, 10, weight=np.array([1, 1]), max_replicas=np.array([6, 6]),
        scale_max=np.array([INF, INF]),
        tiebreak=uint32_to_sortable_int32(fnv32_batch(names, key)),
        avoid_disruption=True,
    )
    got = _plan_both(inp)
    assert [int(x) for x in got.plan[0]] == [want_plan.get(n, 0) for n in names]


def test_plan_batch_large_batch_matches_jax():
    rng = np.random.default_rng(7)
    b, c = 64, 32
    inp = JP.make_inputs(
        b, c, rng.integers(0, 100, b), weight=rng.integers(0, 10, (b, c)),
        tiebreak=rng.integers(-(2**31), 2**31 - 1, (b, c)),
    )
    got = _plan_both(inp)
    assert (got.plan.sum(axis=1) == inp.total).all()


def test_plan_batch_validates_contract():
    inp = JP.make_inputs(1, 2, 10**6, weight=np.array([3000, 3000]))
    with pytest.raises(OverflowError):
        JP.plan_batch(inp)
    with pytest.raises(OverflowError):
        TP.plan_batch(to_device(inp, "cpu"))
    ok = JP.make_inputs(1, 2, 10**5, weight=np.array([3000, -3000]))
    TP.validate_ranges(ok.total, ok.weight)
    JP.validate_ranges(ok.total, ok.weight)
