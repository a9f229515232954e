"""Slice-level parity of the port's dense tick against the JAX package.

* Expansion: every TickInputs plane of the port's ``expand_compact``
  equals JAX ``expand_compact`` and the dense ``featurize.featurize``,
  in value and dtype — on the port's own compact featurization and on
  the JAX package's (crossed over through ``convert``), unpadded and
  padded to engine buckets.
* The tick: the six TickOutputs planes of the port's ``schedule_tick``
  equal JAX ``schedule_tick`` (webhook planes, padded columns, odd B),
  and placements/reasons equal the sequential oracle
  (``pipeline_oracle.schedule_one`` / ``explain_one``).

Tolerance 0 everywhere (integer math).
"""

import numpy as np
import pytest

from test_compact import rich_world
from test_pipeline import random_problem, to_tick_inputs

from kubeadmiral_tpu.ops import pipeline as JPipe
from kubeadmiral_tpu.ops.pipeline_oracle import NIL, explain_one, schedule_one
from kubeadmiral_tpu.scheduler import compact as JCmp
from kubeadmiral_tpu.scheduler import featurize as JFeat
from kubeadmiral_tpu_torch.convert import to_device, to_numpy
from kubeadmiral_tpu_torch.ops import pipeline as TPipe
from kubeadmiral_tpu_torch.scheduler import compact as TCmp
from kubeadmiral_tpu_torch.scheduler import featurize as TFeat
from kubeadmiral_tpu_torch.testing.worlds import build_world


def same_planes(got, want, what):
    for name in want._fields:
        g, w = np.asarray(getattr(got, name)), np.asarray(getattr(want, name))
        assert g.dtype == w.dtype, f"{what}.{name}: dtype {g.dtype} != {w.dtype}"
        assert np.array_equal(g, w), f"{what}.{name} differs"


WORLDS = {
    "rich": lambda: rich_world(b=48, c=14, seed=7),
    "c3": lambda: build_world(40, 23, "3", seed=2)[:2],
    "c5": lambda: build_world(40, 23, "5", seed=2)[:2],
}


@pytest.mark.parametrize("world", sorted(WORLDS))
@pytest.mark.parametrize("padded", [False, True])
def test_expand_compact_matches_jax_and_dense(world, padded):
    units, clusters = WORLDS[world]()
    j_view = JFeat._build_cluster_view(clusters, units)
    j_ci = JCmp.featurize_compact(units, j_view, JCmp.CompactVocab(j_view))
    t_view = TFeat._build_cluster_view(clusters, units)
    t_ci = TCmp.featurize_compact(units, t_view, TCmp.CompactVocab(t_view))
    dense = JFeat.featurize(units, clusters, view=j_view).inputs
    if padded:
        b_pad, c_pad = 64, 32
        j_ci = JCmp.pad_clusters(JCmp.pad_rows(j_ci, b_pad), c_pad)
        j_ci = JCmp.pad_axis1(j_ci, JCmp.SPARSE_FILLS, 8)
        t_ci = TCmp.pad_clusters(TCmp.pad_rows(t_ci, b_pad), c_pad)
        t_ci = TCmp.pad_axis1(t_ci, TCmp.SPARSE_FILLS, 8)
    want = JPipe.expand_compact(j_ci)
    # The port's numpy featurizer builds the same compact planes.
    for name in j_ci._fields:
        assert np.array_equal(np.asarray(getattr(t_ci, name)), np.asarray(getattr(j_ci, name))), name
    own = to_numpy(TPipe.expand_compact(to_device(t_ci, "cpu")))
    crossed = to_numpy(TPipe.expand_compact(to_device(j_ci, "cpu")))
    same_planes(own, want, "expand(own)")
    same_planes(crossed, want, "expand(jax ci)")
    if not padded:
        same_planes(own, dense, "expand vs dense featurize")


@pytest.mark.parametrize("world", sorted(WORLDS))
def test_dense_featurize_matches_jax(world):
    """The port's numpy copy of the dense featurizer (the engine's
    fallback on a vocabulary overflow) builds the JAX package's planes."""
    units, clusters = WORLDS[world]()
    got = TFeat.featurize(units, clusters).inputs
    want = JFeat.featurize(units, clusters).inputs
    assert got._fields == want._fields
    same_planes(got, want, "featurize")


TICK_CASES = [
    # b, c, webhook, invalid columns
    (40, 3, False, 0),
    (64, 8, False, 0),
    (37, 19, False, 0),   # odd B
    (32, 12, True, 3),    # webhook planes + padded columns
    (13, 40, True, 5),
]


def _tick_world(b, c, webhook, invalid):
    rng = np.random.default_rng(99 + 7 * c + b)
    names = [f"member-{j}" for j in range(c)]
    shared = dict(
        alloc=[[int(x) for x in rng.integers(5, 50, 4)] for _ in range(c)],
        used=[[int(x) for x in rng.integers(0, 40, 4)] for _ in range(c)],
        cpu_alloc=[int(x) for x in rng.integers(0, 30, c)],
        cpu_avail=[int(x) for x in rng.integers(-3, 25, c)],
    )
    problems = []
    for i in range(b):
        p = random_problem(rng, c, f"ns-{i}/workload-{i}", names)
        for k, v in shared.items():
            setattr(p, k, v)
        problems.append(p)
    inp = to_tick_inputs(problems, c)
    if webhook:
        inp = inp._replace(
            webhook_ok=rng.random((b, c)) > 0.15,
            webhook_scores=rng.integers(-50, 200, (b, c)).astype(np.int64),
        )
    if invalid:
        valid = np.ones(c, bool)
        valid[-invalid:] = False
        inp = inp._replace(cluster_valid=valid)
    return problems, inp


@pytest.mark.parametrize("b,c,webhook,invalid", TICK_CASES)
def test_schedule_tick_matches_jax_and_oracle(b, c, webhook, invalid):
    problems, inp = _tick_world(b, c, webhook, invalid)
    got = to_numpy(TPipe.schedule_tick(to_device(inp, "cpu")))
    same_planes(got, JPipe.schedule_tick(inp), "schedule_tick")
    if webhook or invalid:
        return  # the sequential oracle has no webhook / padded-slot model
    for i, p in enumerate(problems):
        want = schedule_one(p)
        sel = set(np.nonzero(got.selected[i])[0].tolist())
        assert sel == set(want), f"row {i}: {sorted(sel)} != {sorted(want)}"
        for j in sel:
            expect = NIL if want[j] is None else want[j]
            assert int(got.replicas[i, j]) == expect, (i, j)
        assert got.reasons[i].tolist() == explain_one(p), f"row {i} reasons"
