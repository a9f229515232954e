"""Phase-1 parity: the port's ``phase1_plain`` (the CUDA kernel's plain
twin) against the JAX package's XLA ``_phase1`` and its Pallas kernel
``pallas_slab.phase1_slab`` run in interpret mode — the way
tests/test_pallas_slab.py runs it on the CPU.  Tolerance 0 on all three
planes (integer math).  Cases follow test_pallas_slab.py: odd B, webhook
planes, padded columns, C=200; plus int32 score planes (what every
featurizer produces) and byte-scale resources.

The edge cases come from ``testing/problems.py:edge_tick_inputs``, the
inputs the card also runs: C not a multiple of the kernel's four- and
sixteen-byte accesses (33, 200, 1300), B not a multiple of its rows per
block (13, 333), byte-scale resources, taint counts past the int32 wrap
of 100 * count, negative and int32-wide webhook and affinity scores, rows
whose only feasible column is the last, and rows every column passes.

The CUDA kernel itself needs the card: tests/test_torch_cuda.py holds it
against this plain version there, and chip_smoke.py does so at the main
path's shapes on every chip run.
"""

import numpy as np
import pytest

from test_pipeline import random_problem, to_tick_inputs

from kubeadmiral_tpu.ops import pallas_slab as ps
from kubeadmiral_tpu.ops import pipeline as dev
from kubeadmiral_tpu_torch.convert import to_device
from kubeadmiral_tpu_torch.ops.phase1 import phase1_plain
from kubeadmiral_tpu_torch.testing.problems import EDGE_SHAPES, TAINT_WRAP, edge_tick_inputs

PLANES = ("feasible", "reasons", "totals")


def _random_inputs(b, c, webhook, invalid, int32, scale):
    rng = np.random.default_rng(b * 1000 + c)
    names = [f"member-{j}" for j in range(c)]
    inp = to_tick_inputs([random_problem(rng, c, f"ns/w-{i}", names) for i in range(b)], c)
    if webhook:
        inp = inp._replace(
            webhook_ok=rng.random((b, c)) > 0.15,
            webhook_scores=rng.integers(-50, 200, (b, c)).astype(np.int64),
        )
    if invalid:
        valid = np.ones(c, bool)
        valid[-invalid:] = False
        inp = inp._replace(cluster_valid=valid)
    if int32:
        inp = inp._replace(
            taint_counts=inp.taint_counts.astype(np.int32),
            affinity_scores=inp.affinity_scores.astype(np.int32),
            webhook_scores=inp.webhook_scores.astype(np.int32),
        )
    if scale:
        mult = np.int64(1) << rng.integers(0, 40, inp.request.shape[1]).astype(np.int64)
        inp = inp._replace(
            request=inp.request * mult, alloc=inp.alloc * mult, used=inp.used * mult
        )
    return inp


CASES = [
    # b, c, webhook, invalid columns, int32 score planes, byte-scale resources
    (16, 24, False, 0, False, False),
    (32, 12, True, 3, False, False),   # webhook planes + padded columns
    (13, 40, False, 0, False, False),  # odd B
    (8, 200, True, 7, False, False),   # wide-ish cluster axis
    (21, 64, True, 5, True, False),    # int32 planes, as expand_compact emits
    (24, 33, False, 2, True, True),    # byte-scale resources (range shift)
]


@pytest.mark.parametrize("b,c,webhook,invalid,int32,scale", CASES)
def test_phase1_plain_matches_xla_and_pallas(b, c, webhook, invalid, int32, scale):
    inp = _random_inputs(b, c, webhook, invalid, int32, scale)
    got = phase1_plain(to_device(inp, "cpu"))
    xla = dev._phase1(inp)
    pallas = ps.phase1_slab(inp, interpret=True)
    for name, g, x, p in zip(PLANES, got, xla, pallas):
        g = g.numpy()
        for ref, which in ((x, "xla"), (p, "pallas")):
            ref = np.asarray(ref)
            assert g.dtype == ref.dtype, f"{name} vs {which}: {g.dtype} != {ref.dtype}"
            assert np.array_equal(g, ref), f"{name} differs from {which}"


def _assert_planes_equal(got, ref, which):
    for name, g, r in zip(PLANES, got, ref):
        g, r = g.numpy(), np.asarray(r)
        assert g.dtype == r.dtype, f"{name} vs {which}: {g.dtype} != {r.dtype}"
        assert np.array_equal(g, r), f"{name} differs from {which}"


SCORE_PLANES = ("taint_counts", "affinity_scores", "webhook_scores")

EDGE_CASES = EDGE_SHAPES[:5]  # the widths JAX's interpret mode runs quickly

@pytest.mark.parametrize("b,c,r,invalid,seed", EDGE_CASES)
def test_phase1_plain_matches_xla_and_pallas_on_kernel_edges(b, c, r, invalid, seed):
    inp = edge_tick_inputs(b, c, r, invalid, seed)
    got = phase1_plain(to_device(inp, "cpu"))
    # int32 score planes, as the kernel takes them: XLA normalises in
    # int32 too, so 100 * count wraps in both.
    _assert_planes_equal(got, dev._phase1(inp), "xla")
    # The Pallas kernel widens the score planes to int64 before it
    # scores (pallas_slab.py:phase1_slab), so it computes the int64
    # function: hold it, and XLA, against the plain version there.
    wide = inp._replace(**{k: getattr(inp, k).astype(np.int64) for k in SCORE_PLANES})
    got64 = phase1_plain(to_device(wide, "cpu"))
    _assert_planes_equal(got64, dev._phase1(wide), "xla int64")
    _assert_planes_equal(got64, ps.phase1_slab(wide, interpret=True), "pallas")


@pytest.mark.parametrize("b,c,r,invalid,seed", EDGE_CASES)
def test_edge_inputs_reach_the_edges(b, c, r, invalid, seed):
    # The draws hit what the cases are for, on the cells that count.
    inp = edge_tick_inputs(b, c, r, invalid, seed)
    feasible = phase1_plain(to_device(inp, "cpu"))[0].numpy()
    taint_rows = inp.score_enabled[:, 0]
    assert (feasible & taint_rows[:, None] & (inp.taint_counts > TAINT_WRAP)).any()
    assert (feasible & (inp.affinity_scores < 0)).any()
    assert (feasible & (inp.webhook_scores < 0)).any()
    last_only = feasible[:, -1] & (feasible.sum(1) == 1)
    assert last_only.any()
    if invalid == 0:
        affinity_rows = inp.score_enabled[:, 3]
        masked = np.where(feasible, inp.affinity_scores, 0)
        assert (affinity_rows & feasible.all(1) & (masked.max(1) < 0)).any()
