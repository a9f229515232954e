"""Phase-1 parity: the port's ``phase1_plain`` (the CUDA kernel's plain
twin) against the JAX package's XLA ``_phase1`` and its Pallas kernel
``pallas_slab.phase1_slab`` run in interpret mode — the way
tests/test_pallas_slab.py runs it on the CPU.  Tolerance 0 on all three
planes (integer math).  Cases follow test_pallas_slab.py: odd B, webhook
planes, padded columns, C=200; plus int32 score planes (what every
featurizer produces) and byte-scale resources.

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
