"""Parity of the port's packed result wire with the JAX package.

* ``pack_rows`` and ``pack_wire`` are bit-identical to JAX's and to the
  sequential oracle's ``pack_one`` at the (C, K) cases of
  tests/test_packed_export.py, on the same dense output planes.
* ``unpack_wire`` inverts ``pack_wire``.
* The overflow flag (nsel > K) and ties at the top-K boundary; rows with
  zero replicas pack empty.
* The engine's overflow re-fetch: ``_bitpack_bool`` words and the
  ``_gather_overflow3`` row equal JAX's, and ``_unpack_bits`` inverts
  the masks.

Tolerance 0 everywhere (integer math).
"""

import numpy as np
import pytest
import torch

from test_packed_export import device_pack
from test_pipeline import R, random_problem, to_tick_inputs

from kubeadmiral_tpu.ops import pipeline as JPipe
from kubeadmiral_tpu.ops import reasons as RSN
from kubeadmiral_tpu.ops.pipeline_oracle import pack_one
from kubeadmiral_tpu.scheduler import engine as JEngine
from kubeadmiral_tpu_torch.convert import tensor
from kubeadmiral_tpu_torch.ops import pipeline as TPipe
from kubeadmiral_tpu_torch.scheduler import engine as TEngine


def _planes(problems, c):
    """The JAX dense tick's output planes (numpy) for the problems."""
    out = JPipe.schedule_tick(to_tick_inputs(problems, c))
    return tuple(
        np.asarray(getattr(out, name))
        for name in ("selected", "replicas", "counted", "scores", "reasons")
    )


def _port_pack(planes, k):
    return TPipe.pack_rows(*(tensor(p, "cpu") for p in planes), k)


def _same_packed(got, want):
    for name in want._fields:
        g, w = np.asarray(getattr(got, name)), np.asarray(getattr(want, name))
        assert g.dtype == w.dtype, f"{name}: dtype {g.dtype} != {w.dtype}"
        np.testing.assert_array_equal(g, w, err_msg=name)


def _shared_problems(c, seed, n=60):
    """Problems sharing one cluster axis, as TickInputs requires."""
    rng = np.random.default_rng(seed)
    names = [f"member-{j}" for j in range(c)]
    alloc = [[int(x) for x in rng.integers(5, 50, R)] for _ in range(c)]
    used = [[int(x) for x in rng.integers(0, 40, R)] for _ in range(c)]
    cpu_a = [int(x) for x in rng.integers(0, 30, c)]
    cpu_v = [int(x) for x in rng.integers(-3, 25, c)]
    problems = []
    for i in range(n):
        p = random_problem(rng, c, f"ns-{i}/w-{i}", names)
        p.alloc, p.used = alloc, used
        p.cpu_alloc, p.cpu_avail = cpu_a, cpu_v
        problems.append(p)
    return problems


@pytest.mark.parametrize("c,k", [(3, 8), (8, 4), (19, 8), (19, 32)])
def test_pack_matches_jax_and_oracle(c, k):
    problems = _shared_problems(c, 4000 + c * 100 + k)
    planes = _planes(problems, c)
    got = TPipe.PackedRows(*(x.numpy() for x in _port_pack(planes, k)))
    _same_packed(got, JPipe.pack_rows(*planes, k))
    np.testing.assert_array_equal(
        TPipe.pack_wire(*(tensor(p, "cpu") for p in planes), k).numpy(),
        np.asarray(JPipe.pack_wire(*planes, k)),
    )
    keff = min(k, c)
    for i, prob in enumerate(problems):
        row = {name: getattr(got, name)[i].tolist() for name in got._fields}
        assert row == pack_one(prob, keff), (i, prob)


def test_wire_roundtrip():
    c, k = 8, 4
    planes = _planes(_shared_problems(c, 99, n=20), c)
    wire = TPipe.pack_wire(*(tensor(p, "cpu") for p in planes), k).numpy()
    assert wire.shape == (20, TPipe.wire_width(k)) and wire.dtype == np.int32
    unpacked = TPipe.unpack_wire(wire, k)
    direct = _port_pack(planes, k)
    for name in direct._fields:
        np.testing.assert_array_equal(getattr(unpacked, name), getattr(direct, name).numpy())


def _flat(rng, c, names, maxc):
    """Every cluster feasible with identical scores: the top-K cut is
    decided by the index tie-break alone."""
    p = random_problem(rng, c, "ns/tie", names)
    p.filter_enabled = [True] * 5
    p.score_enabled = [False] * 5
    p.api_ok = [True] * c
    p.taint_ok_new = [True] * c
    p.taint_ok_cur = [True] * c
    p.selector_ok = [True] * c
    p.placement_ok = [True] * c
    p.placement_has = False
    p.request = [0] * R
    p.max_clusters = maxc
    p.mode_divide = False
    p.sticky = False
    p.current = {}
    return p


def test_overflow_flag_and_boundary_ties():
    c, k = 12, 4
    rng = np.random.default_rng(0)
    names = [f"m-{j}" for j in range(c)]
    problems = [_flat(rng, c, names, maxc) for maxc in (4, 7, None, 0)]
    planes = _planes(problems, c)
    got = _port_pack(planes, k)
    _same_packed(TPipe.PackedRows(*(x.numpy() for x in got)), JPipe.pack_rows(*planes, k))
    assert got.nsel.tolist() == [4, 7, c, 0]
    # Ties broke by index; overflow rows keep their lowest indices.
    assert got.idx[0].tolist() == [0, 1, 2, 3]
    assert got.idx[1].tolist() == [0, 1, 2, 3]
    assert got.idx[3].tolist() == [TPipe.PACK_FILL] * k
    assert got.rsum[3][RSN.REASON_BITS.index(RSN.REASON_MAX_CLUSTERS)] == c


def test_zero_replica_rows_pack_empty():
    c, k = 6, 4
    rng = np.random.default_rng(1)
    p = _flat(rng, c, [f"m-{j}" for j in range(c)], None)
    p.mode_divide = True
    p.total = 0
    p.weights = {j: 1 for j in range(c)}
    p.min_replicas, p.max_replicas, p.capacity = {}, {}, {}
    planes = _planes([p], c)
    got = _port_pack(planes, k)
    _same_packed(TPipe.PackedRows(*(x.numpy() for x in got)), device_pack([p], c, k))
    assert int(got.nsel[0]) == 0
    assert got.idx[0].tolist() == [TPipe.PACK_FILL] * k
    assert int(got.rsum[0][RSN.REASON_BITS.index(RSN.REASON_ZERO_REPLICAS)]) == c


@pytest.mark.parametrize("c", [1, 31, 32, 33, 100])
def test_overflow_refetch_words_match_jax(c):
    rng = np.random.default_rng(c)
    n = 9
    sel = rng.random((n, c)) < 0.5
    sel[0] = True  # an all-ones word: bit 31 set
    cnt = sel & (rng.random((n, c)) < 0.5)
    rep = rng.integers(-1, 50, (n, c)).astype(np.int32)
    idx = np.array([3, 0, 8, 3])
    words = TEngine._bitpack_bool(tensor(sel, "cpu")).numpy()
    np.testing.assert_array_equal(words, np.asarray(JEngine._bitpack_bool(sel)))
    np.testing.assert_array_equal(TEngine._unpack_bits(words, c), sel.astype(np.uint8))
    got = TEngine._gather_overflow3(
        tensor(sel.astype(np.int8), "cpu"), tensor(cnt.astype(np.int8), "cpu"),
        tensor(rep, "cpu"), torch.from_numpy(idx),
    ).numpy()
    want = np.asarray(JEngine._gather_overflow3(sel.astype(np.int8), cnt.astype(np.int8), rep, idx))
    np.testing.assert_array_equal(got, want)
    s, r, k = TEngine.SchedulerEngine._split_overflow(got, c)
    np.testing.assert_array_equal(s, sel[idx].astype(np.uint8))
    np.testing.assert_array_equal(k, cnt[idx].astype(np.uint8))
    np.testing.assert_array_equal(r, rep[idx])
