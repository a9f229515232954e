"""The port's drift programs against the JAX package's, bit for bit.

Inputs are seeded numpy problems (``testing/problems.random_tick_inputs``
for the dense format, the port's compact featurization of seeded worlds
for the compact one); the previous tick's planes come from the port's
dense tick on the old cluster planes, so the stored feasibility, scores
and reasons are what an engine would hold.  A drift then moves the
cluster planes at D changed columns (D = 1 exactly, or padded to 8 or 16
slots with out-of-range indices):

* ``_stored_filters`` and ``_phase1_from_stored`` equal JAX's, and equal
  the port's ``phase1_plain`` on the new planes for every row whose
  stored reasons are trustworthy (not sticky-active);
* ``drift_gate_dense`` / ``drift_gate_compact``: the row mask and the
  stored score plane refreshed at the changed columns
  (``refresh_scores``) equal JAX's, over rows with finite, negative and
  unlimited maxClusters, sticky rows and fit flips on columns other
  filters already reject;
* ``drift_wcheck`` equals JAX's int64 and int32 programs;
* ``drift_survivor``: every output plane and the certificate.

Tolerance 0 everywhere (integer math).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_compact import rich_world
from test_torch_pipeline import same_planes

from kubeadmiral_tpu.ops import pipeline as JPipe
from kubeadmiral_tpu.ops.planner import INT32_INF
from kubeadmiral_tpu_torch.convert import tensor, to_device, to_numpy
from kubeadmiral_tpu_torch.ops import filters as F
from kubeadmiral_tpu_torch.ops import pipeline as TPipe
from kubeadmiral_tpu_torch.ops.phase1 import phase1_plain
from kubeadmiral_tpu_torch.scheduler import compact as TCmp
from kubeadmiral_tpu_torch.scheduler import featurize as TFeat
from kubeadmiral_tpu_torch.testing.problems import random_tick_inputs
from kubeadmiral_tpu_torch.testing.worlds import build_world

CLUSTER_ONLY = ("alloc", "used", "cpu_alloc", "cpu_avail", "cluster_valid")


def _t(x):
    return tensor(x, "cpu")


def _drifted(inp, rng, d_real):
    """New cluster planes at d_real random valid columns: used and
    alloc moved (fit flips both ways; the first column emptied), cpu
    figures moved at every other column.  Returns (new inputs, changed columns, cpu-changed flags)."""
    c = inp.cluster_valid.shape[0]
    valid_cols = np.nonzero(inp.cluster_valid)[0]
    cols = np.sort(rng.choice(valid_cols, d_real, replace=False))
    used = np.array(inp.used)
    alloc = np.array(inp.alloc)
    used[cols] = rng.integers(0, 50, (d_real, used.shape[1])) * (alloc[cols] // 50 + 1)
    used[cols[0]] = 0  # emptied: rows the old load rejected fit again
    alloc[cols[1::3]] += alloc[cols[1::3]] // 4
    cpu_avail = np.array(inp.cpu_avail)
    dcpu = np.zeros(c, bool)
    dcpu[cols[::2]] = True
    cpu_avail[cols[::2]] = rng.integers(-3, 25, cols[::2].size)
    new = inp._replace(used=used, alloc=alloc, cpu_avail=cpu_avail)
    return new, cols, dcpu[cols]


def _delta(old, new, cols, dcpu, nb):
    """The engine's delta arguments for the columns, padded to nb slots."""
    d_real = cols.size
    didx = np.full(nb, 1 << 30, np.int32)
    didx[:d_real] = cols
    dvalid = np.zeros(nb, bool)
    dvalid[:d_real] = True
    dflag = np.zeros(nb, bool)
    dflag[:d_real] = dcpu

    def sl(a):
        a = np.asarray(a)
        out = np.zeros((nb,) + a.shape[1:], a.dtype)
        out[:d_real] = a[cols]
        return out

    return (sl(old.alloc), sl(old.used), sl(new.alloc), sl(new.used), didx, dvalid, dflag)


def _fin_rows(max_clusters, b):
    mc = np.asarray(max_clusters)
    fin = np.nonzero((mc >= 0) & (mc < INT32_INF))[0]
    cap = max(64, b // 4)
    idx = np.full(cap if fin.size <= cap else b, 1 << 30, np.int32)
    idx[: fin.size] = fin
    return idx


def _gate_both(fmt, per_object, tables, prev, delta, fin_idx):
    """(JAX mask, JAX plane), (port mask, port refreshed plane)."""
    prev_feas, prev_scores, nfeas = prev
    args = (prev_feas, prev_scores) + delta + (fin_idx, nfeas)
    j_po = {k: jnp.asarray(v) for k, v in per_object.items()}
    t_po = {k: _t(v) for k, v in per_object.items()}
    if fmt == "compact":
        j_tab = {k: jnp.asarray(v) for k, v in tables.items()}
        t_tab = {k: _t(v) for k, v in tables.items()}
        jm, js = JPipe.drift_gate_compact(
            j_po, j_tab, *(jnp.asarray(a) for a in args), TCmp.CUR_ABSENT
        )
        tm, tcols = TPipe.drift_gate_compact(
            t_po, t_tab, *(_t(a) for a in args), TCmp.CUR_ABSENT
        )
    else:
        jm, js = JPipe.drift_gate_dense(j_po, *(jnp.asarray(a) for a in args))
        tm, tcols = TPipe.drift_gate_dense(t_po, *(_t(a) for a in args))
    didx, dvalid = delta[4], delta[5]
    scores = _t(prev_scores)
    TPipe.refresh_scores(scores, _t(didx[dvalid].astype(np.int64)), tcols)
    assert tm.dtype == torch.int8 and tcols.dtype == torch.int32
    return (np.asarray(jm), np.asarray(js)), (tm.numpy(), scores.numpy())


def _prev_planes(tick_inputs_np):
    out = to_numpy(TPipe.schedule_tick(to_device(tick_inputs_np, "cpu")))
    nfeas = (out.feasible != 0).sum(axis=1).astype(np.int32)
    return out, (out.feasible, out.scores, nfeas)


def _dense_case(b, c, d_real, seed):
    old = random_tick_inputs(b, c, 3, webhook=True, invalid=2, seed=seed)
    new, cols, dcpu = _drifted(old, np.random.default_rng(seed + 100), d_real)
    return old, new, cols, dcpu


GATE_CASES = [
    # (b, c, changed columns, delta slots, seed)
    (72, 24, 1, 1, 0),
    (72, 24, 1, 8, 1),   # one column in the padded bucket
    (72, 24, 5, 8, 2),
    (96, 40, 8, 8, 3),
    (64, 40, 12, 16, 4),  # past DRIFT_REFINE_MAX_COLS: the conservative rule
]


def _dense_gate(b, c, d_real, nb, seed):
    old, new, cols, dcpu = _dense_case(b, c, d_real, seed)
    out, prev = _prev_planes(old)
    per_object = {k: np.asarray(v) for k, v in new._asdict().items() if k not in CLUSTER_ONLY}
    delta = _delta(old, new, cols, dcpu, nb)
    fin_idx = _fin_rows(new.max_clusters, b)
    return old, new, cols, out, _gate_both("dense", per_object, None, prev, delta, fin_idx)


@pytest.mark.parametrize("b,c,d_real,nb,seed", GATE_CASES)
def test_gate_dense_matches_jax(b, c, d_real, nb, seed):
    _old, new, _cols, _out, ((jm, js), (tm, ts)) = _dense_gate(b, c, d_real, nb, seed)
    np.testing.assert_array_equal(tm, jm)
    np.testing.assert_array_equal(ts, js)
    mc = np.asarray(new.max_clusters)
    assert ((mc >= 0) & (mc < INT32_INF)).any() and (mc < 0).any() and (mc == INT32_INF).any()
    assert np.asarray(new.sticky).any()


def test_gate_cases_cover_every_class():
    """Over GATE_CASES the gate sees every row class (skip, recompute,
    weight check, fit flip), recomputes finite-K rows, and meets fit
    flips on columns that other filters already reject."""
    seen, fin_recompute, flip_on_rejected = set(), False, False
    for case in GATE_CASES:
        old, new, cols, out, (_j, (tm, _ts)) = _dense_gate(*case)
        seen.update({0} if (tm == 0).any() else set())
        seen.update(bit for bit in (1, 2, 4) if (tm & bit).any())
        mc = np.asarray(new.max_clusters)
        fin = (mc >= 0) & (mc < INT32_INF)
        fin_recompute |= bool(((tm & TPipe.DRIFT_RECOMPUTE) != 0)[fin].any())
        fit_old = F.resources_fit(_t(old.request), _t(old.alloc), _t(old.used)).numpy()
        fit_new = F.resources_fit(_t(new.request), _t(new.alloc), _t(new.used)).numpy()
        flipped = (fit_old != fit_new)[:, cols]
        rejected = (out.reasons[:, cols] & TPipe._NONFIT_BLOCK) != 0
        flip_on_rejected |= bool((flipped & rejected).any())
    assert seen == {0, 1, 2, 4}
    assert fin_recompute and flip_on_rejected


def test_gate_dense_wcheck_and_refinement_engage():
    """A cpu-only drift at one column: no fit moves, so kinf dynamic-
    weight Divide rows go to the weight check and finite-K rows are
    decided by the exact rank refinement."""
    b, c = 96, 24
    old = random_tick_inputs(b, c, 3, seed=11)
    cpu_avail = np.array(old.cpu_avail)
    col = int(np.argmax(np.asarray(old.cluster_valid) & (cpu_avail > 5)))
    cpu_avail[col] -= 4
    new = old._replace(cpu_avail=cpu_avail)
    _out, prev = _prev_planes(old)
    per_object = {k: np.asarray(v) for k, v in new._asdict().items() if k not in CLUSTER_ONLY}
    cols = np.asarray([col])
    for nb in (1, 8):
        delta = _delta(old, new, cols, np.asarray([True]), nb)
        (jm, js), (tm, ts) = _gate_both(
            "dense", per_object, None, prev, delta, _fin_rows(new.max_clusters, b)
        )
        np.testing.assert_array_equal(tm, jm)
        np.testing.assert_array_equal(ts, js)
        assert (tm & TPipe.DRIFT_WCHECK).any()
        assert not (tm & TPipe.DRIFT_FITFLIP).any()


def _compact_case(config, n, c, seed, d_real):
    if config == "rich":
        units, clusters = rich_world(b=n, c=c, seed=seed)
    else:
        units, clusters, _ = build_world(n, c, config, seed=seed)
    view = TFeat._build_cluster_view(clusters, units)
    vocab = TCmp.CompactVocab(view)
    ci = TCmp.featurize_compact(units, view, vocab)
    tables = {k: np.asarray(v) for k, v in TCmp.pad_tables(vocab.tables(), c).items()}
    old_tick = TPipe.expand_compact(to_device(ci, "cpu"))
    old = to_numpy(old_tick)
    new, cols, dcpu = _drifted(old, np.random.default_rng(seed + 7), d_real)
    per_object = {k: np.asarray(getattr(ci, k)) for k in TCmp.PER_OBJECT_FIELDS}
    return per_object, tables, old, new, cols, dcpu


@pytest.mark.parametrize(
    "config,n,c,seed,d_real,nb",
    [("rich", 64, 14, 7, 1, 1), ("rich", 64, 14, 3, 3, 8), ("3", 80, 23, 2, 1, 8),
     ("5", 80, 23, 2, 6, 8), ("5", 80, 40, 5, 10, 16)],
)
def test_gate_compact_matches_jax(config, n, c, seed, d_real, nb):
    per_object, tables, old, new, cols, dcpu = _compact_case(config, n, c, seed, d_real)
    _out, prev = _prev_planes(old)
    delta = _delta(old, new, cols, dcpu, nb)
    fin_idx = _fin_rows(per_object["max_clusters"], n)
    (jm, js), (tm, ts) = _gate_both("compact", per_object, tables, prev, delta, fin_idx)
    np.testing.assert_array_equal(tm, jm)
    np.testing.assert_array_equal(ts, js)
    # The compact gate classifies like the dense gate on the expanded
    # planes of the same rows.
    dense_po = {k: np.asarray(v) for k, v in new._asdict().items() if k not in CLUSTER_ONLY}
    (dm, _), _ = _gate_both("dense", dense_po, None, prev, delta, fin_idx)
    np.testing.assert_array_equal(tm, dm)


@pytest.mark.parametrize("b,c,d_real,nb,seed", GATE_CASES[:3])
def test_stored_phase1_matches_jax_and_plain(b, c, d_real, nb, seed):
    old, new, _cols, _dcpu = _dense_case(b, c, d_real, seed)
    out, _prev = _prev_planes(old)
    new_t = to_device(new, "cpu")
    got_f, got_r = TPipe._stored_filters(new_t, _t(out.reasons))
    want_f, want_r = JPipe._stored_filters(new, jnp.asarray(out.reasons))
    np.testing.assert_array_equal(got_f.numpy(), np.asarray(want_f))
    np.testing.assert_array_equal(got_r.numpy(), np.asarray(want_r))
    got = TPipe._phase1_from_stored(new_t, _t(out.reasons))
    want = JPipe._phase1_from_stored(new, jnp.asarray(out.reasons))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    # Rows whose stored reasons are trustworthy rebuild phase 1 exactly.
    plain = phase1_plain(new_t)
    trust = ~(np.asarray(new.sticky) & np.asarray(new.current_mask).any(axis=1))
    assert trust.any() and not trust.all()
    for g, p in zip(got, plain):
        np.testing.assert_array_equal(g.numpy()[trust], p.numpy()[trust])


@pytest.mark.parametrize("scale", [1, 1000])
def test_wcheck_matches_jax_int64_and_int32(scale):
    b, c = 80, 24
    rng = np.random.default_rng(scale)
    prev_feas = (rng.random((b, c)) < 0.6).astype(np.int8)
    rows = np.zeros(128, np.int32)
    rows[:70] = rng.choice(b, 70, replace=False)
    ao = rng.integers(0, 30, c).astype(np.int64) * scale
    vo = rng.integers(-3, 25, c).astype(np.int64) * scale
    an, vn = ao.copy(), vo.copy()
    vn[rng.choice(c, 3, replace=False)] -= 2 * scale
    got = TPipe.drift_wcheck(_t(prev_feas), _t(rows.astype(np.int64)), _t(ao), _t(vo), _t(an), _t(vn))
    assert got.dtype == torch.int8
    jargs = [jnp.asarray(a) for a in (prev_feas, rows, ao, vo, an, vn)]
    for dtype in (jnp.int64, jnp.int32):
        want = JPipe.drift_wcheck(*jargs, compute_dtype=dtype)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert got.numpy().any() and not got.numpy().all()


@pytest.mark.parametrize("m,i32_keys", [(8, False), (8, True), (16, True), (64, False)])
@pytest.mark.parametrize("seed", [0, 1])
def test_survivor_matches_jax(m, i32_keys, seed):
    b, c = 64, 40
    old, new, _cols, _dcpu = _dense_case(b, c, 4, seed + 20)
    out, _prev = _prev_planes(old)
    got, cert = TPipe.drift_survivor(to_device(new, "cpu"), _t(out.reasons), m, i32_keys)
    want, want_cert = JPipe.drift_survivor(new, jnp.asarray(out.reasons), m, i32_keys=i32_keys)
    same_planes(to_numpy(got), want, f"survivor m={m}")
    assert cert.dtype == torch.int8
    np.testing.assert_array_equal(cert.numpy(), np.asarray(want_cert))
    sticky = np.asarray(new.sticky) & np.asarray(new.current_mask).any(axis=1)
    assert sticky.any() and not cert.numpy()[sticky].any()
    # Certified rows equal the dense tick on the new planes.
    dense = to_numpy(TPipe.schedule_tick(to_device(new, "cpu")))
    ok = cert.numpy() != 0
    assert ok.any()
    for name in ("selected", "replicas", "counted", "feasible", "reasons"):
        np.testing.assert_array_equal(
            getattr(to_numpy(got), name)[ok], getattr(dense, name)[ok], name
        )
