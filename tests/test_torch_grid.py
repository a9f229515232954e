"""The port's clusters axis: every [B, C] plane split by columns.

Under a mesh of shape (No, Nc) with Nc > 1 each entry (i, j) holds its
column block of every resident [B, C] plane (``GridShards``) and runs
the tick's cell-local work there; the per-row reductions, merges and
the planner's scans run on entry (i, 0) over the blocks' small
partials (``ops/split.py``).  These tests hold:

* the split pair's plain twins (``phase1_partial_plain`` then
  ``phase1_finish_plain``) over 2, 3 and 4 column blocks against
  ``phase1_plain``, the JAX package's ``_phase1`` and its Pallas kernel
  in interpret mode, on test_torch_phase1.py's cases and kernel edges,
  a row whose feasible columns all lie in one block, a row whose taint
  maximum is 0 in every block, rows whose maxima are negative in every
  block and rows that score neither normalised plugin;
* the dynamic weights' split stages against ``dynamic_weights`` and
  the JAX package's;
* each split program (the narrow tick, the packed wire, the diff, the
  feasible counts, the f16 compression, the drift gate) against its
  unsplit counterpart on whole rows;
* (the engine chain against the JAX engine on a mesh of the same
  shape, and the opt-in switches, are in test_torch_grid_chain.py);
* where the state lies: every cached [B, C] plane a piece per entry of
  C / Nc columns on its device, each entry's previous planes the
  family's total / (No * Nc) at every tick, and no cell-local, per-row
  reduction or merge program handed a whole [rows, C] plane (the mesh
  runners wrapped); whole-row programs only at their sites;
* the bookkeeping (``resident_state_bytes`` keyed by entry, the
  census's ``validate``) and the snapshots (the payload the unmeshed
  engine's byte for byte; restored into the same mesh, rejected by
  another).
"""

from __future__ import annotations

import pathlib
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))

from kubeadmiral_tpu.ops import pallas_slab as ps  # noqa: E402
from kubeadmiral_tpu.ops import pipeline as jax_pipeline  # noqa: E402
from kubeadmiral_tpu.ops import weights as jax_weights  # noqa: E402
from kubeadmiral_tpu_torch.convert import to_device  # noqa: E402
from kubeadmiral_tpu_torch.ops import phase1 as P  # noqa: E402
from kubeadmiral_tpu_torch.ops import pipeline as TP  # noqa: E402
from kubeadmiral_tpu_torch.ops import scores as S  # noqa: E402
from kubeadmiral_tpu_torch.ops import split as SP  # noqa: E402
from kubeadmiral_tpu_torch.ops import weights as W  # noqa: E402
from kubeadmiral_tpu_torch.parallel import mesh as M  # noqa: E402
from kubeadmiral_tpu_torch.runtime import census  # noqa: E402
from kubeadmiral_tpu_torch.scheduler import engine as engine_mod  # noqa: E402
from kubeadmiral_tpu_torch.scheduler.engine import SchedulerEngine  # noqa: E402
from kubeadmiral_tpu_torch.testing.problems import (  # noqa: E402
    EDGE_SHAPES,
    edge_tick_inputs,
    split_edge_inputs,
)

from __graft_entry__ import _example_batch  # noqa: E402
from test_multidevice import _world  # noqa: E402
from test_torch_multidevice import COUNTERS, _zero_chain  # noqa: E402
from test_torch_phase1 import CASES, _random_inputs  # noqa: E402

PLANES = ("feasible", "reasons", "totals")
SCORE_PLANES = ("taint_counts", "affinity_scores", "webhook_scores")


# -- the split pair -------------------------------------------------------------
def _blocks(inp, nb):
    """Torch TickInputs cut into ``nb`` column blocks (col_bounds)."""
    c = inp.api_ok.shape[1]
    out = []
    for c0, c1 in M.col_bounds(c, nb):
        fields = {}
        for name, v in inp._asdict().items():
            spec = M._FIELD_SPECS[name]
            if M.CLUSTERS in spec:
                v = v.narrow(spec.index(M.CLUSTERS), c0, c1 - c0)
            fields[name] = v
        out.append(inp._replace(**fields))
    return out


def _split_phase1(inp, nb):
    """The plain split pair composed over ``nb`` column blocks."""
    blocks = _blocks(inp, nb)
    parts = [P.phase1_partial_plain(b) for b in blocks]
    maxima = TP.reduce_blocks([p[3] for p in parts], "max")
    totals = [
        P.phase1_finish_plain(p[0], b.score_enabled, b.taint_counts, b.affinity_scores,
                              maxima, p[2])
        for p, b in zip(parts, blocks)
    ]
    return (torch.cat([p[0] for p in parts], 1), torch.cat([p[1] for p in parts], 1),
            torch.cat(totals, 1))


def _assert_planes(got, ref, which):
    for name, g, r in zip(PLANES, got, ref):
        g, r = g.numpy(), np.asarray(r)
        assert g.dtype == r.dtype, f"{name} vs {which}: {g.dtype} != {r.dtype}"
        assert np.array_equal(g, r), f"{name} differs from {which}"


def _pair_against_references(inp):
    """Hold the composed pair over 2, 3 and 4 blocks against
    phase1_plain and XLA on ``inp``, and against the Pallas kernel on its
    int64-widened planes (as test_torch_phase1.py runs it)."""
    xla = jax_pipeline._phase1(inp)
    plain = P.phase1_plain(to_device(inp, "cpu"))
    wide = inp._replace(**{k: np.asarray(getattr(inp, k)).astype(np.int64)
                           for k in SCORE_PLANES})
    pallas = ps.phase1_slab(wide, interpret=True)
    for nb in (2, 3, 4):
        got = _split_phase1(to_device(inp, "cpu"), nb)
        for g, w in zip(got, plain):
            assert torch.equal(g, w), nb
        _assert_planes(got, xla, f"xla over {nb} blocks")
        _assert_planes(_split_phase1(to_device(wide, "cpu"), nb), pallas,
                       f"pallas over {nb} blocks")


@pytest.mark.parametrize("b,c,webhook,invalid,int32,scale", CASES)
def test_split_pair_composes_to_phase1(b, c, webhook, invalid, int32, scale):
    _pair_against_references(_random_inputs(b, c, webhook, invalid, int32, scale))


# The kernel's edges JAX's interpret mode runs quickly, and the one-column
# case: over 2-4 blocks some blocks hold no column (their maxima must not
# count in the rows' maxima).
SPLIT_EDGES = list(EDGE_SHAPES[:5]) + [e for e in EDGE_SHAPES if e[1] == 1]


@pytest.mark.parametrize("b,c,r,invalid,seed", SPLIT_EDGES)
def test_split_pair_composes_on_kernel_edges(b, c, r, invalid, seed):
    _pair_against_references(edge_tick_inputs(b, c, r, invalid, seed))


def test_split_pair_rows_across_blocks():
    """Row 0's feasible columns all lie in the first block; row 1's
    taint counts are 0 on every feasible column (its maximum is 0 in
    every block: taint scores 100 everywhere); row 2's affinity maximum
    lies in the last block only."""
    inp = _random_inputs(16, 24, False, 0, True, False)
    api = np.array(inp.api_ok)
    api[0, 6:] = False
    api[0, :6] = True
    taint = np.array(inp.taint_counts)
    taint[1] = 0
    aff = np.array(inp.affinity_scores)
    aff[2] = 1
    aff[2, -1] = 50
    se = np.array(inp.score_enabled)
    se[:3] = True
    fe = np.array(inp.filter_enabled)
    fe[:3] = False
    fe[0, 0] = True  # row 0: the API filter alone
    inp = inp._replace(api_ok=api, taint_counts=taint, affinity_scores=aff,
                       score_enabled=se, filter_enabled=fe)
    feas = P.phase1_plain(to_device(inp, "cpu"))[0].numpy()
    assert feas[0, :6].all() and not feas[0, 6:].any() and feas[1].any()
    _pair_against_references(inp)
    parts = P.phase1_partial_plain(_blocks(to_device(inp, "cpu"), 4)[1])
    assert int(parts[3][0, 0]) == 0 and int(parts[3][1, 0]) == 0


@pytest.mark.parametrize("b,c,seed", [(21, 24, 0), (13, 33, 1), (1, 40, 2)])
def test_split_pair_negative_maxima_and_unscored_rows(b, c, seed):
    """Rows whose every cell is feasible, with affinity values all below
    0 (their maxima are negative in every block, so a block's maxima must
    start below any value, not at 0), and rows that score neither
    normalised plugin (their maxima are 0)."""
    inp = split_edge_inputs(b, c, 3, seed)
    feas, _, _, maxima = P.phase1_partial_plain(to_device(inp, "cpu"))
    negative = feas.all(1) & (maxima[:, 1] < 0)
    assert negative.any()
    se = torch.from_numpy(np.asarray(inp.score_enabled))
    unscored = ~se[:, S.S_TAINT] & ~se[:, S.S_AFFINITY]
    assert (maxima[unscored] == 0).all() and (unscored.any() or b == 1)
    for part in _blocks(to_device(inp, "cpu"), 4):
        if part.api_ok.shape[1]:
            assert (P.phase1_partial_plain(part)[3][negative, 1] < 0).all()
    _pair_against_references(inp)


def test_split_weights_compose():
    """The dynamic weights' split stages over 1, 2, 3 and 5 column
    blocks equal dynamic_weights and the JAX package's."""
    rng = np.random.default_rng(5)
    b, c = 40, 30
    sel = rng.random((b, c)) < 0.3
    sel[0] = False
    sel[1, 7] = True
    cpu_alloc = rng.integers(0, 64, c).astype(np.int64)
    cpu_avail = rng.integers(-8, 40, c).astype(np.int64)
    cpu_avail[:4] = 0
    sel_t, alloc_t, avail_t = (torch.from_numpy(x) for x in (sel, cpu_alloc, cpu_avail))
    want = W.dynamic_weights(sel_t, alloc_t, avail_t)
    ref = np.asarray(jax_weights.dynamic_weights(sel, cpu_alloc, cpu_avail))
    assert np.array_equal(want.numpy(), ref)
    for nb in (1, 2, 3, 5):
        cols = M.col_bounds(c, nb)
        blk = [(sel_t[:, a:z], alloc_t[a:z], avail_t[a:z], a) for a, z in cols]
        sums = TP.reduce_blocks([W.weight_sums(s, al, av) for s, al, av, _ in blk], "sum")
        tmps = [W.weight_shares(s, al, av, sums) for s, al, av, _ in blk]
        tmp_sum = TP.reduce_blocks([t.sum(dim=-1) for t in tmps], "sum")
        rounded = [W.weight_round(t, tmp_sum, s) for t, (s, *_r) in zip(tmps, blk)]
        peaks = [W.weight_peak(w, s, a) for w, (s, _al, _av, a) in zip(rounded, blk)]
        residual, max_w, first = W.combine_peaks(peaks)
        got = torch.cat([W.weight_residual(w, residual, max_w, first, a)
                         for w, (_s, _al, _av, a) in zip(rounded, blk)], 1)
        assert torch.equal(got, want), nb


# -- the split programs -------------------------------------------------------
def _grid_inputs(mesh, inp):
    """Torch TickInputs laid out as the engine lays them on a grid: the
    [B, C] planes as GridShards, the per-row fields as RowShards, the
    cluster tables whole."""
    out = {}
    for name, v in inp._asdict().items():
        spec = M._FIELD_SPECS[name]
        if spec == (M.OBJECTS, M.CLUSTERS):
            out[name] = M.GridShards.from_host(mesh, v.numpy())
        elif spec[:1] == (M.OBJECTS,):
            out[name] = M.RowShards.from_host(mesh, v.numpy())
        else:
            out[name] = v
    return type(inp)(**out)


GRID_CASES = [(32, 16, 1, 2), (32, 16, 2, 2), (48, 40, 1, 4), (64, 128, 2, 4), (20, 24, 2, 3)]


@pytest.mark.parametrize("b,c,no,nc", GRID_CASES)
def test_split_programs_match_unsplit(b, c, no, nc):
    inp = to_device(_example_batch(b=b, c=c), "cpu")
    mesh = M.make_mesh(["cpu"] * (no * nc), objects_axis=no)
    g = _grid_inputs(mesh, inp)
    for m, i32 in ((4, True), (8, False)):
        ref, rcert = TP.schedule_tick_narrow(inp, m, i32_keys=i32)
        out, cert, unsettled = SP.grid_tick_narrow(mesh, g, "dense", c, m, i32)
        assert unsettled is None
        for name in TP.TickOutputs._fields:
            plane = getattr(out, name)
            assert isinstance(plane, M.GridShards) and len(plane.pieces[0]) == nc
            assert np.array_equal(plane.numpy(), getattr(ref, name).numpy()), (name, m)
        assert np.array_equal(cert.numpy(), rcert.numpy())
    planes = tuple(getattr(out, k) for k in ("selected", "replicas", "counted", "scores",
                                             "reasons"))
    ref_planes = tuple(getattr(ref, k) for k in ("selected", "replicas", "counted", "scores",
                                                 "reasons"))
    for k in (4, 16):
        assert np.array_equal(SP.grid_pack_wire(mesh, planes, k).numpy(),
                              TP.pack_wire(*ref_planes, k).numpy())
    moved = out.scores.map(lambda t: t + (t % 3 == 0).to(t.dtype))
    flip = out.replicas.map(lambda t: torch.where(t % 5 == 1, t + 1, t))

    def diff(sel, rep, cnt, sco, psel, prep, pcnt, psco):
        place = ((sel != psel) | (rep != prep) | (cnt != pcnt)).any(dim=1)
        return place.to(torch.int8) + 2 * (sco != psco).any(dim=1).to(torch.int8)

    got = SP.grid_reduce_rows(mesh, diff, planes[:3] + (out.scores, out.selected, flip,
                                                       out.counted, moved), "any").numpy()
    place = (ref.replicas != torch.where(ref.replicas % 5 == 1, ref.replicas + 1,
                                         ref.replicas)).any(1)
    score = (ref.scores != ref.scores + (ref.scores % 3 == 0).to(ref.scores.dtype)).any(1)
    assert np.array_equal(got, (place.to(torch.int8) + 2 * score.to(torch.int8)).numpy())
    assert np.array_equal(
        SP.grid_reduce_rows(mesh, engine_mod._feasible_counts, (out.feasible,), "sum").numpy(),
        (ref.feasible != 0).sum(1, dtype=torch.int32).numpy(),
    )
    # Odd rows scaled past f16's integers: those with a score lose it.
    scale = torch.where(torch.arange(b) % 2 == 1, 4099, 1).to(torch.int32)[:, None]
    scaled = M.GridShards.from_host(mesh, (ref.scores * scale).numpy())
    f16 = SP.grid_map(mesh, lambda s: s.to(torch.float16), (scaled,))
    exact = SP.grid_reduce_rows(mesh, TP.exact_rows, (scaled,), "all")
    rf16, rexact = TP.compress_scores(ref.scores * scale)
    assert np.array_equal(f16.numpy(), rf16.numpy())
    assert np.array_equal(exact.numpy(), rexact.numpy()) and 0 < rexact.sum() < b
    assert np.array_equal(SP.grid_map(mesh, TP.upcast_scores, (f16,)).numpy(),
                          TP.upcast_scores(rf16).numpy())


@pytest.mark.parametrize("b,c,no,nc,d", [(48, 40, 2, 2, 3), (64, 128, 1, 4, 8),
                                         (32, 16, 2, 2, 16)])
def test_split_drift_gate_matches_unsplit(b, c, no, nc, d):
    """The dense gate over grid planes equals drift_gate_dense: the
    exact refinement (D <= DRIFT_REFINE_MAX_COLS) and the conservative
    rule past it."""
    rng = np.random.default_rng(b + c + d)
    inp = to_device(_example_batch(b=b, c=c), "cpu")
    out = TP.schedule_tick(inp)
    cols = np.sort(rng.choice(c, size=min(d, c), replace=False))
    didx = np.full(d, 1 << 30, np.int32)
    didx[: cols.size] = cols
    dvalid = np.zeros(d, bool)
    dvalid[: cols.size] = True
    dcpu = dvalid & (rng.random(d) < 0.5)
    alloc, used = inp.alloc.numpy(), inp.used.numpy()
    take = np.clip(didx, 0, c - 1)
    delta = (
        torch.from_numpy(alloc[take]), torch.from_numpy(used[take]),
        torch.from_numpy(alloc[take] // 2), torch.from_numpy(used[take] * 2),
        torch.from_numpy(didx), torch.from_numpy(dvalid), torch.from_numpy(dcpu),
    )
    mc = inp.max_clusters.numpy()
    fin_rows = np.nonzero((mc >= 0) & (mc < int(TP._INF)))[0]
    fin = np.full(max(64, fin_rows.size), 1 << 30, np.int32)
    fin[: fin_rows.size] = fin_rows
    nfeas = (out.feasible != 0).sum(1, dtype=torch.int32)
    per_object = {name: getattr(inp, name) for name in inp._fields
                  if M._FIELD_SPECS[name][:1] == (M.OBJECTS,)}
    want = TP.drift_gate_dense(per_object, out.feasible, out.scores, *delta[:4], *delta[4:],
                               torch.from_numpy(fin), nfeas)
    mesh = M.make_mesh(["cpu"] * (no * nc), objects_axis=no)
    g = _grid_inputs(mesh, inp)
    got = SP.grid_drift_gate(
        mesh, "dense", {name: getattr(g, name) for name in per_object},
        M.GridShards.from_host(mesh, out.feasible.numpy()),
        M.GridShards.from_host(mesh, out.scores.numpy()),
        M.RowShards.from_host(mesh, nfeas.numpy()), torch.from_numpy(fin), delta,
    )
    assert np.array_equal(got[0].numpy(), want[0].numpy())
    assert np.array_equal(got[1].numpy(), want[1].numpy())
    assert (want[0].numpy() != 0).any()


# -- the engine on a grid -----------------------------------------------------
def _port(shape, rec=None, **kw):
    mesh = None if shape is None else M.make_mesh(["cpu"] * (shape[0] * shape[1]),
                                                  objects_axis=shape[0])
    return SchedulerEngine(device="cpu", mesh=mesh, min_bucket=32, narrow_m=8,
                           flight_recorder=rec, devprof=None, **kw)


# Whole-row programs (kind 4) and where they run.
KIND4_SITES = {"_apply_cert_fallback", "_run_group", "_drain_drift_gates",
               "_fetch_overflow_window", "_gather_planes", "_tick"}


def _entry_tensors(entry) -> dict:
    found = {f"prev_out[{k}]": t for k, t in enumerate(entry.prev_out or ())}
    found.update(prev_feas=entry.prev_feas, prev_reasons=entry.prev_reasons,
                 prev_nfeas=entry.prev_nfeas, prev_sco_exact=entry.prev_sco_exact)
    found.update({f"per_object.{k}": t for k, t in (entry.device_per_object or {}).items()})
    return {k: t for k, t in found.items() if t is not None}


def _assert_on_entries(engine, label):
    """Every cached [B, C] plane is a GridShards with piece (i, j) of
    C / Nc columns on entry (i, j); every per-row input a RowReplicas
    with a copy of its rows on each entry (i, j); every other tensor a
    RowShards on the lanes."""
    no, nc = engine.mesh.shape
    for idx, entry in engine._chunk_cache.items():
        b_pad, c_pad = entry.padded_shape[:2]
        for name, t in _entry_tensors(entry).items():
            where = (label, idx, name)
            if isinstance(t, M.GridShards):
                assert t.bounds == M.row_bounds(b_pad, no), where
                assert t.cols == M.col_bounds(c_pad, nc), where
                for i, row in enumerate(t.pieces):
                    for j, piece in enumerate(row):
                        lo, hi = t.bounds[i]
                        c0, c1 = t.cols[j]
                        assert tuple(piece.shape) == (hi - lo, c1 - c0), where
                        assert piece.device == engine.mesh.devices[i, j], where
            else:
                assert isinstance(t, M.RowShards), where
                assert t.bounds == M.row_bounds(b_pad, no), where
                assert t.pieces[0].shape[1:] != (c_pad,), where
                assert isinstance(t, M.RowReplicas) == name.startswith("per_object."), where
            if isinstance(t, M.RowReplicas):
                assert len(t.copies) == nc, where
                for j, copy in enumerate(t.copies):
                    for i, piece in enumerate(copy):
                        lo, hi = t.bounds[i]
                        assert piece.shape == t.pieces[i].shape, where
                        assert piece.device == engine.mesh.devices[i, j], where
                        assert torch.equal(piece, t.pieces[i]), where
        for name in ("prev_out[0]", "prev_out[3]", "prev_feas", "prev_reasons"):
            assert isinstance(_entry_tensors(entry)[name], M.GridShards), (label, name)


def _tensors(value) -> list:
    if isinstance(value, dict):
        value = tuple(value.values())
    if isinstance(value, (tuple, list)):
        return [t for v in value for t in _tensors(v)]
    return [value] if isinstance(value, torch.Tensor) else []


def _checked_runners(monkeypatch, c_full: int):
    """The mesh runners wrapped: no cell-local program (``run_grid``)
    and no per-row reduction or merge (``run_rows``) is handed a whole
    [rows, C] plane (a tensor C columns wide) or a grid holder whole;
    whole-row programs (``run_whole``) run only at KIND4_SITES.
    Returns the calls by runner, the kind-4 sites seen and the ids of
    the tensors a cell-local program had moved to its entry."""
    calls = {"run_grid": 0, "run_rows": 0, "run_whole": 0}
    sites: set = set()
    moved: set = set()
    real_place = M._place

    def place(t, device, stream):
        if calls.get("in_grid"):
            moved.add(id(t))
        return real_place(t, device, stream)

    def refuse(where, args):
        for t in _tensors(list(args)):
            assert not (t.dim() >= 2 and t.shape[1] == c_full), (where, tuple(t.shape))

    real_grid, real_rows, real_whole = M.run_grid, M.run_rows, engine_mod.run_whole

    def run_grid(mesh, fn, c, *args):
        calls["run_grid"] += 1
        calls["in_grid"] = True
        try:
            return real_grid(mesh, lambda cell, *p: (refuse("run_grid", p), fn(cell, *p))[1],
                             c, *args)
        finally:
            calls["in_grid"] = False

    def run_rows(mesh, fn, rows, whole=(), bounds=False, **kw):
        calls["run_rows"] += 1
        assert not any(isinstance(h, M.GridShards) for a in rows for h in M._holders(a, []))

        def checked(*p, **k):
            refuse("run_rows", p)
            return fn(*p, **k)

        return real_rows(mesh, checked, rows, whole, bounds=bounds, **kw)

    def run_whole(mesh, fn, rows, whole=(), cols=None, bounds=False, **kw):
        import traceback

        calls["run_whole"] += 1
        sites.add(traceback.extract_stack()[-3].name)
        return real_whole(mesh, fn, rows, whole, cols=cols, bounds=bounds, **kw)

    for mod in (SP, engine_mod):
        monkeypatch.setattr(mod, "run_rows", run_rows)
    monkeypatch.setattr(SP, "run_grid", run_grid)
    monkeypatch.setattr(engine_mod, "run_whole", run_whole)
    monkeypatch.setattr(M, "_place", place)
    return calls, sites, moved


@pytest.mark.parametrize("shape", [(2, 2), (1, 4)])
def test_state_stays_on_its_entries(shape, monkeypatch):
    """Through the zero chain on a 128-column world, every cached [B, C]
    plane lies on its entries, each entry's previous planes are the
    family's total / (No * Nc), results and counters equal the unmeshed
    port, no cell-local or per-row program sees a whole [rows, C] plane
    and the whole-row programs run only at their sites (the dense
    re-solve under ``_tick`` never: the default path is narrow), and no
    cell-local program moves a resident per-row input to its entry (each
    reads its own copy)."""
    units, clusters = _world(b=96, c=128)
    grid, single = _port(shape), _port(None)
    no, nc = shape
    calls, sites, moved = _checked_runners(monkeypatch, 128)
    for label, batch, cl in _zero_chain(units, clusters):
        moved.clear()
        assert grid.schedule(batch, cl) == single.schedule(batch, cl), label
        lanes = {id(p) for e in grid._chunk_cache.values()
                 for t in (e.device_per_object or {}).values()
                 if isinstance(t, M.RowReplicas) for p in t.pieces}
        assert lanes and not (moved & lanes), label
        for name in COUNTERS:
            assert getattr(grid, name) == getattr(single, name), (label, name)
        _assert_on_entries(grid, label)
        mine, one = grid.resident_state_bytes(), single.resident_state_bytes()
        assert mine["by_family"] == one["by_family"], label
        share = one["by_family"]["prev_planes"] // (no * nc)
        assert len(mine["prev_planes_by_device"]) == no * nc
        assert set(mine["prev_planes_by_device"].values()) == {share}, label
    assert calls["run_grid"] > 0 and calls["run_rows"] > 0
    assert sites <= KIND4_SITES - {"_tick", "_gather_planes"}, sites
    assert grid.drift_stats["unified"] + grid.drift_stats["unified_fallback"] > 0


def test_resident_bytes_and_census_by_entry():
    units, clusters = _world()
    grid, single = _port((2, 2)), _port(None)
    grid.schedule(units, clusters)
    single.schedule(units, clusters)
    got, one = grid.resident_state_bytes(), single.resident_state_bytes()
    assert got["by_family"] == one["by_family"] and got["total"] == one["total"]
    labels = [f"cpu/{i}.{j}" for i in range(2) for j in range(2)]
    prev, inputs, vectors = (got["by_family"][f] for f in ("prev_planes", "per_object",
                                                            "vectors"))
    # The per-row inputs on both entries of their row, the vectors on (i, 0).
    assert sorted(got["by_device"]) == labels
    assert sum(got["by_device"].values()) == got["total"] + inputs
    assert got["prev_planes_by_device"] == {k: prev // 4 for k in labels}
    for k in labels:
        want = prev // 4 + inputs // 2 + (vectors // 2 if k.endswith(".0") else 0)
        assert got["by_device"][k] == want, k
    assert got["per_device"] == max(got["by_device"].values())
    assert got["device_count"] == 2
    checked = census.validate(256, 64, device="cpu",
                              mesh=M.make_mesh(["cpu"] * 4, objects_axis=2))
    assert checked["ok"] and sorted(checked["live_by_lane"]) == labels


def test_snapshot_on_a_grid():
    """A (2, 2) snapshot is the unmeshed engine's payload byte for byte
    but its mesh shape; it resumes a (2, 2) engine with no dispatch, its
    chunks resume an unmeshed one under the unmeshed config, and a (2,
    1) engine rejects it."""
    units, clusters = _world(b=64)
    src, plain = _port((2, 2)), _port(None)
    want = src.schedule(units, clusters)
    assert plain.schedule(units, clusters) == want
    payload, ref = src.snapshot_state(), plain.snapshot_state()
    assert payload["config"]["mesh"] == (2, 2) and ref["config"]["mesh"] is None
    assert {k: v for k, v in payload["config"].items() if k != "mesh"} == {
        k: v for k, v in ref["config"].items() if k != "mesh"}
    assert payload.keys() == ref.keys() and payload["chunks"].keys() == ref["chunks"].keys()
    for idx, chunk in payload["chunks"].items():
        for key, value in chunk.items():
            other = ref["chunks"][idx][key]
            if isinstance(value, np.ndarray):
                assert value.dtype == other.dtype and value.tobytes() == other.tobytes(), key
            else:
                assert value == other, key
    dst = _port((2, 2))
    dst.stage_restore(payload, assume_fresh=True)
    before = dst.dispatches_total
    assert dst.schedule(units, clusters) == want
    assert dst.restore_info["result"] == "loaded" and dst.dispatches_total == before
    _assert_on_entries(dst, "restored")
    unmeshed = dict(payload, config=dict(payload["config"], mesh=None))
    one = _port(None)
    one.stage_restore(unmeshed, assume_fresh=True)
    assert one.schedule(units, clusters) == want and one.restore_info["result"] == "loaded"
    for shape in ((2, 1), None):
        other = _port(shape)
        other.stage_restore(payload, assume_fresh=True)
        assert other.schedule(units, clusters) == want
        assert other.restore_info["result"] == "rejected", shape


# -- the grid holder ------------------------------------------------------------
def test_grid_holder_routes_rows_and_columns():
    mesh = M.make_mesh(["cpu"] * 6, objects_axis=2)
    arr = np.arange(11 * 10, dtype=np.int32).reshape(11, 10)
    g = M.GridShards.from_host(mesh, arr)
    assert g.cols == M.col_bounds(10, 3) == [(0, 4), (4, 7), (7, 10)]
    assert g.shape == (11, 10) and np.array_equal(g.numpy(), arr) and g.nbytes == arr.nbytes
    assert np.array_equal(g[2:9].numpy(), arr[2:9])
    idx = M.RowIndex([9, 0, 5, 5, 10])
    sel = g.index_select(0, idx)
    assert sel.bounds == M.row_bounds(5, 2) and np.array_equal(sel.numpy(), arr[idx.rows])
    both = M.cat_rows([g, g[:3]])
    assert np.array_equal(both.index_select(0, M.RowIndex([12, 1])).numpy(), arr[[1, 1]])
    g.index_copy_(0, M.RowIndex([3, 8]), M.GridShards.from_host(mesh, -arr[:2]))
    arr[[3, 8]] = -arr[:2]
    assert np.array_equal(g.numpy(), arr)
    vals = M.RowShards.from_host(mesh, np.full((11, 3), 7, np.int32))
    g.index_copy_cols_(np.array([1, 5, 9]), vals)
    arr[:, [1, 5, 9]] = 7
    assert np.array_equal(g.numpy(), arr)
    assert np.array_equal(torch.cat([g.lane(0), g.lane(1)]).numpy(), arr)
    labels = [label for label, _p in g.entries()]
    assert labels == [f"cpu/{i}.{j}" for i in range(2) for j in range(3)]
    keys, (vals_m,) = TP.merge_topk(
        [torch.tensor([[1, 5]]), torch.tensor([[2, 9]]), torch.tensor([[0, 3]])],
        [(torch.tensor([[10, 50]]),), (torch.tensor([[20, 90]]),), (torch.tensor([[0, 30]]),)],
        3,
    )
    assert keys.tolist() == [[0, 1, 2]] and vals_m.tolist() == [[0, 10, 20]]


def test_row_replicas_hold_every_entry():
    """A per-row input on a (2, 3) grid: a copy of each row shard on
    every entry of its row; a cell-local program reads its own copy in
    place; row gathers, scatters, slices and concatenations keep every
    copy; the host read and the lane reads see the lanes' copy."""
    mesh = M.make_mesh(["cpu"] * 6, objects_axis=2)
    arr = np.arange(9 * 4, dtype=np.int64).reshape(9, 4)
    r = M.RowReplicas.from_host(mesh, arr)
    assert r.bounds == M.row_bounds(9, 2) and len(r.copies) == 3
    assert r.nbytes == arr.nbytes and np.array_equal(r.numpy(), arr)
    for j in range(3):
        assert np.array_equal(r.copy(j).numpy(), arr)
        cell = M.Cell(1, j, *r.bounds[1], *M.col_bounds(6, 3)[j], 6)
        assert M._cell_piece(r, cell, mesh.devices[1, j], None, mesh) is r.copies[j][1]
    assert [label for label, _p in r.entries()] == [f"cpu/{i}.{j}" for i in range(2)
                                                    for j in range(3)]

    def same(holder, want):
        assert isinstance(holder, M.RowReplicas)
        for j in range(3):
            assert np.array_equal(holder.copy(j).numpy(), want), j

    idx = M.RowIndex([8, 0, 4, 4])
    same(r.index_select(0, idx), arr[idx.rows])
    same(r[2:7], arr[2:7])
    same(M.cat_rows([r, r[:2]]), np.concatenate([arr, arr[:2]]))
    same(r.map(lambda p: p * 2), arr * 2)
    r.index_copy_(0, M.RowIndex([1, 7]), M.RowReplicas.from_host(mesh, -arr[:2]))
    arr[[1, 7]] = -arr[:2]
    same(r, arr)
    r.index_copy_(0, M.RowIndex([3]), M.RowShards.from_host(mesh, arr[:1] + 100))
    arr[3] = arr[0] + 100
    same(r, arr)
