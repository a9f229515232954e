"""The tick's programs split over the mesh's clusters axis.

Under a mesh of shape (No, Nc) with Nc > 1 every ``[B, C]`` plane lies
as one column block per entry (``parallel.mesh.GridShards``), as the
JAX package's grid layout lays it (``P(OBJECTS, CLUSTERS)``).  JAX's
GSPMD turns the per-row work over a sharded cluster axis into
collectives; here each program is written out in the mesh's kinds
(``parallel/mesh.py``): cell-local stages on every block
(``run_grid``), and per-row reductions, sorts and merges of the blocks'
small ``[rows, k]`` partials on entry (i, 0) (``run_rows``), whose
results go back to the blocks with the next cell-local stage.

* ``grid_tick_narrow``: the narrow tick: the block stages of
  ``ops.pipeline``'s narrow solve on every block and its merge stages
  on (i, 0) (``_narrow_solve`` is their composition on one block).
  Phase 1 is the split pair (``ops.phase1.phase1_partial`` and
  ``phase1_finish``, the rows' normalisation maxima combined between
  them); the select stage's top-M and the planner's top-M members in
  processing order are merged from each block's first keys
  (``merge_topk``: exact, the keys are unique); the dynamic weights'
  per-row sums and first maximum are combined over the blocks
  (``ops.weights``' split stages); the planner's scans run on (i, 0)
  over [rows, M], and their per-cell results go back to the blocks.
* ``grid_pack_wire``: ``ops.pipeline``'s ``pack_block`` on every block
  and ``pack_merge`` on (i, 0) (``pack_rows`` is their composition).
* ``grid_reduce_rows`` and ``grid_map``: per-cell programs on every
  block, their per-row values (diff bits, exactness, counts) OR-ed,
  AND-ed or summed on (i, 0).
* ``grid_drift_gate``: the drift gate, its changed columns gathered by
  the blocks that own them and its refinement's counts summed.

Each function is bit-identical to its unsplit counterpart on the
whole rows.  Programs that need whole rows (the dense solve, the
certificate fallback, the survivor programs, the overflow and dense
fetch gathers) run as whole-row programs (``run_whole``) in the engine.
"""

from __future__ import annotations

import torch

from kubeadmiral_tpu_torch.ops.phase1 import phase1_finish, phase1_partial
from kubeadmiral_tpu_torch.ops.pipeline import (
    DRIFT_REFINE_MAX_COLS,
    TickOutputs,
    _cert_inf,
    _classify_head,
    _classify_tail,
    _compact_delta_filters,
    _dense_delta_filters,
    _finalize,
    _GATE_PLANES,
    _planner_weights,
    _refine_counts,
    _resource_scores_cols,
    _slots,
    _take_slots,
    expand_compact,
    pack_block,
    pack_merge,
    planner_block,
    planner_members,
    planner_merge,
    planner_slots_block,
    planner_spread,
    reduce_blocks,
    select_block,
    select_cert,
    select_merge,
    selected_block,
    wire_of,
)
from kubeadmiral_tpu_torch.ops.weights import (
    combine_peaks,
    weight_peak,
    weight_residual,
    weight_round,
    weight_shares,
    weight_sums,
)
from kubeadmiral_tpu_torch.parallel.mesh import GridShards, run_grid, run_rows


# -- the narrow tick ----------------------------------------------------------
def grid_tick_narrow(mesh, device_in, fmt: str, c: int, m: int, i32_keys: bool,
                     key_max=None, budget_factory=None, observe=None):
    """The narrow tick over a grid: (TickOutputs of ``GridShards``, cert
    i8[B] and the planner's unsettled rows as ``RowShards``; unsettled
    None without a budget).  ``device_in``: CompactInputs or TickInputs
    whose per-row fields are row holders, whose [B, C] fields are
    ``GridShards`` and whose cluster tables are whole tensors (each
    block takes its columns).  ``budget_factory()``: a fresh planner
    budget for each lane (None: no budget).  ``observe(kind, value)``
    sees the block stage's tie-break plane.  The stages are
    ``ops.pipeline``'s (``_narrow_solve`` is their composition on one
    block); here each block stage runs on every entry and each merge on
    entry (i, 0)."""
    cert_inf = _cert_inf(c, i32_keys)

    # Kind 1: expand and pass 1 of phase 1 on every block.
    def block_phase1(cell, piece):
        tin = expand_compact(piece, key_max, col0=cell.c0) if fmt == "compact" else piece
        feas, rsn, part, mx = phase1_partial(tin)
        return tin, feas, rsn, part, mx, tin.current_mask.any(dim=-1)

    tin, feas, rsn, part, mx, cur_any = run_grid(mesh, block_phase1, c, device_in)
    if observe is not None and fmt == "compact":
        observe("tiebreak", tin.tiebreak)

    # Kind 2: the rows' normalisation maxima and sticky flag.
    def lane_maxima(mx_b, cur_b, sticky):
        return reduce_blocks(mx_b, "max"), sticky & reduce_blocks(cur_b, "any")

    mxg, sticky_active = run_rows(mesh, lane_maxima, (mx, cur_any, device_in.sticky))

    # Kind 1: phase 1's normalised terms; the select keys, each block's
    # first M + 1 with the cells' feasibility and totals riding along.
    def block_select(cell, tin, feas, part, mxg):
        totals = phase1_finish(
            feas, tin.score_enabled, tin.taint_counts, tin.affinity_scores, mxg, part
        )
        return (totals,) + select_block(totals, feas, cell.c0, c, m, i32_keys)

    totals, comp, parts = run_grid(mesh, block_select, c, tin, feas, part, mxg)

    # Kind 3: the select stage on M candidates.
    def lane_select(parts, max_clusters):
        return select_merge(parts, max_clusters, c, m, i32_keys)

    cand_s, sel_n, kinf, pre_cert, worst_sel = run_rows(
        mesh, lane_select, (parts, device_in.max_clusters)
    )

    # Kind 1: the selection on the blocks, the certificate's best
    # feasible non-candidate, and the weights' selection sums.
    def block_selected(cell, tin, feas, comp, cand_s, sel_n, kinf):
        selected, best_out = selected_block(feas, comp, cand_s, sel_n, kinf, cell.c0, cert_inf)
        return selected, best_out, weight_sums(selected, tin.cpu_alloc, tin.cpu_avail)

    selected, best_out_b, sums_b = run_grid(
        mesh, block_selected, c, tin, feas, comp, cand_s, sel_n, kinf
    )

    def lane_sums(best_out_b, sums_b, kinf, pre_cert, worst_sel):
        return select_cert(best_out_b, kinf, pre_cert, worst_sel), reduce_blocks(sums_b, "sum")

    cert_sel, sums = run_rows(mesh, lane_sums, (best_out_b, sums_b, kinf, pre_cert, worst_sel))

    # The dynamic weights (``ops.weights``' stages): shares, their sum,
    # rounding, the residual.
    def block_shares(cell, tin, selected, sums):
        tmp = weight_shares(selected, tin.cpu_alloc, tin.cpu_avail, sums)
        return tmp, tmp.sum(dim=-1)

    tmp, tmp_sum_b = run_grid(mesh, block_shares, c, tin, selected, sums)
    tmp_sum = run_rows(mesh, lambda parts: reduce_blocks(parts, "sum"), (tmp_sum_b,))

    def block_round(cell, selected, tmp, tmp_sum):
        weight = weight_round(tmp, tmp_sum, selected)
        return weight, weight_peak(weight, selected, cell.c0)

    weight, peak_b = run_grid(mesh, block_round, c, selected, tmp, tmp_sum)
    residual, max_w, first = run_rows(mesh, combine_peaks, (peak_b,))

    # Kind 1: the planner weights and processing keys; each block's
    # first M member keys in processing order.
    def block_planner(cell, tin, selected, weight, residual, max_w, first):
        dyn_w = weight_residual(weight, residual, max_w, first, cell.c0)
        weights = _planner_weights(tin, selected, dyn_w)
        return (weights,) + planner_block(tin, selected, weights, cell.c0, c, m)

    weights, special, comp_true, neg_b = run_grid(
        mesh, block_planner, c, tin, selected, weight, residual, max_w, first
    )
    cand_p = run_rows(mesh, lambda neg_b: planner_members(neg_b, c, m), (neg_b,))

    # Kind 1: the member slots' planes from the blocks that own them,
    # and the phantom tail's sums over the members outside the slots.
    def block_slots(cell, tin, selected, weights, special, comp_true, cand_p):
        return planner_slots_block(tin, selected, weights, special, comp_true, cand_p, cell.c0)

    slots = run_grid(mesh, block_slots, c, tin, selected, weights, special, comp_true, cand_p)

    # Kind 3: the planner over the M member slots, on (i, 0).
    def lane_plan(inside_b, taken_b, tail_w_b, best_tail_b, spec_out_b, total,
                  avoid_disruption, keep_unschedulable, mode_divide, cert_sel):
        budget = None if budget_factory is None else budget_factory()
        divide_n, plan_cert = planner_merge(
            inside_b, taken_b, tail_w_b, best_tail_b, spec_out_b, total, avoid_disruption,
            keep_unschedulable, budget,
        )
        cert = cert_sel & (~mode_divide | plan_cert)
        unsettled = None if budget is None else budget.unsettled
        return divide_n, cert.to(torch.int8), unsettled

    divide_n, cert, unsettled = run_rows(
        mesh, lane_plan,
        slots + (device_in.total, device_in.avoid_disruption, device_in.keep_unschedulable,
                 device_in.mode_divide, cert_sel),
    )

    # Kind 1: the planned replicas back to their blocks; the finalize.
    def block_finalize(cell, tin, feas, rsn, totals, selected, cand_p, divide_n, sticky):
        divide = planner_spread(cand_p, divide_n, cell.c0, cell.c1 - cell.c0)
        return _finalize(tin, feas, rsn, totals, selected, divide, sticky_active=sticky)

    out = run_grid(
        mesh, block_finalize, c, tin, feas, rsn, totals, selected, cand_p, divide_n,
        sticky_active,
    )
    return TickOutputs(*(b.grid() for b in out)), cert, unsettled


# -- the packed wire ----------------------------------------------------------
def grid_pack_wire(mesh, planes: tuple, k: int):
    """``pack_wire`` over grid planes (selected, replicas, counted,
    scores, reasons): ``ops.pipeline.pack_block`` on every block (its
    first K with the global index), ``pack_merge`` on (i, 0).  The wire
    is a ``RowShards``."""
    c = planes[0].shape[1]
    parts = run_grid(mesh, lambda cell, *p: pack_block(*p, cell.c0, c, k), c, *planes)
    return run_rows(mesh, lambda parts: wire_of(pack_merge(parts, c, k)), (parts,))


# -- cell-local programs and per-row reductions ------------------------------
def grid_reduce_rows(mesh, fn, planes: tuple, op: str):
    """``fn`` on every block of grid planes (a per-row value or a tuple
    of them; kind 1), combined per row over the blocks by ``op`` on
    (i, 0) (``reduce_blocks``; kind 2): ``fn`` of the whole rows where
    ``op`` is how ``fn``'s value of a row combines over its columns (an
    OR of diff bits, an AND of exactness, a sum of counts)."""
    parts = run_grid(mesh, lambda cell, *p: fn(*p), planes[0].shape[1], *planes)
    if not isinstance(parts, tuple):
        return run_rows(mesh, lambda b: reduce_blocks(b, op), (parts,))
    return run_rows(mesh, lambda *bs: tuple(reduce_blocks(b, op) for b in bs), parts)


def grid_map(mesh, fn, planes: tuple):
    """A cell-local ``fn`` of grid planes on every block (kind 1), as a
    ``GridShards``."""
    return run_grid(mesh, lambda cell, *p: fn(*p), planes[0].shape[1], *planes).grid()


# -- the drift gate -----------------------------------------------------------
def grid_drift_gate(mesh, fmt: str, per_object: dict, prev_feas, prev_scores, nfeas, fin,
                    delta: tuple, tables_d=None, cur_absent=None):
    """The drift gate over a chunk's grid planes: (i8[B] mask, i32[B, D]
    the changed columns' new totals), as ``RowShards``.  ``delta``: the
    old and new cluster tensors at the changed columns, their indices,
    validity and cpu flags (whole tensors); ``fin``: the chunk's
    finite-maxClusters rows (global, padded out of range);
    ``tables_d``: the compact format's vocabulary tables at the changed
    columns (``ops.pipeline._delta_tables``)."""
    c = prev_feas.shape[1]
    alloc_old_d, used_old_d, alloc_new_d, used_new_d, didx, dvalid, dcpu = delta
    d = didx.shape[0]
    names = _GATE_PLANES if fmt == "dense" else ()

    def fin_local(fin, lo, hi):
        return torch.where((fin >= lo) & (fin < hi), fin - lo, 1 << 30)

    # Kind 1: the changed columns' cells, from the blocks that own them.
    def block_cols(cell, prev_feas, prev_scores, planes, didx):
        d_safe = torch.clamp(didx.to(torch.int64), 0, c - 1)[None, :].expand(
            prev_feas.shape[0], d
        )
        inside, local = _slots(d_safe, cell.c0, cell.c1 - cell.c0)
        got = {name: _take_slots(p, inside, local) for name, p in planes.items()}
        cur_any = planes["current_mask"].any(dim=1) if planes else None
        return (_take_slots(prev_feas != 0, inside, local),
                _take_slots(prev_scores.to(torch.int64), inside, local), got, cur_any)

    pf_b, tot_b, planes_b, cur_b = run_grid(
        mesh, block_cols, c, prev_feas, prev_scores,
        {name: per_object[name] for name in names}, didx,
    )

    # Kind 2: the rows' filters at the changed columns and the gate's
    # head; the finite rows' keys go back to the blocks.
    def lane_head(lo, hi, per_object, pf_b, tot_b, planes_b, cur_b, nfeas, fin, tables_d,
                  alloc_old_d, used_old_d, alloc_new_d, used_new_d, didx, dvalid, dcpu):
        pf_d = reduce_blocks(pf_b, "any")
        tot_old_d = reduce_blocks(tot_b, "sum")
        if fmt == "dense":
            planes_d = {name: reduce_blocks(planes_b[name], "any") for name in names}
            fea_new_d = _dense_delta_filters(per_object, planes_d, alloc_new_d, used_new_d)
            sticky_active = per_object["sticky"] & reduce_blocks(cur_b, "any")
        else:
            fea_new_d, sticky_active = _compact_delta_filters(
                per_object, tables_d, didx, alloc_new_d, used_new_d, cur_absent
            )
        enabled, request = per_object["score_enabled"], per_object["request"]
        head = _classify_head(
            fea_new_d, pf_d, tot_old_d,
            _resource_scores_cols(request, enabled, alloc_old_d, used_old_d),
            _resource_scores_cols(request, enabled, alloc_new_d, used_new_d),
            didx, dvalid, dcpu, per_object["max_clusters"], nfeas, fin_local(fin, lo, hi), c,
        )
        return head, sticky_active

    per_row = {k: v for k, v in per_object.items() if not isinstance(v, GridShards)}
    head, sticky_active = run_rows(
        mesh, lane_head, (per_row, pf_b, tot_b, planes_b, cur_b, nfeas),
        (fin, tables_d, *delta), bounds=True,
    )

    counts = None
    if d <= DRIFT_REFINE_MAX_COLS:
        # Kind 1: the refinement's counts over each block's columns.
        def block_counts(cell, prev_feas, prev_scores, key_old, key_new, didx, dvalid, fin):
            return _refine_counts(
                prev_feas, prev_scores, didx, dvalid, fin_local(fin, cell.lo, cell.hi),
                key_old, key_new, cell.c0, c,
            )

        counts = run_grid(
            mesh, block_counts, c, prev_feas, prev_scores, head.key_old, head.key_new,
            didx, dvalid, fin,
        )

    # Kind 2: the counts summed; the rows classified.
    def lane_tail(lo, hi, head, sticky_active, per_object, counts, fin, dvalid):
        total = None if counts is None else tuple(reduce_blocks(cb, "sum") for cb in counts)
        return _classify_tail(
            head, total, dvalid, per_object["mode_divide"], per_object["weights_given"],
            sticky_active, fin_local(fin, lo, hi), head.pf_d.shape[0],
        )

    return run_rows(
        mesh, lane_tail, (head, sticky_active, per_row, counts), (fin, dvalid), bounds=True,
    )
