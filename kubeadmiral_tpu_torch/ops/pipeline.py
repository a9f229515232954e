"""The dense scheduling tick in torch.

Torch counterpart of the dense part of ``kubeadmiral_tpu/ops/pipeline.py``:
the stages of the reference's generic scheduler (reference:
pkg/controllers/scheduler/core/generic_scheduler.go:92-150) over a whole
batch at once —

    feasible, reasons, totals = phase1(inp)     # Filter + Score + Normalize
    selected = top-K(totals)                    # Select (MaxCluster)
    replicas = planner(weights, mins, maxes, caps)  # Replicas (RSP)

with the sticky-cluster short-circuit, Duplicate vs Divide mode and
static vs dynamic RSP weights folded in as masks.  ``expand_compact``
turns the featurizer's compact form into the dense planes on the
device.  Plane dtypes follow the JAX package one for one.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from kubeadmiral_tpu_torch.ops import reasons as RSN
from kubeadmiral_tpu_torch.ops.phase1 import phase1
from kubeadmiral_tpu_torch.ops.planner import INT32_INF, PlannerInputs, plan_batch
from kubeadmiral_tpu_torch.ops.select import select_topk
from kubeadmiral_tpu_torch.ops.weights import dynamic_weights

NIL_REPLICAS = np.int64(-1)  # "no replica count" (Duplicate-mode placement)
_NIL = int(NIL_REPLICAS)
_INF = int(INT32_INF)
_FNV_PRIME = 16777619


class TickInputs(NamedTuple):
    """One scheduling problem per row (see scheduler/featurize.py)."""

    # --- filter stage ---
    filter_enabled: torch.Tensor  # bool[B,5] (ops.filters.F_* order)
    api_ok: torch.Tensor          # bool[B,C]
    taint_ok_new: torch.Tensor    # bool[B,C]
    taint_ok_cur: torch.Tensor    # bool[B,C]
    selector_ok: torch.Tensor     # bool[B,C]
    placement_has: torch.Tensor   # bool[B]
    placement_ok: torch.Tensor    # bool[B,C]
    request: torch.Tensor         # i64[B,R]
    alloc: torch.Tensor           # i64[C,R]
    used: torch.Tensor            # i64[C,R]
    # --- score stage ---
    score_enabled: torch.Tensor   # bool[B,5] (ops.scores.S_* order)
    taint_counts: torch.Tensor    # int[B,C]
    affinity_scores: torch.Tensor # int[B,C]
    # --- out-of-process (webhook) plugins, evaluated host-side ---
    webhook_ok: torch.Tensor      # bool[B,C]; AND-ed into the filter result
    webhook_scores: torch.Tensor  # int[B,C]; added to the score totals
    # --- select stage ---
    max_clusters: torch.Tensor    # i32[B]; INT32_INF = unlimited, <0 = none
    # --- replicas stage ---
    mode_divide: torch.Tensor     # bool[B]
    sticky: torch.Tensor          # bool[B]
    current_mask: torch.Tensor    # bool[B,C]
    current_replicas: torch.Tensor  # int[B,C]; NIL_REPLICAS = nil entry
    total: torch.Tensor           # i32[B]
    weights_given: torch.Tensor   # bool[B]
    weights: torch.Tensor         # i32[B,C] static policy weights
    min_replicas: torch.Tensor    # i32[B,C]
    max_replicas: torch.Tensor    # i32[B,C]; INT32_INF = unbounded
    scale_max: torch.Tensor       # i32[B,C]; INT32_INF = unbounded
    capacity: torch.Tensor        # i32[B,C]; INT32_INF = no estimate
    keep_unschedulable: torch.Tensor  # bool[B]
    avoid_disruption: torch.Tensor    # bool[B]
    tiebreak: torch.Tensor        # i32[B,C]
    # --- dynamic weights ---
    cpu_alloc: torch.Tensor       # i64[C] Quantity.Value() cores
    cpu_avail: torch.Tensor       # i64[C]
    # --- padding ---
    cluster_valid: torch.Tensor   # bool[C]; False marks padded cluster slots


class TickOutputs(NamedTuple):
    """Masks are int8 (0/1) and numbers int32, as in the JAX package."""

    selected: torch.Tensor   # i8[B,C] final placements (0/1)
    replicas: torch.Tensor   # i32[B,C]; meaningful only where counted
    counted: torch.Tensor    # i8[B,C]; 0 = placement carries no replica count
    feasible: torch.Tensor   # i8[B,C] post-filter
    scores: torch.Tensor     # i32[B,C] post-normalize totals
    reasons: torch.Tensor    # i32[B,C] rejection bitmask (ops.reasons); 0
                             # exactly where selected


def fnv_tiebreak_plane(key_bytes, key_len, name_hash_state):
    """The planner tie-break plane: continue each cluster name's FNV-1
    state over the object key's bytes (h = h*prime ^ byte, uint32
    wraparound computed in int64 under a 32-bit mask), then map to
    order-preserving int32 (utils/hashing.uint32_to_sortable_int32).
    Bytes past every key's length leave the state unchanged, so the scan
    stops at the longest key."""
    b = key_bytes.shape[0]
    c = name_hash_state.shape[0]
    state = name_hash_state.to(torch.int64)[None, :].expand(b, c)
    key_bytes = key_bytes.to(torch.int64)
    key_len = key_len.to(torch.int64)
    n_bytes = min(key_bytes.shape[1], int(key_len.max())) if b else 0
    for j in range(n_bytes):
        upd = ((state * _FNV_PRIME) & 0xFFFFFFFF) ^ key_bytes[:, j : j + 1]
        state = torch.where((key_len > j)[:, None], upd, state)
    return (state - 2**31).to(torch.int32)


def _scatter_rows(b, c, idx, vals, default, dtype):
    """Dense [b, c] grid from per-row sparse (idx, value) entries;
    out-of-range indices (the EMPTY_SLOT sentinel) are dropped."""
    out = torch.full((b, c), default, dtype=dtype, device=idx.device)
    keep = (idx >= 0) & (idx < c)
    rows = torch.arange(b, device=idx.device)[:, None].expand_as(idx)
    out[rows[keep], idx[keep].long()] = vals[keep].to(dtype)
    return out


def expand_compact(ci) -> TickInputs:
    """Device-side expansion of CompactInputs into the dense planes the
    tick consumes: vocabulary-table gathers, sparse policy scatters and
    the FNV-1 tie-break plane.  Bit-exact with scheduler/featurize.py."""
    b = ci.gvk_id.shape[0]
    c = ci.cluster_valid.shape[0]
    device = ci.gvk_id.device

    taint_row = ci.taint_set_id.long()
    tol_id = ci.tol_id.long()
    api_ok = ci.api_matrix[ci.gvk_id.long()]
    taint_ok_new = ci.taint_new[tol_id][:, taint_row]
    taint_ok_cur = ci.taint_cur[tol_id][:, taint_row]
    taint_counts = ci.taint_prefer[tol_id][:, taint_row]
    selector_ok = ci.sel_matrix[ci.sel_id.long()]
    affinity_scores = ci.pref_matrix[ci.pref_id.long()]
    placement_ok = ci.place_matrix[ci.place_id.long()]

    idx = ci.sparse_idx
    i32 = torch.int32
    min_replicas = _scatter_rows(b, c, idx, ci.sparse_min, 0, i32)
    max_replicas = _scatter_rows(b, c, idx, ci.sparse_max, _INF, i32)
    weights = _scatter_rows(b, c, idx, ci.sparse_weight, 0, i32)
    capacity = _scatter_rows(b, c, idx, ci.sparse_capacity, _INF, i32)
    current_mask = _scatter_rows(b, c, idx, ci.sparse_cur != -2, False, torch.bool)
    current_replicas = _scatter_rows(
        b, c, idx, torch.where(ci.sparse_cur >= 0, ci.sparse_cur, _NIL), _NIL, i32
    )

    tiebreak = fnv_tiebreak_plane(ci.key_bytes, ci.key_len, ci.name_hash_state)

    return TickInputs(
        filter_enabled=ci.filter_enabled,
        api_ok=api_ok,
        taint_ok_new=taint_ok_new,
        taint_ok_cur=taint_ok_cur,
        selector_ok=selector_ok,
        placement_has=ci.placement_has,
        placement_ok=placement_ok,
        request=ci.request,
        alloc=ci.alloc,
        used=ci.used,
        score_enabled=ci.score_enabled,
        taint_counts=taint_counts,
        affinity_scores=affinity_scores,
        webhook_ok=torch.ones((b, c), dtype=torch.bool, device=device),
        webhook_scores=torch.zeros((b, c), dtype=i32, device=device),
        max_clusters=ci.max_clusters,
        mode_divide=ci.mode_divide,
        sticky=ci.sticky,
        current_mask=current_mask,
        current_replicas=current_replicas,
        total=ci.total,
        weights_given=ci.weights_given,
        weights=weights,
        min_replicas=min_replicas,
        max_replicas=max_replicas,
        scale_max=max_replicas,
        capacity=capacity,
        keep_unschedulable=ci.keep_unschedulable,
        avoid_disruption=ci.avoid_disruption,
        tiebreak=tiebreak,
        cpu_alloc=ci.cpu_alloc,
        cpu_avail=ci.cpu_avail,
        cluster_valid=ci.cluster_valid,
    )


def _current_plane(inp: TickInputs):
    """The planner's current-replica grid: NIL sticky entries stand in
    for the full desired total (scheduler.go treats a nil count as
    'everything here')."""
    total64 = inp.total.to(torch.int64)
    cur = torch.where(
        inp.current_replicas == _NIL, total64[:, None], inp.current_replicas
    )
    return torch.where(inp.current_mask, cur, 0).to(torch.int32)


def _planner_weights(inp: TickInputs, selected):
    """Static-or-dynamic per-cluster weights, zeroed outside the selection."""
    dyn_w = dynamic_weights(selected, inp.cpu_alloc, inp.cpu_avail)
    weights = torch.where(inp.weights_given[:, None], inp.weights, dyn_w).to(torch.int32)
    return torch.where(selected, weights, 0)


def schedule_tick(inp: TickInputs) -> TickOutputs:
    """One dense tick over a batch: phase 1 (the CUDA kernel on the
    card), top-K select, dynamic weights, the replica planner and the
    finalize tail."""
    feasible, reasons, totals = phase1(inp)

    # --- Select ---
    selected = select_topk(totals, feasible, inp.max_clusters)

    # --- Replicas (Divide mode) ---
    weights = _planner_weights(inp, selected)
    plan_out = plan_batch(
        PlannerInputs(
            weight=weights,
            min_replicas=torch.where(selected, inp.min_replicas, 0),
            max_replicas=inp.max_replicas,
            scale_max=inp.scale_max,
            capacity=inp.capacity,
            tiebreak=inp.tiebreak,
            member=selected,
            total=inp.total,
            current=_current_plane(inp),
            avoid_disruption=inp.avoid_disruption,
            keep_unschedulable=inp.keep_unschedulable,
        ),
        validate=False,
    )
    # The RSP merges capacity overflow back into the result as "nice to
    # schedule" replicas (rsp.go:158-177) and drops zero entries.
    divide_replicas = (plan_out.plan + plan_out.overflow).to(torch.int64)
    return _finalize(inp, feasible, reasons, totals, selected, divide_replicas)


def _finalize(
    inp: TickInputs, feasible, reasons, totals, selected, divide_replicas
) -> TickOutputs:
    """Select/divide reason bits, Duplicate-vs-Divide output shaping,
    the sticky-cluster short-circuit, and the reasons==0-iff-selected
    invariant.  All elementwise."""
    i32 = torch.int32
    # Feasible pairs the top-K cut (including K == 0 for a negative
    # maxClusters).
    reasons = reasons | (feasible & ~selected).to(i32) * RSN.REASON_MAX_CLUSTERS
    # Zero entries are dropped; negative entries (pathological min>max
    # policies) are preserved, as the reference's merge does.
    divide_selected = selected & (divide_replicas != 0)

    mode_divide = inp.mode_divide[:, None]
    # Selected by top-K but dropped by the Divide-mode zero-entry merge.
    reasons = reasons | (
        mode_divide & selected & ~divide_selected
    ).to(i32) * RSN.REASON_ZERO_REPLICAS

    out_selected = torch.where(mode_divide, divide_selected, selected)
    out_replicas = torch.where(
        mode_divide, torch.where(divide_selected, divide_replicas, 0), _NIL
    )
    out_counted = mode_divide & divide_selected

    # --- Sticky-cluster short-circuit (generic_scheduler.go:103-107) ---
    sticky_active = (inp.sticky & inp.current_mask.any(dim=-1))[:, None]
    out_selected = torch.where(sticky_active, inp.current_mask, out_selected)
    out_replicas = torch.where(
        sticky_active,
        torch.where(inp.current_mask, inp.current_replicas, 0),
        out_replicas,
    )
    out_counted = torch.where(
        sticky_active,
        inp.current_mask & (inp.current_replicas != _NIL),
        out_counted,
    )
    out_replicas = torch.where(out_selected, out_replicas, 0)

    # Sticky short-circuit reasons: the current clusters win; everything
    # else is cut by stickiness (filter bits kept for context).
    reasons = torch.where(
        sticky_active & ~inp.current_mask,
        reasons | RSN.REASON_STICKY,
        reasons,
    )
    # Invariant: reasons == 0 exactly where selected.
    reasons = torch.where(out_selected, 0, reasons)

    return TickOutputs(
        selected=out_selected.to(torch.int8),
        replicas=out_replicas.to(i32),
        counted=(out_counted & out_selected).to(torch.int8),
        feasible=feasible.to(torch.int8),
        scores=totals.to(i32),
        reasons=reasons.to(i32),
    )
