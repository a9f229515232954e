"""The scheduling tick in torch: dense, narrow, and the packed wire.

Torch counterpart of ``kubeadmiral_tpu/ops/pipeline.py`` (cold paths):
the stages of the reference's generic scheduler (reference:
pkg/controllers/scheduler/core/generic_scheduler.go:92-150) over a whole
batch at once —

    feasible, reasons, totals = phase1(inp)     # Filter + Score + Normalize
    selected = top-K(totals)                    # Select (MaxCluster)
    replicas = planner(weights, mins, maxes, caps)  # Replicas (RSP)

with the sticky-cluster short-circuit, Duplicate vs Divide mode and
static vs dynamic RSP weights folded in as masks.  ``expand_compact``
turns the featurizer's compact form into the dense planes on the
device.  ``schedule_tick`` runs select and planner over the whole
cluster axis; ``schedule_tick_narrow`` runs them over M candidate
columns per row with a per-row exactness certificate; ``pack_wire``
compacts the output planes into K slots per row for the device->host
copy.  The drift programs (``drift_gate_dense``/``drift_gate_compact``,
``drift_wcheck``, ``drift_survivor``) classify and re-solve the rows a
capacity drift can move from the stored planes of the previous tick.
Plane dtypes follow the JAX package one for one.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from kubeadmiral_tpu_torch.ops import filters as F
from kubeadmiral_tpu_torch.ops import reasons as RSN
from kubeadmiral_tpu_torch.ops import scores as S
from kubeadmiral_tpu_torch.ops.phase1 import phase1 as _phase1
from kubeadmiral_tpu_torch.ops.planner import (
    INT32_INF,
    PlannerInputs,
    plan_batch,
    plan_batch_narrow,
    processing_key,
)
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


def fnv_tiebreak_plane(key_bytes, key_len, name_hash_state, n_bytes=None):
    """The planner tie-break plane: continue each cluster name's FNV-1
    state over the object key's bytes (h = h*prime ^ byte, uint32
    wraparound computed in int64 under a 32-bit mask), then map to
    order-preserving int32 (utils/hashing.uint32_to_sortable_int32).
    Bytes past every key's length leave the state unchanged, so the scan
    may stop at any ``n_bytes`` at least the longest key: the caller's
    host-side bound (the keys' lengths are host arrays before the upload;
    reading them back from the card would wait for it), else the padded
    width."""
    b = key_bytes.shape[0]
    c = name_hash_state.shape[0]
    state = name_hash_state.to(torch.int64)[None, :].expand(b, c)
    key_bytes = key_bytes.to(torch.int64)
    key_len = key_len.to(torch.int64)
    width = key_bytes.shape[1]
    n_bytes = width if n_bytes is None else min(width, int(n_bytes))
    for j in range(n_bytes if b else 0):
        upd = ((state * _FNV_PRIME) & 0xFFFFFFFF) ^ key_bytes[:, j : j + 1]
        state = torch.where((key_len > j)[:, None], upd, state)
    return (state - 2**31).to(torch.int32)


def _scatter_rows(b, c, idx, vals, default, dtype):
    """Dense [b, c] grid (contiguous) from per-row sparse (idx, value)
    entries; out-of-range indices (the EMPTY_SLOT sentinel) are dropped:
    they scatter into a spare slot past the grid (a boolean-mask index
    would wait on the device for its count)."""
    out = torch.full((b * c + 1,), default, dtype=dtype, device=idx.device)
    keep = (idx >= 0) & (idx < c)
    rows = torch.arange(b, device=idx.device)[:, None]
    flat = torch.where(keep, rows * c + idx.long(), b * c)
    out.scatter_(0, flat.reshape(-1), vals.to(dtype).reshape(-1))
    return out[: b * c].view(b, c)


def expand_compact(ci, key_len_max=None) -> TickInputs:
    """Device-side expansion of CompactInputs into the dense planes the
    tick consumes: vocabulary-table gathers, sparse policy scatters and
    the FNV-1 tie-break plane.  Bit-exact with scheduler/featurize.py.
    ``key_len_max``: a host-side bound on the rows' key lengths, where
    the FNV scan may stop (``fnv_tiebreak_plane``)."""
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

    tiebreak = fnv_tiebreak_plane(
        ci.key_bytes, ci.key_len, ci.name_hash_state, key_len_max
    )

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


def schedule_tick(inp: TickInputs, budget=None) -> TickOutputs:
    """One dense tick over a batch: phase 1 (the CUDA kernel on the
    card), top-K select, dynamic weights, the replica planner and the
    finalize tail.  ``budget``: the planner's ``RoundBudget``, if any."""
    feasible, reasons, totals = _phase1(inp)

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
        budget=budget,
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


# -- narrow solve ---------------------------------------------------------
# At wide cluster axes the tick's cost is its sorts: select's full-width
# rank and the planner's per-row processing-order sorts.  The narrow
# solve keeps phase 1 dense and ranks/bin-packs over M candidate columns
# per row.  Exactness is enforced per row by a certificate; the engine
# re-solves uncertified rows through the dense tick, so placements are
# bit-identical by construction:
#
# * rows whose top-K cut cannot engage (maxClusters unlimited, >= the
#   feasible count, or negative) select the feasible mask, no sort;
# * rows with an engaged cut select over the top-M columns by select's
#   own (-total, index) order, packed into one collision-free key and
#   single-key sorted; the certificate compares the worst selected key
#   with the best feasible non-candidate;
# * the planner narrows to the top-M members in its own processing order
#   (``_plan_topm``; ops/planner.py ``plan_batch_narrow``), and columns
#   with planner structure left outside the slots fail the certificate.

_CERT_INF = 1 << 62
_I32_MAX = 2**31 - 1


def _cbits(c: int) -> int:
    return max(1, (c - 1).bit_length())


def _select_comp(totals, feasible, c, iota, i32_keys):
    """The select stage's collision-free composite key ((-total, index)
    ascending) for the candidate sort and its certificate.  Returns
    (comp, key_ok bool[B], cert_inf).  With ``i32_keys`` and a cluster
    axis that leaves >= 12 value bits the key is int32 (half the bytes
    through the sort); rows whose feasible totals leave the narrowed
    range get ``key_ok`` False and fail the certificate."""
    if i32_keys:
        cbits = _cbits(c)
        if cbits <= 18:
            lim = 1 << (30 - cbits)
            inrange = (totals < lim) & (totals > -lim)
            key_ok = ~(feasible & ~inrange).any(dim=-1)
            key1 = torch.where(
                feasible & inrange, -totals.to(torch.int32), lim
            )
            # key1 * 2**cbits lies in (-2**30, 2**30]: exact in int32,
            # with the low cbits bits free for the index.
            comp = (key1 * (1 << cbits)) | iota.to(torch.int32)
            return comp, key_ok, _I32_MAX
    key1 = torch.where(feasible, -totals.to(torch.int32), _I32_MAX)
    comp = key1.to(torch.int64) * c + iota
    return comp, torch.ones_like(feasible[:, 0]), _CERT_INF


def _decode_comp(sorted_comp, c, i32_keys):
    """Low-bits decode of a sorted composite back to column indices
    (int64, floor-mod for the negative int64 keys)."""
    if i32_keys and _cbits(c) <= 18:
        return (sorted_comp & ((1 << _cbits(c)) - 1)).to(torch.int64)
    return sorted_comp.to(torch.int64) % c


def _scatter_mask(shape, cols, values, device):
    return torch.zeros(shape, dtype=torch.bool, device=device).scatter_(
        1, cols, values
    )


def _plan_topm(inp: TickInputs, selected, weights, m: int, budget=None):
    """The planner over the top-M member slots in ITS OWN processing
    order.  Returns (divide_replicas i64[B, C], cert bool[B]); cert holds
    iff ``plan_batch_narrow``'s phantom-tail certificate held and no
    selected column with planner structure was left outside the slots."""
    b, c = selected.shape
    m = min(m, c)
    device = selected.device
    iota = torch.arange(c, dtype=torch.int64, device=device).expand(b, c)
    special = (
        (inp.min_replicas > 0)
        | (inp.max_replicas != _INF)
        | (inp.scale_max != _INF)
        | (inp.capacity != _INF)
        | inp.current_mask
    )
    # Candidate PRIORITY boosts structured columns into the slots; the
    # CERTIFICATE compares the true processing order (no special bit).
    comp_prio = processing_key(weights, inp.tiebreak, special)
    comp_true = processing_key(weights, inp.tiebreak, torch.zeros_like(special))
    # One descending single-key sort of (priority | inverted index).
    # comp_prio fits 53 bits, so the index costs a `shift`-bit drop of
    # the priority when 53 + cbits > 63 (1 bit at C = 2048, 3 at 5120):
    # the certificate compares TRUE keys, so a mis-pick from the dropped
    # bits falls back to dense.  Selected columns rank above every
    # unselected one; spare slots take the lowest-index unselected
    # columns (masked off by member_p).  Bit for bit as the JAX package,
    # including the wrap of the one key that can reach 2**63.
    cbits = _cbits(c)
    shift = max(0, 53 + cbits - 63)
    low = (1 << cbits) - 1
    inv_iota = low - iota
    key_p = torch.where(
        selected, (((comp_prio >> shift) + 1) << cbits) | inv_iota, inv_iota
    )
    sorted_p = -torch.sort(-key_p, dim=-1).values[:, :m]
    cand_p = torch.sort(low - (sorted_p & low), dim=-1).values

    def take_p(plane):
        return plane.gather(1, cand_p)

    cand_p_mask = _scatter_mask((b, c), cand_p, True, device)
    outside = selected & ~cand_p_mask
    tail_w = torch.where(outside, torch.clamp(weights, min=0), 0).sum(
        dim=-1, dtype=torch.int32
    )
    best_tail = torch.where(outside, comp_true, -1).amax(dim=-1)
    spec_out = (outside & special).any(dim=-1)

    member_p = take_p(selected)
    plan_out, pcert = plan_batch_narrow(
        PlannerInputs(
            weight=take_p(weights),
            min_replicas=torch.where(member_p, take_p(inp.min_replicas), 0),
            max_replicas=take_p(inp.max_replicas),
            scale_max=take_p(inp.scale_max),
            capacity=take_p(inp.capacity),
            tiebreak=take_p(inp.tiebreak),
            member=member_p,
            total=inp.total,
            current=take_p(_current_plane(inp)),
            avoid_disruption=inp.avoid_disruption,
            keep_unschedulable=inp.keep_unschedulable,
        ),
        tail_w,
        best_tail,
        take_p(comp_true),
        budget,
    )
    divide_n = (plan_out.plan + plan_out.overflow).to(torch.int64)
    divide_replicas = torch.zeros((b, c), dtype=torch.int64, device=device)
    divide_replicas.scatter_(1, cand_p, divide_n)
    return divide_replicas, pcert & ~spec_out


def _narrow_solve(
    inp: TickInputs, feasible, reasons, totals, m: int, i32_keys: bool, budget=None
):
    """Select + planner over M candidate columns, given the phase-1
    triple.  Returns (outputs, cert i8[B])."""
    b, c = feasible.shape
    m = min(m, c)
    device = feasible.device
    iota = torch.arange(c, dtype=torch.int64, device=device).expand(b, c)

    # --- select resolution ------------------------------------------------
    nfeas = feasible.sum(dim=-1, dtype=torch.int32)
    k_eff = torch.where(
        inp.max_clusters < 0, 0, torch.clamp(inp.max_clusters, max=c)
    )
    # The cut cannot engage: selection is the feasible set, no sort.
    kinf = k_eff >= nfeas

    comp_sel, key_ok, cert_inf = _select_comp(totals, feasible, c, iota, i32_keys)
    cand_s = _decode_comp(torch.sort(comp_sel, dim=-1).values[:, :m], c, i32_keys)
    # Ascending: the narrow slot order keeps the dense index order.
    cand_s = torch.sort(cand_s, dim=-1).values
    fea_s = feasible.gather(1, cand_s)
    sel_n = select_topk(totals.gather(1, cand_s), fea_s, inp.max_clusters)
    sel_scatter = _scatter_mask((b, c), cand_s, sel_n, device)
    selected = torch.where(kinf[:, None], feasible, sel_scatter)

    # Select certificate: every feasible non-candidate ranks strictly
    # after every selected column, and the narrow cut had enough feasible
    # candidates to fill k (or saw every feasible column).
    cand_mask = _scatter_mask((b, c), cand_s, True, device)
    out_feas = feasible & ~cand_mask
    best_out = torch.where(out_feas, comp_sel, cert_inf).amin(dim=-1)
    worst_sel = torch.where(
        sel_n, comp_sel.gather(1, cand_s), -cert_inf
    ).amax(dim=-1)
    nf_cand = fea_s.sum(dim=-1, dtype=torch.int32)
    cert_sel = kinf | (
        key_ok
        & ((nf_cand >= k_eff) | (nfeas == nf_cand))
        & (best_out > worst_sel)
    )

    # --- planner candidates: top-M members in processing order ------------
    weights = _planner_weights(inp, selected)
    divide_replicas, plan_cert = _plan_topm(inp, selected, weights, m, budget)

    # Sticky rows certify under the same conditions: their reasons keep
    # the would-be pipeline's zero-replica bits.
    cert = cert_sel & (~inp.mode_divide | plan_cert)
    out = _finalize(inp, feasible, reasons, totals, selected, divide_replicas)
    return out, cert.to(torch.int8)


def schedule_tick_narrow(inp: TickInputs, m: int, i32_keys: bool = True, budget=None):
    """The narrow tick; returns (outputs, cert i8[B]).

    ``m`` is the candidate width.  ``cert[b] == 1`` guarantees row b's
    outputs are bit-identical to ``schedule_tick``; rows with 0 must be
    re-solved dense.  ``i32_keys`` demotes the select composite key to
    int32 where the range allows (cert-guarded per row).  Phase 1 is
    ``ops.phase1.phase1``: the CUDA kernel on CUDA tensors.  ``budget``:
    the planner's ``RoundBudget``, if any."""
    feasible, reasons, totals = _phase1(inp)
    return _narrow_solve(inp, feasible, reasons, totals, m, i32_keys, budget)


# -- packed placement wire ------------------------------------------------
# Each object lands on at most maxClusters clusters, yet the dense planes
# ship B x C cells.  The packed wire compacts every row into K slots on
# the device, so the copy scales as B x K; a row selecting more than K
# clusters raises its overflow flag (nsel > K) and the engine re-fetches
# it separately.

PACK_FILL = -1  # idx value of unused packed slots


class PackedRows(NamedTuple):
    """The packed placement layout: one row per object, K slots."""

    idx: torch.Tensor   # i32[N,K] selected cluster indices; PACK_FILL pads
    rep: torch.Tensor   # i32[N,K] replicas of that cluster (NIL in Duplicate mode)
    cnt: torch.Tensor   # i32[N,K] 1 when the placement carries a replica count
    sco: torch.Tensor   # i32[N,K] post-normalize score total of that cluster
    nsel: torch.Tensor  # i32[N]   true selected count; nsel > K flags overflow
    nfeas: torch.Tensor # i32[N]   valid clusters with no filter-stage reason
    rsum: torch.Tensor  # i32[N,NUM_REASON_BITS] clusters rejected per reason
    #                     bit (ops.reasons.REASON_BITS order), valid slots only


def pack_rows(selected, replicas, counted, scores, reasons, k: int) -> PackedRows:
    """Top-k-compact [N, C] output planes into the packed layout.  Slot
    order is (score desc, cluster index asc) over the selected clusters —
    select's own ranking — from one sort of the collision-free int64
    composite ``key1 * C + iota``, decoded by floor-mod."""
    n, c = selected.shape
    k = min(k, c)
    selb = selected != 0
    iota = torch.arange(c, dtype=torch.int64, device=selected.device).expand(n, c)
    key1 = torch.where(selb, -scores.to(torch.int32), _I32_MAX)
    comp = key1.to(torch.int64) * c + iota
    order = (torch.sort(comp, dim=-1).values % c)[:, :k]
    valid = selb.gather(1, order)
    gidx = torch.where(valid, order, 0)

    def take(plane):
        return torch.where(valid, plane.to(torch.int32).gather(1, gidx), 0)

    rsn = reasons.to(torch.int32)
    valid_slot = (rsn & RSN.REASON_CLUSTER_INVALID) == 0
    rsum = torch.stack(
        [(((rsn & bit) != 0) & valid_slot).sum(dim=-1) for bit in RSN.REASON_BITS],
        dim=-1,
    ).to(torch.int32)
    nfeas = (((rsn & RSN.FILTER_REASON_MASK) == 0) & valid_slot).sum(dim=-1)
    return PackedRows(
        idx=torch.where(valid, order, PACK_FILL).to(torch.int32),
        rep=take(replicas),
        cnt=take(counted),
        sco=take(scores),
        nsel=selb.sum(dim=-1, dtype=torch.int32),
        nfeas=nfeas.to(torch.int32),
        rsum=rsum,
    )


def wire_width(k: int) -> int:
    """Column count of a packed wire row: 4 K-wide planes + nsel + nfeas
    + the reason-summary counts."""
    return 4 * k + 2 + RSN.NUM_REASON_BITS


def pack_wire(selected, replicas, counted, scores, reasons, k: int) -> torch.Tensor:
    """The packed layout as ONE i32[N, wire_width(k)] tensor: a single
    device->host copy per fetch."""
    p = pack_rows(selected, replicas, counted, scores, reasons, k)
    return torch.cat(
        [p.idx, p.rep, p.cnt, p.sco, p.nsel[:, None], p.nfeas[:, None], p.rsum],
        dim=-1,
    )


def unpack_wire(arr, k: int) -> PackedRows:
    """Host-side inverse of pack_wire (numpy views, no copies)."""
    arr = np.asarray(arr)
    return PackedRows(
        idx=arr[:, :k],
        rep=arr[:, k : 2 * k],
        cnt=arr[:, 2 * k : 3 * k],
        sco=arr[:, 3 * k : 4 * k],
        nsel=arr[:, 4 * k],
        nfeas=arr[:, 4 * k + 1],
        rsum=arr[:, 4 * k + 2 : 4 * k + 2 + RSN.NUM_REASON_BITS],
    )


# -- drift: phase 1 from stored planes ------------------------------------
# A drift survivor row's topology filters are per-object and cannot have
# moved, so phase 1 is rebuilt from the previous tick's reason plane:
# every filter bit but resources_fit is read back, resources_fit is
# recomputed dense against the new cluster planes, and the scores are
# recomputed in full over the new feasibility (a fit flip shifts the
# normalisation maxima).  Sticky-active rows are the one exception (their
# current columns carry reason 0 whatever the filters say): the survivor
# program fails their certificate.

_NONFIT_BLOCK = RSN.FILTER_REASON_MASK & ~RSN.REASON_RESOURCES_FIT


def _stored_filters(inp: TickInputs, reasons_rows):
    """(feasible, base_reasons) of drift survivor rows from the stored
    reason plane plus a dense resources_fit recompute."""
    fit_ok = F.resources_fit(inp.request, inp.alloc, inp.used)
    fit_enabled = inp.filter_enabled[:, F.F_RESOURCES_FIT, None]
    topo_ok = (reasons_rows & _NONFIT_BLOCK) == 0
    feasible = (
        topo_ok
        & (~fit_enabled | fit_ok)
        & inp.cluster_valid[None, :]
        & inp.webhook_ok
    )
    fit_bit = (fit_enabled & ~fit_ok).to(torch.int32) * RSN.REASON_RESOURCES_FIT
    base_reasons = (
        reasons_rows & ~(RSN.SELECT_REASON_MASK | RSN.REASON_RESOURCES_FIT)
    ) | fit_bit
    return feasible, base_reasons


def _phase1_from_stored(inp: TickInputs, reasons_rows):
    """(feasible, base_reasons, totals): _stored_filters plus the full
    score recompute."""
    feasible, base_reasons = _stored_filters(inp, reasons_rows)
    totals = S.total_scores(
        inp.score_enabled,
        feasible,
        inp.request,
        inp.alloc,
        inp.used,
        inp.taint_counts,
        inp.affinity_scores,
    )
    totals = totals + torch.where(feasible, inp.webhook_scores, 0)
    return feasible, base_reasons, totals


def drift_survivor(inp: TickInputs, reasons_rows, m: int, i32_keys: bool = False):
    """The unified drift-survivor solve over gathered rows [n, C]
    (expanded) and their stored reason rows: phase 1 from the stored
    planes, then the narrow select and planner.  Returns (outputs, cert
    i8[n]); cert == 1 guarantees the dense tick's outputs, as for
    ``schedule_tick_narrow``, and fails closed on sticky-active rows."""
    feasible, base_reasons, totals = _phase1_from_stored(inp, reasons_rows)
    out, cert = _narrow_solve(inp, feasible, base_reasons, totals, m, i32_keys)
    sticky_active = inp.sticky & inp.current_mask.any(dim=-1)
    return out, ((cert != 0) & ~sticky_active).to(torch.int8)


# -- drift gate ------------------------------------------------------------
# A capacity drift changes the cluster planes at a few columns.  The gate
# classifies every row of a cached chunk from its device-resident inputs
# and the previous tick's planes, without select or planner:
#
#   recompute - the row's placement may move and is re-scheduled;
#   wcheck    - the selection cannot move, but the row's dynamic weights
#               read a column whose CPU figures moved (drift_wcheck
#               decides);
#   neither   - the row's outputs are provably those of the last tick.
#
# Feasibility reads the cluster planes only through resources_fit, so it
# flips only at changed columns (a fit flip recomputes).  Without a flip
# the totals change only at changed columns (the resource plugins are
# per cell; taint and affinity normalise over the unchanged feasible
# set).  A row whose top-K cut cannot engage selects its feasible set;
# else its selected set changes iff a changed column's membership flips,
# which the gate counts exactly by the select stage's own (-total, index)
# order for at most DRIFT_REFINE_MAX_COLS columns (conservatively beyond
# that).  Sticky-active rows never move.  The changed columns' new totals
# are returned so that the stored score plane stays exact for the rows
# the gate skips.

DRIFT_RECOMPUTE = 1  # gate-mask bit: the row is re-scheduled
DRIFT_WCHECK = 2     # gate-mask bit: the row needs the dynamic-weight check
DRIFT_FITFLIP = 4    # gate-mask bit: feasibility flipped at a changed column
# Widest delta the exact top-K membership refinement runs at: its rank
# counts cost O(rows x C x D) compares.
DRIFT_REFINE_MAX_COLS = 8


def _resource_scores_cols(request, score_enabled, alloc_d, used_d):
    """The cluster-plane part of a row's total at the given columns: the
    resource plugins, enabled-masked.  i64[B, D]."""
    parts = (
        (S.S_BALANCED, S.balanced_allocation_score(request, alloc_d, used_d)),
        (S.S_LEAST, S.least_allocated_score(request, alloc_d, used_d)),
        (S.S_MOST, S.most_allocated_score(request, alloc_d, used_d)),
    )
    total = torch.zeros(
        (request.shape[0], alloc_d.shape[0]), dtype=torch.int64, device=request.device
    )
    for idx, s in parts:
        total = total + torch.where(score_enabled[:, idx, None], s, 0)
    return total


def _drift_classify(
    fea_new_d,      # bool[B, D] feasibility at the changed columns, new planes
    prev_feas,      # i8[B, C] previous feasibility plane
    prev_scores,    # i32[B, C] previous post-normalize totals
    res_old_d,      # i64[B, D] resource-score part at the columns, old planes
    res_new_d,      # i64[B, D] the same, new planes
    delta_idx,      # i32[D] changed columns (padding: out of range)
    delta_valid,    # bool[D] the slot is a real changed column
    delta_cpu,      # bool[D] the column's cpu_alloc/cpu_avail changed
    max_clusters,   # i32[B]
    mode_divide,    # bool[B]
    weights_given,  # bool[B]
    sticky_active,  # bool[B]
    fin_idx,        # i32[Nf] rows with a finite maxClusters (padding: out of range)
    nfeas,          # i32[B] the stored per-row feasible counts
):
    """Shared tail of the dense and compact gates.  Returns (i8[B] mask,
    i32[B, D] the changed columns' new totals)."""
    b, c = prev_feas.shape
    device = prev_feas.device
    d = delta_idx.shape[0]
    d_safe = torch.clamp(delta_idx.to(torch.int64), 0, c - 1)
    pf_d = prev_feas[:, d_safe] != 0
    valid = delta_valid[None, :]
    fitflip = ((fea_new_d != pf_d) & valid).any(dim=1)
    dcpu = delta_cpu & delta_valid
    dcpu_any = (pf_d & dcpu[None, :]).any(dim=1)
    # The top-K cut cannot engage: unlimited, K >= nfeas, or negative K.
    kinf = (max_clusters == _INF) | (max_clusters < 0) | (max_clusters >= nfeas)

    tot_old_d = prev_scores[:, d_safe].to(torch.int64)
    tot_new_d = torch.where(pf_d, tot_old_d - res_old_d + res_new_d, 0)

    if d <= DRIFT_REFINE_MAX_COLS:
        # Exact top-K refinement over the finite-K rows: a delta
        # column's membership before and after, counted with the select
        # stage's comparator packed into one collision-free int64 key.
        # Scatters send out-of-range slots to a spare last slot (no
        # boolean indexing: that would wait on the device).
        didx64 = delta_idx.to(torch.int64)
        is_delta = torch.zeros(c + 1, dtype=torch.bool, device=device)
        is_delta[torch.where(didx64 < c, didx64, c)] = delta_valid
        is_delta = is_delta[:c]
        fin = fin_idx.to(torch.int64)
        ridx = torch.clamp(fin, 0, b - 1)
        pf_g = prev_feas[ridx] != 0                          # [Nf, C]
        pf_d_g = pf_d[ridx]                                  # [Nf, D]
        iota = torch.arange(c, dtype=torch.int64, device=device)[None, :]
        comp = (-prev_scores[ridx].to(torch.int64)) * c + iota
        comp_u = torch.where(pf_g & ~is_delta[None, :], comp, _CERT_INF)
        key_old = (-tot_old_d[ridx]) * c + didx64[None, :]   # [Nf, D]
        key_new = (-tot_new_d[ridx]) * c + didx64[None, :]
        e_mask = (pf_d_g & valid)[:, :, None]

        def above_counts(key_d):
            cnt = torch.stack(
                [
                    (comp_u < key_d[:, t : t + 1]).sum(dim=1, dtype=torch.int32)
                    for t in range(d)
                ],
                dim=1,
            )
            e_beats = key_d[:, :, None] < key_d[:, None, :]
            return cnt + (e_beats & e_mask).sum(dim=1, dtype=torch.int32)

        k = torch.clamp(max_clusters[ridx], 0, c)[:, None]
        member_old = pf_d_g & (above_counts(key_old) < k)
        member_new = pf_d_g & (above_counts(key_new) < k)
        sel_moved_g = ((member_old != member_new) & valid).any(dim=1)
        # Finite-K dynamic-weight rows whose selection touches a
        # cpu-changed column: the wcheck cannot decide them.
        dyn_fin_g = ((member_old | member_new) & dcpu[None, :]).any(dim=1)
        exposed_g = sel_moved_g | (mode_divide[ridx] & ~weights_given[ridx] & dyn_fin_g)
        sel_exposed = torch.zeros(b + 1, dtype=torch.bool, device=device)
        sel_exposed[torch.where(fin < b, fin, b)] = exposed_g
        sel_exposed = sel_exposed[:b]
    else:
        # Conservative: any feasible delta column may cross the K cut.
        sel_exposed = ((fea_new_d | pf_d) & valid).any(dim=1)

    recompute = ~sticky_active & (fitflip | (~kinf & sel_exposed))
    # Sound only where the selection is the feasible set (kinf).
    wcheck = (
        ~sticky_active & ~recompute & kinf & mode_divide & ~weights_given & dcpu_any
    )
    mask = (
        recompute.to(torch.int8) * DRIFT_RECOMPUTE
        + wcheck.to(torch.int8) * DRIFT_WCHECK
        + (fitflip & ~sticky_active).to(torch.int8) * DRIFT_FITFLIP
    )
    return mask, tot_new_d.to(torch.int32)


def _gate_tail(per_object, fea_new_d, sticky_active, prev_feas, prev_scores,
               alloc_old_d, used_old_d, alloc_new_d, used_new_d,
               delta_idx, delta_valid, delta_cpu, fin_idx, nfeas):
    enabled = per_object["score_enabled"]
    request = per_object["request"]
    return _drift_classify(
        fea_new_d,
        prev_feas,
        prev_scores,
        _resource_scores_cols(request, enabled, alloc_old_d, used_old_d),
        _resource_scores_cols(request, enabled, alloc_new_d, used_new_d),
        delta_idx,
        delta_valid,
        delta_cpu,
        per_object["max_clusters"],
        per_object["mode_divide"],
        per_object["weights_given"],
        sticky_active,
        fin_idx,
        nfeas,
    )


def drift_gate_dense(
    per_object: dict, prev_feas, prev_scores, alloc_old_d, used_old_d,
    alloc_new_d, used_new_d, delta_idx, delta_valid, delta_cpu, fin_idx, nfeas,
):
    """Drift gate over a chunk's dense device-resident per-object planes.

    ``*_old_d``/``*_new_d`` are the old and new cluster tensors at the
    changed columns (i64[D, R]); ``delta_idx`` i32[D] names the columns
    (padding slots carry an out-of-range index and ``delta_valid``
    False); ``fin_idx`` i32[Nf] the finite-maxClusters rows; ``nfeas``
    i32[B] the stored feasible counts.  Returns (i8[B] mask, i32[B, D]
    the changed columns' new totals, for ``refresh_scores``)."""
    c = prev_feas.shape[1]
    d_safe = torch.clamp(delta_idx.to(torch.int64), 0, c - 1)
    fit_new = F.resources_fit(per_object["request"], alloc_new_d, used_new_d)
    fea_new_d, _ = F.combine_filters_explain(
        per_object["filter_enabled"],
        per_object["api_ok"][:, d_safe],
        per_object["taint_ok_new"][:, d_safe],
        per_object["taint_ok_cur"][:, d_safe],
        per_object["current_mask"][:, d_safe],
        fit_new,
        per_object["placement_has"],
        per_object["placement_ok"][:, d_safe],
        per_object["selector_ok"][:, d_safe],
    )
    fea_new_d = fea_new_d & per_object["webhook_ok"][:, d_safe]
    sticky_active = per_object["sticky"] & per_object["current_mask"].any(dim=1)
    return _gate_tail(
        per_object, fea_new_d, sticky_active, prev_feas, prev_scores,
        alloc_old_d, used_old_d, alloc_new_d, used_new_d,
        delta_idx, delta_valid, delta_cpu, fin_idx, nfeas,
    )


def drift_gate_compact(
    per_object: dict, tables: dict, prev_feas, prev_scores, alloc_old_d,
    used_old_d, alloc_new_d, used_new_d, delta_idx, delta_valid, delta_cpu,
    fin_idx, nfeas, cur_absent,
):
    """The drift gate over compact per-object tensors: the changed
    columns' filter masks are gathered from the vocabulary tables (a
    D-column slice of ``expand_compact``), so no [B, C] plane is built.
    Returns what ``drift_gate_dense`` returns."""
    c = prev_feas.shape[1]
    d_safe = torch.clamp(delta_idx.to(torch.int64), 0, c - 1)
    tol_id = per_object["tol_id"].long()
    api = tables["api_matrix"][:, d_safe][per_object["gvk_id"].long()]
    trow = tables["taint_set_id"][d_safe].long()
    taint_new = tables["taint_new"][tol_id][:, trow]
    taint_cur = tables["taint_cur"][tol_id][:, trow]
    selector = tables["sel_matrix"][:, d_safe][per_object["sel_id"].long()]
    placement = tables["place_matrix"][:, d_safe][per_object["place_id"].long()]
    cur_present = per_object["sparse_cur"] != int(cur_absent)  # [B, P]
    current_d = (
        (per_object["sparse_idx"].to(torch.int64)[:, :, None]
         == delta_idx.to(torch.int64)[None, None, :])
        & cur_present[:, :, None]
    ).any(dim=1)
    fit_new = F.resources_fit(per_object["request"], alloc_new_d, used_new_d)
    fea_new_d, _ = F.combine_filters_explain(
        per_object["filter_enabled"],
        api,
        taint_new,
        taint_cur,
        current_d,
        fit_new,
        per_object["placement_has"],
        placement,
        selector,
    )
    sticky_active = per_object["sticky"] & cur_present.any(dim=1)
    return _gate_tail(
        per_object, fea_new_d, sticky_active, prev_feas, prev_scores,
        alloc_old_d, used_old_d, alloc_new_d, used_new_d,
        delta_idx, delta_valid, delta_cpu, fin_idx, nfeas,
    )


def refresh_scores(prev_scores, cols, new_cols):
    """Write a gate's new totals into the stored score plane in place:
    ``cols`` i64[nv] are the real changed columns (the first nv delta
    slots), ``new_cols`` the gate's i32[B, D].  A scatter of nv columns,
    not a copy of the plane.  Returns ``prev_scores``."""
    if cols.numel():
        prev_scores.index_copy_(1, cols, new_cols[:, : cols.numel()])
    return prev_scores


def drift_wcheck(prev_feas, rows_idx, cpu_alloc_old, cpu_avail_old,
                 cpu_alloc_new, cpu_avail_new):
    """Dynamic-weight check of gate-classified wcheck rows, whose
    selection is their feasible set: i8[K], 1 where the weights over
    prev_feas differ between the old and new cpu planes (the row is
    recomputed).  Integer arithmetic in int64 throughout."""
    sel = prev_feas[rows_idx] != 0
    w_old = dynamic_weights(sel, cpu_alloc_old, cpu_avail_old)
    w_new = dynamic_weights(sel, cpu_alloc_new, cpu_avail_new)
    return (w_old != w_new).any(dim=-1).to(torch.int8)
