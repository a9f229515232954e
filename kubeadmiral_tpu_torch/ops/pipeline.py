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
``drift_wcheck``, ``drift_survivor``, and the three-stream revert's
``drift_resolve`` and ``drift_replan``) classify
and re-solve the rows a capacity drift can move from the stored planes
of the previous tick; ``compress_scores`` keeps a score plane in f16.
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


def expand_compact(ci, key_len_max=None, col0: int = 0) -> TickInputs:
    """Device-side expansion of CompactInputs into the dense planes the
    tick consumes: vocabulary-table gathers, sparse policy scatters and
    the FNV-1 tie-break plane.  Bit-exact with scheduler/featurize.py.
    ``key_len_max``: a host-side bound on the rows' key lengths, where
    the FNV scan may stop (``fnv_tiebreak_plane``).  ``col0``: the global
    column of the tables' first column, on a column block of the mesh's
    clusters axis (the sparse entries name global columns; those
    outside the block are dropped)."""
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

    idx = ci.sparse_idx if col0 == 0 else ci.sparse_idx - col0
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


def _planner_weights(inp: TickInputs, selected, dyn_w=None):
    """Static-or-dynamic per-cluster weights, zeroed outside the
    selection (``dyn_w``: the dynamic weights, given on a column block
    of the mesh's clusters axis)."""
    if dyn_w is None:
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
    inp: TickInputs, feasible, reasons, totals, selected, divide_replicas,
    sticky_active=None,
) -> TickOutputs:
    """Select/divide reason bits, Duplicate-vs-Divide output shaping,
    the sticky-cluster short-circuit, and the reasons==0-iff-selected
    invariant.  All elementwise but the rows' sticky flag
    (``sticky_active`` bool[B], given on a column block, where the
    current mask's row OR spans every block)."""
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
    if sticky_active is None:
        sticky_active = inp.sticky & inp.current_mask.any(dim=-1)
    sticky_active = sticky_active[:, None]
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
    (comp, key_ok bool[B]); ``_cert_inf`` is the certificate's
    sentinel for the same key width.  With ``i32_keys`` and a cluster
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
            return comp, key_ok
    key1 = torch.where(feasible, -totals.to(torch.int32), _I32_MAX)
    comp = key1.to(torch.int64) * c + iota
    return comp, torch.ones_like(feasible[:, 0])


def _decode_comp(sorted_comp, c, i32_keys):
    """Low-bits decode of a sorted composite back to column indices
    (int64, floor-mod for the negative int64 keys)."""
    if i32_keys and _cbits(c) <= 18:
        return (sorted_comp & ((1 << _cbits(c)) - 1)).to(torch.int64)
    return sorted_comp.to(torch.int64) % c


def _cert_inf(c: int, i32_keys: bool) -> int:
    """The select certificate's sentinel for the key width in use."""
    return _I32_MAX if (i32_keys and _cbits(c) <= 18) else _CERT_INF


# -- the narrow solve's stages ---------------------------------------------
# The narrow solve and the packed wire are written as block stages over
# the columns [c0, c0 + width) of a padded cluster axis of c columns, and
# merge stages over the blocks' small [rows, k] partials, given as lists
# in column order.  ``_narrow_solve``, ``_plan_topm`` and ``pack_rows``
# are their composition on one block of every column; under the mesh's
# clusters axis ``ops/split.py`` runs the block stages on every entry and
# the merges on entry (i, 0).  The row's top-M (top-K) is merged exactly
# from each block's first M (K): the keys are unique across the row.


def reduce_blocks(parts: list, op: str) -> torch.Tensor:
    """The row's blocks' partials combined elementwise in column order:
    "sum", "max", "min", "any" or "all"."""
    out = parts[0]
    for p in parts[1:]:
        if op == "sum":
            out = out + p
        elif op == "max":
            out = torch.maximum(out, p)
        elif op == "min":
            out = torch.minimum(out, p)
        elif op == "any":
            out = out | p
        elif op == "all":
            out = out & p
        else:
            raise ValueError(f"reduce_blocks: unknown op {op!r}")
    return out


def merge_topk(keys: list, payloads: list, k: int, descending: bool = False):
    """The first ``k`` of the union of the blocks' ranked candidates:
    ``keys`` the blocks' ``[rows, t_j]`` keys, each block's in order
    (unique within a row across blocks), ``payloads`` per block a tuple
    of ``[rows, t_j]`` values riding with each key.  Returns (the k keys
    in order, the payloads gathered alongside).  Exact: each block sent
    at least its share of the union's first k.  One block is its own
    merge."""
    if len(keys) == 1:
        return keys[0][:, :k], [p[:, :k] for p in (payloads[0] if payloads else ())]
    cat = torch.cat(keys, dim=1)
    order = torch.sort(cat, dim=1, descending=descending).indices[:, :k]
    riding = [
        torch.cat([p[n] for p in payloads], dim=1).gather(1, order)
        for n in range(len(payloads[0]) if payloads else 0)
    ]
    return cat.gather(1, order), riding


def _block_iota(rows: int, c0: int, width: int, device) -> torch.Tensor:
    """The block's global column indices, [rows, width]."""
    return torch.arange(c0, c0 + width, dtype=torch.int64, device=device).expand(rows, width)


def _slots(cols, c0: int, width: int):
    """Global column indices [rows, k] -> (in this block, the block-local
    index; the spare column ``width`` for slots of other blocks)."""
    inside = (cols >= c0) & (cols < c0 + width)
    return inside, torch.where(inside, cols - c0, width)


def _spread(local, vals, width: int, fill, dtype) -> torch.Tensor:
    """[rows, width] grid of ``vals`` at ``local`` (slots of other blocks
    land in the spare column past the block and are dropped)."""
    grid = torch.full((local.shape[0], width + 1), fill, dtype=dtype, device=local.device)
    grid.scatter_(1, local, vals.to(dtype))
    return grid[:, :width]


def _take_slots(plane, inside, local):
    """``plane`` at the slots' block-local columns, zero (False) where a
    slot lies in another block."""
    got = plane.gather(1, torch.clamp(local, max=plane.shape[1] - 1))
    return torch.where(inside, got, torch.zeros((), dtype=plane.dtype, device=plane.device))


def _own(parts: list, inside: list):
    """The blocks' ``_take_slots`` gathers joined: each slot from the
    block that owns it."""
    out = parts[0]
    for part, own in zip(parts[1:], inside[1:]):
        out = torch.where(own, part, out)
    return out


class SelectPart(NamedTuple):
    """A block's part of the select stage: its feasible count, key
    range flag, and first M + 1 keys with their cells' feasibility and
    totals (a field per block in a merge)."""

    nfeas: torch.Tensor  # i32[rows]
    key_ok: torch.Tensor  # bool[rows]
    keys: torch.Tensor  # [rows, t] the block's first keys, ascending
    fea: torch.Tensor  # bool[rows, t]
    tot: torch.Tensor  # [rows, t]


def select_block(totals, feasible, c0: int, c: int, m: int, i32_keys: bool):
    """Block stage of the narrow select: (the block's composite keys,
    its ``SelectPart``).  One more key than M, so that the best feasible
    non-candidate is the merge's too."""
    rows, width = feasible.shape
    iota = _block_iota(rows, c0, width, feasible.device)
    comp, key_ok = _select_comp(totals, feasible, c, iota, i32_keys)
    t = min(min(m, c) + 1, width)
    keys, order = torch.sort(comp, dim=-1)
    order = order[:, :t]
    return comp, SelectPart(
        feasible.sum(dim=-1, dtype=torch.int32), key_ok, keys[:, :t],
        feasible.gather(1, order), totals.gather(1, order),
    )


def select_merge(parts: SelectPart, max_clusters, c: int, m: int, i32_keys: bool):
    """Merge stage of the narrow select over the blocks' parts (each
    field a list in column order): (candidate columns ascending [rows,
    M], their selection, kinf, the certificate but its best feasible
    non-candidate, the worst selected key)."""
    cert_inf = _cert_inf(c, i32_keys)
    nfeas = reduce_blocks(parts.nfeas, "sum")
    key_ok = reduce_blocks(parts.key_ok, "all")
    keys, (fea_m, tot_m) = merge_topk(parts.keys, list(zip(parts.fea, parts.tot)), min(m, c))
    cols = _decode_comp(keys, c, i32_keys)
    # Ascending: the narrow slot order keeps the dense index order.
    order = torch.sort(cols, dim=-1).indices
    cand_s = cols.gather(1, order)
    fea_s = fea_m.gather(1, order)
    sel_n = select_topk(tot_m.gather(1, order), fea_s, max_clusters)
    worst_sel = torch.where(sel_n, keys.gather(1, order), -cert_inf).amax(dim=-1)
    k_eff = torch.where(max_clusters < 0, 0, torch.clamp(max_clusters, max=c))
    # The cut cannot engage: selection is the feasible set, no sort.
    kinf = k_eff >= nfeas
    # Select certificate: the narrow cut had enough feasible candidates
    # to fill k (or saw every feasible column); ``select_cert`` adds
    # that every feasible non-candidate ranks after every selection.
    nf_cand = fea_s.sum(dim=-1, dtype=torch.int32)
    pre_cert = key_ok & ((nf_cand >= k_eff) | (nfeas == nf_cand))
    return cand_s, sel_n, kinf, pre_cert, worst_sel


def selected_block(feasible, comp, cand_s, sel_n, kinf, c0: int, cert_inf: int):
    """Block stage: (the block's selection, its best feasible
    non-candidate key)."""
    width = feasible.shape[1]
    inside, local = _slots(cand_s, c0, width)
    cand_mask = _spread(local, inside, width, False, torch.bool)
    sel_scatter = _spread(local, sel_n & inside, width, False, torch.bool)
    selected = torch.where(kinf[:, None], feasible, sel_scatter)
    best_out = torch.where(feasible & ~cand_mask, comp, cert_inf).amin(dim=-1)
    return selected, best_out


def select_cert(best_out_b: list, kinf, pre_cert, worst_sel):
    """Merge stage: the select certificate."""
    return kinf | (pre_cert & (reduce_blocks(best_out_b, "min") > worst_sel))


def _special(inp: TickInputs):
    """Columns with planner structure."""
    return (
        (inp.min_replicas > 0)
        | (inp.max_replicas != _INF)
        | (inp.scale_max != _INF)
        | (inp.capacity != _INF)
        | inp.current_mask
    )


def planner_block(inp: TickInputs, selected, weights, c0: int, c: int, m: int):
    """Block stage of the top-M planner: (special, the true processing
    keys, the block's first M of the negated slot keys, ascending)."""
    special = _special(inp)
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
    # columns (masked off by the members).  Bit for bit as the JAX
    # package, including the wrap of the one key that can reach 2**63.
    cbits = _cbits(c)
    shift = max(0, 53 + cbits - 63)
    rows, width = selected.shape
    inv_iota = ((1 << cbits) - 1) - _block_iota(rows, c0, width, selected.device)
    key_p = torch.where(
        selected, (((comp_prio >> shift) + 1) << cbits) | inv_iota, inv_iota
    )
    t = min(min(m, c), width)
    return special, comp_true, torch.sort(-key_p, dim=-1).values[:, :t]


def planner_members(neg_b: list, c: int, m: int):
    """Merge stage: the top-M members' columns, ascending [rows, M]."""
    low = (1 << _cbits(c)) - 1
    neg, _ = merge_topk(neg_b, [], min(m, c))
    return torch.sort(low - ((-neg) & low), dim=-1).values


def planner_slots_block(inp: TickInputs, selected, weights, special, comp_true, cand_p,
                        c0: int):
    """Block stage: (which slots lie here, the planner's planes at them,
    and the phantom tail's weight sum, best true key and structure flag
    over the block's members outside the slots)."""
    width = selected.shape[1]
    inside, local = _slots(cand_p, c0, width)
    outside = selected & ~_spread(local, inside, width, False, torch.bool)
    planes = (
        selected, weights, inp.min_replicas, inp.max_replicas, inp.scale_max,
        inp.capacity, inp.tiebreak, _current_plane(inp), comp_true,
    )
    return (
        inside,
        tuple(_take_slots(p, inside, local) for p in planes),
        torch.where(outside, torch.clamp(weights, min=0), 0).sum(dim=-1, dtype=torch.int32),
        torch.where(outside, comp_true, -1).amax(dim=-1),
        (outside & special).any(dim=-1),
    )


def planner_merge(inside_b: list, taken_b: tuple, tail_w_b: list, best_tail_b: list,
                  spec_out_b: list, total, avoid_disruption, keep_unschedulable, budget=None):
    """Merge stage: ``plan_batch_narrow`` over the M slots.  Returns
    (the slots' replicas i64[rows, M], the planner certificate)."""
    member, w, mn, mx, smax, cap, tb, cur, ctrue = (
        _own(blocks, inside_b) for blocks in taken_b
    )
    plan_out, pcert = plan_batch_narrow(
        PlannerInputs(
            weight=w,
            min_replicas=torch.where(member, mn, 0),
            max_replicas=mx,
            scale_max=smax,
            capacity=cap,
            tiebreak=tb,
            member=member,
            total=total,
            current=cur,
            avoid_disruption=avoid_disruption,
            keep_unschedulable=keep_unschedulable,
        ),
        reduce_blocks(tail_w_b, "sum"),
        reduce_blocks(best_tail_b, "max"),
        ctrue,
        budget,
    )
    divide_n = (plan_out.plan + plan_out.overflow).to(torch.int64)
    return divide_n, pcert & ~reduce_blocks(spec_out_b, "any")


def planner_spread(cand_p, divide_n, c0: int, width: int):
    """Block stage: the slots' replicas on the block's columns."""
    inside, local = _slots(cand_p, c0, width)
    return _spread(local, torch.where(inside, divide_n, 0), width, 0, torch.int64)


def _plan_topm(inp: TickInputs, selected, weights, m: int, budget=None):
    """The planner over the top-M member slots in ITS OWN processing
    order.  Returns (divide_replicas i64[B, C], cert bool[B]); cert holds
    iff ``plan_batch_narrow``'s phantom-tail certificate held and no
    selected column with planner structure was left outside the slots."""
    c = selected.shape[1]
    special, comp_true, neg = planner_block(inp, selected, weights, 0, c, m)
    cand_p = planner_members([neg], c, m)
    inside, taken, tail_w, best_tail, spec_out = planner_slots_block(
        inp, selected, weights, special, comp_true, cand_p, 0
    )
    divide_n, plan_cert = planner_merge(
        [inside], tuple([t] for t in taken), [tail_w], [best_tail], [spec_out],
        inp.total, inp.avoid_disruption, inp.keep_unschedulable, budget,
    )
    return planner_spread(cand_p, divide_n, 0, c), plan_cert


def _narrow_solve(
    inp: TickInputs, feasible, reasons, totals, m: int, i32_keys: bool, budget=None
):
    """Select + planner over M candidate columns, given the phase-1
    triple.  Returns (outputs, cert i8[B])."""
    c = feasible.shape[1]
    comp, part = select_block(totals, feasible, 0, c, m, i32_keys)
    cand_s, sel_n, kinf, pre_cert, worst_sel = select_merge(
        SelectPart(*([f] for f in part)), inp.max_clusters, c, m, i32_keys
    )
    selected, best_out = selected_block(
        feasible, comp, cand_s, sel_n, kinf, 0, _cert_inf(c, i32_keys)
    )
    cert_sel = select_cert([best_out], kinf, pre_cert, worst_sel)

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


class PackPart(NamedTuple):
    """A block's part of the packed wire: its first K selected cells by
    the wire's (-score, index) key with their values, and its counts (a
    field per block in a merge)."""

    keys: torch.Tensor   # i64[rows, t] the block's first keys, ascending
    sel: torch.Tensor    # bool[rows, t]
    rep: torch.Tensor    # i32[rows, t]
    cnt: torch.Tensor    # i32[rows, t]
    sco: torch.Tensor    # i32[rows, t]
    nsel: torch.Tensor   # i32[rows]
    nfeas: torch.Tensor  # i64[rows]
    rsum: torch.Tensor   # i64[rows, NUM_REASON_BITS]


def pack_block(selected, replicas, counted, scores, reasons, c0: int, c: int,
               k: int) -> PackPart:
    """Block stage of ``pack_rows`` over the columns [c0, c0 + width):
    one sort of the collision-free int64 composite ``key1 * C + iota``
    with the global index."""
    rows, width = selected.shape
    selb = selected != 0
    key1 = torch.where(selb, -scores.to(torch.int32), _I32_MAX)
    comp = key1.to(torch.int64) * c + _block_iota(rows, c0, width, selected.device)
    keys, order = torch.sort(comp, dim=-1)
    t = min(min(k, c), width)
    order = order[:, :t]
    rsn = reasons.to(torch.int32)
    valid_slot = (rsn & RSN.REASON_CLUSTER_INVALID) == 0
    rsum = torch.stack(
        [(((rsn & bit) != 0) & valid_slot).sum(dim=-1) for bit in RSN.REASON_BITS],
        dim=-1,
    )
    return PackPart(
        keys[:, :t],
        selb.gather(1, order),
        *(p.to(torch.int32).gather(1, order) for p in (replicas, counted, scores)),
        selb.sum(dim=-1, dtype=torch.int32),
        (((rsn & RSN.FILTER_REASON_MASK) == 0) & valid_slot).sum(dim=-1),
        rsum,
    )


def pack_merge(parts: PackPart, c: int, k: int) -> PackedRows:
    """Merge stage of ``pack_rows`` over the blocks' parts (each field a
    list in column order): the first K slots of the row, decoded by
    floor-mod, and the counts summed."""
    keys, (valid, rep, cnt, sco) = merge_topk(
        parts.keys, list(zip(parts.sel, parts.rep, parts.cnt, parts.sco)), min(k, c)
    )

    def take(v):
        return torch.where(valid, v, 0)

    return PackedRows(
        idx=torch.where(valid, keys % c, PACK_FILL).to(torch.int32),
        rep=take(rep),
        cnt=take(cnt),
        sco=take(sco),
        nsel=reduce_blocks(parts.nsel, "sum"),
        nfeas=reduce_blocks(parts.nfeas, "sum").to(torch.int32),
        rsum=reduce_blocks(parts.rsum, "sum").to(torch.int32),
    )


def pack_rows(selected, replicas, counted, scores, reasons, k: int) -> PackedRows:
    """Top-k-compact [N, C] output planes into the packed layout.  Slot
    order is (score desc, cluster index asc) over the selected clusters —
    select's own ranking: ``pack_block`` and ``pack_merge`` on one block
    of every column."""
    c = selected.shape[1]
    part = pack_block(selected, replicas, counted, scores, reasons, 0, c, k)
    return pack_merge(PackPart(*([f] for f in part)), c, k)


def wire_width(k: int) -> int:
    """Column count of a packed wire row: 4 K-wide planes + nsel + nfeas
    + the reason-summary counts."""
    return 4 * k + 2 + RSN.NUM_REASON_BITS


def wire_of(p: PackedRows) -> torch.Tensor:
    """The packed layout as ONE i32[N, wire_width(k)] tensor."""
    return torch.cat(
        [p.idx, p.rep, p.cnt, p.sco, p.nsel[:, None], p.nfeas[:, None], p.rsum],
        dim=-1,
    )


def pack_wire(selected, replicas, counted, scores, reasons, k: int) -> torch.Tensor:
    """The packed layout as ONE i32[N, wire_width(k)] tensor: a single
    device->host copy per fetch."""
    return wire_of(pack_rows(selected, replicas, counted, scores, reasons, k))


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


# -- drift: the three-stream survivor programs ----------------------------
# The engine's revert of the unified survivor stream sends a gated
# chunk's survivors through three programs: rows without a fit flip
# through the sort-free ``drift_resolve``, kinf fit-flip rows through the
# selection-known ``drift_replan``, finite-K fit-flip rows through the
# score-only solve (JAX's ``drift_scoreonly``, the same solve as
# ``drift_survivor``).  Each certifies per row; failures take the slabs.


def drift_replan(inp: TickInputs, reasons_rows, scores_rows, m: int):
    """Selection-known replan of kinf fit-flip survivors [n, C]: the cut
    cannot engage, so the new selection is the new feasible set from
    ``_stored_filters``; Divide rows run the top-M planner leg.  Scores
    are not recomputed: the outputs carry ``scores_rows`` (the stored
    plane), which no decision of a kinf row reads.  Returns (outputs,
    cert i8[n]); cert == 1 guarantees the dense tick's placements,
    replicas and reasons."""
    c = inp.cluster_valid.shape[0]
    feasible, base_reasons = _stored_filters(inp, reasons_rows)
    nfeas = feasible.sum(dim=-1, dtype=torch.int32)
    k_eff = torch.where(
        inp.max_clusters < 0, 0, torch.clamp(inp.max_clusters, max=c)
    )
    kinf = (inp.max_clusters == _INF) | (k_eff >= nfeas)
    # A negative maxClusters selects nothing.
    selected = feasible & (inp.max_clusters >= 0)[:, None]
    sticky_active = inp.sticky & inp.current_mask.any(dim=-1)
    weights = _planner_weights(inp, selected)
    divide_replicas, plan_cert = _plan_topm(inp, selected, weights, m)
    cert = (
        (kinf | (inp.max_clusters < 0))
        & ~sticky_active
        & (~inp.mode_divide | plan_cert)
    )
    out = _finalize(inp, feasible, base_reasons, scores_rows, selected, divide_replicas)
    return out, cert.to(torch.int8)


def drift_resolve(
    inp: TickInputs,   # gathered survivor rows [n, C] (expanded)
    prev_feas_rows,    # i8[n, C] stored feasibility rows
    scores_rows,       # i32[n, C] gate-refreshed score rows (the new totals)
    reasons_rows,      # i32[n, C] stored reason rows
    alloc_old_d,       # i64[D, R] old cluster tensors at the changed columns
    used_old_d,
    alloc_new_d,       # i64[D, R] new cluster tensors at the changed columns
    used_new_d,
    delta_idx,         # i32[D] changed columns (padding: out of range)
    delta_valid,       # bool[D]
    m: int,            # candidate slots (the engine's narrow M)
):
    """Sort-free re-solve of gate survivors without a fit flip.

    Phase 1 is known: feasibility is the stored plane and the refreshed
    score plane holds the new totals.  The new top-K lies in the old
    selection (stored feasible columns without a MAX_CLUSTERS bit), the
    feasible changed columns and the best D feasible outsiders by the
    (-total, index) key (unchanged columns keep their order, and an
    outsider enters only when a changed column leaves): D iterated
    argmins, no sort.  Select and the planner (zero phantom tail: the
    selection lies in the slots) run over those at most M columns.
    Returns (outputs [n, C], cert i8[n]); cert == 1 guarantees the
    dense tick's outputs; rows with 0 (fit moved at a changed column,
    kinf, sticky, more than M candidates, planner certificate) take the
    slab path.  Scatters route out-of-range indices (unused slots, pad
    delta slots) to a spare column past the grid."""
    n, c = prev_feas_rows.shape
    d = delta_idx.shape[0]
    device = prev_feas_rows.device
    feas = prev_feas_rows != 0
    totals = scores_rows

    # Fit must not move at any changed column.
    fit_old_d = F.resources_fit(inp.request, alloc_old_d, used_old_d)
    fit_new_d = F.resources_fit(inp.request, alloc_new_d, used_new_d)
    cert = ~((fit_old_d != fit_new_d) & delta_valid[None, :]).any(dim=1)

    # The old select-stage selection, from the stored planes.
    sel_stage = feas & ((reasons_rows & RSN.REASON_MAX_CLUSTERS) == 0)
    nfeas = feas.sum(dim=-1, dtype=torch.int32)
    k_eff = torch.where(
        inp.max_clusters < 0, 0, torch.clamp(inp.max_clusters, max=c)
    )
    kinf = (inp.max_clusters == _INF) | (inp.max_clusters < 0) | (k_eff >= nfeas)
    sticky_active = inp.sticky & inp.current_mask.any(dim=-1)
    k_sel = sel_stage.sum(dim=-1, dtype=torch.int32)
    cert = cert & ~kinf & ~sticky_active & (k_sel == k_eff)

    # Candidates: old selection | feasible changed columns | best-D
    # feasible outsiders by the new composite key.
    didx64 = delta_idx.to(torch.int64)
    is_delta = torch.zeros(c + 1, dtype=torch.bool, device=device)
    is_delta[torch.where((didx64 >= 0) & (didx64 < c), didx64, c)] = delta_valid
    is_delta = is_delta[:c]
    iota = torch.arange(c, dtype=torch.int64, device=device).expand(n, c)
    comp = (-totals.to(torch.int64)) * c + iota
    avail = feas & ~sel_stage & ~is_delta[None, :]
    compm = torch.where(avail, comp, _CERT_INF)
    entrant = torch.zeros((n, c), dtype=torch.bool, device=device)
    # At most one outsider enters per valid changed column.
    nvd = delta_valid.to(torch.int32).sum()
    for t in range(d):
        mval = compm.amin(dim=-1, keepdim=True)
        pick = (compm == mval) & (mval < _CERT_INF) & (nvd > t)
        entrant = entrant | pick
        compm = torch.where(pick, _CERT_INF, compm)
    cand_mask = sel_stage | (is_delta[None, :] & feas) | entrant
    n_cand = cand_mask.sum(dim=-1, dtype=torch.int32)
    cert = cert & (n_cand <= m)

    # The candidates in m ascending slots (column c on unused slots):
    # slot order is column order, the narrow tie-break contract.
    pos = torch.cumsum(cand_mask.to(torch.int64), dim=-1) - 1
    slot = torch.clamp(torch.where(cand_mask, pos, m), max=m)
    cand = torch.full((n, m + 1), c, dtype=torch.int64, device=device)
    cand.scatter_(1, slot, iota)
    cand = cand[:, :m]
    valid_slot = cand < c
    cand_c = torch.clamp(cand, max=c - 1)

    def take(plane):
        return plane.gather(1, cand_c)

    def spread(vals, fill, dtype):
        grid = torch.full((n, c + 1), fill, dtype=dtype, device=device)
        grid.scatter_(1, cand, vals.to(dtype))
        return grid[:, :c]

    fea_s = take(feas) & valid_slot
    sel_n = select_topk(take(totals), fea_s, inp.max_clusters)
    selected = spread(sel_n, False, torch.bool)

    # The planner over the same slots, with a zero phantom tail.
    weights = _planner_weights(inp, selected)
    comp_true = processing_key(
        take(weights), take(inp.tiebreak), torch.zeros_like(sel_n)
    )
    plan_out, pcert = plan_batch_narrow(
        PlannerInputs(
            weight=torch.where(sel_n, take(weights), 0),
            min_replicas=torch.where(sel_n, take(inp.min_replicas), 0),
            max_replicas=take(inp.max_replicas),
            scale_max=take(inp.scale_max),
            capacity=take(inp.capacity),
            tiebreak=take(inp.tiebreak),
            member=sel_n,
            total=inp.total,
            current=take(_current_plane(inp)),
            avoid_disruption=inp.avoid_disruption,
            keep_unschedulable=inp.keep_unschedulable,
        ),
        torch.zeros(n, dtype=torch.int32, device=device),
        torch.full((n,), -1, dtype=torch.int64, device=device),
        comp_true,
    )
    divide_replicas = spread(plan_out.plan + plan_out.overflow, 0, torch.int64)
    cert = cert & (~inp.mode_divide | pcert)

    # Filter reasons: the stored bits with resources_fit recomputed
    # against the new planes (the one filter a drift can move);
    # _finalize re-derives the select and replica bits.
    fit_ok = F.resources_fit(inp.request, inp.alloc, inp.used)
    fit_bit = (
        inp.filter_enabled[:, F.F_RESOURCES_FIT, None] & ~fit_ok
    ).to(torch.int32) * RSN.REASON_RESOURCES_FIT
    base_reasons = (
        reasons_rows & ~(RSN.SELECT_REASON_MASK | RSN.REASON_RESOURCES_FIT)
    ) | fit_bit
    out = _finalize(inp, feas, base_reasons, totals, selected, divide_replicas)
    return out, cert.to(torch.int8)


# -- f16 score planes ------------------------------------------------------
# An engine may keep its resident score plane as float16 beside a per-row
# exactness vector: a row is exact iff every score survives the
# i32 -> f16 -> i32 round trip.  The f16 -> i32 leg saturates (+-inf to
# the int32 bounds, as XLA converts), so the vector never rests on a
# conversion C++ leaves undefined; every finite f16 value is an integer
# int32 holds.


def upcast_scores(f16):
    """Stored f16 scores -> i32, saturating the infinities."""
    finite = torch.isfinite(f16)
    back = torch.where(finite, f16, 0).to(torch.int32)
    back = torch.where(~finite & (f16 > 0), _I32_MAX, back)
    return torch.where(~finite & (f16 < 0), -_I32_MAX - 1, back)


def exact_rows(scores):
    """i8[n]: 1 where every score of the row round-trips through f16."""
    back = upcast_scores(scores.to(torch.float16))
    return (back == scores).all(dim=1).to(torch.int8)


def compress_scores(scores, old_exact=None):
    """i32[B, C] scores -> (f16[B, C], i8[B] exactness).  ``old_exact``
    is ANDed in: a plane refreshed through an inexact one stays inexact
    until a recompute stores fresh scores."""
    exact = exact_rows(scores)
    if old_exact is not None:
        exact = exact * old_exact
    return scores.to(torch.float16), exact


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
    i32[B, D] the changed columns' new totals).  The composition of
    the split stages below over the whole cluster axis."""
    b, c = prev_feas.shape
    d_safe = torch.clamp(delta_idx.to(torch.int64), 0, c - 1)
    pf_d = prev_feas[:, d_safe] != 0
    tot_old_d = prev_scores[:, d_safe].to(torch.int64)
    head = _classify_head(
        fea_new_d, pf_d, tot_old_d, res_old_d, res_new_d, delta_idx, delta_valid, delta_cpu,
        max_clusters, nfeas, fin_idx, c,
    )
    counts = None
    if delta_idx.shape[0] <= DRIFT_REFINE_MAX_COLS:
        counts = _refine_counts(
            prev_feas, prev_scores, delta_idx, delta_valid, fin_idx, head.key_old,
            head.key_new, 0, c,
        )
    return _classify_tail(head, counts, delta_valid, mode_divide, weights_given,
                          sticky_active, fin_idx, b)


# The gate's classification in three stages, so that a column block of
# the mesh's clusters axis runs the one stage that reads whole rows:
# _classify_head (per row, from the changed columns' gathered values),
# _refine_counts (per block: the exact top-K refinement's counts over
# the block's columns, summed over the blocks) and _classify_tail (per
# row).


class _GateHead(NamedTuple):
    fea_new_d: torch.Tensor  # bool[B, D]
    fitflip: torch.Tensor   # bool[B]
    dcpu: torch.Tensor      # bool[D]
    dcpu_any: torch.Tensor  # bool[B]
    kinf: torch.Tensor      # bool[B]
    pf_d: torch.Tensor      # bool[B, D]
    tot_new_d: torch.Tensor  # i64[B, D]
    key_old: torch.Tensor   # i64[Nf, D] the changed columns' keys, finite rows
    key_new: torch.Tensor
    k_fin: torch.Tensor     # i32[Nf, 1] the finite rows' K, clamped to [0, C]


def _classify_head(fea_new_d, pf_d, tot_old_d, res_old_d, res_new_d, delta_idx,
                   delta_valid, delta_cpu, max_clusters, nfeas, fin_idx, c: int):
    """The gate's per-row part before the refinement's counts: fit
    flips, cpu-changed columns, kinf, the new totals at the changed
    columns and their composite keys on the finite-K rows."""
    b = pf_d.shape[0]
    valid = delta_valid[None, :]
    fitflip = ((fea_new_d != pf_d) & valid).any(dim=1)
    dcpu = delta_cpu & delta_valid
    dcpu_any = (pf_d & dcpu[None, :]).any(dim=1)
    # The top-K cut cannot engage: unlimited, K >= nfeas, or negative K.
    kinf = (max_clusters == _INF) | (max_clusters < 0) | (max_clusters >= nfeas)
    tot_new_d = torch.where(pf_d, tot_old_d - res_old_d + res_new_d, 0)
    ridx = torch.clamp(fin_idx.to(torch.int64), 0, max(b - 1, 0))
    didx64 = delta_idx.to(torch.int64)
    key_old = (-tot_old_d[ridx]) * c + didx64[None, :]   # [Nf, D]
    key_new = (-tot_new_d[ridx]) * c + didx64[None, :]
    k_fin = torch.clamp(max_clusters[ridx], 0, c)[:, None]
    return _GateHead(fea_new_d, fitflip, dcpu, dcpu_any, kinf, pf_d, tot_new_d, key_old,
                     key_new, k_fin)


def _refine_counts(prev_feas, prev_scores, delta_idx, delta_valid, fin_idx, key_old,
                   key_new, c0: int, c: int):
    """The exact top-K refinement's counts over a block of columns
    starting at global column ``c0`` (of ``c``): per finite row and
    delta slot, the unchanged feasible columns whose (-total, index) key
    beats the slot's old and new keys.  i32[Nf, D] each; summed over
    the blocks they are the counts over the whole axis.  Scatters send
    out-of-range slots to a spare last slot (no boolean indexing: that
    would wait on the device)."""
    b, cb = prev_feas.shape
    d = delta_idx.shape[0]
    device = prev_feas.device
    local = delta_idx.to(torch.int64) - c0
    is_delta = torch.zeros(cb + 1, dtype=torch.bool, device=device)
    is_delta[torch.where((local >= 0) & (local < cb), local, cb)] = delta_valid
    is_delta = is_delta[:cb]
    ridx = torch.clamp(fin_idx.to(torch.int64), 0, max(b - 1, 0))
    pf_g = prev_feas[ridx] != 0                          # [Nf, Cb]
    iota = torch.arange(c0, c0 + cb, dtype=torch.int64, device=device)[None, :]
    comp = (-prev_scores[ridx].to(torch.int64)) * c + iota
    comp_u = torch.where(pf_g & ~is_delta[None, :], comp, _CERT_INF)

    def counts(key_d):
        return torch.stack(
            [(comp_u < key_d[:, t : t + 1]).sum(dim=1, dtype=torch.int32) for t in range(d)],
            dim=1,
        )

    return counts(key_old), counts(key_new)


def _classify_tail(head: _GateHead, counts, delta_valid, mode_divide, weights_given,
                   sticky_active, fin_idx, b: int):
    """The gate's rows classified, given the refinement's counts over
    the whole axis (None: the conservative rule past
    DRIFT_REFINE_MAX_COLS).  Returns (i8[B] mask, i32[B, D] new totals)."""
    device = head.pf_d.device
    valid = delta_valid[None, :]
    pf_d = head.pf_d
    if counts is not None:
        # Exact top-K refinement over the finite-K rows: a delta
        # column's membership before and after, counted with the select
        # stage's comparator packed into one collision-free int64 key.
        fin = fin_idx.to(torch.int64)
        ridx = torch.clamp(fin, 0, max(b - 1, 0))
        pf_d_g = pf_d[ridx]                                  # [Nf, D]
        e_mask = (pf_d_g & valid)[:, :, None]

        def above_counts(key_d, cnt):
            e_beats = key_d[:, :, None] < key_d[:, None, :]
            return cnt + (e_beats & e_mask).sum(dim=1, dtype=torch.int32)

        k = head.k_fin
        member_old = pf_d_g & (above_counts(head.key_old, counts[0]) < k)
        member_new = pf_d_g & (above_counts(head.key_new, counts[1]) < k)
        sel_moved_g = ((member_old != member_new) & valid).any(dim=1)
        # Finite-K dynamic-weight rows whose selection touches a
        # cpu-changed column: the wcheck cannot decide them.
        dyn_fin_g = ((member_old | member_new) & head.dcpu[None, :]).any(dim=1)
        exposed_g = sel_moved_g | (mode_divide[ridx] & ~weights_given[ridx] & dyn_fin_g)
        sel_exposed = torch.zeros(b + 1, dtype=torch.bool, device=device)
        sel_exposed[torch.where(fin < b, fin, b)] = exposed_g
        sel_exposed = sel_exposed[:b]
    else:
        # Conservative: any feasible delta column may cross the K cut.
        sel_exposed = ((head.fea_new_d | pf_d) & valid).any(dim=1)

    recompute = ~sticky_active & (head.fitflip | (~head.kinf & sel_exposed))
    # Sound only where the selection is the feasible set (kinf).
    wcheck = (
        ~sticky_active & ~recompute & head.kinf & mode_divide & ~weights_given
        & head.dcpu_any
    )
    mask = (
        recompute.to(torch.int8) * DRIFT_RECOMPUTE
        + wcheck.to(torch.int8) * DRIFT_WCHECK
        + (head.fitflip & ~sticky_active).to(torch.int8) * DRIFT_FITFLIP
    )
    return mask, head.tot_new_d.to(torch.int32)


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


_GATE_PLANES = (
    "api_ok", "taint_ok_new", "taint_ok_cur", "current_mask", "placement_ok",
    "selector_ok", "webhook_ok",
)


def _dense_delta_filters(per_object: dict, planes_d: dict, alloc_new_d, used_new_d):
    """New feasibility at the changed columns from the dense per-object
    planes gathered there (``planes_d``, each [B, D])."""
    fit_new = F.resources_fit(per_object["request"], alloc_new_d, used_new_d)
    fea_new_d, _ = F.combine_filters_explain(
        per_object["filter_enabled"],
        planes_d["api_ok"],
        planes_d["taint_ok_new"],
        planes_d["taint_ok_cur"],
        planes_d["current_mask"],
        fit_new,
        per_object["placement_has"],
        planes_d["placement_ok"],
        planes_d["selector_ok"],
    )
    return fea_new_d & planes_d["webhook_ok"]


def _delta_tables(tables: dict, d_safe) -> dict:
    """The vocabulary tables' columns at the changed columns (the taint
    tables whole): what the compact gate reads of them."""
    return {
        "api_matrix": tables["api_matrix"][:, d_safe],
        "taint_set_id": tables["taint_set_id"][d_safe],
        "taint_new": tables["taint_new"],
        "taint_cur": tables["taint_cur"],
        "sel_matrix": tables["sel_matrix"][:, d_safe],
        "place_matrix": tables["place_matrix"][:, d_safe],
    }


def _compact_delta_filters(per_object: dict, tables_d: dict, delta_idx, alloc_new_d,
                           used_new_d, cur_absent):
    """(new feasibility at the changed columns, sticky_active) of
    compact rows, from the tables' columns there (``_delta_tables``): a
    D-column slice of ``expand_compact``, no [B, C] plane built."""
    tol_id = per_object["tol_id"].long()
    api = tables_d["api_matrix"][per_object["gvk_id"].long()]
    trow = tables_d["taint_set_id"].long()
    taint_new = tables_d["taint_new"][tol_id][:, trow]
    taint_cur = tables_d["taint_cur"][tol_id][:, trow]
    selector = tables_d["sel_matrix"][per_object["sel_id"].long()]
    placement = tables_d["place_matrix"][per_object["place_id"].long()]
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
    return fea_new_d, per_object["sticky"] & cur_present.any(dim=1)


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
    planes_d = {name: per_object[name][:, d_safe] for name in _GATE_PLANES}
    fea_new_d = _dense_delta_filters(per_object, planes_d, alloc_new_d, used_new_d)
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
    fea_new_d, sticky_active = _compact_delta_filters(
        per_object, _delta_tables(tables, d_safe), delta_idx, alloc_new_d, used_new_d,
        cur_absent,
    )
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
