"""Score stage: per-(object, cluster) int scores + normalization.

Torch counterpart of ``kubeadmiral_tpu/ops/scores.py`` (reference:
pkg/controllers/scheduler/framework/plugins/...), masked to feasible
clusters and summed per the generic scheduler
(core/generic_scheduler.go:171-192).

Score plugin indices (column order of ``score_enabled``):
  0 TaintToleration, 1 ClusterResourcesBalancedAllocation,
  2 ClusterResourcesLeastAllocated, 3 ClusterAffinity,
  4 ClusterResourcesMostAllocated.

All arithmetic is exact integer math.  The JAX package divides with an
f64 estimate plus one correction step (``_floordiv_smallq``), which is
exact floor division wherever the quotient is small — every lane a
caller keeps.  Here ``floordiv`` is torch's exact 64-bit floor
division, so kept lanes match bit for bit and masked-out lanes (which
may carry negative or huge numerators) never matter.
"""

from __future__ import annotations

import torch

from kubeadmiral_tpu_torch.ops.filters import R_CPU, R_MEM

S_TAINT = 0
S_BALANCED = 1
S_LEAST = 2
S_AFFINITY = 3
S_MOST = 4
NUM_SCORE_PLUGINS = 5

MAX_CLUSTER_SCORE = 100

# Range-reduction thresholds for the exact balanced-allocation score:
# the smallest shift s (multiple of 8) with (x >> s) < 2^26 keeps the
# cross products below 2^52 so 100*(T-D) fits int64 exactly.
_BALANCED_SHIFT_THRESHOLDS = tuple(1 << (26 + 8 * k) for k in range(5))


def floordiv(num, den):
    """Exact floor division with the divisor clamped to >= 1 (the
    ``_floordiv_smallq`` contract)."""
    return torch.div(num, torch.clamp(den, min=1), rounding_mode="floor")


def _requested_totals(request, alloc, used):
    """Per-pair (allocatable, requested-including-this-object) for
    cpu+mem (calculateResourceAllocatableRequest, fit.go:160-183)."""
    req_cpu = used[None, :, R_CPU] + request[:, None, R_CPU]
    req_mem = used[None, :, R_MEM] + request[:, None, R_MEM]
    alloc_cpu = alloc[None, :, R_CPU].expand(req_cpu.shape)
    alloc_mem = alloc[None, :, R_MEM].expand(req_mem.shape)
    return alloc_cpu, alloc_mem, req_cpu, req_mem


def _balanced_range_shift(cap):
    s = torch.zeros_like(cap)
    for t in _BALANCED_SHIFT_THRESHOLDS:
        s = s + 8 * (cap >= t).to(cap.dtype)
    return s


def balanced_allocation_score(request, alloc, used):
    """(1 - |cpuFraction - memFraction|) * 100, 0 if either fraction
    >= 1 (balanced_allocation.go:45-78), as the exact rational
    |rc*am - rm*ac| / (ac*am) with range-shifted operands."""
    alloc_cpu, alloc_mem, req_cpu, req_mem = _requested_totals(request, alloc, used)
    infeasible = (
        (alloc_cpu == 0)
        | (alloc_mem == 0)
        | (req_cpu >= alloc_cpu)
        | (req_mem >= alloc_mem)
    )
    s_cpu = _balanced_range_shift(alloc_cpu)
    s_mem = _balanced_range_shift(alloc_mem)
    ac = alloc_cpu >> s_cpu
    rc = req_cpu >> s_cpu
    am = alloc_mem >> s_mem
    rm = req_mem >> s_mem
    total = torch.clamp(ac * am, min=1)
    diff_num = (rc * am - rm * ac).abs()
    score = floordiv(MAX_CLUSTER_SCORE * (total - diff_num), total)
    return torch.where(infeasible, 0, score)


def _ratio_score(req, alloc, least: bool):
    zero = alloc == 0
    over = req > alloc
    free = alloc - req if least else req
    score = floordiv(free * MAX_CLUSTER_SCORE, alloc)
    return torch.where(zero | over, 0, score)


def least_allocated_score(request, alloc, used):
    """((cap-req)*100//cap per resource, cpu+mem averaged) — least_allocated.go:42-93."""
    alloc_cpu, alloc_mem, req_cpu, req_mem = _requested_totals(request, alloc, used)
    s = _ratio_score(req_cpu, alloc_cpu, True) + _ratio_score(req_mem, alloc_mem, True)
    return torch.div(s, 2, rounding_mode="floor")


def most_allocated_score(request, alloc, used):
    """(req*100//cap per resource, cpu+mem averaged) — most_allocated.go:42-93."""
    alloc_cpu, alloc_mem, req_cpu, req_mem = _requested_totals(request, alloc, used)
    s = _ratio_score(req_cpu, alloc_cpu, False) + _ratio_score(req_mem, alloc_mem, False)
    return torch.div(s, 2, rounding_mode="floor")


def normalize(scores, feasible, reverse: bool):
    """DefaultNormalizeScore (framework/util.go:455-482) over feasible
    clusters of each object: scale to [0,100] by the per-object max; if
    the max is 0 -> all 100 when reversed, else left as-is."""
    masked = torch.where(feasible, scores, 0)
    return normalize_by(scores, feasible, reverse, masked.amax(dim=-1))


def normalize_by(scores, feasible, reverse: bool, max_count):
    """``normalize`` given each row's maximum of the masked scores
    (``max_count`` [B]), which a column block of the cluster axis cannot
    see whole: the rows' maxima over every block."""
    masked = torch.where(feasible, scores, 0)
    max_count = max_count.to(masked.dtype)[:, None]
    scaled = floordiv(MAX_CLUSTER_SCORE * masked, max_count)
    if reverse:
        scaled = MAX_CLUSTER_SCORE - scaled
        untouched = torch.full_like(masked, MAX_CLUSTER_SCORE)
    else:
        untouched = masked
    return torch.where(max_count == 0, untouched, scaled)


def total_scores(
    score_enabled,   # bool[B, 5]
    feasible,        # bool[B, C]
    request, alloc, used,
    taint_counts,    # int[B, C] intolerable PreferNoSchedule taints
    affinity_scores, # int[B, C] preferred-term weight sums
):
    """Sum of enabled, normalized plugin scores; 0 on infeasible
    clusters.  i64[B, C]."""
    plugin_scores = (
        (S_TAINT, normalize(taint_counts, feasible, reverse=True)),
        (S_BALANCED, balanced_allocation_score(request, alloc, used)),
        (S_LEAST, least_allocated_score(request, alloc, used)),
        (S_AFFINITY, normalize(affinity_scores, feasible, reverse=False)),
        (S_MOST, most_allocated_score(request, alloc, used)),
    )
    total = torch.zeros(feasible.shape, dtype=torch.int64, device=feasible.device)
    for idx, s in plugin_scores:
        total = total + torch.where(score_enabled[:, idx, None], s, 0)
    return torch.where(feasible, total, 0)
