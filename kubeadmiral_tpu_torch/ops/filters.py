"""Filter stage: feasibility masks over [B objects x C clusters].

Torch counterpart of ``kubeadmiral_tpu/ops/filters.py``.  Each reference
filter plugin (pkg/controllers/scheduler/framework/plugins/*) is a
boolean mask; a disabled plugin contributes all-True.  String-world
plugins are pre-matched host-side by the featurizer, so this module only
combines masks and does the numeric resource-fit math.

Filter plugin indices (column order of ``filter_enabled``):
  0 APIResources, 1 TaintToleration, 2 ClusterResourcesFit,
  3 PlacementFilter, 4 ClusterAffinity.
"""

from __future__ import annotations

import torch

F_API_RESOURCES = 0
F_TAINT_TOLERATION = 1
F_RESOURCES_FIT = 2
F_PLACEMENT = 3
F_CLUSTER_AFFINITY = 4
NUM_FILTER_PLUGINS = 5

# Resource tensor column layout (shared with scores): fixed columns then
# dynamically discovered scalar/extended resources.
R_CPU = 0  # millicores
R_MEM = 1  # bytes
NUM_FIXED_RESOURCES = 2


def resources_fit(request, alloc, used):
    """ClusterResourcesFit (fit.go:47-131).  request i64[B, R];
    alloc/used i64[C, R] -> bool[B, C].  CPU and memory are always
    checked once any resource is requested; scalar columns only where
    the request is positive.  An all-zero request fits everywhere."""
    free_ok = alloc[None, :, :] >= request[:, None, :] + used[None, :, :]
    scalar_req = request[:, None, NUM_FIXED_RESOURCES:] > 0
    scalar_ok = free_ok[:, :, NUM_FIXED_RESOURCES:] | ~scalar_req
    fixed_ok = free_ok[:, :, R_CPU] & free_ok[:, :, R_MEM]
    ok = fixed_ok & scalar_ok.all(dim=-1)
    no_request = (request <= 0).all(dim=-1)
    return no_request[:, None] | ok


def combine_filters_explain(
    filter_enabled,  # bool[B, 5]
    api_ok,          # bool[B, C]
    taint_ok_new,    # bool[B, C]
    taint_ok_cur,    # bool[B, C]
    current_mask,    # bool[B, C]
    fit_ok,          # bool[B, C]
    placement_has,   # bool[B]
    placement_ok,    # bool[B, C]
    selector_ok,     # bool[B, C]
):
    """Conjunction of enabled filter plugins plus the per-(object,
    cluster) reason bitmask: bit i is set iff enabled plugin i rejected
    the pair.  Returns (feasible bool[B, C], reasons i32[B, C]) with
    ``feasible == (reasons == 0)`` by construction."""
    taint_ok = torch.where(current_mask, taint_ok_cur, taint_ok_new)
    placement = ~placement_has[:, None] | placement_ok
    reasons = torch.zeros(api_ok.shape, dtype=torch.int32, device=api_ok.device)
    for idx, ok in (
        (F_API_RESOURCES, api_ok),
        (F_TAINT_TOLERATION, taint_ok),
        (F_RESOURCES_FIT, fit_ok),
        (F_PLACEMENT, placement),
        (F_CLUSTER_AFFINITY, selector_ok),
    ):
        rejected = filter_enabled[:, idx, None] & ~ok
        reasons |= rejected.to(torch.int32) << idx
    return reasons == 0, reasons
