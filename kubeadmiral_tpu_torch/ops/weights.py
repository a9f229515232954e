"""Dynamic cluster weights for replica scheduling.

Torch counterpart of ``kubeadmiral_tpu/ops/weights.py`` (reference:
rsp.go:183-272): when the policy provides no static weights, each
object's selected clusters are weighted by their share of available
CPU, clamped by an allocatable-share limit (x1.4), then re-normalized to
sum to 1000 with the rounding residual handed to the heaviest cluster.
All rounding is half-away-from-zero in exact integer arithmetic.
"""

from __future__ import annotations

import torch

from kubeadmiral_tpu_torch.ops.scores import floordiv

SUM_WEIGHT = 1000
# SUM_WEIGHT * 1.4 as an exact rational (rsp.go:183-213 supplyLimitRatio).
SUPPLY_LIMIT_NUM = 1400


def _round_half_div(num, den):
    """Round-half-away-from-zero of num/den for non-negative integers:
    floor((2*num + den) / (2*den))."""
    return floordiv(2 * num + den, 2 * den)


def dynamic_weights(selected, cpu_alloc, cpu_avail):
    """selected bool[B,C]; cpu_alloc/cpu_avail i64[C] -> i32[B,C]
    weights, zero outside the selection mask."""
    sel = selected
    cpu_alloc = cpu_alloc.to(torch.int64)
    cpu_avail = cpu_avail.to(torch.int64)
    n = torch.clamp(sel.sum(dim=-1, keepdim=True), min=1)

    # CalcWeightLimit: allocatable-CPU share * 1000 * 1.4 (rsp.go:183-213).
    alloc = torch.where(sel, cpu_alloc[None, :], 0)
    alloc_sum = alloc.sum(dim=-1, keepdim=True)
    equal = _round_half_div(torch.full_like(n, SUM_WEIGHT), n)
    limit = torch.where(
        alloc_sum == 0,
        equal,
        _round_half_div(alloc * SUPPLY_LIMIT_NUM, torch.clamp(alloc_sum, min=1)),
    )

    # AvailableToPercentage (rsp.go:215-272): available-CPU share, clamped.
    avail = torch.where(sel, cpu_avail[None, :], 0)
    avail_pos = torch.clamp(avail, min=0)
    avail_sum = avail_pos.sum(dim=-1, keepdim=True)
    tmp = torch.where(
        avail_sum == 0,
        equal,
        torch.minimum(
            _round_half_div(avail_pos * SUM_WEIGHT, torch.clamp(avail_sum, min=1)),
            limit,
        ),
    )
    tmp = torch.where(sel, tmp, 0)
    tmp_sum = tmp.sum(dim=-1, keepdim=True)
    weight = torch.where(
        tmp_sum > 0,
        _round_half_div(tmp * SUM_WEIGHT, torch.clamp(tmp_sum, min=1)),
        0,
    )
    weight = torch.where(sel, weight, 0)

    # Residual of the second rounding pass goes to the heaviest cluster
    # (first index on ties), clamped at zero.
    residual = SUM_WEIGHT - weight.sum(dim=-1, keepdim=True)
    max_w = weight.amax(dim=-1, keepdim=True)
    at_max = (weight == max_w) & sel
    is_first_max = (torch.cumsum(at_max.to(torch.int32), dim=-1) == 1) & at_max
    weight = torch.where(
        is_first_max & (max_w > 0), torch.clamp(weight + residual, min=0), weight
    )
    return weight.to(torch.int32)
