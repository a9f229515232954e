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
    weights, zero outside the selection mask.  The composition of the
    split stages below on one block of the cluster axis."""
    sums = weight_sums(selected, cpu_alloc, cpu_avail)
    tmp = weight_shares(selected, cpu_alloc, cpu_avail, sums)
    weight = weight_round(tmp, tmp.sum(dim=-1), selected)
    residual, max_w, first = combine_peaks([weight_peak(weight, selected, 0)])
    return weight_residual(weight, residual, max_w, first, 0)


# -- the split stages ---------------------------------------------------------
# On a column block of the mesh's clusters axis the weights need three
# per-row reductions over every block: the selection's count and cpu
# sums (weight_sums, summed), the shares' sum (weight_shares, summed),
# and the rounding's sum, maximum and first column at the maximum
# (weight_peak, combined by combine_peaks); weight_residual then hands
# the residual to that column in its own block.

_NO_COLUMN = 1 << 62  # weight_peak: no selected column at the maximum


def weight_sums(selected, cpu_alloc, cpu_avail):
    """i64[B, 3] over a block: the selected count, the selected
    cpu_alloc sum and the selected positive cpu_avail sum."""
    sel = selected
    alloc = torch.where(sel, cpu_alloc.to(torch.int64)[None, :], 0)
    avail_pos = torch.clamp(torch.where(sel, cpu_avail.to(torch.int64)[None, :], 0), min=0)
    return torch.stack(
        [sel.sum(dim=-1), alloc.sum(dim=-1), avail_pos.sum(dim=-1)], dim=-1
    )


def weight_shares(selected, cpu_alloc, cpu_avail, sums):
    """The block's pre-rounding shares (i64), given ``sums``, the rows'
    weight_sums over the whole cluster axis."""
    sel = selected
    n = torch.clamp(sums[:, 0:1], min=1)
    alloc_sum, avail_sum = sums[:, 1:2], sums[:, 2:3]

    # CalcWeightLimit: allocatable-CPU share * 1000 * 1.4 (rsp.go:183-213).
    alloc = torch.where(sel, cpu_alloc.to(torch.int64)[None, :], 0)
    equal = _round_half_div(torch.full_like(n, SUM_WEIGHT), n)
    limit = torch.where(
        alloc_sum == 0,
        equal,
        _round_half_div(alloc * SUPPLY_LIMIT_NUM, torch.clamp(alloc_sum, min=1)),
    )

    # AvailableToPercentage (rsp.go:215-272): available-CPU share, clamped.
    avail = torch.where(sel, cpu_avail.to(torch.int64)[None, :], 0)
    avail_pos = torch.clamp(avail, min=0)
    tmp = torch.where(
        avail_sum == 0,
        equal,
        torch.minimum(
            _round_half_div(avail_pos * SUM_WEIGHT, torch.clamp(avail_sum, min=1)),
            limit,
        ),
    )
    return torch.where(sel, tmp, 0)


def weight_round(tmp, tmp_sum, selected):
    """The block's rounded weights (i64), given ``tmp_sum`` [B], the
    rows' share sums over the whole cluster axis."""
    tmp_sum = tmp_sum[:, None]
    weight = torch.where(
        tmp_sum > 0,
        _round_half_div(tmp * SUM_WEIGHT, torch.clamp(tmp_sum, min=1)),
        0,
    )
    return torch.where(selected, weight, 0)


def weight_peak(weight, selected, c0: int):
    """i64[B, 3] over a block starting at global column ``c0``: the
    weights' sum, their maximum, and the first global column where a
    selected weight equals that maximum (``_NO_COLUMN``: none)."""
    max_w = weight.amax(dim=-1)
    at_max = (weight == max_w[:, None]) & selected
    first = torch.where(
        at_max.any(dim=-1),
        at_max.to(torch.int32).argmax(dim=-1).to(torch.int64) + c0,
        _NO_COLUMN,
    )
    return torch.stack([weight.sum(dim=-1), max_w, first], dim=-1)


def combine_peaks(peaks: list):
    """The blocks' weight_peak partials in column order -> (residual,
    maximum, first column at the maximum) per row: the residual of the
    rounding goes to the heaviest selected cluster, first index on
    ties."""
    stack = torch.stack(peaks)  # [blocks, B, 3]
    max_w = stack[:, :, 1].amax(dim=0)
    first = torch.where(stack[:, :, 1] == max_w[None, :], stack[:, :, 2], _NO_COLUMN)
    return SUM_WEIGHT - stack[:, :, 0].sum(dim=0), max_w, first.amin(dim=0)


def weight_residual(weight, residual, max_w, first, c0: int):
    """The block's final weights (i32): the residual added, clamped at
    zero, at the row's first maximum where it lies in this block."""
    iota = torch.arange(weight.shape[-1], dtype=torch.int64, device=weight.device) + c0
    is_first_max = iota[None, :] == first[:, None]
    weight = torch.where(
        is_first_max & (max_w > 0)[:, None],
        torch.clamp(weight + residual[:, None], min=0),
        weight,
    )
    return weight.to(torch.int32)
