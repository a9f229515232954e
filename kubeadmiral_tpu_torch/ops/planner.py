"""Batched replica planner in torch (the dense planner).

Torch counterpart of ``kubeadmiral_tpu/ops/planner.py``: the reference's
weighted fair distribution (pkg/controllers/util/planner/planner.go:
83-366) as dense tensor math over ``[B objects x C cluster slots]``.

The reference walks clusters one at a time, carrying a running remainder
``rem`` and handing each cluster ``take_j = min(c_j, rem)``; that
recurrence is ``rem' = max(rem - c_j, 0)``, whose prefix composition
has the closed form ``max(r0 - A_s, cummax(A_s) - A_s)`` with
``A_s = cumsum(c)`` — one cumsum and one cummax per pass
(``_running_remainder``).  The weighted rounds run batched: every row
steps while any row still moves, and a row that has stopped keeps its
state (what ``vmap`` of ``lax.while_loop`` does in the JAX package).
Since a stopped row keeps its state, extra rounds change nothing: under
a ``RoundBudget`` with a round count each loop runs that many rounds
without reading the device, and the rows still going after them are
reported (the caller re-solves those with the checked loop).

Value contract (int32 math, kept where the reference keeps it so
wraparound matches): ``total * max(weight) + sum(weight)`` must stay
below 2**31; ``validate_ranges`` enforces it host-side.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

INT32_INF = np.int32(np.iinfo(np.int32).max)
_INF = int(INT32_INF)


class PlannerInputs(NamedTuple):
    """One scheduling problem per row; cluster slots padded to C.

    All int32 (``member``, ``avoid_disruption`` and ``keep_unschedulable``
    bool).  ``INT32_INF`` marks absent max-replicas / capacity.
    ``scale_max`` is the max bound of the avoid-disruption scale-up pass
    (the directly named preference only, planner.go:320-324)."""

    weight: torch.Tensor        # [B, C]
    min_replicas: torch.Tensor  # [B, C]
    max_replicas: torch.Tensor  # [B, C]
    scale_max: torch.Tensor     # [B, C]
    capacity: torch.Tensor      # [B, C]
    tiebreak: torch.Tensor      # [B, C]
    member: torch.Tensor        # [B, C] bool — cluster participates
    total: torch.Tensor         # [B]
    current: torch.Tensor       # [B, C]
    avoid_disruption: torch.Tensor    # [B] bool
    keep_unschedulable: torch.Tensor  # [B] bool


class PlannerOutputs(NamedTuple):
    plan: torch.Tensor      # [B, C]
    overflow: torch.Tensor  # [B, C]


class RoundBudget:
    """How a solve runs its weighted-round loops.  ``rounds``: each loop
    runs that many rounds with no host read of the loop condition
    (``bool(go.any())`` waits for the card); None: until no row goes,
    read every round.  ``unsettled`` collects, over the solve's loops,
    the rows still going after their rounds (bool[B] on the device; None
    before the first loop): their results are not final.  With
    ``record``, ``per_row`` receives each loop's rounds per row (an
    int32 numpy array, read from the device after the loop)."""

    def __init__(self, rounds: Optional[int], record: bool = False):
        self.rounds = rounds
        self.unsettled = None
        self.per_row: Optional[list] = [] if record else None

    def run(self, step, state: tuple) -> tuple:
        """Apply ``step`` to ``state`` (whose last member is the [B, 1]
        go flag) for the budget's rounds."""
        counter = None
        if self.per_row is not None:
            counter = torch.zeros_like(state[-1], dtype=torch.int32)
        done = 0
        while (
            done < self.rounds if self.rounds is not None else bool(state[-1].any())
        ):
            if counter is not None:
                counter += state[-1]
            state = step(*state)
            done += 1
        if counter is not None:
            self.per_row.append(counter[:, 0].cpu().numpy())
        go = state[-1][:, 0]
        self.unsettled = go if self.unsettled is None else self.unsettled | go
        return state


def _running_remainder(r0, c):
    """Remainder seen by each slot in a sequential min-take pass: slot j
    gets ``rem`` after slots 0..j-1 each took ``min(c_i, rem)``.
    r0 [B, 1], c [B, C] -> [B, C], in c's dtype (wrapping int32)."""
    a_s = torch.cumsum(c, dim=-1, dtype=c.dtype)
    b_s = torch.cummax(a_s, dim=-1).values - a_s
    rem_after = torch.maximum(r0 - a_s, b_s)
    return torch.cat([r0.expand(-1, 1).to(c.dtype), rem_after[:, :-1]], dim=-1)


def _processing_order(weight_key, tiebreak):
    """Permutation sorting each row by (weight_key asc, tiebreak asc,
    index asc): both int32 keys pack into one collision-free int64
    (the signed high word keeps the order) and a STABLE sort supplies
    the index comparator."""
    key = (weight_key.to(torch.int64) << 32) + (tiebreak.to(torch.int64) + 2**31)
    return torch.sort(key, dim=-1, stable=True).indices


def _distribute(
    weight, min_replicas, max_replicas, capacity, tiebreak, member, total, keep,
    tail_weight=None, budget=None,
):
    """getDesiredPlan (planner.go:211-304) for every row.  ``total`` and
    ``keep`` are [B, 1].  Returns (plan, overflow, unplaced remainder
    [B, 1]) in the caller's cluster order.

    ``tail_weight`` ([B, 1]) serves the narrow planner
    (``plan_batch_narrow``): the cluster axis then holds only the top-M
    member slots, and ``tail_weight`` is the summed clamped weight of the
    members left out of them, added to every round's ``weight_sum`` so
    the ceil quotas match the full-width run while the tail itself
    receives nothing.  The result then also carries the final active set
    (cluster order) and the per-row ``spilled`` flag: some round's
    remainder survived past the slots, which the full-width cascade
    would have handed to the tail.

    ``budget`` (a RoundBudget): run its rounds; without one, rounds
    run until no row goes, the loop condition read every round."""
    # Processing order: members first, weight desc, tiebreak asc, index
    # asc.  Non-positive weight = no share; the sort runs on the
    # clamped weight.
    w_clamped = torch.clamp(weight, min=0)
    sort_weight = torch.where(member, -w_clamped, _INF)
    perm = _processing_order(sort_weight, tiebreak)
    w = w_clamped.gather(1, perm)
    min_r = min_replicas.gather(1, perm)
    max_r = max_replicas.gather(1, perm)
    cap = capacity.gather(1, perm)
    mem = member.gather(1, perm)

    # --- minReplicas pass (ignores max_replicas, clips at capacity) ---
    want_min = torch.where(mem, min_r, 0)
    take_cap = torch.minimum(want_min, cap)
    rem_before = _running_remainder(total, take_cap)
    plan = torch.minimum(take_cap, rem_before)
    wanted = torch.minimum(want_min, rem_before)
    overflow = torch.where(mem, torch.clamp(wanted - cap, min=0), 0)
    remaining = rem_before[:, -1:] - plan[:, -1:]

    # --- weighted rounds until every row reaches its fixed point ---
    active = mem
    moved = torch.ones_like(remaining, dtype=torch.bool)
    spilled = torch.zeros_like(remaining, dtype=torch.bool)
    go = moved & (remaining > 0)

    def one_round(plan, overflow, active, remaining, moved, spilled, go):
        w_active = torch.where(active, w, 0)
        weight_sum = w_active.sum(dim=-1, keepdim=True, dtype=w_active.dtype)
        if tail_weight is not None:
            # Phantom tail: out-of-slot members keep weighing in the
            # quota denominator every round (int32, wrapping).
            weight_sum = weight_sum + tail_weight
        d = remaining  # round-start snapshot
        safe_sum = torch.clamp(weight_sum, min=1)
        quota = torch.div(d * w_active + safe_sum - 1, safe_sum, rounding_mode="floor")
        quota = torch.where(active & (weight_sum > 0), quota, 0)

        allowed = torch.minimum(max_r, cap) - plan  # may be negative
        c_take = torch.where(active, torch.minimum(quota, allowed), 0)
        rem_r = _running_remainder(d, c_take)
        take = torch.minimum(c_take, rem_r)
        extra = torch.minimum(quota, rem_r)

        after_max = torch.minimum(plan + extra, max_r)
        new_overflow = overflow + torch.where(
            active, torch.clamp(after_max - cap, min=0), 0
        )
        full = active & ((plan + extra > max_r) | (after_max > cap))
        taken = torch.where(active, take, 0)
        new_plan = plan + taken
        new_remaining = d - taken.sum(dim=-1, keepdim=True, dtype=taken.dtype)
        new_moved = (taken > 0).any(dim=-1, keepdim=True) & (weight_sum > 0)

        # A row that has stopped keeps its state.
        plan = torch.where(go, new_plan, plan)
        overflow = torch.where(go, new_overflow, overflow)
        active = torch.where(go, active & ~full, active)
        remaining = torch.where(go, new_remaining, remaining)
        moved = torch.where(go, new_moved, moved)
        spilled = torch.where(go, spilled | (new_remaining > 0), spilled)
        return plan, overflow, active, remaining, moved, spilled, moved & (remaining > 0)

    state = (budget or RoundBudget(None)).run(
        one_round, (plan, overflow, active, remaining, moved, spilled, go)
    )
    plan, overflow, active, remaining, moved, spilled, go = state

    # Without keep_unschedulable, overflow is trimmed to what could not
    # be placed anywhere at all.
    overflow = torch.where(
        keep, overflow, torch.clamp(torch.minimum(overflow, remaining), min=0)
    )

    # Back to the caller's cluster order.
    inv_plan = torch.empty_like(plan).scatter_(1, perm, plan)
    inv_overflow = torch.empty_like(overflow).scatter_(1, perm, overflow)
    if tail_weight is not None:
        inv_active = torch.empty_like(active).scatter_(1, perm, active)
        return inv_plan, inv_overflow, remaining, inv_active, spilled[:, 0]
    return inv_plan, inv_overflow, remaining


def _keep(inp: PlannerInputs):
    """A reschedule would keep bouncing capacity-overflowed replicas if
    they were dropped while disruption is allowed (planner.go:108-118)."""
    return (inp.keep_unschedulable | ~inp.avoid_disruption)[:, None]


def _steady_plan(inp: PlannerInputs, desired, budget=None):
    """The avoid-disruption branch: move only the delta from the current
    replicas (scale up by shortfall, scale down by excess); rows without
    avoid-disruption take ``desired`` as is."""
    zeros = torch.zeros_like(inp.weight)
    no_cap = torch.full_like(inp.weight, _INF)
    no_keep = torch.zeros_like(inp.total[:, None], dtype=torch.bool)
    current_ok = torch.where(
        inp.member, torch.minimum(inp.current, inp.capacity), 0
    )
    current_total = current_ok.sum(dim=-1, keepdim=True, dtype=torch.int32)
    desired_total = desired.sum(dim=-1, keepdim=True, dtype=torch.int32)

    # Scale up: clusters below their desired share grow, weighted by the
    # shortfall, bounded by the directly-named max minus current.
    up_member = inp.member & (desired > current_ok)
    up_weight = torch.where(up_member, desired - current_ok, 0)
    up_max = torch.where(
        inp.scale_max == _INF, _INF, inp.scale_max - current_ok
    )
    grow, _, _ = _distribute(
        up_weight, zeros, up_max, no_cap, inp.tiebreak, up_member,
        torch.clamp(desired_total - current_total, min=0), no_keep, budget=budget,
    )

    # Scale down: clusters above their desired share shrink, weighted by
    # the excess, never below zero.
    down_member = inp.member & (desired < current_ok)
    down_weight = torch.where(down_member, current_ok - desired, 0)
    shrink, _, _ = _distribute(
        down_weight, zeros, torch.where(down_member, current_ok, _INF), no_cap,
        inp.tiebreak, down_member,
        torch.clamp(current_total - desired_total, min=0), no_keep, budget=budget,
    )

    steady = torch.where(
        current_total == desired_total,
        current_ok,
        torch.where(
            current_total > desired_total, current_ok - shrink, current_ok + grow
        ),
    )
    return torch.where(inp.avoid_disruption[:, None], steady, desired)


def _plan_rows(inp: PlannerInputs, budget=None) -> PlannerOutputs:
    """The full planner for every row (``_plan_one`` batched)."""
    desired, overflow, _ = _distribute(
        inp.weight, inp.min_replicas, inp.max_replicas, inp.capacity,
        inp.tiebreak, inp.member, inp.total[:, None], _keep(inp), budget=budget,
    )
    return PlannerOutputs(plan=_steady_plan(inp, desired, budget), overflow=overflow)


# -- narrow solve ---------------------------------------------------------
# A row's plan touches only a PREFIX of its processing order: clusters
# past the point where the running remainder reaches zero receive
# nothing and, without min/max/capacity/current structure, add nothing
# but their weight to the quota denominator.  The narrow planner runs
# over the top-M member slots in processing order with the left-out
# members' summed weight as a phantom ``tail_weight``, and certifies per
# row that the result equals the full-width run (uncertified rows are
# re-solved dense by the engine).

# Bit layout of the processing-order composite key (int64): the weight
# field clamps at 2^20-1, far above the featurizer's sum<=1000 contract;
# a clamp collision only fails the certificate, never reorders silently.
_KEY_W_BITS = 20
_KEY_TB_BITS = 32
_KEY_SPECIAL_SHIFT = _KEY_W_BITS + _KEY_TB_BITS


def processing_key(weight, tiebreak, special):
    """int64 composite ordering members by (special desc, clamped weight
    desc, tiebreak asc): a larger key is processed earlier, up to the
    final index tie-break, which the consumer adds.  ``special`` marks
    columns with planner structure (min/max/capacity/current) that must
    never land in the phantom tail."""
    w = torch.clamp(weight, min=0, max=(1 << _KEY_W_BITS) - 1).to(torch.int64)
    # tiebreak asc preferred -> inverted into an unsigned 32-bit field.
    tbu = _INF - tiebreak.to(torch.int64)
    return (
        (special.to(torch.int64) << _KEY_SPECIAL_SHIFT)
        + (w << _KEY_TB_BITS)
        + tbu
    )


def plan_batch_narrow(inp: PlannerInputs, tail_weight, best_tail, comp, budget=None):
    """The planner over [B, M] processing-order slots, plus its exactness
    certificate (``_plan_one_narrow`` batched).  ``tail_weight`` i32[B]
    is the summed clamped weight of member columns outside the slots,
    ``best_tail`` i64[B] the largest processing key among them (-1 when
    none), ``comp`` i64[B, M] the slots' own processing keys.  Returns
    (outputs, cert bool[B]); cert holds iff the narrow result provably
    equals the full-width planner:

    * every slot that received replicas, accrued overflow or saturated
      out of the active set orders strictly before the best tail member,
      and
    * no weighted round's remainder survived past the slots (the
      full-width cascade would have handed it to the tail within that
      round) — or the tail carries zero weight and is inert.

    The avoid-disruption passes run on the slots without a tail: their
    members derive from desired and current, both zero outside the slots
    for certified rows."""
    desired, overflow, _, active_end, spilled = _distribute(
        inp.weight, inp.min_replicas, inp.max_replicas, inp.capacity,
        inp.tiebreak, inp.member, inp.total[:, None], _keep(inp),
        tail_weight=tail_weight[:, None], budget=budget,
    )
    touched = (desired > 0) | (overflow > 0) | (inp.member & ~active_end)
    cert = (tail_weight == 0) | (
        ~spilled & (~touched | (comp > best_tail[:, None])).all(dim=-1)
    )
    plan = _steady_plan(inp, desired, budget)
    return PlannerOutputs(plan=plan, overflow=overflow), cert


def plan_batch(
    inp: PlannerInputs, *, validate: bool = True, budget=None
) -> PlannerOutputs:
    """Plan every object in the batch; validates the int32 contract first."""
    if validate:
        validate_ranges(inp.total.cpu().numpy(), inp.weight.cpu().numpy())
    return _plan_rows(inp, budget)


def validate_ranges(total: np.ndarray, weight: np.ndarray) -> None:
    """Host-side guard for the int32 value contract.  Sums the CLAMPED
    weights — the planner zeroes negatives, so negative entries must not
    cancel positive ones in the overflow estimate."""
    clamped = np.maximum(weight, 0)
    max_w = int(clamped.max(initial=0))
    max_t = int(total.max(initial=0))
    w_sum = int(clamped.sum(axis=-1).max(initial=0))
    if max_t * max_w + w_sum >= 2**31:
        raise OverflowError(
            f"planner int32 contract violated: total={max_t} * weight={max_w} "
            f"+ weight_sum={w_sum} >= 2**31; normalize weights first"
        )
