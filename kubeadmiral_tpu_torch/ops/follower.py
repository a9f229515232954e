"""Batched follower-scheduling union.

The port's copy of ``kubeadmiral_tpu/ops/follower.py`` (the same class
over the port's ScheduleResult; copied, since the JAX package's module
imports its engine and so JAX).  The reference's follower
controller makes a follower resource's placement the union of its
leader workloads' placements (reference:
pkg/controllers/follower/controller.go:95-521).  Given engine row
indices, each follower row's result is overwritten with the union of
its leader rows' placements.

Incremental: the union for a follower is recomputed only when one of
its leaders' placements changed this tick (the engine's
``last_changed``), so a 1 % churn tick pays for the affected followers,
not for all of them.
"""

from __future__ import annotations

from typing import Iterable, Mapping, Optional, Sequence

from kubeadmiral_tpu_torch.scheduler.engine import ScheduleResult, _FrozenDict


class FollowerIndex:
    """Leader→follower union over engine rows.

    ``follows`` maps a follower row index to the row indices of its
    leaders.  The graph is bipartite, as in the reference (leaders are
    workloads, followers config/secret-style resources): a follower must
    not itself be another follower's leader.
    """

    def __init__(self, follows: Mapping[int, Sequence[int]]):
        self.follows: dict[int, tuple[int, ...]] = {
            int(f): tuple(int(x) for x in leaders)
            for f, leaders in follows.items()
        }
        for f, leaders in self.follows.items():
            for leader in leaders:
                if leader in self.follows:
                    raise ValueError(
                        f"row {leader} is both a leader (of {f}) and a "
                        "follower; the follows graph must be bipartite"
                    )
        # Reverse index: leader row -> follower rows it affects.
        self._followers_of: dict[int, list[int]] = {}
        for f, leaders in self.follows.items():
            for leader in leaders:
                self._followers_of.setdefault(leader, []).append(f)
        self._cache: dict[int, ScheduleResult] = {}

    def affected(self, changed: Optional[Iterable[int]]) -> Iterable[int]:
        """Follower rows whose union is stale given changed leader rows
        (None: every row may have changed)."""
        if changed is None or not self._cache:
            return self.follows.keys()
        out: set[int] = set()
        for row in changed:
            out.update(self._followers_of.get(row, ()))
        return out

    def apply(
        self,
        results: list[ScheduleResult],
        changed: Optional[Iterable[int]] = None,
    ) -> list[ScheduleResult]:
        """Overwrite the follower rows of ``results`` in place with their
        leaders' placement union (clusters only, no replica counts, as
        spec.follows places them).  ``changed`` is the engine's
        ``last_changed`` of the same tick."""
        for f in self.affected(changed):
            union: dict = {}
            for leader in self.follows[f]:
                union.update(results[leader].clusters)
            self._cache[f] = ScheduleResult(
                clusters=_FrozenDict(dict.fromkeys(union))
            )
        cache = self._cache
        for f in self.follows:
            results[f] = cache[f]
        return results
