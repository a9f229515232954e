"""Select stage: MaxCluster top-K (reference: plugins/maxcluster/max_cluster.go).

Torch counterpart of ``kubeadmiral_tpu/ops/select.py``.  Feasible
clusters rank by score desc, cluster index asc (the reference's tie
order is unspecified); a negative maxClusters selects nothing and
INT32_INF means "no limit".
"""

from __future__ import annotations

import torch

INT32_MAX = 2**31 - 1


def select_topk(scores, feasible, max_clusters):
    """scores int[B,C], feasible bool[B,C], max_clusters i32[B] -> bool[B,C].

    The (key, index) pair packs into one collision-free int64
    (key * C + iota), so any sort — stable or not — gives the same
    rank.  The rank is the inverse permutation, built with a scatter."""
    c = scores.shape[-1]
    sort_key = torch.where(feasible, -scores.to(torch.int32), INT32_MAX)
    iota = torch.arange(c, dtype=torch.int64, device=scores.device).expand(sort_key.shape)
    comp = sort_key.to(torch.int64) * c + iota
    order = torch.sort(comp, dim=-1).values % c
    rank = torch.empty_like(order).scatter_(1, order, iota)
    k = torch.where(
        max_clusters < 0, 0, torch.clamp(max_clusters, max=c)
    ).to(torch.int64)
    return feasible & (rank < k[:, None])
