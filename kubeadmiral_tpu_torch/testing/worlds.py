"""Seeded benchmark worlds for the BASELINE configurations.

A copy of ``bench.py``'s ``build_world`` for configs 3 and 5
(BASELINE.md), parametrised instead of read from the environment:

  3  10k mixed Deployment/StatefulSet x 500 clusters — taint/affinity
     masks, static+dynamic weights, capacity feedback.
  5  100k x 5k — multi-resource (cpu/mem/gpu) bin-pack scoring
     (MostAllocated replaces the default spreading scores); every tenth
     object is a follower (placement = union of its leaders', applied
     after the tick by the control plane, not by the engine).

``churn`` and ``drift`` are copies of ``bench.py``'s steady-state tick
workloads: about 1 % of the objects changed since the last tick, and
one cluster's free capacity halved.  ``webhook`` is a seeded stand-in
for out-of-process webhook plugins (``schedule(webhook_eval=)``).
"""

from __future__ import annotations

import dataclasses
import zlib

import numpy as np

from kubeadmiral_tpu_torch.models.types import (
    AutoMigrationSpec,
    ClusterAffinity,
    ClusterState,
    CLUSTER_RESOURCES_MOST,
    MODE_DIVIDE,
    PreferredSchedulingTerm,
    SelectorRequirement,
    SelectorTerm,
    SchedulingUnit,
    Taint,
    TAINT_TOLERATION,
    Toleration,
    parse_resources,
)

SHAPES = {"3": (10_000, 500), "5": (100_000, 5_000)}


def build_world(n_objects: int, n_clusters: int, config: str = "3", seed: int = 0):
    """(units, clusters, followers) for ``config`` "3" or "5" at the
    given scale, every draw from ``numpy.random.default_rng(seed)``."""
    if config not in SHAPES:
        raise ValueError(f"config must be one of {sorted(SHAPES)}, got {config!r}")
    rng = np.random.default_rng(seed)
    gvks = ("apps/v1/Deployment", "apps/v1/StatefulSet")
    regions = ("us", "eu", "ap")
    gpu = config == "5"
    clusters = []
    for j in range(n_clusters):
        cpu = int(rng.integers(32, 512))
        mem_gi = int(rng.integers(128, 2048))
        free_frac = float(rng.uniform(0.1, 0.9))
        alloc = {"cpu": str(cpu), "memory": f"{mem_gi}Gi"}
        avail = {
            "cpu": f"{int(cpu * free_frac * 1000)}m",
            "memory": f"{int(mem_gi * free_frac)}Gi",
        }
        if gpu and j % 3 == 0:
            n_gpu = int(rng.integers(4, 64))
            alloc["nvidia.com/gpu"] = str(n_gpu)
            avail["nvidia.com/gpu"] = str(int(n_gpu * free_frac))
        clusters.append(
            ClusterState(
                name=f"member-{j:05d}",
                labels={
                    "region": regions[j % 3],
                    "zone": f"z{j % 17}",
                    "tier": str(j % 4),
                },
                taints=(Taint("dedicated", "batch", "NoSchedule"),)
                if j % 11 == 0
                else (),
                allocatable=parse_resources(alloc),
                available=parse_resources(avail),
                api_resources=frozenset(gvks),
            )
        )
    names = [c.name for c in clusters]

    affinities = [None] + [
        ClusterAffinity(
            required=(
                SelectorTerm(
                    match_expressions=(
                        SelectorRequirement("region", "In", (regions[k],)),
                    )
                ),
            ),
            preferred=(
                PreferredSchedulingTerm(
                    weight=30,
                    preference=SelectorTerm(
                        match_expressions=(
                            SelectorRequirement("tier", "In", ("0", "1")),
                        )
                    ),
                ),
            ),
        )
        for k in range(3)
    ] + [None]

    binpack_scores = (TAINT_TOLERATION, CLUSTER_RESOURCES_MOST)

    units = []
    followers = []
    for i in range(n_objects):
        if config == "5" and i % 10 == 9:
            followers.append(i)  # placement = union of leaders, post-tick
        divide = i % 4 != 0
        request = {
            "cpu": f"{int(rng.integers(0, 8)) * 250}m",
            "memory": f"{int(rng.integers(0, 16)) * 256}Mi",
        }
        if gpu and i % 3 == 0:
            request["nvidia.com/gpu"] = str(int(rng.integers(1, 4)))
        units.append(
            SchedulingUnit(
                gvk=gvks[i % 2],
                namespace=f"ns-{i % 97}",
                name=f"workload-{i:06d}",
                scheduling_mode=MODE_DIVIDE if divide else "Duplicate",
                desired_replicas=int(rng.integers(1, 100)) if divide else None,
                resource_request=parse_resources(request),
                current_clusters={},
                tolerations=(Toleration(key="dedicated", operator="Exists"),)
                if i % 3 == 0
                else (),
                affinity=affinities[i % len(affinities)],
                max_clusters=int(rng.integers(1, 20)) if i % 5 == 0 else None,
                avoid_disruption=bool(i % 2),
                enabled_scores=binpack_scores if config == "5" else None,
                auto_migration=AutoMigrationSpec(
                    estimated_capacity={
                        names[int(rng.integers(0, n_clusters))]: int(
                            rng.integers(0, 50)
                        )
                    }
                )
                if i % 7 == 0
                else None,
            )
        )
    return units, clusters, followers


def churn(rng, units, fraction=0.01):
    """A fresh list with about ``fraction`` of the objects replaced by
    copies with a few more desired replicas (``rng``: a numpy
    Generator); the other rows are the same objects."""
    out = list(units)
    n = max(1, int(len(units) * fraction))
    for i in rng.integers(0, len(units), n):
        su = units[int(i)]
        out[int(i)] = dataclasses.replace(
            su,
            desired_replicas=(su.desired_replicas or 1) + int(rng.integers(1, 9)),
        )
    return out


def drift(clusters, index=0):
    """A fresh cluster list with cluster ``index``'s available
    resources halved (a capacity drift); the other clusters are the same
    objects."""
    out = list(clusters)
    out[index] = dataclasses.replace(
        out[index],
        available={k: max(0, v // 2) for k, v in out[index].available.items()},
    )
    return out


def drift_zero(clusters, index=0):
    """A fresh cluster list with cluster ``index``'s available resources
    set to 0: the rows it fitted stop fitting (feasibility flips)."""
    out = list(clusters)
    out[index] = dataclasses.replace(
        out[index], available={k: 0 for k in out[index].available}
    )
    return out


def drift_wide(clusters, count=None):
    """A fresh cluster list with the available resources of the first
    ``count`` clusters halved; by default len(clusters) // 4 + 1, more
    columns than the engine's drift gate takes (max(8, C // 4))."""
    if count is None:
        count = len(clusters) // 4 + 1
    out = list(clusters)
    for i in range(count):
        out[i] = dataclasses.replace(
            out[i], available={k: max(0, v // 2) for k, v in out[i].available.items()}
        )
    return out


# Webhook scores past the featurizer's int32 clamp (+-2**30).
WEBHOOK_HUGE = 1 << 32


def webhook(seed: int = 0, reject: float = 0.25, silent_every: int = 50,
            huge_every: int = 64):
    """A deterministic ``webhook_eval(unit, clusters) -> (ok_row,
    score_row) | None``: each row's answer is drawn from
    ``numpy.random.default_rng((seed, crc32(unit.key)))``, so it depends
    on the seed and the unit's key only.  A row gets no answer (None: no
    webhook planes for it) with probability 1 / ``silent_every``; else a
    cluster is rejected with probability ``reject``, nine rows in ten
    get a score in [-50, 150] per cluster (the rest 0), and a row gets
    scores of +-WEBHOOK_HUGE on four clusters with probability
    1 / ``huge_every``: past the clamp, so its totals leave the narrow
    solve's 32-bit key range, and where a maxClusters cut engages the
    row fails the certificate."""

    def webhook_eval(unit, clusters):
        rng = np.random.default_rng((seed, zlib.crc32(unit.key.encode())))
        if rng.random() < 1 / silent_every:
            return None
        c = len(clusters)
        ok = rng.random(c) >= reject
        scores = np.zeros(c, np.int64)
        if rng.random() < 0.9:
            scores = rng.integers(-50, 151, c)
        if rng.random() < 1 / huge_every:
            cols = rng.integers(0, c, 4)
            scores[cols] = np.where(np.arange(4) % 2 == 0, WEBHOOK_HUGE, -WEBHOOK_HUGE)
        return ok, scores

    return webhook_eval
