"""Seeded worlds of plain records for the benchmark's configurations.

Frozen copy of ``kubeadmiral_tpu_torch/testing/worlds.py`` (``build_world``,
``churn``, ``drift``) as of commit 5df33979f11fc4d3c609bdae8857b52774b11979,
rewritten to emit plain records (dicts of strings and canonical integers:
cpu in millicores, memory in bytes) in place of the port's typed objects.
Every draw is made in the same order from the same generator, so a record
world converted by ``benchmark/adapter.py`` equals the port's world for the
same seed (``benchmark/tests/test_bench_world.py``).  The program's copy may
change; this one does not, so the traffic stays what it was.

A configuration file (``benchmark/configs/*.json``) supplies the sizes that
the original read from its ``config`` argument: the object and cluster
counts, the score plugins, whether the world has GPUs and followers.

Records:
  cluster  {"name", "labels", "taints": [[key, value, effect]], "alloc",
            "avail", "api": [gvk]}
  unit     {"gvk", "namespace", "name", "mode", "replicas", "request",
            "tolerations": [[key, operator, value, effect]], "affinity",
            "max_clusters", "avoid_disruption", "scores", "capacity"}
  affinity {"required": [term] | None, "preferred": [[weight, term]]},
            term = [[key, operator, [values]]]
Records are shared between lists and never mutated: a change makes a copy.
"""

from __future__ import annotations

import numpy as np

GVKS = ("apps/v1/Deployment", "apps/v1/StatefulSet")
REGIONS = ("us", "eu", "ap")
GI = 1 << 30
MI = 1 << 20
DIVIDE = "Divide"
DUPLICATE = "Duplicate"


def build_world(cfg: dict, seed: int):
    """(units, clusters, followers) records of ``cfg`` (a configuration
    file's ``world`` object), every draw from ``default_rng(seed)``."""
    n_objects, n_clusters = int(cfg["objects"]), int(cfg["clusters"])
    gpu = bool(cfg["gpu"])
    scores = list(cfg["scores"]) if cfg["scores"] is not None else None
    follower_every = cfg.get("follower_every")
    rng = np.random.default_rng(seed)
    clusters = []
    for j in range(n_clusters):
        cpu = int(rng.integers(32, 512))
        mem_gi = int(rng.integers(128, 2048))
        free_frac = float(rng.uniform(0.1, 0.9))
        alloc = {"cpu": cpu * 1000, "memory": mem_gi * GI}
        avail = {
            "cpu": int(cpu * free_frac * 1000),
            "memory": int(mem_gi * free_frac) * GI,
        }
        if gpu and j % 3 == 0:
            n_gpu = int(rng.integers(4, 64))
            alloc["nvidia.com/gpu"] = n_gpu
            avail["nvidia.com/gpu"] = int(n_gpu * free_frac)
        clusters.append({
            "name": f"member-{j:05d}",
            "labels": {"region": REGIONS[j % 3], "zone": f"z{j % 17}", "tier": str(j % 4)},
            "taints": [["dedicated", "batch", "NoSchedule"]] if j % 11 == 0 else [],
            "alloc": alloc,
            "avail": avail,
            "api": list(GVKS),
        })
    names = [c["name"] for c in clusters]

    affinities = [None] + [
        {
            "required": [[["region", "In", [REGIONS[k]]]]],
            "preferred": [[30, [["tier", "In", ["0", "1"]]]]],
        }
        for k in range(3)
    ] + [None]
    tolerate = [["dedicated", "Exists", "", ""]]

    units = []
    followers = []
    for i in range(n_objects):
        if follower_every and i % follower_every == follower_every - 1:
            followers.append(i)  # placement = union of leaders, post-tick
        divide = i % 4 != 0
        request = {
            "cpu": int(rng.integers(0, 8)) * 250,
            "memory": int(rng.integers(0, 16)) * 256 * MI,
        }
        if gpu and i % 3 == 0:
            request["nvidia.com/gpu"] = int(rng.integers(1, 4))
        replicas = int(rng.integers(1, 100)) if divide else None
        max_clusters = int(rng.integers(1, 20)) if i % 5 == 0 else None
        capacity = None
        if i % 7 == 0:
            cname = names[int(rng.integers(0, n_clusters))]
            capacity = {cname: int(rng.integers(0, 50))}
        units.append({
            "gvk": GVKS[i % 2],
            "namespace": f"ns-{i % 97}",
            "name": f"workload-{i:06d}",
            "mode": DIVIDE if divide else DUPLICATE,
            "replicas": replicas,
            "request": request,
            "tolerations": tolerate if i % 3 == 0 else [],
            "affinity": affinities[i % len(affinities)],
            "max_clusters": max_clusters,
            "avoid_disruption": bool(i % 2),
            "scores": scores,
            "capacity": capacity,
        })
    return units, clusters, followers


def churn(rng, units, fraction=0.01):
    """(rows, records): about ``fraction`` of the objects replaced by
    copies with 1..8 more desired replicas (``rng``: a numpy Generator),
    as ``worlds.churn`` draws them; a row drawn twice keeps its last
    copy, made from the list as given."""
    n = max(1, int(len(units) * fraction))
    changed = {}
    for i in rng.integers(0, len(units), n):
        su = units[int(i)]
        changed[int(i)] = {
            **su, "replicas": (su["replicas"] or 1) + int(rng.integers(1, 9)),
        }
    return changed


def drift(cluster: dict) -> dict:
    """A copy of ``cluster`` with its available resources halved (a
    capacity drift, ``worlds.drift``)."""
    return {**cluster, "avail": {k: max(0, v // 2) for k, v in cluster["avail"].items()}}


def respec(units):
    """A second generation of every object, each one's spec changed:
    a Divide object's desired replicas and a Duplicate object's cpu and
    memory requests moved to another value of the same range (1..99
    replicas; 0..1750 m and 0..3840 Mi in the world's steps), so every
    row differs from the first generation's.  No draw: the same world
    always gives the same generation."""
    out = []
    for i, su in enumerate(units):
        if su["mode"] == DIVIDE:
            new = {**su, "replicas": 1 + (su["replicas"] - 1 + 1 + i % 97) % 99}
        else:
            req = dict(su["request"])
            req["cpu"] = (req["cpu"] // 250 + 1 + i % 7) % 8 * 250
            req["memory"] = (req["memory"] // (256 * MI) + 1 + i % 15) % 16 * 256 * MI
            new = {**su, "request": req}
        out.append(new)
    return out
