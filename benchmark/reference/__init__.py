"""The plain reference scheduler: every answer the benchmark judges is
worked out again here from the benchmark's own records.

Filter -> Score (``planes.py``, vectorised over blocks of rows) -> Select
-> Replicas (``replicas.py``, row by row), as the upstream scheduler's
plugins define them.  Imports numpy and nothing of the program, of JAX or
of the JAX package (``benchmark/tests/test_bench_boundary.py``).
"""

from __future__ import annotations

import numpy as np

from benchmark.reference import fnv, replicas
from benchmark.reference.planes import Block, Clusters, Memo

BLOCK_ROWS = 256


def key_of(record: dict) -> str:
    ns = record["namespace"]
    return f"{ns}/{record['name']}" if ns else record["name"]


def decide(records, cl: Clusters, memo: Memo = None, itype=np.int64, block_rows: int = BLOCK_ROWS):
    """The placement of each record against ``cl``: {cluster name:
    replicas}, None as the count in Duplicate mode."""
    memo = memo or Memo(cl)
    out = []
    for b0 in range(0, len(records), block_rows):
        blk = Block(records[b0:b0 + block_rows], cl, memo, itype)
        for i, rec in enumerate(blk.records):
            out.append(_decide_row(rec, blk.feasible[i], blk.totals[i], cl))
    return out


def _decide_row(rec: dict, feasible: np.ndarray, totals: np.ndarray, cl: Clusters) -> dict:
    sel = replicas.select(totals, feasible, rec["max_clusters"])
    if len(sel) == 0:
        return {}
    if rec["mode"] != "Divide":
        return {cl.names[j]: None for j in sel}
    sel = np.sort(sel)
    weights = replicas.dynamic_weights(sel, cl.cpu_alloc, cl.cpu_avail)
    hashes = fnv.extend(cl.name_state[sel], key_of(rec).encode())
    cap = np.full(len(sel), replicas.INF, np.int64)
    for name, value in (rec["capacity"] or {}).items():
        j = cl.index.get(name)
        if j is not None and value >= 0:
            at = np.searchsorted(sel, j)
            if at < len(sel) and sel[at] == j:
                cap[at] = value
    reps = replicas.plan(weights, hashes, sel, cap, rec["replicas"] or 0,
                         rec["avoid_disruption"], False)
    return {cl.names[j]: int(r) for j, r in zip(sel, reps) if r != 0}
