"""Phase 1's least time on the H100 for the work a tick's inputs need.

Frozen copy of ``chip_smoke.py``'s ``phase1_work`` and ``phase1_bound``
and their constants as of commit 5df33979f11fc4d3c609bdae8857b52774b11979,
rewritten in numpy over the plain reference's own planes
(``benchmark/reference/planes.py:Block``), not over the kernel's
arguments: padding rows, padded clusters and certificate re-dispatches
are not work, so the bound reads the same whatever implements phase 1.
Work is counted block by block and summed; the bytes of the cluster
tables are counted once a tick, as one call over every row would read
them.
"""

from __future__ import annotations

import numpy as np

# Published peaks of one NVIDIA H100 SXM (data sheet, 700 W).
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS = 67e12
# Compute capability 9.0 issues 64 int32 instructions per SM clock, a
# quarter of the fp32 lanes' 256 operations; conversions 16, a sixteenth.
INT32_OPS_PER_S = FP32_FLOPS / 4
CONV_OPS_PER_S = FP32_FLOPS / 16

# Phase-1 instructions per cell, as they compile for sm_90a (a 64-bit
# add, compare or shift counts 2, a 64-bit multiply 3).
CELL_OPS = 10           # webhook/valid tests, feasibility, two reason bits, four stores
FILTER_OPS = 2          # each enabled filter: test and OR
FIT_OPS = 5             # each resource of a requesting row: 64-bit add, compare, AND
NORM_OPS = 6            # taint/affinity on a feasible cell
BALANCED_OPS = 50       # guards, range shifts, multiplies, |difference|, x100, add
RESOURCE_OPS = 4        # used + request for cpu and memory
RATIO_OPS = 20          # least/most: guards, x100 per resource, the average, add
WEBHOOK_OPS = 2         # the webhook score on a feasible cell
DIV_CONV_OPS = 2        # a short division's I2F and F2I.FLOOR
DIV_INT32_OPS = 13      # its correction with a divisor at most 2^30
DIV_INT64_OPS = 20      # the same past 2^30
DIV_EXACT_OPS = 97      # the exact 64-bit routine
SCORE_BYTES = 4         # the taint and affinity planes are int32

S_TAINT, S_BALANCED, S_LEAST, S_AFFINITY, S_MOST = range(5)
N_FILTERS = 5  # every record enables the five default filters


def _shift(cap):
    s = np.zeros(cap.shape, np.int64)
    for k in range(5):
        s += 8 * (cap >= (1 << (26 + 8 * k)))
    return s


def block_work(blk) -> dict:
    """What phase 1 must do on one block's rows, given the reference's
    feasibility: cells each filter and plugin touches and the divisions
    it keeps, by the short path or the exact one."""
    feasible, se = blk.feasible, blk.score_enabled
    b, c = feasible.shape
    w = {"rows": b, "cells": b * c, "feasible": int(feasible.sum()),
         "div_short": 0, "div_short64": 0, "div_exact": 0}

    def divisions(keep, num, den):
        den = np.maximum(den, 1)
        kept = int(keep.sum())
        q = num // den
        short = keep & (np.abs(q) < 2**20 - 1) & (den < 2**62)
        w["div_short"] += int(short.sum())
        w["div_short64"] += int((short & (den > 2**30)).sum())
        w["div_exact"] += kept - int(short.sum())

    scored = [feasible & se[:, p, None] for p in range(5)]
    for p, plane in ((S_TAINT, blk.taint_counts), (S_AFFINITY, blk.affinity_scores)):
        plane = plane.astype(np.int64)
        row_max = np.where(scored[p], plane, 0).max(axis=1, keepdims=True) if c else np.zeros((b, 1), np.int64)
        divisions(scored[p] & (row_max != 0), plane * 100, np.broadcast_to(row_max, plane.shape))
    ac = np.broadcast_to(blk.alloc[None, :, 0].astype(np.int64), feasible.shape)
    am = np.broadcast_to(blk.alloc[None, :, 1].astype(np.int64), feasible.shape)
    rc = blk.used[None, :, 0].astype(np.int64) + blk.request[:, None, 0].astype(np.int64)
    rm = blk.used[None, :, 1].astype(np.int64) + blk.request[:, None, 1].astype(np.int64)
    keep = scored[S_BALANCED] & (ac != 0) & (am != 0) & (rc < ac) & (rm < am)
    sc, sm = _shift(ac), _shift(am)
    a_c, r_c, a_m, r_m = ac >> sc, rc >> sc, am >> sm, rm >> sm
    total = np.maximum(a_c * a_m, 1)
    divisions(keep, 100 * (total - np.abs(r_c * a_m - r_m * a_c)), total)
    for p, least in ((S_LEAST, True), (S_MOST, False)):
        for req, alloc in ((rc, ac), (rm, am)):
            divisions(scored[p] & (alloc != 0) & (req <= alloc), (alloc - req if least else req) * 100, alloc)
    resource = scored[S_BALANCED] | scored[S_LEAST] | scored[S_MOST]
    w["filter_cells"] = N_FILTERS * b * c
    w["fit_cells"] = int((blk.request > 0).any(axis=1).sum()) * c
    w["scored"] = [int(m.sum()) for m in scored]
    w["resource_cells"] = int(resource.sum())
    w["request_columns"] = blk.request.shape[1]
    w["clusters"] = c
    return w


def add(works) -> dict:
    """The blocks' work summed: one tick's."""
    out = None
    for w in works:
        if out is None:
            out = {k: (list(v) if isinstance(v, list) else v) for k, v in w.items()}
            continue
        for k, v in w.items():
            if k in ("clusters", "request_columns"):
                out[k] = max(out[k], v)
            elif isinstance(v, list):
                out[k] = [x + y for x, y in zip(out[k], v)]
            else:
                out[k] += v
    return out


def bound(w: dict) -> dict:
    """Least time for the work ``w``: bytes (each plane read once where a
    row's filters and plugins read it, each output written once) over the
    HBM rate, against the int32 instructions and the conversions over
    their peaks; the larger bounds it."""
    b, c, r = w["rows"], w["clusters"], w["request_columns"]
    scored = w["scored"]
    fc = w["filter_cells"] // N_FILTERS  # cells of one filter
    cluster_r = r if w["fit_cells"] else (2 if w["resource_cells"] else 0)
    nbytes = (
        b * (5 + 5 + 1 + 8 * r)                # flags, placement_has, request
        + fc + fc                              # api_ok, selector_ok (no placement lists)
        + 2 * fc                               # current_mask, then one taint plane
        + b * c + c                            # webhook_ok, cluster_valid
        + 2 * 8 * c * cluster_r                # alloc, used
        + SCORE_BYTES * (w["feasible"] + scored[S_TAINT] + scored[S_AFFINITY])
        + (1 + 4 + 8) * b * c                  # feasible, reasons, totals
    )
    base = (
        CELL_OPS * w["cells"]
        + FILTER_OPS * w["filter_cells"]
        + FIT_OPS * r * w["fit_cells"]
        + NORM_OPS * (scored[S_TAINT] + scored[S_AFFINITY])
        + BALANCED_OPS * scored[S_BALANCED]
        + RESOURCE_OPS * w["resource_cells"]
        + RATIO_OPS * (scored[S_LEAST] + scored[S_MOST])
        + WEBHOOK_OPS * w["feasible"]
    )
    int_ops = (
        base
        + DIV_INT32_OPS * (w["div_short"] - w["div_short64"])
        + DIV_INT64_OPS * w["div_short64"]
        + DIV_EXACT_OPS * w["div_exact"]
    )
    conv_ops = DIV_CONV_OPS * w["div_short"]
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = max(int_ops / INT32_OPS_PER_S * 1e3, conv_ops / CONV_OPS_PER_S * 1e3)
    return {
        "bytes": int(nbytes), "int_ops": int(int_ops), "conv_ops": int(conv_ops),
        "bytes_ms": bytes_ms, "ops_ms": ops_ms, "bound_ms": max(bytes_ms, ops_ms),
        "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
    }
