#!/usr/bin/env python3
"""Quickest proof that the PyTorch/CUDA port runs on an NVIDIA GPU.

Drives ``kubeadmiral_tpu_torch`` on the card:

1. prints the card's name and power limit;
2. builds the phase-1 CUDA kernel (csrc/phase1.cu) with nvcc for sm_90a;
3. builds the config 3 (10k x 500) and config 5 (100k x 5k) worlds;
4. holds the kernel against its plain torch twin on the same CUDA
   tensors (tolerance 0: integer math, bit-identical) on a c5 chunk
   (4096 x 5120, R=3), a c3 chunk (4096 x 512, R=2), an odd-B case with
   padded columns and webhook planes, the kernel's edge cases
   (testing/problems.py:EDGE_SHAPES, the inputs the CPU tests hold
   against JAX) and a case whose planes are not 16-byte aligned; times
   kernel vs plain with CUDA events (median after warm-up, L2 flushed)
   and works out the kernel's bound from what these inputs need (bytes;
   int32-pipe instructions and conversions with each division at the
   short division's cost, and under PR 1's 64-bit division count beside
   it); prints ptxas's registers, shared memory and spills and checks the
   short divisions' shape in the build's SASS;
4b. attribution: the kernel's time and bound at both chunks with (a) the
   flags as they are, (b) no fit filter and no resource plugins, (c) no
   taint or affinity scoring, (d) every filter and plugin off, each
   variant held against the plain version;
5. holds the GPU narrow tick (the kernel as its phase 1) against the CPU
   narrow tick, bit for bit on every output plane, the cert plane and
   the packed wire: the whole c3 chunk and the first 512 rows of the c5
   chunk (rows are independent);
6. profiles one chunk of the engine's path (expand, narrow tick, pack)
   per config with torch.profiler;
7. runs one cold ``SchedulerEngine().schedule(units, clusters)`` tick per
   config on the card at full size — the pipelined window (depth 16),
   the narrow solve with its dense fallback and the packed wire —
   requires the phase-1 launch count to equal chunks + fallback
   dispatches (+ planner re-dispatches, if any), prints the stage
   timings, narrow_stats, overflow rows, fetch bytes against the dense
   planes' 6 B per cell, ``max_memory_allocated`` and the host
   synchronisations made inside the chunk dispatches, and holds the
   placements against the port's CPU engine (every row at c3; the first
   rows at c5);
7b. the window against the sequential dispatch in turns per config: cold
   ticks on fresh engines at depth 16, 1, 1, 16, each checked as in 7
   and equal to 7's placements (a ``turns c5 depth`` line: wall ms,
   stages, launches, peak memory, dispatch syncs, fetch bytes per tick);
   then cold ticks at depth 16 with the planner's round budget
   (``PLANNER_ROUNDS``) at 1, 2, 4, 4, 2, 1, each checked as in 7 and
   equal to 7's placements (a ``turns c5 planner rounds`` line: wall,
   device and device + fetch ms, re-dispatches, syncs); the ``syncs``
   line: the synchronising operations of one chunk's dispatch
   (c5 and c3, window and sequential) under
   ``torch.cuda.set_sync_debug_mode("warn")``, with their sites;
8. runs the dense tick through the engine (NARROW_M patched to the
   cluster bucket) at a cut depth — c3 whole, the first 20k c5 objects —
   requires one launch per chunk and placements equal to the narrow
   path's; then the first chunk of each world with NARROW_M = 8 (M = 32),
   where rows fail the certificate: requires a fallback dispatch (two
   launches) and placements equal to the narrow path's; at c3 a second
   dense and a second narrow tick follow, so the two paths run in turns
   (narrow, dense, dense, narrow) with equal placements; every tick of 7
   and 8 is a cold tick on a fresh engine;
9. the warm phase (``warm_phase``), per world at full size on the engine
   of step 7's cold tick: a no-op tick on the same list and on a fresh
   list of the same objects (no launch, the previous result objects),
   three 1 % churn ticks (the sub-batch path: one launch per slab plus
   fallbacks, the changed rows equal a fresh engine's cold tick over
   those units, the other rows the previous result objects), a capacity
   drift (cluster 0's available halved) and a tick back on the first
   clusters, and at c5 also ``drift-zero`` (cluster 0's available set to
   0: fit flips, the survivor program) and ``drift-wide`` (more than a
   quarter of the clusters halved: no gate, every chunk dispatched), each
   followed by a tick back.  A drift tick and a tick back run the drift
   gate where the drift is gate-shaped; they must launch the kernel once
   per recompute slab, mass-change chunk, ungated chunk and certificate
   fallback as the engine's counters give them, upload no per-object
   input, equal a fresh engine's cold tick on every row, and report as
   changed every row whose placement moved; they print ``drift_stats``,
   ``survivor_stats``, ``gate_wait`` and the stage split.  Each tick logs
   its wall ms, stages, cache and fetch paths, launches, dispatch
   shapes, fetch and upload bytes, overflow and changed rows and
   ``torch.cuda.memory_allocated()``; then holds the kernel against its
   twin, timed with its bound, at the first churn tick's slab shape;
9b. the surface phase (``surface_phase``), per world on a fresh engine:
   a cold ``want_scores`` tick (results and scores equal to the CPU
   engine's on the check rows; fetch bytes equal to step 7's plus the
   overflow rows' score words), a no-op and a 1 % churn tick with
   scores and a follower index (follower rows are their leaders'
   unions), a plain tick (no launch), a capacity drift with scores and
   a tick back (the drift gate bypassed: one launch per chunk; placements
   and scores equal to a fresh engine's), then a ``webhook_eval`` tick
   with scores (``testing/worlds.py:webhook``; c5 cut to
   C5_DENSE_OBJECTS objects): one launch per chunk plus certificate
   fallbacks, results equal to the CPU engine's, the chunk cache
   untouched, a plain tick after it replaying with no launch; then the
   kernel against its twin, timed with its bound, on the first webhook
   chunk's inputs.  Each window drain logs its chunks, memory and the
   pinned host bytes held;
10. prints the kernels JSON line, then ``{"ok": true, "device": ...}`` as
   the last line.

Any failed check exits nonzero without the final line.  Without CUDA it
exits 2 before doing anything.  Usage: ``python3 chip_smoke.py``.
"""

from __future__ import annotations

import contextlib
import gc
import json
import math
import re
import shutil
import subprocess
import sys
import time

import numpy as np

HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
# The data sheet's 67 TFLOP/s fp32 counts 128 lanes x 2 (an FMA) per SM
# clock; compute capability 9.0 issues 64 int32 instructions per SM clock,
# a quarter of that.  Phase 1 is integer work, so this is its peak.
INT32_OPS_PER_S = 67e12 / 4
# Conversions (I2F, F2I, FRND) issue 16 per SM clock on compute
# capability 9.0, a sixteenth of the fp32 lanes' 256 operations.
CONV_OPS_PER_S = 67e12 / 16
C5_CHECK_ROWS = 1024       # c5 rows re-solved on the CPU engine
C5_NARROW_ROWS = 512       # c5 chunk rows of the GPU-vs-CPU narrow tick check
C5_DENSE_OBJECTS = 20000   # c5 depth of the dense-path engine run
FALLBACK_OBJECTS = 4096    # depth of the forced-fallback run (one chunk)
FALLBACK_NARROW_M = 8      # M = 32 over maxClusters <= 19: many rows fail the cert

# Phase-1 work besides the 64-bit divisions, in int32-pipe instructions
# (a 64-bit add, compare or shift counts 2, a 64-bit multiply 3 — an
# IMAD.WIDE.U32 and two IMADs — as they compile for sm_90a):
CELL_OPS = 10           # every cell: webhook/valid tests, feasibility, the two
                        # extra reason bits, four stores
FILTER_OPS = 2          # each enabled filter on each cell: test and OR
FIT_OPS = 5             # each resource on each cell of a row that requests:
                        # 64-bit add, 64-bit compare, AND
NORM_OPS = 6            # taint/affinity on a feasible cell: masked max, x100,
                        # reverse, zero-max select, 64-bit add to the total
BALANCED_OPS = 50       # guards, two range shifts, four shifts, three
                        # multiplies, |difference|, x100, add
RESOURCE_OPS = 4        # used + request for cpu and mem (any resource plugin)
RATIO_OPS = 20          # least/most: two guards and two x100 per resource,
                        # the floor average, add
WEBHOOK_OPS = 2         # webhook score added on a feasible cell
# One kept division by the short path (csrc/phase1.cu: short_div),
# counted by hand from the sm_90a build's SASS (PERF.md, PR 4): I2F.S64
# (I2F.S32 for the int32 planes), FMUL and F2I.FLOOR for the estimate;
# the divisor's test against 2^30 and its branch; the remainder's
# correction, 4 instructions in 32 bits (IMAD, IMAD, ISETP, SHF) or 11 in
# 64 (the negated divisor, IMAD.WIDE.U32 and two IMADs, the two 64-bit
# compares, the sign, the branch out); the +1/-1 adjustment and the range
# test with its flag, 6.  division_sass() checks the sites' shape.
DIV_CONV_OPS = 2        # I2F, F2I.FLOOR
DIV_FP32_OPS = 1        # FMUL
DIV_INT32_OPS = 13      # divisor at most 2^30: the correction in 32 bits
DIV_INT64_OPS = 20      # divisor past 2^30: in 64 bits
# PR 1's 64-bit floor division, from PR 1's build (PERF.md, PR 1): the
# 32-bit path when both operands are in [0, 2^32), else the 64-bit
# routine; the short division's exact path is the latter.
PR1_DIV_FAST = 19
PR1_DIV_SLOW = 97


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def chunk_device_inputs(engine, units, clusters):
    """The first chunk's device inputs (CompactInputs, or TickInputs on
    the dense fallback), exactly as engine.schedule builds them, with the
    chunk's candidate width M (None: dense tick), wire width K and the
    host bound on its key lengths."""
    from kubeadmiral_tpu_torch.scheduler.featurize import _build_cluster_view

    view = _build_cluster_view(clusters, units)
    c_bucket, eff, ladder = engine._tick_geometry(len(view.clusters))
    vocab = engine._vocab_for(view, engine._topo_fingerprint(view))
    chunk = units[:eff]
    inputs, fmt = engine._featurize_full(chunk, clusters, view, vocab)
    b_pad = engine._bucket_rows(len(chunk), ladder, eff, len(units) > eff)
    padded = engine._pad_for_dispatch(inputs, fmt, b_pad, c_bucket)
    dev = engine._device_inputs(
        None, padded, "miss", fmt, vocab, c_bucket,
        engine._cluster_planes_device(view, c_bucket),
    )
    return (
        dev, fmt, engine._narrow_m(inputs, c_bucket), engine._pack_k(inputs, c_bucket),
        engine._key_max(padded, fmt),
    )


def chunk_tick_inputs(engine, units, clusters):
    """The first chunk's expanded device TickInputs, M and K."""
    from kubeadmiral_tpu_torch.ops.pipeline import expand_compact

    dev, fmt, m, k, key_max = chunk_device_inputs(engine, units, clusters)
    return (expand_compact(dev, key_max) if fmt == "compact" else dev), m, k


def chunk_path(inp, m, k):
    """The engine's device work for one chunk of expanded inputs: the
    narrow tick (or the dense one when M is None) and the packed wire."""
    from kubeadmiral_tpu_torch.ops.pipeline import (
        pack_wire,
        schedule_tick,
        schedule_tick_narrow,
    )

    if m is None:
        out, cert = schedule_tick(inp), None
    else:
        out, cert = schedule_tick_narrow(inp, m)
    wire = pack_wire(out.selected, out.replicas, out.counted, out.scores, out.reasons, k)
    return out, cert, wire


def check_narrow(label: str, inp, m, k, rows: int) -> dict:
    """Hold the GPU narrow tick (kernel phase 1) against the CPU narrow
    tick (plain phase 1) on the chunk's first ``rows`` rows: every output
    plane, the cert plane and the packed wire, bit for bit."""
    import torch

    from kubeadmiral_tpu_torch.ops.pipeline import TickInputs

    if m is None:
        raise AssertionError(f"{label}: the engine does not narrow this chunk")
    out, cert, wire = chunk_path(inp, m, k)
    torch.cuda.synchronize()
    cluster_only = ("alloc", "used", "cpu_alloc", "cpu_avail", "cluster_valid")
    cpu_in = TickInputs(
        **{
            name: (x if name in cluster_only else x[:rows]).cpu()
            for name, x in inp._asdict().items()
        }
    )
    t0 = time.perf_counter()
    want_out, want_cert, want_wire = chunk_path(cpu_in, m, k)
    cpu_s = time.perf_counter() - t0
    pairs = [(f, getattr(out, f)[:rows], getattr(want_out, f)) for f in out._fields]
    pairs += [("cert", cert[:rows], want_cert), ("wire", wire[:rows], want_wire)]
    for name, g, w in pairs:
        g = g.cpu()
        if g.dtype != w.dtype or g.shape != w.shape or not torch.equal(g, w):
            raise AssertionError(f"{label}: GPU narrow tick differs from the CPU one in {name}")
    row = {
        "case": label, "rows": rows, "m": m, "k": k,
        "certified": int(want_cert.sum()), "planes_equal": len(pairs), "cpu_s": cpu_s,
    }
    log(f"narrow {label}: {json.dumps(row)}")
    return row


def profile_chunk(label: str, engine, units, clusters, top: int = 14) -> None:
    """Device time of one chunk's expand + narrow tick + pack by kernel
    (torch.profiler), against the window's wall time (idle share)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from kubeadmiral_tpu_torch.ops.pipeline import expand_compact

    dev, fmt, m, k, key_max = chunk_device_inputs(engine, units, clusters)
    run = lambda: chunk_path(  # noqa: E731
        expand_compact(dev, key_max) if fmt == "compact" else dev, m, k
    )
    run()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6

    def dev_us(e):
        return getattr(e, "self_device_time_total", None) or getattr(e, "self_cuda_time_total", 0)

    # Device-side events only (the kernels and copies themselves; the
    # host ops that launched them would count the same time again).
    events = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    busy = sum(dev_us(e) for e in events)
    log(
        f"profile {label} (m={m}, k={k}): wall {wall_us / 1e3:.2f} ms, device busy "
        f"{busy / 1e3:.2f} ms, idle share {1 - busy / wall_us:.3f}"
    )
    for e in sorted(events, key=dev_us, reverse=True)[:top]:
        log(f"  {dev_us(e) / 1e3:9.3f} ms  x{e.count:<5d} {e.key[:90]}")


HOLD_CYCLES = 4_000_000  # ~2 ms of the card's clock


def timed_ms(fn, runs: int = 7) -> float:
    """Median device time of fn() in ms (CUDA events), after a warm-up,
    with L2 flushed before every run.  The card spins for HOLD_CYCLES
    after the flush, so the host has queued the start event, fn's work
    and the end event before the start event is reached: the events
    then hold fn's device time, not the host's time to launch it."""
    import torch

    flush = torch.empty(256 << 20, dtype=torch.uint8, device="cuda")
    fn()
    times = []
    for _ in range(runs):
        flush.zero_()
        torch.cuda._sleep(HOLD_CYCLES)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def division_sass(lib_path) -> dict:
    """The short divisions in the built kernel, from its SASS.  Each site
    rounds the float estimate num * rcp down to an integer with one
    F2I.FLOOR whose operand an FMUL wrote; no other instruction of the
    kernel floors a float.  Returns the number of sites per kernel
    instance; raises if the last write before an F2I.FLOOR to its
    operand is not an FMUL, or the build has no site."""
    cuobjdump = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    sass = subprocess.run(
        [cuobjdump, "-sass", str(lib_path)], capture_output=True, text=True, check=True
    ).stdout
    sites = {}
    for body in re.split(r"\n\s+Function : ", sass)[1:]:
        name = body.split("\n", 1)[0].strip()
        code = [t.strip() for t in re.findall(r"/\*[0-9a-f]{4,}\*/\s+([^;]*);", body)]
        floors = [i for i, t in enumerate(code) if t.startswith("F2I.FLOOR")]
        for i in floors:
            src = code[i].split(",")[-1].strip()
            writer = next(
                (t for t in reversed(code[:i])
                 if re.match(rf"(@!?P\d )?\S+ {re.escape(src)},", t)), "",
            )
            if not writer.startswith("FMUL"):
                raise AssertionError(f"{name}: F2I.FLOOR at SASS line {i} floors {writer!r}")
        if floors:
            args = re.search(r"phase1_kernelILi(\d)ELb(\d)ELb(\d)E", name)
            key = "rows{}_shared{}_vec{}".format(*args.groups()) if args else name
            sites[key] = len(floors)
    if not sites:
        raise AssertionError("no short-division site in the built kernel")
    return {"sites": sites}


def phase1_work(inp, feasible) -> dict:
    """What phase 1 must do on these inputs, given the feasibility it
    computes: which cells each filter and score plugin touches, and the
    divisions it keeps, counted two ways: by the short division (a
    quotient within 2^20 and a divisor below 2^62, else the exact path)
    and by PR 1's 64-bit division (both operands in [0, 2^32) take the
    32-bit path, the rest the 64-bit routine)."""
    import torch

    from kubeadmiral_tpu_torch.ops import scores as S

    fe, se = inp.filter_enabled, inp.score_enabled
    c = feasible.shape[1]
    counts = {"short": 0, "short64": 0, "exact": 0, "fast": 0, "slow": 0}

    def divisions(keep, num, den):
        den = den.clamp(min=1)
        kept = int(keep.sum())
        q = torch.div(num, den, rounding_mode="floor")
        short = keep & (q.abs() < 2**20 - 1) & (den < 2**62)
        fast = int((keep & (num >= 0) & (num < 2**32) & (den < 2**32)).sum())
        counts["short"] += int(short.sum())
        counts["short64"] += int((short & (den > 2**30)).sum())
        counts["exact"] += kept - int(short.sum())
        counts["fast"] += fast
        counts["slow"] += kept - fast

    scored = {p: feasible & se[:, p, None] for p in range(S.NUM_SCORE_PLUGINS)}
    for p, plane in ((S.S_TAINT, inp.taint_counts), (S.S_AFFINITY, inp.affinity_scores)):
        row_max = torch.where(scored[p], plane, 0).amax(1, keepdim=True)
        num = (plane * 100).to(torch.int64)  # the plane's int32 product, as the kernel
        divisions(scored[p] & (row_max != 0), num, row_max.to(torch.int64).expand_as(num))
    alloc_cpu, alloc_mem, req_cpu, req_mem = S._requested_totals(inp.request, inp.alloc, inp.used)
    keep = (
        scored[S.S_BALANCED] & (alloc_cpu != 0) & (alloc_mem != 0)
        & (req_cpu < alloc_cpu) & (req_mem < alloc_mem)
    )
    s_cpu, s_mem = S._balanced_range_shift(alloc_cpu), S._balanced_range_shift(alloc_mem)
    ac, rc = alloc_cpu >> s_cpu, req_cpu >> s_cpu
    am, rm = alloc_mem >> s_mem, req_mem >> s_mem
    total = (ac * am).clamp(min=1)
    divisions(keep, 100 * (total - (rc * am - rm * ac).abs()), total)
    for p, least in ((S.S_LEAST, True), (S.S_MOST, False)):
        for req, alloc in ((req_cpu, alloc_cpu), (req_mem, alloc_mem)):
            keep = scored[p] & (alloc != 0) & (req <= alloc)
            divisions(keep, (alloc - req if least else req) * 100, alloc)

    resource = scored[S.S_BALANCED] | scored[S.S_LEAST] | scored[S.S_MOST]
    return {
        "cells": feasible.numel(),
        "feasible": int(feasible.sum()),
        "filter_cells": [int(fe[:, f].sum()) * c for f in range(fe.shape[1])],
        "fit_cells": int((fe[:, 2] & (inp.request > 0).any(1)).sum()) * c,
        "placement_cells": int((fe[:, 3] & inp.placement_has).sum()) * c,
        "scored": {p: int(m.sum()) for p, m in scored.items()},
        "resource_cells": int(resource.sum()),
        "div_short": counts["short"],
        "div_short64": counts["short64"],
        "div_exact": counts["exact"],
        "div_fast": counts["fast"],
        "div_slow": counts["slow"],
    }


def phase1_bound(inp, feasible) -> dict:
    """Least time for phase 1 on these inputs: the bytes the function
    needs (each plane read once, and only where a row's enabled filters
    and plugins read it; each output written once) over the HBM rate,
    and its operations over the peak of the pipe that runs them — the
    larger of the int32 instructions over the int32 peak and the short
    divisions' conversions over the conversion peak (their two fp32
    instructions are below both).  The operation side is also given
    under PR 1's count (``ops_pr1_ms``: every division at the 64-bit
    routine's SASS length, all at the int32 peak); the bound takes the
    new one."""
    from kubeadmiral_tpu_torch.ops import scores as S

    w = phase1_work(inp, feasible)
    b, c = feasible.shape
    r = inp.request.shape[1]
    score_bytes = inp.taint_counts.element_size()
    scored = w["scored"]
    api, taint, fit, _, selector = w["filter_cells"]
    # alloc/used: every resource where a row's fit filter runs, else cpu
    # and mem where a resource plugin scores.
    cluster_r = r if w["fit_cells"] else (2 if w["resource_cells"] else 0)
    nbytes = (
        b * (5 + 5 + 1 + 8 * r)                  # flags, placement_has, request
        + api + selector + w["placement_cells"]  # api_ok, selector_ok, placement_ok
        + 2 * taint                              # current_mask, then one taint plane
        + b * c + c                              # webhook_ok, cluster_valid
        + 2 * 8 * c * cluster_r                  # alloc, used
        + score_bytes * (w["feasible"] + scored[S.S_TAINT] + scored[S.S_AFFINITY])
        + (1 + 4 + 8) * b * c                    # feasible, reasons, totals
    )
    base = (
        CELL_OPS * w["cells"]
        + FILTER_OPS * sum(w["filter_cells"])
        + FIT_OPS * r * w["fit_cells"]
        + NORM_OPS * (scored[S.S_TAINT] + scored[S.S_AFFINITY])
        + BALANCED_OPS * scored[S.S_BALANCED]
        + RESOURCE_OPS * w["resource_cells"]
        + RATIO_OPS * (scored[S.S_LEAST] + scored[S.S_MOST])
        + WEBHOOK_OPS * w["feasible"]
    )
    int_ops = (
        base
        + DIV_INT32_OPS * (w["div_short"] - w["div_short64"])
        + DIV_INT64_OPS * w["div_short64"]
        + PR1_DIV_SLOW * w["div_exact"]
    )
    conv_ops = DIV_CONV_OPS * w["div_short"]
    pr1_ops = base + PR1_DIV_FAST * w["div_fast"] + PR1_DIV_SLOW * w["div_slow"]
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    int_ms = int_ops / INT32_OPS_PER_S * 1e3
    conv_ms = conv_ops / CONV_OPS_PER_S * 1e3
    ops_ms = max(int_ms, conv_ms)
    return {
        "bytes": int(nbytes),
        "ops": int(int_ops),
        "conv_ops": int(conv_ops),
        "ops_ms": ops_ms,
        "ops_pr1": int(pr1_ops),
        "ops_pr1_ms": pr1_ops / INT32_OPS_PER_S * 1e3,
        "bound_ms": max(bytes_ms, ops_ms),
        "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
        "derivation": (
            f"max({nbytes} B / {HBM_BYTES_PER_S:.3g} B/s = {bytes_ms:.6f} ms, "
            f"{int_ops} int32 instructions / {INT32_OPS_PER_S:.4g} /s = {int_ms:.6f} ms, "
            f"{conv_ops} conversions / {CONV_OPS_PER_S:.4g} /s = {conv_ms:.6f} ms); "
            f"under PR 1's division count {pr1_ops} int32 instructions = "
            f"{pr1_ops / INT32_OPS_PER_S * 1e3:.6f} ms"
        ),
        "work": {k: v for k, v in w.items() if k != "scored"}
        | {"scored": [scored[p] for p in range(S.NUM_SCORE_PLUGINS)]},
    }


def check_phase1(label: str, inp, timed: bool = False, plain: bool = True) -> dict:
    """Hold the kernel against phase1_plain on ``inp`` (tolerance 0).
    With ``timed``, also time the kernel (and the plain version unless
    ``plain`` is False) and work out its bound."""
    import torch

    from kubeadmiral_tpu_torch.ops.phase1 import phase1, phase1_plain

    got = phase1(inp)
    want = phase1_plain(inp)
    torch.cuda.synchronize()
    err = 0
    for name, g, w in zip(("feasible", "reasons", "totals"), got, want):
        if g.dtype != w.dtype or g.shape != w.shape:
            raise AssertionError(f"{label}: {name} {g.dtype}{tuple(g.shape)} vs {w.dtype}{tuple(w.shape)}")
        err = max(err, int((g.to(torch.int64) - w.to(torch.int64)).abs().max()))
    b, c = inp.api_ok.shape
    row = {"case": label, "shape": [b, c, int(inp.request.shape[1])], "max_abs_err": err}
    if err != 0:
        raise AssertionError(f"{label}: kernel differs from phase1_plain (max abs err {err})")
    if timed:
        row["ms"] = timed_ms(lambda: phase1(inp))
        if plain:
            row["plain_ms"] = timed_ms(lambda: phase1_plain(inp), runs=3)
        row.update(phase1_bound(inp, want[0]))
    log(f"phase1 {label}: {json.dumps(row)}")
    return row


# Where the kernel's time goes, without ncu: the same chunk with the
# row flags switched off (per row, so a disabled filter or plugin reads
# no plane and does no work).  Feasibility follows the flags, so each
# variant has its own bound.
ATTRIBUTION = (
    # key, what stays, filters off, score plugins off
    ("a", "as the chunk has them", (), ()),
    ("b", "no fit filter, no resource plugins", (2,), (1, 2, 4)),
    ("c", "no taint or affinity scoring", (), (0, 3)),
    ("d", "every filter and plugin off", (0, 1, 2, 3, 4), (0, 1, 2, 3, 4)),
)


def attribute(label: str, inp) -> dict:
    """Kernel time beside its bound for each ATTRIBUTION variant of a
    chunk, every variant held against phase1_plain.  Returns
    {key: row}."""
    rows = {}
    for key, what, filters_off, scores_off in ATTRIBUTION:
        fe, se = inp.filter_enabled.clone(), inp.score_enabled.clone()
        fe[:, list(filters_off)] = False
        se[:, list(scores_off)] = False
        variant = inp._replace(filter_enabled=fe, score_enabled=se)
        row = check_phase1(f"{label}-{key}", variant, timed=True, plain=False)
        rows[key] = {"what": what, "ms": row["ms"], "bound_ms": row["bound_ms"],
                     "bound_by": row["bound_by"], "share": row["bound_ms"] / row["ms"],
                     "work": row["work"]}
    log(f"attribution {label}: {json.dumps(rows)}")
    return rows


@contextlib.contextmanager
def gc_time():
    """Yield a dict that receives the wall ms the host spent in Python's
    garbage collector while the block ran ("ms") and its collections by
    generation ("collections")."""
    got = {"ms": 0.0, "collections": [0, 0, 0]}
    started = []

    def callback(phase, info):
        if phase == "start":
            started.append(time.perf_counter())
        elif started:
            got["ms"] += (time.perf_counter() - started.pop()) * 1e3
            got["collections"][info["generation"]] += 1

    gc.callbacks.append(callback)
    try:
        yield got
    finally:
        gc.callbacks.remove(callback)


def pinned_bytes():
    """The byte counters of PyTorch's caching host allocator (the pinned
    staging of uploads and reads), or None where this torch has no
    ``torch.cuda.host_memory_stats``."""
    import torch

    stats = getattr(torch.cuda, "host_memory_stats", None)
    if stats is None:
        return None
    return {k: v for k, v in stats().items() if "bytes" in k}


def counted_tick(engine, units, clusters, capture: bool = False, **kw):
    """engine.schedule(units, clusters, **kw) with every tick dispatch recorded
    as (kind, rows, clusters), kind "narrow" or "dense" (on a narrow
    path the dense ones are certificate fallbacks), the phase-1 launch
    count set to 0 just before the call and read just after, and the
    engine's counters as deltas over the call.  With ``capture`` the
    first dispatch's expanded inputs are kept (on a churn tick a
    sub-batch slab's, for check_phase1 at its shape), moved to the host
    after the timed call so that ``memory_allocated`` counts the
    engine's tensors only.  Garbage is collected before the clock starts,
    so that the script's own garbage (a fresh reference engine's results)
    is not collected inside the timed tick; the collector's own time
    inside the tick is reported (``gc_ms``, collections by generation).
    The peak of ``memory_allocated`` is reset before the call; the
    synchronising operations made inside the chunk dispatches are
    counted (``dispatch_syncs``, testing/syncs.py); each window drain
    records its chunks, ``memory_allocated`` and the pinned host bytes
    held as it starts (``drains``).  Returns (results, tick dict,
    captured host inputs or None)."""
    import torch

    from kubeadmiral_tpu_torch.ops.phase1 import phase1
    from kubeadmiral_tpu_torch.testing.sample_counts import recorded_dispatches
    from kubeadmiral_tpu_torch.testing.syncs import counted_dispatch_syncs

    captured = []
    before = (
        dict(engine.narrow_stats), dict(engine.cache_stats), dict(engine.fetch_stats),
        dict(engine.upload_bytes), engine.overflow_rows_total, engine.fetch_bytes_total,
        dict(engine.drift_stats), dict(engine.survivor_stats), engine.planner_reruns,
    )
    drains = []
    real_drain = engine._drain_window

    def drain(items, *args):
        if items:
            drains.append({
                "chunks": len(items), "memory_allocated": torch.cuda.memory_allocated(),
                "pinned": pinned_bytes(),
            })
        return real_drain(items, *args)

    gc.collect()
    torch.cuda.reset_peak_memory_stats()
    engine._drain_window = drain
    try:
        with recorded_dispatches(keep=captured if capture else None) as calls, \
                counted_dispatch_syncs(engine) as syncs, gc_time() as collector:
            phase1.launches = 0
            t0 = time.perf_counter()
            results = engine.schedule(units, clusters, **kw)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launches = phase1.launches
    finally:
        del engine._drain_window
    narrow0, cache0, fetch0, upload0, over0, bytes0, gate0, surv0, reruns0 = before
    captured = [type(inp)(*(x.cpu() for x in inp)) for inp in captured]

    def delta(now, then):
        return {k: v - then[k] for k, v in now.items() if v - then[k]}

    narrow = [c for c in calls if c[0] == "narrow"]
    tick = {
        "objects": len(units),
        "clusters": len(clusters),
        "tick_ms": wall * 1e3,
        "objects_per_s": len(units) / wall,
        "phase1_launches": launches,
        "narrow_dispatches": len(narrow),
        "dense_dispatches": len(calls) - len(narrow),
        "dispatch_shapes": sorted({tuple(c) for c in calls}),
        "narrow_stats": {k: v - narrow0[k] for k, v in engine.narrow_stats.items()},
        "cache": delta(engine.cache_stats, cache0),
        "fetch_paths": delta(engine.fetch_stats, fetch0),
        "drift_stats": delta(engine.drift_stats, gate0),
        "survivor_stats": delta(engine.survivor_stats, surv0),
        "overflow_rows": engine.overflow_rows_total - over0,
        "fetch_bytes": engine.fetch_bytes_total - bytes0,
        "upload_bytes": {k: v - upload0[k] for k, v in engine.upload_bytes.items()},
        "changed_rows": None if engine.last_changed is None else len(engine.last_changed),
        "stage_s": dict(engine.timings),
        "gc_ms": collector["ms"],
        "gc_collections": collector["collections"],
        "pipeline_depth": engine.pipeline_depth,
        "planner_reruns": engine.planner_reruns - reruns0,
        "dispatch_syncs": len(syncs),
        "dispatch_sync_sites": sorted(set(syncs)),
        "memory_allocated": torch.cuda.memory_allocated(),
        "max_memory_allocated": torch.cuda.max_memory_allocated(),
        "drains": drains,
    }
    return results, tick, captured[0] if captured else None


def run_tick(label: str, engine, units, clusters, **kw) -> dict:
    """One cold engine tick on the card (``engine`` fresh: no cache;
    ``kw`` to schedule).  Requires launches = chunks + fallback
    dispatches + planner re-dispatches (windowed chunks whose planner
    outlasted its round budget, dispatched again)."""
    c_bucket, eff, _ = engine._tick_geometry(len(clusters))
    chunks = math.ceil(len(units) / eff)
    results, tick, _ = counted_tick(engine, units, clusters, **kw)
    narrow, dense = tick["narrow_dispatches"], tick["dense_dispatches"]
    reruns = tick["planner_reruns"]
    if narrow not in (0, chunks + reruns):
        raise AssertionError(f"{label}: {narrow} narrow ticks for {chunks} chunks + {reruns} reruns")
    # Every chunk runs one tick, narrow or dense (twice if re-dispatched);
    # further dense ticks are the narrow chunks' certificate fallbacks.
    fallback = dense - (chunks + reruns - narrow)
    if tick["phase1_launches"] != chunks + fallback + reruns:
        raise AssertionError(
            f"{label}: phase1 launched {tick['phase1_launches']} times for {chunks} "
            f"chunks + {fallback} fallback dispatches + {reruns} planner re-dispatches"
        )
    if tick["cache"] != {"miss": chunks}:
        raise AssertionError(f"{label}: not a cold tick: {tick['cache']}")
    dense_bytes = 6 * len(units) * c_bucket
    tick.update(
        c_bucket=c_bucket,
        chunks=chunks,
        narrow_m=engine.narrow_last_m if narrow else None,
        fallback_dispatches=fallback,
        dense_plane_bytes=dense_bytes,
        fetch_vs_dense=tick["fetch_bytes"] / dense_bytes,
    )
    log(f"tick {label}: {json.dumps(tick)}")
    return {"results": results, **tick}


def run_with_narrow_m(label: str, units, clusters, narrow_m: int) -> dict:
    """run_tick on a fresh engine with the engine's NARROW_M constant
    patched for the call."""
    from kubeadmiral_tpu_torch.scheduler import engine as engine_mod

    saved = engine_mod.NARROW_M
    engine_mod.NARROW_M = narrow_m
    try:
        return run_tick(
            f"{label} (NARROW_M={narrow_m}, {len(units)} objects)",
            engine_mod.SchedulerEngine(), units, clusters,
        )
    finally:
        engine_mod.NARROW_M = saved


def turns_c3(units, clusters, got, narrow: dict, dense: dict) -> dict:
    """Narrow against dense at C = 512 in turns: narrow, dense (the
    ticks already run), then dense, narrow again, each a cold tick on a
    fresh engine held against the first narrow run's placements.  Host
    stages swing with order and between calls, so one pair of ticks
    decides nothing.  Logs and returns each arm's tick_ms, device +
    fetch ms and decode ms."""
    from kubeadmiral_tpu_torch.scheduler.engine import SchedulerEngine

    dense2 = run_with_narrow_m("c3 dense, turn 2", units, clusters, narrow["c_bucket"])
    narrow2 = run_tick("c3 narrow, turn 2", SchedulerEngine(), units, clusters)
    if dense2["narrow_m"] is not None or narrow2["narrow_m"] is None:
        raise AssertionError("c3 turns: an arm took the other path")
    for label, tick in (("dense, turn 2", dense2), ("narrow, turn 2", narrow2)):
        assert_results_equal(f"c3 {label} vs narrow", tick.pop("results"), got)
    arms = {}
    for arm, runs in (("narrow", (narrow, narrow2)), ("dense", (dense, dense2))):
        arms[arm] = {
            "tick_ms": [r["tick_ms"] for r in runs],
            "device_fetch_ms": [
                (r["stage_s"]["device"] + r["stage_s"]["fetch"]) * 1e3 for r in runs
            ],
            "decode_ms": [r["stage_s"]["decode"] * 1e3 for r in runs],
        }
    log(f"turns c3 narrow vs dense (narrow, dense, dense, narrow): {json.dumps(arms)}")
    return arms


# The window against the sequential dispatch, in turns (fresh engines).
TURN_DEPTHS = (16, 1, 1, 16)


def turns_depth(cfg: str, units, clusters, got) -> dict:
    """Cold ticks on fresh engines at TURN_DEPTHS, each checked as
    run_tick checks (launches = chunks + fallbacks + re-dispatches) and
    equal to ``got`` (step 7's placements); logs and returns per depth
    the wall ms, stages, garbage-collector time, launches, peak memory
    and dispatch syncs."""
    import torch

    from kubeadmiral_tpu_torch.scheduler.engine import SchedulerEngine

    arms: dict = {}
    for turn, depth in enumerate(TURN_DEPTHS):
        engine = SchedulerEngine()
        engine.pipeline_depth = depth
        tick = run_tick(f"c{cfg} depth {depth}, turn {turn}", engine, units, clusters)
        assert_results_equal(f"c{cfg} depth {depth}, turn {turn} vs narrow", tick.pop("results"), got)
        arm = arms.setdefault(str(depth), {
            k: [] for k in ("tick_ms", "stage_ms", "gc_ms", "gc_collections", "launches",
                            "max_memory_allocated", "dispatch_syncs", "planner_reruns",
                            "fetch_bytes")
        })
        arm["tick_ms"].append(tick["tick_ms"])
        arm["stage_ms"].append({k: v * 1e3 for k, v in tick["stage_s"].items()})
        arm["gc_ms"].append(tick["gc_ms"])
        arm["gc_collections"].append(tick["gc_collections"])
        arm["launches"].append(tick["phase1_launches"])
        arm["max_memory_allocated"].append(tick["max_memory_allocated"])
        arm["dispatch_syncs"].append(tick["dispatch_syncs"])
        arm["planner_reruns"].append(tick["planner_reruns"])
        arm["fetch_bytes"].append(tick["fetch_bytes"])
        del engine, tick
        torch.cuda.empty_cache()
    log(f"turns c{cfg} depth (16, 1, 1, 16): {json.dumps(arms)}")
    return arms


# The window's planner round budget in turns (fresh engines, depth 16).
TURN_BUDGETS = (1, 2, 4, 4, 2, 1)


def turns_budget(cfg: str, units, clusters, got) -> dict:
    """Cold ticks at the default depth on fresh engines with the
    engine's PLANNER_ROUNDS patched to TURN_BUDGETS, each checked as
    run_tick checks and equal to ``got``; logs and returns per budget
    the wall ms, the device (queuing) and device + fetch ms, planner
    re-dispatches and dispatch syncs."""
    import torch

    from kubeadmiral_tpu_torch.scheduler import engine as engine_mod

    saved = engine_mod.PLANNER_ROUNDS
    arms: dict = {}
    try:
        for turn, rounds in enumerate(TURN_BUDGETS):
            engine_mod.PLANNER_ROUNDS = rounds
            engine = engine_mod.SchedulerEngine()
            label = f"c{cfg} planner rounds {rounds}, turn {turn}"
            tick = run_tick(label, engine, units, clusters)
            assert_results_equal(f"{label} vs narrow", tick.pop("results"), got)
            stage = tick["stage_s"]
            arm = arms.setdefault(str(rounds), {
                k: [] for k in ("tick_ms", "device_ms", "device_fetch_ms", "planner_reruns",
                                "dispatch_syncs")
            })
            arm["tick_ms"].append(tick["tick_ms"])
            arm["device_ms"].append(stage["device"] * 1e3)
            arm["device_fetch_ms"].append((stage["device"] + stage["fetch"]) * 1e3)
            arm["planner_reruns"].append(tick["planner_reruns"])
            arm["dispatch_syncs"].append(tick["dispatch_syncs"])
            del engine, tick
            torch.cuda.empty_cache()
    finally:
        engine_mod.PLANNER_ROUNDS = saved
    log(f"turns c{cfg} planner rounds {TURN_BUDGETS}: {json.dumps(arms)}")
    return arms


def dispatch_syncs(worlds) -> dict:
    """The synchronising operations of one chunk's dispatch (the first
    chunk's, on a fresh engine), c5 and c3, the window's and the
    sequential one, under torch.cuda.set_sync_debug_mode("warn"): counts,
    sites and the dispatch's host ms."""
    import torch

    from kubeadmiral_tpu_torch.testing.syncs import first_chunk_syncs

    out = {}
    for cfg in ("5", "3"):
        units, clusters, _ = worlds[cfg]
        for name, windowed in (("window", True), ("sequential", False)):
            probe = first_chunk_syncs(units, clusters, windowed)
            sites: dict = {}
            for site in probe["sites"]:
                sites[site] = sites.get(site, 0) + 1
            out[f"c{cfg} {name}"] = {
                "syncs": len(probe["sites"]), "sites": sites, "other_warnings": probe["other"],
                "queue_ms": probe["queue_ms"],
            }
        torch.cuda.empty_cache()
    log(f"syncs: {json.dumps(out)}")
    return out


WARM_CHURN_TICKS = 3
# The warm phase's capacity drifts per world (testing/worlds.py), each
# followed by a tick back on the first clusters.
WARM_DRIFTS = {"3": ("drift",), "5": ("drift", "drift-zero", "drift-wide")}


def warm_phase(cfg: str, units, clusters, engine, cold: dict, results):
    """The steady-state ticks of one world on ``engine``, which has just
    run the world's cold tick (``cold``, ``results``): a no-op tick on
    the same list and one on a fresh list of the same objects,
    WARM_CHURN_TICKS 1 % churn ticks (testing/worlds.churn, numpy seed
    0), then each of WARM_DRIFTS[cfg] and a tick back on the first
    clusters.

    No-op ticks must launch nothing and replay the previous result
    objects.  A churn tick must launch one kernel per sub-batch slab plus
    one per certificate fallback, with as many slabs as the engine's
    ladder cuts the changed rows into; its changed rows must equal a
    fresh engine's cold tick over those units alone (rows are
    independent) and its other rows must be the previous tick's result
    objects.  A drift tick and a tick back are checked by ``drift_tick``.
    Returns (ticks by label, the first churn tick's slab inputs on the
    host)."""
    import torch

    from kubeadmiral_tpu_torch.scheduler.engine import SchedulerEngine
    from kubeadmiral_tpu_torch.testing.worlds import churn, drift, drift_wide, drift_zero

    shapes = {"drift": drift, "drift-zero": drift_zero, "drift-wide": drift_wide}
    _, eff, ladder = engine._tick_geometry(len(clusters))
    chunks = math.ceil(len(units) / eff)
    rng = np.random.default_rng(0)
    ticks = {}

    def fresh(label, batch, cl):
        t0 = time.perf_counter()
        want = SchedulerEngine().schedule(batch, cl)
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        log(f"fresh engine c{cfg} {label}: {len(batch)} rows in {time.perf_counter() - t0:.2f} s")
        return want

    def record(label, tick):
        tick.pop("results", None)
        ticks[label] = tick
        log(f"warm c{cfg} {label}: {json.dumps(tick)}")

    def drift_tick(label, batch, cl, prev, want):
        """A capacity-drift tick on device-resident inputs.  Gated chunks
        launch the kernel only for the recompute rows' sub-batch slabs
        and for mass-change chunks; chunks the gate does not take (a
        drift wider than it handles) are dispatched whole; each of those
        dispatches adds one launch per certificate fallback.  No
        per-object upload; every row equal to ``want``; every row whose
        placement moved among the changed rows."""
        got, tick, _ = counted_tick(engine, batch, cl)
        gate = tick["drift_stats"]
        recompute = gate.get("recompute", 0)
        slabs = -(-recompute // engine._slab_cut(recompute, eff, ladder)) if recompute else 0
        dispatches = (
            slabs + gate.get("fallback", 0) + chunks - gate.get("gated", 0)
            + tick["planner_reruns"]
        )
        narrow, dense = tick["narrow_dispatches"], tick["dense_dispatches"]
        fallback = dense if narrow else 0
        if (narrow or dense) != dispatches or tick["phase1_launches"] != dispatches + fallback:
            raise AssertionError(
                f"c{cfg} {label}: {tick['phase1_launches']} launches, {narrow} narrow + "
                f"{dense} dense dispatches for {slabs} slabs + {gate.get('fallback', 0)} "
                f"mass-change chunks + {chunks - gate.get('gated', 0)} ungated chunks "
                f"+ {tick['planner_reruns']} planner re-dispatches: {tick}"
            )
        if tick["cache"] != {"hit": chunks} or tick["upload_bytes"]["object"]:
            raise AssertionError(f"c{cfg} {label}: not a hit on device-resident inputs: {tick}")
        assert_results_equal(f"c{cfg} {label} vs fresh engine", got, want)
        moved = {i for i, (a, b) in enumerate(zip(got, prev)) if a.clusters != b.clusters}
        changed = (
            set(range(len(got))) if engine.last_changed is None else set(engine.last_changed)
        )
        if not moved <= changed:
            raise AssertionError(f"c{cfg} {label}: {len(moved - changed)} moved rows not changed")
        tick.update(recompute_slabs=slabs, fallback_dispatches=fallback, moved_rows=len(moved))
        record(label, tick)
        return got

    record("cold", cold)
    for label, batch in (("noop", units), ("noop, fresh list", list(units))):
        again, tick, _ = counted_tick(engine, batch, clusters)
        launched = tick["phase1_launches"] + tick["narrow_dispatches"] + tick["dense_dispatches"]
        if launched or tick["fetch_paths"] != {"noop": chunks}:
            raise AssertionError(f"c{cfg} {label}: {tick}")
        if len(again) != len(results) or any(a is not b for a, b in zip(again, results)):
            raise AssertionError(f"c{cfg} {label}: did not replay the previous results")
        record(label, tick)

    prev_units, prev, slab = units, results, None
    for i in range(WARM_CHURN_TICKS):
        label = f"churn {i}"
        batch = churn(rng, prev_units)
        got, tick, captured = counted_tick(engine, batch, clusters, capture=slab is None)
        changed = [j for j, (a, b) in enumerate(zip(batch, prev_units)) if a is not b]
        cut = engine._slab_cut(len(changed), eff, ladder)
        slabs = -(-len(changed) // cut)
        narrow = tick["narrow_dispatches"]
        slab_dispatches = narrow or tick["dense_dispatches"]
        fallback = tick["dense_dispatches"] if narrow else 0
        if slab_dispatches != slabs:
            raise AssertionError(f"c{cfg} {label}: {slab_dispatches} slab dispatches, not {slabs}")
        if tick["phase1_launches"] != slabs + fallback:
            raise AssertionError(
                f"c{cfg} {label}: {tick['phase1_launches']} launches for {slabs} slabs "
                f"+ {fallback} fallback dispatches"
            )
        touched = len({j // eff for j in changed})
        paths = {"subbatch": touched}
        if chunks > touched:
            paths["noop"] = chunks - touched
        if tick["fetch_paths"] != paths:
            raise AssertionError(f"c{cfg} {label}: fetch paths {tick['fetch_paths']}, not {paths}")
        kept = set(changed)
        if any(got[j] is not prev[j] for j in range(len(got)) if j not in kept):
            raise AssertionError(f"c{cfg} {label}: an unchanged row is a new result object")
        want = fresh(f"{label}, changed units", [batch[j] for j in changed], clusters)
        assert_results_equal(f"c{cfg} {label} changed rows vs fresh engine",
                             [got[j] for j in changed], want)
        tick.update(changed_units=len(changed), slabs=slabs, slab_cut=cut,
                    fallback_dispatches=fallback)
        record(label, tick)
        if slab is None:
            slab = captured
        prev_units, prev = batch, got
    # One fresh cold tick on the first clusters serves every tick back.
    back_want = None
    for name in WARM_DRIFTS[cfg]:
        drifted = shapes[name](clusters)
        prev = drift_tick(name, prev_units, drifted, prev, fresh(name, prev_units, drifted))
        if back_want is None:
            back_want = fresh("back", prev_units, clusters)
        back = "back" if name == "drift" else f"back from {name}"
        prev = drift_tick(back, prev_units, clusters, prev, back_want)
    del engine
    torch.cuda.empty_cache()
    return ticks, slab


def assert_results_equal(label: str, got, want, scores: bool = False) -> None:
    """Equal placements row by row (and equal score dicts with
    ``scores``)."""
    if len(got) != len(want):
        raise AssertionError(f"{label}: {len(got)} results vs {len(want)}")
    bad = [i for i, (a, b) in enumerate(zip(got, want)) if a.clusters != b.clusters]
    if scores:
        bad += [i for i, (a, b) in enumerate(zip(got, want)) if a.scores != b.scores]
    if bad:
        i = min(bad)
        raise AssertionError(
            f"{label}: {len(set(bad))} rows differ; row {i}: {dict(got[i].clusters)} "
            f"{dict(got[i].scores)} vs {dict(want[i].clusters)} {dict(want[i].scores)}"
        )
    placed = sum(1 for r in got if r.clusters)
    scored = f", {sum(1 for r in got if r.scores)} with scores" if scores else ""
    log(f"check {label}: {len(got)} rows equal ({placed} placed{scored})")


# The surface phase's follower index: every FOLLOW_EVERY-th row follows
# its two predecessors.
FOLLOW_EVERY = 50


def check_unions(label: str, results, follows: dict) -> None:
    """Every follower row's placement is its leaders' union, without
    replica counts."""
    for f, leaders in follows.items():
        want = set()
        for leader in leaders:
            want.update(results[leader].clusters)
        got = results[f].clusters
        if set(got) != want or any(v is not None for v in got.values()):
            raise AssertionError(f"{label}: follower row {f} is not its leaders' union")
    log(f"check {label}: {len(follows)} follower rows are their leaders' unions")


def surface_phase(cfg: str, units, clusters, plain_cold: dict) -> dict:
    """The rest of schedule()'s surface at full size on a fresh engine.

    Scores: a cold ``want_scores`` tick (launches as run_tick; results
    and scores equal to the CPU engine's on the check rows; fetch bytes
    equal to step 7's plain cold tick's plus the overflow rows' score
    words, 4 B a cluster slot, when neither re-dispatched), a no-op and
    a 1 % churn tick with scores and a follower index (FOLLOW_EVERY),
    a plain tick on the same list (the scored decodes serve it: no
    launch), a capacity drift with scores (no gate: every chunk
    dispatched whole) and a tick back, each drift tick equal in
    placements and scores to a fresh engine's.

    Webhook: a ``want_scores`` tick with testing/worlds.py:webhook(0)
    over the first C5_DENSE_OBJECTS objects at c5 (all at c3): one
    launch per chunk plus certificate fallbacks (some rows' webhook
    scores leave the narrow key range, so there are some); results and
    scores equal to the CPU engine's on the check rows; the chunk cache
    untouched; then a plain tick over the whole list replays with no
    launch and no upload; then the kernel against phase1_plain on the
    first webhook chunk's inputs, timed, with its bound.  Returns {"ticks":
    by label, "webhook_chunk": check_phase1's row}."""
    import torch

    from kubeadmiral_tpu_torch.ops.follower import FollowerIndex
    from kubeadmiral_tpu_torch.scheduler.engine import SchedulerEngine
    from kubeadmiral_tpu_torch.testing.worlds import churn, drift, webhook

    engine = SchedulerEngine()
    c_bucket, eff, ladder = engine._tick_geometry(len(clusters))
    chunks = math.ceil(len(units) / eff)
    check = len(units) if cfg == "3" else C5_CHECK_ROWS
    follows = {i: (i - 2, i - 1) for i in range(FOLLOW_EVERY, len(units), FOLLOW_EVERY)}
    fidx = FollowerIndex(follows)
    ticks = {}

    def record(label, tick):
        tick.pop("results", None)
        ticks[label] = tick
        log(f"surface c{cfg} {label}: {json.dumps(tick)}")

    def cpu_check(label, got, batch, cl, **kw):
        rows = min(check, len(got))
        t0 = time.perf_counter()
        want = SchedulerEngine(device="cpu").schedule(batch[:rows], cl, **kw)
        log(f"cpu engine c{cfg} {label}: {rows} rows in {time.perf_counter() - t0:.2f} s")
        assert_results_equal(f"c{cfg} {label} gpu vs cpu", got[:rows], want, scores=True)

    def fresh(label, batch, cl):
        t0 = time.perf_counter()
        want = SchedulerEngine().schedule(batch, cl, want_scores=True)
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        log(f"fresh engine c{cfg} {label}: {len(batch)} rows in {time.perf_counter() - t0:.2f} s")
        return want

    def no_launch(label, tick, paths=None):
        launched = tick["phase1_launches"] + tick["narrow_dispatches"] + tick["dense_dispatches"]
        if launched or tick["upload_bytes"]["object"]:
            raise AssertionError(f"c{cfg} {label}: launched or uploaded: {tick}")
        if paths is not None and tick["fetch_paths"] != paths:
            raise AssertionError(f"c{cfg} {label}: fetch paths {tick['fetch_paths']}")

    def same_objects(label, got, prev, skip=()):
        if any(got[j] is not prev[j] for j in range(len(got)) if j not in skip):
            raise AssertionError(f"c{cfg} {label}: a row is not the previous result object")

    # Scored cold tick: the plain cold tick's bytes plus the score words
    # of its overflow rows.
    tick = run_tick(f"c{cfg} scores cold", engine, units, clusters, want_scores=True)
    got = tick.pop("results")
    if tick["overflow_rows"] != plain_cold["overflow_rows"]:
        raise AssertionError(f"c{cfg} scores cold: overflow rows differ from the plain cold tick")
    predicted = plain_cold["fetch_bytes"] + tick["overflow_rows"] * c_bucket * 4
    tick["predicted_fetch_bytes"] = predicted
    if tick["planner_reruns"] == 0 and plain_cold["planner_reruns"] == 0:
        if tick["fetch_bytes"] != predicted:
            raise AssertionError(
                f"c{cfg} scores cold: {tick['fetch_bytes']} fetch bytes, {predicted} predicted"
            )
    record("cold", tick)
    cpu_check("scores cold", got, units, clusters, want_scores=True)

    again, tick, _ = counted_tick(engine, units, clusters, want_scores=True, follower_index=fidx)
    no_launch("noop", tick, {"noop": chunks})
    same_objects("noop", again, got, skip=follows)
    check_unions(f"c{cfg} surface noop", again, follows)
    record("noop", tick)

    rng = np.random.default_rng(0)
    batch = churn(rng, units)
    got, tick, _ = counted_tick(
        engine, batch, clusters, want_scores=True, follower_index=fidx
    )
    changed = [j for j, (a, b) in enumerate(zip(batch, units)) if a is not b]
    cut = engine._slab_cut(len(changed), eff, ladder)
    slabs = -(-len(changed) // cut)
    narrow = tick["narrow_dispatches"]
    fallback = tick["dense_dispatches"] if narrow else 0
    if (narrow or tick["dense_dispatches"]) != slabs or tick["phase1_launches"] != slabs + fallback:
        raise AssertionError(f"c{cfg} surface churn: {tick['phase1_launches']} launches, {slabs} slabs")
    same_objects("churn", got, again, skip=set(changed) | set(follows))
    check_unions(f"c{cfg} surface churn", got, follows)
    mine = [j for j in changed if j not in follows]
    want = fresh("churn, changed units", [batch[j] for j in mine], clusters)
    assert_results_equal(f"c{cfg} surface churn changed rows vs fresh engine",
                         [got[j] for j in mine], want, scores=True)
    tick.update(changed_units=len(changed), slabs=slabs, fallback_dispatches=fallback)
    record("churn", tick)

    plain, tick, _ = counted_tick(engine, batch, clusters)
    no_launch("plain", tick, {"noop": chunks})
    same_objects("plain", plain, got, skip=follows)
    record("plain", tick)

    prev = plain
    for label, cl in (("drift", drift(clusters)), ("back", clusters)):
        got, tick, _ = counted_tick(engine, batch, cl, want_scores=True)
        narrow, dense = tick["narrow_dispatches"], tick["dense_dispatches"]
        reruns = tick["planner_reruns"]
        fallback = dense if narrow else 0
        if tick["drift_stats"].get("gated", 0) or (narrow or dense) != chunks + reruns:
            raise AssertionError(f"c{cfg} surface {label}: the drift gate ran: {tick}")
        if tick["phase1_launches"] != chunks + reruns + fallback:
            raise AssertionError(f"c{cfg} surface {label}: {tick['phase1_launches']} launches")
        if tick["cache"] != {"hit": chunks} or tick["upload_bytes"]["object"]:
            raise AssertionError(f"c{cfg} surface {label}: not a hit on device inputs: {tick}")
        assert_results_equal(f"c{cfg} surface {label} vs fresh engine", got,
                             fresh(label, batch, cl), scores=True)
        moved = {i for i, (a, b) in enumerate(zip(got, prev)) if a.clusters != b.clusters}
        if engine.last_changed is not None and not moved <= set(engine.last_changed):
            raise AssertionError(f"c{cfg} surface {label}: moved rows not changed")
        tick.update(fallback_dispatches=fallback, moved_rows=len(moved))
        record(label, tick)
        prev = got

    # Webhook: a dense-featurized, uncached tick; then a plain tick back.
    depth = len(units) if cfg == "3" else C5_DENSE_OBJECTS
    hook = webhook(seed=0)
    wchunks = math.ceil(depth / eff)
    hooked, tick, captured = counted_tick(
        engine, batch[:depth], clusters, capture=True, want_scores=True, webhook_eval=hook
    )
    narrow, dense = tick["narrow_dispatches"], tick["dense_dispatches"]
    reruns = tick["planner_reruns"]
    if narrow != wchunks + reruns or tick["phase1_launches"] != narrow + dense:
        raise AssertionError(f"c{cfg} webhook: {tick['phase1_launches']} launches, {narrow} narrow")
    if not dense or not tick["narrow_stats"]["fallback"]:
        raise AssertionError(f"c{cfg} webhook: no certificate fallback: {tick['narrow_stats']}")
    if tick["cache"] or tick["fetch_paths"] != {"full": wchunks}:
        raise AssertionError(f"c{cfg} webhook: touched the chunk cache: {tick}")
    tick.update(chunks=wchunks, fallback_dispatches=dense)
    record("webhook", tick)
    cpu_check("webhook", hooked, batch, clusters, want_scores=True, webhook_eval=hook)
    back, tick, _ = counted_tick(engine, batch, clusters)
    no_launch("plain after webhook", tick)
    same_objects("plain after webhook", back, prev)
    record("plain after webhook", tick)
    del engine, hooked, back
    torch.cuda.empty_cache()
    inp = type(captured)(*(x.cuda() for x in captured))
    del captured
    row = check_phase1(f"c{cfg}-webhook-chunk", inp, timed=True)
    del inp
    torch.cuda.empty_cache()
    return {"ticks": ticks, "webhook_chunk": row}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    from kubeadmiral_tpu_torch.convert import to_device
    from kubeadmiral_tpu_torch.ops import phase1 as phase1_mod
    from kubeadmiral_tpu_torch.scheduler import engine as engine_mod
    from kubeadmiral_tpu_torch.scheduler.engine import SchedulerEngine
    from kubeadmiral_tpu_torch.testing.problems import (
        EDGE_SHAPES,
        edge_tick_inputs,
        random_tick_inputs,
    )
    from kubeadmiral_tpu_torch.testing.worlds import SHAPES, build_world

    t_all = time.perf_counter()
    card = card_line()
    log(card)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} device {torch.cuda.get_device_name(0)}")

    t0 = time.perf_counter()
    phase1_mod._library()
    log(f"phase build: {time.perf_counter() - t0:.2f} s (nvcc sm_90a, {phase1_mod.SOURCE.name})")
    log(f"phase1 build (ptxas -v):\n{phase1_mod.build_log().strip()}")
    div = division_sass(phase1_mod.build())
    log(f"phase1 short division sites (SASS): {json.dumps(div)}")

    t0 = time.perf_counter()
    worlds = {cfg: build_world(*SHAPES[cfg], config=cfg, seed=0) for cfg in ("3", "5")}
    log(f"phase worlds: {time.perf_counter() - t0:.2f} s")

    t0 = time.perf_counter()
    gpu = SchedulerEngine()
    rows = {}
    for cfg in ("5", "3"):
        units, clusters, _ = worlds[cfg]
        inp, _, _ = chunk_tick_inputs(gpu, units, clusters)
        rows[cfg] = check_phase1(f"c{cfg}-chunk", inp, timed=True)
        del inp
    odd = random_tick_inputs(333, 200, r=4, webhook=True, invalid=7, scale=True, seed=7)
    check_phase1("odd-B-webhook-padded", to_device(odd, "cuda"))
    for b, c, r, invalid, seed in EDGE_SHAPES:
        edge = to_device(edge_tick_inputs(b, c, r, invalid, seed), "cuda")
        check_phase1(f"edge-{b}x{c}x{r}", edge)
    # Every per-row plane a view one row in: C % 4 == 0 but the planes are
    # not all 16-byte aligned, so the kernel loads cell by cell.
    full = to_device(edge_tick_inputs(9, 5124, 3, 0.05, seed=9), "cuda")
    per_row = [k for k, v in full._asdict().items() if v.shape[:1] == (9,)]
    check_phase1("unaligned-8x5124x3", full._replace(**{k: getattr(full, k)[1:] for k in per_row}))
    torch.cuda.empty_cache()
    log(f"phase kernel-vs-plain: {time.perf_counter() - t0:.2f} s")

    # Where the kernel's time goes at both chunks (PERF.md, PR 4).
    t0 = time.perf_counter()
    attribution = {}
    for cfg in ("5", "3"):
        units, clusters, _ = worlds[cfg]
        inp, _, _ = chunk_tick_inputs(gpu, units, clusters)
        attribution[cfg] = attribute(f"c{cfg}-chunk", inp)
        del inp
    torch.cuda.empty_cache()
    log(f"phase attribution: {time.perf_counter() - t0:.2f} s")

    t0 = time.perf_counter()
    for cfg, rows_checked in (("3", None), ("5", C5_NARROW_ROWS)):
        units, clusters, _ = worlds[cfg]
        inp, m, k = chunk_tick_inputs(gpu, units, clusters)
        check_narrow(f"c{cfg}-chunk", inp, m, k, rows_checked or inp.total.shape[0])
        del inp
    torch.cuda.empty_cache()
    log(f"phase narrow gpu-vs-cpu: {time.perf_counter() - t0:.2f} s")

    t0 = time.perf_counter()
    for cfg in ("5", "3"):
        profile_chunk(f"c{cfg}-chunk", gpu, *worlds[cfg][:2])
    torch.cuda.empty_cache()
    log(f"phase profile: {time.perf_counter() - t0:.2f} s")

    t0 = time.perf_counter()
    syncs = dispatch_syncs(worlds)
    log(f"phase syncs: {time.perf_counter() - t0:.2f} s")

    ticks, dense_ticks, fallback_ticks = {}, {}, {}
    warm, slab_rows, depth_turns, surface = {}, {}, {}, {}
    for cfg in ("3", "5"):
        t0 = time.perf_counter()
        units, clusters, _ = worlds[cfg]
        engine = SchedulerEngine()
        tick = run_tick(f"c{cfg} narrow", engine, units, clusters)
        if tick["narrow_m"] is None:
            raise AssertionError(f"c{cfg}: the engine did not take the narrow path")
        got = tick.pop("results")
        ticks[cfg] = tick
        check = units if cfg == "3" else units[:C5_CHECK_ROWS]
        t1 = time.perf_counter()
        want = SchedulerEngine(device="cpu").schedule(check, clusters)
        log(f"cpu engine c{cfg}: {len(check)} rows in {time.perf_counter() - t1:.2f} s")
        assert_results_equal(f"c{cfg} gpu vs cpu", got[: len(check)], want)
        del want
        torch.cuda.empty_cache()
        log(f"phase e2e-c{cfg}: {time.perf_counter() - t0:.2f} s")

        # The window against the sequential dispatch, in turns.
        t0 = time.perf_counter()
        depth_turns[cfg] = turns_depth(cfg, units, clusters, got)
        log(f"phase turns-c{cfg}: {time.perf_counter() - t0:.2f} s")
        t0 = time.perf_counter()
        turns_budget(cfg, units, clusters, got)
        log(f"phase budget-turns-c{cfg}: {time.perf_counter() - t0:.2f} s")

        # The dense tick through the engine: M patched to the cluster
        # bucket.  Cut depth at c5 (first C5_DENSE_OBJECTS objects).
        t0 = time.perf_counter()
        depth = len(units) if cfg == "3" else C5_DENSE_OBJECTS
        dense = run_with_narrow_m(f"c{cfg} dense", units[:depth], clusters, tick["c_bucket"])
        if dense["narrow_m"] is not None or dense["fallback_dispatches"] != 0:
            raise AssertionError(f"c{cfg}: NARROW_M at the bucket did not take the dense path")
        assert_results_equal(f"c{cfg} dense vs narrow", dense.pop("results"), got[:depth])
        dense_ticks[cfg] = dense

        # A narrower M on the first chunk: rows fail the certificate and
        # the dense re-solve runs on the card.
        fb = run_with_narrow_m(
            f"c{cfg} fallback", units[:FALLBACK_OBJECTS], clusters, FALLBACK_NARROW_M
        )
        if fb["fallback_dispatches"] == 0 or fb["narrow_stats"]["fallback"] == 0:
            raise AssertionError(f"c{cfg}: the forced-fallback run re-solved no row")
        assert_results_equal(f"c{cfg} fallback vs narrow", fb.pop("results"), got[:FALLBACK_OBJECTS])
        fallback_ticks[cfg] = fb
        if cfg == "3":
            turns_c3(units, clusters, got, tick, dense)
        torch.cuda.empty_cache()
        log(f"phase e2e-c{cfg}-dense-and-fallback: {time.perf_counter() - t0:.2f} s")

        # The steady-state ticks on the cold tick's engine, then the
        # kernel at the sub-batch slab shape the first churn tick ran.
        t0 = time.perf_counter()
        warm[cfg], slab = warm_phase(cfg, units, clusters, engine, dict(tick), got)
        del engine, got
        slab = type(slab)(*(x.cuda() for x in slab))
        slab_rows[cfg] = check_phase1(f"c{cfg}-slab", slab, timed=True)
        del slab
        torch.cuda.empty_cache()
        log(f"phase warm-c{cfg}: {time.perf_counter() - t0:.2f} s")

        # Scores, follower unions and webhook ticks on a fresh engine.
        t0 = time.perf_counter()
        surface[cfg] = surface_phase(cfg, units, clusters, ticks[cfg])
        log(f"phase surface-c{cfg}: {time.perf_counter() - t0:.2f} s")

    c5, c3 = rows["5"], rows["3"]
    kernels = {
        "kernels": [
            {
                "name": "phase1",
                "route": "cuda",
                "source": "kubeadmiral_tpu_torch/csrc/phase1.cu",
                "replaces": "kubeadmiral_tpu/ops/pallas_slab.py:64",
                "match": True,
                # phase1.launches counts calls of kt_phase1, each of which
                # launches columns_kernel, then phase1_kernel; every ms
                # below spans both.
                "kernels_per_call": 2,
                "launches": ticks["5"]["phase1_launches"],
                "launches_c3": ticks["3"]["phase1_launches"],
                "launches_dense_c5": dense_ticks["5"]["phase1_launches"],
                "launches_dense_c3": dense_ticks["3"]["phase1_launches"],
                "launches_fallback_c5": fallback_ticks["5"]["phase1_launches"],
                "launches_fallback_c3": fallback_ticks["3"]["phase1_launches"],
                "max_abs_err": max(
                    r["max_abs_err"]
                    for r in (c5, c3, slab_rows["5"], slab_rows["3"],
                              surface["5"]["webhook_chunk"], surface["3"]["webhook_chunk"])
                ),
                "ms": c5["ms"],
                "plain_ms": c5["plain_ms"],
                "bound_ms": c5["bound_ms"],
                "bound_by": c5["bound_by"],
                "library_ms": None,
                "shape": c5["shape"],
                "ops_ms": c5["ops_ms"],
                "ops_pr1_ms": c5["ops_pr1_ms"],
                "ms_c3": c3["ms"],
                "plain_ms_c3": c3["plain_ms"],
                "bound_ms_c3": c3["bound_ms"],
                "bound_by_c3": c3["bound_by"],
                "ops_ms_c3": c3["ops_ms"],
                "ops_pr1_ms_c3": c3["ops_pr1_ms"],
                "shape_c3": c3["shape"],
                "attribution": {
                    f"c{cfg}": {k: [v["ms"], v["bound_ms"]] for k, v in rows_.items()}
                    for cfg, rows_ in attribution.items()
                },
                "tick_ms_c3": ticks["3"]["tick_ms"],
                "tick_ms_c5": ticks["5"]["tick_ms"],
                # The window (depth 16) and the sequential dispatch (1)
                # in turns: launches per cold tick, and the
                # synchronising operations of one chunk's dispatch.
                "launches_turns": {
                    f"c{cfg} depth {depth}": arm["launches"]
                    for cfg, arms in depth_turns.items()
                    for depth, arm in arms.items()
                },
                "dispatch_syncs": {k: v["syncs"] for k, v in syncs.items()},
                # The steady-state ticks (warm phase): launches per churn
                # tick (slabs + fallback dispatches), of the no-op ticks
                # of both worlds (0), and of the drift ticks.
                "launches_churn_c5": [
                    warm["5"][f"churn {i}"]["phase1_launches"] for i in range(WARM_CHURN_TICKS)
                ],
                "launches_churn_c3": [
                    warm["3"][f"churn {i}"]["phase1_launches"] for i in range(WARM_CHURN_TICKS)
                ],
                "launches_noop": sum(
                    w[label]["phase1_launches"]
                    for w in warm.values()
                    for label in ("noop", "noop, fresh list")
                ),
                "launches_drift_c5": warm["5"]["drift"]["phase1_launches"],
                "launches_drift_c3": warm["3"]["drift"]["phase1_launches"],
                # Every drift tick and tick back of the warm phase.
                "launches_warm_drift": {
                    f"c{cfg} {label}": warm[cfg][label]["phase1_launches"]
                    for cfg in ("3", "5")
                    for label in warm[cfg]
                    if label.startswith(("drift", "back"))
                },
                **{
                    f"slab_c{cfg}": {
                        key: slab_rows[cfg][key]
                        for key in ("shape", "ms", "plain_ms", "bound_ms", "bound_by", "ops_ms")
                    }
                    for cfg in ("5", "3")
                },
                # The surface phase: launches per scored tick (cold,
                # no-op, churn, plain, drift, back) and per tick of the
                # webhook step, and the kernel on the first webhook chunk.
                **{
                    f"launches_scores_c{cfg}": {
                        label: t["phase1_launches"]
                        for label, t in surface[cfg]["ticks"].items()
                        if label not in ("webhook", "plain after webhook")
                    }
                    for cfg in ("5", "3")
                },
                **{
                    f"launches_webhook_c{cfg}": {
                        label: surface[cfg]["ticks"][label]["phase1_launches"]
                        for label in ("webhook", "plain after webhook")
                    }
                    for cfg in ("5", "3")
                },
                **{
                    f"webhook_chunk_c{cfg}": {
                        key: surface[cfg]["webhook_chunk"][key]
                        for key in ("shape", "ms", "plain_ms", "bound_ms", "bound_by", "ops_ms")
                    }
                    for cfg in ("5", "3")
                },
                "card": card,
            }
        ]
    }
    log(f"phase total: {time.perf_counter() - t_all:.2f} s")
    print(json.dumps(kernels), flush=True)
    print(json.dumps({
        "ok": True,
        "device": {
            "platform": "gpu",
            "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(),
        },
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
