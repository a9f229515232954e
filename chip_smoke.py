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
   dispatches (+ planner re-dispatches, if any) and the engine's own
   dispatch ledger (``runtime/devprof.py``, CUDA events) to hold as many
   ``tick_narrow`` records as narrow dispatches and ``narrow_fallback``
   records as fallback dispatches, in dispatch order under the tick's
   id (``last_tick_id``), nothing in flight after ``drain()`` and at most
   the tick's wall of device time (``ledger c5 cold`` lines: device and
   queue ms by program kind; the same on the warm phase's no-op ticks,
   which leave no record, and its first churn tick; before the ticks a
   ``ledger overhead`` line: µs per ``observe`` on the card), prints the stage
   timings, narrow_stats, overflow rows, fetch bytes against the dense
   planes' 6 B per cell, ``max_memory_allocated`` and the host
   synchronisations made inside the chunk dispatches, and holds the
   placements against the port's CPU engine (every row at c3; the first
   rows at c5);
7b. the window against the sequential dispatch in turns per config: cold
   ticks on fresh engines at depth 16, 1, 1, 16 (c5 cut to its first
   C5_BUDGET_OBJECTS objects), each checked as in 7
   and equal to 7's placements (a ``turns c5 depth`` line: wall ms,
   stages, launches, peak memory, dispatch syncs, fetch bytes per tick);
   then cold ticks at depth 16 with the planner's round budget
   (``PLANNER_ROUNDS``) at 1, 2, 2, 1 (c5: 1, 2, over its first
   C5_BUDGET_OBJECTS objects), each checked as in 7 and
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
10. the persistence phase: right after the c5 warm phase, the converged
   engine's ``snapshot_state()`` (timed; plane and host bytes beside
   ``resident_state_bytes()`` and ``memory_allocated``) and a
   ``pickle.dumps`` / ``loads`` in memory (timed; the c5 image is too
   large to fsync here) and ``recorder_probe`` (the flight recorder's
   cost for a c5 cold tick's rows: record, export, pickle, evict; the
   process-wide recorder every engine here feeds is cleared before each
   warm and surface phase); after the surface phases, the kill matrix's
   snapshot-write and dispatch-flush rounds on the card (``kill_round``:
   the restart driver's reference, a victim SIGKILLed with its tick-3
   snapshot half written and its successor, a victim SIGKILLed halfway
   through the member flush after tick 3 and its successor, each a
   subprocess on ``--device cuda`` at 10,000 x 500; each successor loads
   and equals the reference's placements and reason counts, and the
   breaker its victim opened on ``m-001`` is still open; their wall ms
   and the snapshot files' bytes), then fresh c5 engines staged with the snapshot
   (``resume_phase``): a fresh resume that launches and dispatches
   nothing and replays every chunk as ``noop``, equal to a fresh
   engine's cold tick, and a stale resume (cluster 0's available
   halved) through the drift gate, equal to a fresh engine's cold tick
   on that world; each with the restore's featurize / upload / decode
   split.  The c5 cold tick's fetch bytes must equal
   C5_COLD_FETCH_BYTES (the flight recorder reads nothing);
10a. the stream phase (``stream_phase``), c3 then c5, each on a fresh
   engine: the streaming front end (``scheduler/streaming.py``) fed
   ``bench.py --scenario churn_rate``'s event mix in 1,024-event slabs
   (a cold flush, the bench's warm-up, STREAM_FLUSHES event flushes
   with capacity drifts); every flush after the first passes the
   engine its dirty rows, launches once per dispatch, and the stream
   grows its placeholder block by one chunk; the results equal a fresh
   engine's stop-the-world tick at the checked flushes; the kernel
   against its twin on a flush's slab; ``stream c3 ...`` lines and a
   summary (rows re-decided per second, event -> visible latency);
10b. the control phase (``control_phase``): the control plane
   (``testing/cpworld.py``, ``bench_e2e.py``'s world at
   CONTROL_SHAPE = 10,000 Deployments x 500 member clusters, with its
   PropagationPolicy and OverridePolicy) — a ``ClusterFleet`` under the
   port's ``ControllerManager``, whose FTC watch starts the controller
   sets of the ``deployments.apps``, ``configmaps`` and ``namespaces``
   FTCs (federate, scheduler, override, nsautoprop, sync, policyrc,
   status, status aggregator, auto-migration over its pod informer, the
   follower; the plane's monitors) and whose ``step_all`` settles them,
   the manager's default engine on the card (every readiness check the
   manager registered ready after the cold round; a device-profile
   capture beside the churn round naming both CUDA kernels) — through a join, a cold, a 1 % churn, a
   no-op resync, a topology round (one more member), a follow round (a
   namespace, its auto-migrating policy, 100 ConfigMaps and the 100
   Deployments that mount them) and a migrate round (20 of them stuck
   in one member), each checked (joins; every object placed, its
   replicas summing to ``spec.replicas``; every placed pair a member
   Deployment with its replicas and an ``OK`` status, and nothing else
   on the members; the override annotation on tier-1 members only; one
   status object per FederatedDeployment; the policies' ref counts; no
   placement drift; churn and migrate moving and rewriting only their
   objects; the resync reaching no engine, 0 launches, no member write;
   the namespace in every member and each ConfigMap on its
   Deployment's clusters; ``estimatedCapacity`` written on exactly the
   stuck objects, their capped members holding at most 2; no controller
   panic, shed or retry; no controller but the schedulers launching);
   per round the launch count is set to 0 just before and read just
   after, with the dispatch shapes; the cold round launches at least
   once per chunk its ticks fill and dispatches a full 4,096-row chunk,
   the follow and migrate rounds at least once; the kernel against its
   twin on the cold round's first chunk, the churn round's dispatch and
   the migrate round's first dispatch; then the same rounds over
   ``SchedulerEngine(device="cpu")`` in the same controllers, every
   round's store equal to the card's object for object, host and
   members (wall-clock fields masked); a ``control <round>`` line per
   round (walls by controller kind, engine ticks, launches, dispatch
   shapes, fetch bytes, objects placed, the store's object and status
   counts, member objects, ConfigMaps and Namespaces, member writes and
   ops by verb, dispatch batches, sheds and retries, the controllers'
   checks with the monitors' gauges) and a ``control summary`` line;
10c. the process phase (``process_phase``, beside 10b's CPU twin, when
   the card is idle): ``python -m kubeadmiral_tpu_torch`` on the card as
   a subprocess, its health, metrics, debug, waterfall, trace and
   device-profile routes answering 200, then SIGTERM: exit 0 with
   leadership released and no write shed; then the process over HTTP
   (``process_http_phase``): ``--transport http --members 3`` on the
   card, its three members Joined and Ready as the host apiserver's
   socket reads, a Deployment and its PropagationPolicy created through
   that socket, the divided copies read back from the member sockets
   with the printed admin tokens, then SIGTERM: exit 0, no write shed;
10d. the HTTP phase: ``http_world`` runs in a subprocess of its own
   (``python3 chip_smoke.py --http-world DIR``) from the tick loop on,
   beside steps 7-10c: ``testing/cpworld.py``'s world at HTTP_SHAPE
   (1,000 Deployments x 20 members, ``BENCH_E2E_HTTP_r06.json``'s
   size) over a kwok-lite farm of apiserver sockets, the port's
   ControllerManager with its default engine on the card, through the
   join, cold, churn, no-op, topology and partition rounds, each
   checked as cpworld checks it, with the launches per round (counts
   set to 0 before, read after), dispatch shapes, requests by verb,
   watch events, reconnects and relists, member writes, sheds, retries,
   breaker opens and a fleet scrape of every member; after the control
   phase (``http_phase_finish``) the same rounds over an in-memory
   ``ClusterFleet`` and the CPU engine, every round's stores equal under
   ``cpworld.transport_masked``, and the kernel against its twin on the
   cold round's first dispatch, timed with its bound; ``http <round>``
   lines and an ``http summary``;
10e. the extension stage (``extension_stage``): the port's
   ``ExtensionService`` on a socket serving ``testing/worlds.py``'s
   seeded webhook as filter-batch and score-batch handlers, a
   ``want_scores`` tick on the card over the HTTP world's 1,000
   Deployments and 20 clusters through the scheduler's webhook
   evaluator: results and scores equal the in-process stand-in's tick,
   one POST per plugin; an ``extension`` line;
11. prints the kernels JSON line, then ``{"ok": true, "device": ...}`` as
   the last line.

Any failed check exits nonzero without the final line, and every
subprocess it started is stopped.  Without CUDA it exits 2 before doing
anything.  Usage: ``python3 chip_smoke.py``.

Two phases are cut to make room for the HTTP phase within the time
limit: c5's depth turns run over its first C5_BUDGET_OBJECTS objects
(as its budget turns), and c5's budget turns run C5_TURN_BUDGETS (1, 2)
(c3 keeps TURN_BUDGETS).
"""

from __future__ import annotations

import contextlib
import dataclasses
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
C5_BUDGET_OBJECTS = 50000  # c5 depth of the depth turns and the planner-round budget turns
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


def counted_tick(engine, units, clusters, capture: bool = False, call=None,
                 collect: bool = True, **kw):
    """engine.schedule(units, clusters, **kw) — or ``call()``, a caller of
    the engine such as a stream's flush, with ``units`` the world it
    ticks — with every tick dispatch recorded
    as (kind, rows, clusters), kind "narrow" or "dense" (on a narrow
    path the dense ones are certificate fallbacks), the phase-1 launch
    count set to 0 just before the call and read just after, and the
    engine's counters as deltas over the call.  With ``capture`` the
    first dispatch's expanded inputs are kept (on a churn tick a
    sub-batch slab's, for check_phase1 at its shape), moved to the host
    after the timed call so that ``memory_allocated`` counts the
    engine's tensors only.  Garbage is collected before the clock starts,
    so that the script's own garbage (a fresh reference engine's results)
    is not collected inside the timed tick (unless ``collect`` is off: a
    stream collects before offering a slab's events, so that the
    collection does not sit between the events and their flush); the
    collector's own time inside the tick is reported (``gc_ms``,
    collections by generation).
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

    t_gc = time.perf_counter()
    if collect:
        gc.collect()
    gc_collect_ms = (time.perf_counter() - t_gc) * 1e3
    torch.cuda.reset_peak_memory_stats()
    engine._drain_window = drain
    try:
        with recorded_dispatches(keep=captured if capture else None) as calls, \
                counted_dispatch_syncs(engine) as syncs, gc_time() as collector:
            phase1.launches = 0
            t0 = time.perf_counter()
            results = call() if call is not None else engine.schedule(units, clusters, **kw)
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
        "objects": len(results),
        "clusters": len(clusters),
        "tick_ms": wall * 1e3,
        "objects_per_s": len(results) / wall,
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
        "gc_collect_ms": gc_collect_ms,
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


def ledger_check(label: str, engine, tick: dict, fallback: int) -> dict:
    """The dispatch ledger's view of the tick just run on ``engine`` (an
    engine with a ``DispatchLedger`` of its own; ``tick`` from
    counted_tick, ``fallback`` its certificate-fallback dispatches):
    nothing in flight after ``drain()``; the tick's records in dispatch
    order, each carrying the tick's id, which is ``last_tick_id``; as
    many ``tick_narrow`` records as narrow dispatches, ``narrow_fallback``
    records as fallback dispatches and ``tick`` records as the other
    dense dispatches (a no-op tick: no record at all); the records'
    device seconds summing to at most the tick's wall.  Prints a
    ``ledger <label>`` line: device and queue ms by program kind."""
    ledger = engine.devprof
    if not ledger.drain(120.0) or ledger.inflight:
        raise AssertionError(f"ledger {label}: {ledger.inflight} records in flight after drain()")
    tick_id = engine.last_tick_id
    entries = [e for e in ledger._ticks if e.tick == tick_id]
    if len(entries) != 1:
        raise AssertionError(f"ledger {label}: {len(entries)} closed ticks with id {tick_id}")
    records = entries[0].records
    seqs = [r.seq for r in records]
    if seqs != sorted(seqs) or any(r.tick != tick_id for r in records):
        raise AssertionError(f"ledger {label}: records out of dispatch order or of another tick")
    summary = ledger.tick_summary(tick_id)
    by = summary["by_program"]
    got = {k: by.get(k, {}).get("n", 0) for k in ("tick_narrow", "narrow_fallback", "tick")}
    want = {
        "tick_narrow": tick["narrow_dispatches"],
        "narrow_fallback": fallback,
        "tick": tick["dense_dispatches"] - fallback,
    }
    if got != want:
        raise AssertionError(f"ledger {label}: records {got}, dispatches {want}")
    if not (tick["narrow_dispatches"] or tick["dense_dispatches"]) and records:
        raise AssertionError(f"ledger {label}: a no-op tick left {len(records)} records")
    device_s = sum(r.device_s for r in records)
    if device_s * 1e3 > tick["tick_ms"]:
        raise AssertionError(f"ledger {label}: {device_s * 1e3} device ms in a {tick['tick_ms']} ms tick")
    row = {
        "tick": tick_id, "records": len(records), "device_ms": device_s * 1e3,
        "queue_ms": sum(r.queue_s for r in records) * 1e3, "wall_ms": summary["wall_ms"],
        "tick_ms": tick["tick_ms"], "by_program": by, "by_device": summary["by_device"],
    }
    log(f"ledger {label}: {json.dumps(row)}")
    return row


LEDGER_PROBE_CALLS = 5_000


def ledger_overhead() -> dict:
    """What one ``observe`` costs the thread that dispatches, on the
    card: LEDGER_PROBE_CALLS observations of a 4-byte CUDA output on a
    fresh ledger (an event recorded on the current stream, a deque
    append; the watcher retires them beside), timed on the host clock,
    then drained.  Prints a ``ledger overhead`` line: µs per call."""
    import torch

    from kubeadmiral_tpu_torch.runtime.devprof import DispatchLedger

    ledger = DispatchLedger()
    out = torch.zeros(1, dtype=torch.int32, device="cuda")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(LEDGER_PROBE_CALLS):
        ledger.observe("tick", out)
    observe_s = time.perf_counter() - t0
    if not ledger.drain(120.0):
        raise AssertionError("ledger overhead: records still in flight")
    row = {"calls": LEDGER_PROBE_CALLS, "us_per_observe": observe_s / LEDGER_PROBE_CALLS * 1e6,
           "drain_s": time.perf_counter() - t0 - observe_s}
    log(f"ledger overhead: {json.dumps(row)}")
    return row


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


# The window's planner round budget in turns (fresh engines, depth 16);
# c5 runs the first two turns only (C5_TURN_BUDGETS), to make room in
# the time limit for the HTTP phase.
TURN_BUDGETS = (1, 2, 2, 1)
C5_TURN_BUDGETS = (1, 2)


def turns_budget(cfg: str, units, clusters, got, budgets=TURN_BUDGETS) -> dict:
    """Cold ticks at the default depth on fresh engines with the
    engine's PLANNER_ROUNDS patched to ``budgets``, each checked as
    run_tick checks and equal to ``got``; logs and returns per budget
    the wall ms, the device (queuing) and device + fetch ms, planner
    re-dispatches and dispatch syncs."""
    import torch

    from kubeadmiral_tpu_torch.scheduler import engine as engine_mod

    saved = engine_mod.PLANNER_ROUNDS
    arms: dict = {}
    try:
        for turn, rounds in enumerate(budgets):
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
    log(f"turns c{cfg} planner rounds {tuple(budgets)}: {json.dumps(arms)}")
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
    host, the resume world: the last churn tick's units with a fresh
    engine's cold ticks over them on the first clusters ("cold") and on
    the first drift ("drift"))."""
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
        slabs, fallback = check_drift_launches(f"c{cfg} {label}", engine, tick, chunks)
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
        if engine.devprof.enabled:
            tick["ledger"] = ledger_check(f"c{cfg} {label}", engine, tick, 0)
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
        if i == 0 and engine.devprof.enabled:
            tick["ledger"] = ledger_check(f"c{cfg} {label}", engine, tick, fallback)
        record(label, tick)
        if slab is None:
            slab = captured
        prev_units, prev = batch, got
    # One fresh cold tick on the first clusters serves every tick back.
    back_want, drift_want = None, None
    for name in WARM_DRIFTS[cfg]:
        drifted = shapes[name](clusters)
        want = fresh(name, prev_units, drifted)
        drift_want = drift_want or want
        prev = drift_tick(name, prev_units, drifted, prev, want)
        if back_want is None:
            back_want = fresh("back", prev_units, clusters)
        back = "back" if name == "drift" else f"back from {name}"
        prev = drift_tick(back, prev_units, clusters, prev, back_want)
    del engine
    torch.cuda.empty_cache()
    return ticks, slab, {"units": prev_units, "cold": back_want, "drift": drift_want}


def check_drift_launches(label: str, engine, tick: dict, chunks: int) -> tuple[int, int]:
    """A tick through the drift gate launches the kernel once per
    recompute slab, mass-change chunk, chunk the gate did not take and
    planner re-dispatch, plus one per certificate fallback.  Returns
    (recompute slabs, fallback dispatches)."""
    gate = tick["drift_stats"]
    _, eff, ladder = engine._tick_geometry(tick["clusters"])
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
            f"{label}: {tick['phase1_launches']} launches, {narrow} narrow + "
            f"{dense} dense dispatches for {slabs} slabs + {gate.get('fallback', 0)} "
            f"mass-change chunks + {chunks - gate.get('gated', 0)} ungated chunks "
            f"+ {tick['planner_reruns']} planner re-dispatches: {tick}"
        )
    return slabs, fallback


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


# Cold c5 fetch bytes of the windowed cold tick (PERF.md section 5): the
# flight recorder is fed from the wire already read, so they stay.
C5_COLD_FETCH_BYTES = 1_111_048_960
# The kill round's world (testing/restart_driver.py) at config 3's shape.
KILL_ROUND_SHAPE = (10_000, 500)
SNAPSHOT_PLANES = ("sel", "rep", "cnt", "sco", "feas", "rsn")


def recorder_probe(units, results, names) -> dict:
    """The flight recorder's host cost for one c5 cold tick: recording
    its rows in 4,096-row calls (as the drains do) into a fresh recorder
    that keeps one tick, exporting the ring (what a SnapshotManager
    persists) and pickling the export, then recording a 1,000-row tick,
    which evicts the cold tick's records (their placement maps are the
    recorder's own copies here, so the eviction frees them, as it frees
    a discarded engine's)."""
    import pickle

    from kubeadmiral_tpu_torch.ops import reasons as RSN
    from kubeadmiral_tpu_torch.runtime.flightrec import FlightRecorder

    n = len(units)
    keys = [u.key for u in units]
    placements = [dict(r.clusters) for r in results]
    counts = np.zeros((n, RSN.NUM_REASON_BITS), np.int32)
    feasible = np.zeros(n, np.int32)
    topk_i, topk_s = [np.zeros(0, np.int32)] * n, [np.zeros(0, np.int64)] * n

    def tick(rows: int, placements) -> float:
        t0 = time.perf_counter()
        rec.begin_tick(rows, len(names))
        for s in range(0, rows, 4096):
            part = slice(s, min(rows, s + 4096))
            rec.record_rows(
                keys[part], placements[part], None, None, names, program="probe",
                reason_counts=counts[part], feasible_n=feasible[part],
                topk_idx=topk_i[part], topk_scores=topk_s[part],
            )
        rec.end_tick()
        return (time.perf_counter() - t0) * 1e3

    rec = FlightRecorder(max_ticks=1)
    gc.collect()
    record_ms = tick(n, placements)
    recorded_bytes = rec.stats()["bytes"]
    t0 = time.perf_counter()
    state = rec.export_state()
    export_ms = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    exported = len(pickle.dumps(state, protocol=4))
    pickle_ms = (time.perf_counter() - t0) * 1e3
    later = [dict(p) for p in placements[:1000]]
    del state, placements
    evict_ms = tick(1000, later)
    return {
        "rows": n, "record_ms": record_ms, "recorder_bytes": recorded_bytes,
        "export_ms": export_ms, "export_pickle_ms": pickle_ms,
        "export_pickle_bytes": exported, "evict_and_record_1000_ms": evict_ms,
    }


def capture_snapshot(engine, chunks: int, resume: dict, names):
    """The warm c5 engine's ``snapshot_state()``, timed, with its plane
    and host bytes beside ``resident_state_bytes()`` and
    ``torch.cuda.memory_allocated()``; then ``pickle.dumps`` / ``loads``
    in memory, timed (the image is too large to fsync within the
    script's time); then ``recorder_probe`` over the resume world's cold
    tick.  Returns (the unpickled payload, the numbers)."""
    import pickle

    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    snap = engine.snapshot_state()
    capture_ms = (time.perf_counter() - t0) * 1e3
    if snap is None or len(snap["chunks"]) != chunks:
        raise AssertionError(f"c5 snapshot: {None if snap is None else len(snap['chunks'])} chunks, not {chunks}")
    planes = sum(cs[k].nbytes for cs in snap["chunks"].values() for k in SNAPSHOT_PLANES)
    host = planes + sum(a.nbytes for a in snap["view"].values())
    t0 = time.perf_counter()
    blob = pickle.dumps(snap, protocol=4)
    dumps_ms = (time.perf_counter() - t0) * 1e3
    pickled = len(blob)
    del snap
    t0 = time.perf_counter()
    snap = pickle.loads(blob)
    loads_ms = (time.perf_counter() - t0) * 1e3
    del blob
    row = {
        "chunks": len(snap["chunks"]), "rows": snap["rows"],
        "snapshot_state_ms": capture_ms, "plane_bytes": planes, "host_bytes": host,
        "pickle_bytes": pickled, "pickle_dumps_ms": dumps_ms, "pickle_loads_ms": loads_ms,
        "resident_state_bytes": engine.resident_state_bytes(),
        "memory_allocated": torch.cuda.memory_allocated(),
        "flight_recorder": recorder_probe(resume["units"], resume["cold"], names),
    }
    log(f"persist c5 capture: {json.dumps(row)}")
    return snap, row


def resume_phase(snap, resume: dict, clusters, chunks: int) -> dict:
    """Fresh engines staged with the c5 snapshot.  The fresh resume (the
    same world, a fresh list) must launch nothing, dispatch nothing,
    replay every chunk with ``noop`` and equal a fresh engine's cold
    tick; the stale resume (cluster 0's available halved) must load
    stale, ride the drift gate (launches as a drift tick's) and equal a
    fresh engine's cold tick on that world.  Each tick's line carries
    its wall ms, stages, the restore's featurize / upload / decode
    split, ``resident_state_bytes()`` and ``memory_allocated``."""
    import torch

    from kubeadmiral_tpu_torch.scheduler.engine import SchedulerEngine
    from kubeadmiral_tpu_torch.testing.worlds import drift

    out = {}
    for label, cl, want in (
        ("fresh resume", clusters, resume["cold"]),
        ("stale resume", drift(clusters), resume["drift"]),
    ):
        engine = SchedulerEngine()
        engine.stage_restore(snap, assume_fresh=label == "fresh resume")
        got, tick, _ = counted_tick(engine, list(resume["units"]), cl)
        info = engine.restore_info
        tick.update(
            restore_info=info, dispatches_total=engine.dispatches_total,
            resident_state_bytes=engine.resident_state_bytes(),
        )
        if info["result"] != "loaded" or info["chunks"] != chunks:
            raise AssertionError(f"c5 {label}: restore {info}")
        if label == "fresh resume":
            launched = tick["phase1_launches"] + tick["narrow_dispatches"] + tick["dense_dispatches"]
            if not info["fresh"] or launched or engine.dispatches_total:
                raise AssertionError(f"c5 {label}: launched on a fresh resume: {tick}")
            if tick["fetch_paths"] != {"noop": chunks}:
                raise AssertionError(f"c5 {label}: fetch paths {tick['fetch_paths']}")
        else:
            if info["fresh"] or not tick["drift_stats"].get("gated"):
                raise AssertionError(f"c5 {label}: did not ride the drift gate: {tick}")
            check_drift_launches(f"c5 {label}", engine, tick, chunks)
        assert_results_equal(f"c5 {label} vs fresh engine", got, want)
        log(f"persist c5 {label}: {json.dumps(tick)}")
        out[label] = tick
        del engine, got
        torch.cuda.empty_cache()
    return out


def kill_round() -> dict:
    """The kill matrix's snapshot-write and dispatch-flush rounds on the
    card at KILL_ROUND_SHAPE: testing/restart_driver.py as subprocesses
    on ``--device cuda`` (a reference; a victim that SIGKILLs itself
    with tick 3's snapshot half written and its successor; a victim
    that reaches tick 3's end and dies halfway through the member flush
    of its placements, and its successor), in a scratch directory of the
    checkout removed afterwards, the breakers' cool-down at 300 s (as
    tests/test_restart.py sets it).  Each successor must load a snapshot
    (tick 2's, tick 3's) and equal the reference's placements and
    flight-recorder reason counts, with nothing quarantined, and the
    breaker the victim opened on ``m-001`` before tick 3 must still be
    open and admit nothing.  Returns the processes' wall ms, the
    snapshot files' bytes and the successors' restores, fetch paths and
    launches."""
    import os
    import tempfile
    from pathlib import Path

    root = Path(__file__).resolve().parent
    n, c = KILL_ROUND_SHAPE
    work = tempfile.mkdtemp(prefix="_persist_", dir=root)
    walls = {}

    def run(mode: str, sub: str, *args) -> None:
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-m", "kubeadmiral_tpu_torch.testing.restart_driver", mode,
             "--dir", os.path.join(work, sub), "--device", "cuda",
             "--objects", str(n), "--clusters", str(c), "--breaker-open-s", "300", *args],
            cwd=root, capture_output=True, text=True, timeout=600,
        )
        walls[f"{sub} {mode}"] = (time.perf_counter() - t0) * 1e3
        want_rc = -9 if mode == "victim" else 0
        if proc.returncode != want_rc:
            raise AssertionError(
                f"kill round {mode}: exit {proc.returncode}, not {want_rc}\n"
                f"{proc.stdout[-4000:]}\n{proc.stderr[-4000:]}"
            )

    try:
        run("reference", "reference")
        run("victim", "kill", "--kill-phase", "snapshot-write")
        kill = Path(work, "kill")
        if not (kill / "tick2.done").exists() or (kill / "tick3.done").exists():
            raise AssertionError("kill round: the victim did not die in tick 3")
        files = {f.name: f.stat().st_size for f in (kill / "snapshots").iterdir()}
        run("successor", "kill")
        run("victim", "flush", "--kill-phase", "dispatch-flush")
        flushed = Path(work, "flush")
        if not (flushed / "tick3.done").exists():
            raise AssertionError("kill round: the dispatch-flush victim did not finish tick 3")
        run("successor", "flush")
        ref = json.loads(Path(work, "reference", "reference.json").read_text())
        succs = {
            "snapshot-write": json.loads((kill / "successor.json").read_text()),
            "dispatch-flush": json.loads((flushed / "successor.json").read_text()),
        }
    finally:
        shutil.rmtree(work, ignore_errors=True)
    for phase, succ in succs.items():
        if succ["restore_info"]["result"] != "loaded" or succ["quarantined"]:
            raise AssertionError(
                f"kill round {phase}: restore {succ['restore_info']}, "
                f"quarantined {succ['quarantined']}"
            )
        if succ["placements"] != ref["placements"]:
            raise AssertionError(f"kill round {phase}: successor placements differ from the reference's")
        if succ["reason_counts"] != ref["reason_counts"] or len(ref["reason_counts"]) != n:
            raise AssertionError(f"kill round {phase}: successor reason counts differ from the reference's")
        if succ["breaker_m001"] != "open" or succ["breaker_allows_m001"] is not False:
            raise AssertionError(
                f"kill round {phase}: m-001's breaker {succ['breaker_m001']}, "
                f"admits {succ['breaker_allows_m001']}"
            )
    succ, flush_succ = succs["snapshot-write"], succs["dispatch-flush"]
    row = {
        "objects": n, "clusters": c, "wall_ms": walls, "snapshot_files": files,
        "restore_info": succ["restore_info"], "fetch_paths": succ["fetch_paths"],
        "successor_launches": succ["launches"], "counters": succ["counters"],
        "dispatch_flush": {
            "restore_info": flush_succ["restore_info"], "fetch_paths": flush_succ["fetch_paths"],
            "successor_launches": flush_succ["launches"],
            "breaker_m001": flush_succ["breaker_m001"],
        },
    }
    log(f"persist c3 kill round: {json.dumps(row)}")
    return row


# The stream phase (bench.py --scenario churn_rate): event-log flushes
# per world, and the event flushes before which a capacity drift is
# queued (one every 10 flushes; c5 runs one).  c3 checks its flushes
# against a stop-the-world tick after the cold, warm-up and drift
# flushes and every STREAM_CHECK_EVERY-th; c5 after its last flush only
# (a fresh c5 cold tick takes 14-18 s).
STREAM_FLUSHES = {"3": 20, "5": 5}
STREAM_DRIFTS = {"3": (10, 20), "5": (3,)}
STREAM_CHECK_EVERY = 5


def stream_phase(cfg: str, units, clusters) -> dict:
    """The streaming front end on the card: a ``StreamingScheduler``
    over a fresh default engine (the card's), fed ``bench.py``'s churn
    mix (``testing/worlds.py``: a quarter arrivals, the rest 1..8 more
    replicas on a random object, numpy seed 0) in slabs of the row
    watermark (``streaming.SLAB_ROWS`` events, then ``pump()``).  A cold
    flush, the bench's warm-up (1 % updates, then cluster 1's available
    x 0.9), then STREAM_FLUSHES[cfg] event flushes, a random member's
    available x 0.9 queued before each of STREAM_DRIFTS[cfg] (the drift
    event and SLAB_ROWS - 1 events make one slab).

    Every flush after the first hands the engine the dirty-row hint;
    each flush's launches equal its dispatches (slabs and chunk
    dispatches, narrow, plus dense certificate fallbacks); the placeholder
    block is one engine chunk and grows at least once; the stream's
    results equal a fresh card engine's cold tick over ``stream.units``
    (placeholders dropped) and ``stream.clusters`` after the last flush,
    and at c3 also after the cold, warm-up and drift flushes and every
    STREAM_CHECK_EVERY-th.  The kernel is held against its twin on the
    slab of the second event flush (a churn flush: the first one grows
    the world and dispatches whole chunks).  Prints a ``stream c<cfg>``
    line per flush (``helper_ms`` with this script's check) and a
    summary: rows re-decided per second over the event flushes' offer
    and flush walls, and the event -> visible latency p50/p99."""
    import torch

    from kubeadmiral_tpu_torch.runtime import flightrec
    from kubeadmiral_tpu_torch.scheduler.engine import SchedulerEngine
    from kubeadmiral_tpu_torch.scheduler.streaming import StreamingScheduler, is_placeholder
    from kubeadmiral_tpu_torch.testing.worlds import capacity_drift, stream_event

    flightrec.get_default().clear()
    engine = SchedulerEngine()
    stream = StreamingScheduler(engine, clusters, units)
    if stream.grow_block != engine.chunk_size:
        raise AssertionError(f"c{cfg} stream: grow block {stream.grow_block}, not one chunk")
    hints = []
    schedule = engine.schedule

    def spy(u, c, **kw):
        hints.append(kw.get("dirty_rows"))
        return schedule(u, c, **kw)

    engine.schedule = spy
    rng = np.random.default_rng(0)
    flushes, seq, slab = {}, 0, None

    def flush(label: str, pump: bool = False, capture: bool = False, check: bool = False,
              offer_ms: float = 0.0):
        nonlocal slab
        t_helper = time.perf_counter()
        rows0, world0 = stream.rows_flushed, len(stream.units)
        triggers0 = dict(stream.flush_stats)
        results, tick, captured = counted_tick(
            engine, None, stream.clusters, capture=capture,
            call=stream.pump if pump else stream.flush, collect=not pump,
        )
        if results is None:
            raise AssertionError(f"c{cfg} stream {label}: pump() did not flush")
        narrow, dense = tick["narrow_dispatches"], tick["dense_dispatches"]
        if tick["phase1_launches"] != narrow + dense:
            raise AssertionError(
                f"c{cfg} stream {label}: {tick['phase1_launches']} launches for {narrow} "
                f"slab and chunk dispatches + {dense} fallback dispatches"
            )
        grew = len(stream.units) - world0
        if grew % stream.grow_block:
            raise AssertionError(f"c{cfg} stream {label}: grew {grew} rows")
        tick.update(
            rows=stream.rows_flushed - rows0,
            trigger=[k for k, v in stream.flush_stats.items() if v != triggers0.get(k, 0)],
            slab_dispatches=narrow if narrow else dense,
            fallback_dispatches=dense if narrow else 0,
            grew=grew,
            world_rows=len(stream.units),
            dirty_rows=None if hints[-1] is None else len(hints[-1]),
        )
        if check:
            world = stream.units  # a copy of the unit list: take it once
            live = [i for i, u in enumerate(world) if not is_placeholder(u)]
            want, fresh, _ = counted_tick(SchedulerEngine(), [world[i] for i in live], stream.clusters)
            tick["fresh"] = {
                k: fresh[k] for k in ("objects", "tick_ms", "phase1_launches", "cache", "stage_s",
                                      "gc_ms", "gc_collections", "gc_collect_ms", "fetch_bytes")
            }
            assert_results_equal(f"c{cfg} stream {label} vs stop-the-world",
                                 [results[i] for i in live], want)
            del want
            torch.cuda.empty_cache()
        if capture and captured is not None and slab is None:
            slab = captured
        tick.update(offer_ms=offer_ms, helper_ms=(time.perf_counter() - t_helper) * 1e3)
        log(f"stream c{cfg} {label}: {json.dumps(tick)}")
        flushes[label] = tick
        return tick

    full = cfg == "3"
    flush("cold", check=full)
    for i in rng.integers(0, len(units), max(1, len(units) // 100)):
        su = units[int(i)]
        stream.offer(dataclasses.replace(su, desired_replicas=(su.desired_replicas or 1) + 1))
    flush("warm-up churn", check=full)
    base = stream.clusters[1]
    stream.update_cluster(dataclasses.replace(
        base, available={k: max(0, int(v * 0.9)) for k, v in base.available.items()}
    ))
    flush("warm-up drift", check=full)

    lat0 = len(stream.latencies)
    t_log = time.perf_counter()
    n = STREAM_FLUSHES[cfg]
    for k in range(1, n + 1):
        drifted = k in STREAM_DRIFTS[cfg]
        gc.collect()
        t_offer = time.perf_counter()
        if drifted:
            stream.update_cluster(capacity_drift(rng, stream.clusters))
        for _ in range(stream.slab_rows - drifted):
            stream.offer(stream_event(rng, units, seq))
            seq += 1
        check = k == n or (full and (drifted or k % STREAM_CHECK_EVERY == 0))
        flush(f"flush {k}{' drift' if drifted else ''}", pump=True, capture=k == 2, check=check,
              offer_ms=(time.perf_counter() - t_offer) * 1e3)
    log_s = time.perf_counter() - t_log

    if any(h is None for h in hints[1:]):
        raise AssertionError(f"c{cfg} stream: a flush after the first had no dirty-row hint")
    if not any(t["grew"] == stream.grow_block for t in flushes.values()):
        raise AssertionError(f"c{cfg} stream: the placeholder block never grew by one chunk")
    lat = np.asarray(list(stream.latencies)[lat0:], float) * 1e3
    event_ticks = [t for label, t in flushes.items() if label.startswith("flush")]
    stream_s = sum(t["offer_ms"] + t["tick_ms"] for t in event_ticks) / 1e3
    summary = {
        "objects": len(units), "clusters": len(clusters), "world_rows": len(stream.units),
        "grow_block": stream.grow_block, "slab_rows": stream.slab_rows,
        "flushes": stream.flushes, "flush_stats": dict(stream.flush_stats),
        "events_total": dict(stream.events_total), "rows_flushed": stream.rows_flushed,
        # The bench's loop without this script's checks: offering the
        # events and flushing them.
        "event_log_s": log_s, "stream_s": stream_s,
        "rows_per_s": sum(t["rows"] for t in event_ticks) / stream_s,
        "world_rows_per_s": sum(t["objects"] for t in event_ticks) / stream_s,
        "flush_ms": [t["tick_ms"] for t in event_ticks],
        "latency_ms_p50": float(np.percentile(lat, 50)),
        "latency_ms_p99": float(np.percentile(lat, 99)),
        "launches": {label: t["phase1_launches"] for label, t in flushes.items()},
        "memory_allocated": torch.cuda.memory_allocated(),
    }
    log(f"stream c{cfg} summary: {json.dumps(summary)}")
    kernel = check_phase1(f"c{cfg}-stream-slab", type(slab)(*(x.cuda() for x in slab)), timed=True)
    del engine, stream
    torch.cuda.empty_cache()
    return {"flushes": flushes, "summary": summary, "kernel": kernel}


CONTROL_SHAPE = (10_000, 500)  # bench_e2e.py at config-#3 scale (BASELINE.md:64)


CAPTURE_S = 60.0  # the device-profile capture's cap beside the control churn round
PROFILED_KERNELS = ("columns_kernel", "phase1_kernel")


def read_capture(label: str, capture: dict) -> dict:
    """A ``capture_device_profile`` result: no error, and a Chrome trace
    whose events name each of PROFILED_KERNELS.  Returns its wall, size,
    event count and the kernels' event counts."""
    import os

    if "error" in capture or not os.path.isfile(capture.get("trace", "")):
        raise AssertionError(f"{label}: device profile failed: {capture}")
    with open(capture["trace"]) as f:
        events = json.load(f).get("traceEvents", [])
    named = {
        k: sum(1 for e in events if k in str(e.get("name", ""))) for k in PROFILED_KERNELS
    }
    if not all(named.values()):
        raise AssertionError(f"{label}: the device profile names {named}")
    return {
        "wall_s": capture["wall_s"], "trace_bytes": os.path.getsize(capture["trace"]),
        "events": len(events), "kernel_events": named,
    }


def control_phase(beside=None) -> dict:
    """The control plane on the card (``testing/cpworld.py``): a
    ``ClusterFleet`` under the port's ``ControllerManager``, which starts
    each of the ``deployments.apps``, ``configmaps`` and ``namespaces``
    FTCs' controller sets from their FTC objects
    (federate, scheduler, override, nsautoprop, sync, policyrc, status,
    status aggregator, auto-migration over its pod informer, the
    follower; the plane's monitors), the manager's engine, the default
    one (the card's), settled through the manager's ``step_all``,
    through the join, cold, churn, no-op resync, topology, follow and
    migrate rounds at CONTROL_SHAPE, each checked there (joins; every
    object placed, its replicas summing to ``spec.replicas``; every
    placed pair's member Deployment with an ``OK`` status; the override
    annotation on tier-1 members only; one status object per
    FederatedDeployment listing its placed clusters; the policies' ref
    counts; no placement drift; churn and migrate moving and rewriting
    only their objects; the resync reaching no engine and writing no
    member; ``team-a`` in every member and each ``cfg-i`` on ``mig-i``'s
    clusters; ``estimatedCapacity`` written on exactly the stuck objects,
    the capped members holding at most 2; no controller panic, shed or
    retry).  After the cold round every readiness check the manager
    registered must read ready.  During the churn round a
    ``capture_device_profile`` runs on a side thread (the round started
    once the profiler records, the capture stopped when it has settled,
    at most CAPTURE_S seconds); its Chrome trace must name both of the
    kernel's CUDA kernels (PROFILED_KERNELS).  ``beside``, if given, runs
    on another thread while the CPU twin runs (the card is idle then);
    its result is returned under ``beside``.  Every controller's steps but the schedulers' are counted:
    they must launch nothing.  Per round the phase-1 launch count is set
    to 0 just before and read just after, beside the dispatches' shapes;
    the cold round must launch at least once per chunk its ticks fill
    and dispatch at least one full 4,096-row chunk, the follow and
    migrate rounds at least once each.  The kernel is held against its
    plain twin on the cold round's first chunk, the churn round's
    dispatch and the migrate round's first dispatch.  Then the same
    rounds with ``SchedulerEngine(device="cpu")`` in the same
    controllers: every round's store (host and members) equals the
    card's object for object, wall-clock fields masked.  Prints a
    ``control <round>`` line per round."""
    import tempfile
    import threading
    from pathlib import Path

    import torch

    from kubeadmiral_tpu_torch.ops.phase1 import phase1
    from kubeadmiral_tpu_torch.runtime import devprof, flightrec
    from kubeadmiral_tpu_torch.scheduler.engine import SchedulerEngine
    from kubeadmiral_tpu_torch.testing import cpworld
    from kubeadmiral_tpu_torch.testing.sample_counts import recorded_dispatches

    objects, clusters = CONTROL_SHAPE
    flightrec.get_default().clear()
    plane = cpworld.ControlPlane()  # the manager's default engine: the card's
    if type(plane.manager).__module__ != "kubeadmiral_tpu_torch.runtime.manager":
        raise AssertionError(f"control: the plane runs {type(plane.manager)}")
    if plane.engine.device.type != "cuda":
        raise AssertionError(f"control: the default engine runs on {plane.engine.device}")
    chunk = plane.engine.chunk_size
    # Kernel launches inside every controller's steps but the
    # schedulers': each stage must launch nothing.
    stage_launches: dict[str, int] = {}

    def counted_step(stage: str, step):
        def counted():
            before = phase1.launches
            try:
                return step()
            finally:
                stage_launches[stage] += phase1.launches - before
        return counted

    for stage, ctl in [*plane.timer.controllers, *(("monitor", m) for m in plane.monitors)]:
        if stage == "schedule":
            continue
        stage_launches.setdefault(stage, 0)
        for worker in cpworld.workers_of(ctl):
            worker.step = counted_step(stage, worker.step)
    stack = contextlib.ExitStack()
    recording = {}
    counted, first_inputs = {}, {}
    capture: dict = {}
    work = tempfile.mkdtemp(prefix="_profile_", dir=Path(__file__).resolve().parent)

    def on_round(name: str) -> None:
        keep = [] if name in ("cold", "churn", "migrate") else None
        if name == "churn":
            ready, stop = threading.Event(), threading.Event()
            thread = threading.Thread(
                target=lambda: capture.update(devprof.capture_device_profile(
                    CAPTURE_S, out_dir=work, ready=ready, stop=stop)),
                name="control-profile",
            )
            thread.start()
            if not ready.wait(120.0):
                thread.join()
                raise AssertionError(f"control churn: the profiler did not start: {capture}")
            capture["thread"], capture["stop"] = thread, stop
        recording[name] = (stack.enter_context(recorded_dispatches(keep=keep)), keep)
        phase1.launches = 0

    def after_round(name: str, report: dict) -> None:
        counted[name] = phase1.launches
        stack.close()
        shapes, keep = recording.pop(name)
        report["dispatch_shapes"] = sorted({tuple(c) for c in shapes})
        report["dispatches"] = len(shapes)
        if keep:
            first_inputs[name] = keep[0]
        if name == "cold":
            ready = plane.manager.health.readyz()
            if not ready or not all(ready.values()):
                raise AssertionError(f"control cold: readiness {ready}")
            report["readiness_checks"] = len(ready)
        if name == "churn":
            capture.pop("stop").set()
            capture.pop("thread").join()

    t0 = time.perf_counter()
    try:
        reports = cpworld.run_rounds(plane, objects, clusters, on_round, after_round)
        profile = read_capture("control churn", capture)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    card_s = time.perf_counter() - t0
    for name, report in reports.items():
        if counted[name] != report["phase1_launches"]:
            raise AssertionError(
                f"control {name}: {counted[name]} launches counted, "
                f"{report['phase1_launches']} in its engine ticks"
            )
    cold = reports["cold"]
    fills = sum(-(-t["units"] // chunk) for t in cold["ticks"])
    if cold["phase1_launches"] < fills:
        raise AssertionError(f"control cold: {cold['phase1_launches']} launches, {fills} chunks filled")
    if not any(rows == chunk for _, rows, _ in cold["dispatch_shapes"]):
        raise AssertionError(f"control cold: no full {chunk}-row chunk in {cold['dispatch_shapes']}")
    for name in ("follow", "migrate"):
        if reports[name]["phase1_launches"] < 1:
            raise AssertionError(f"control {name}: the scheduler's ticks launched nothing")
    kernel = {
        "cold_chunk": check_phase1("control-cold-chunk", first_inputs["cold"], timed=True),
        "churn": check_phase1("control-churn", first_inputs["churn"], timed=True),
        "migrate": check_phase1("control-migrate", first_inputs["migrate"], timed=True),
    }
    del first_inputs
    panics = plane.panics()
    engine_ticks = plane.engine.tick_seq
    if any(stage_launches.values()):
        raise AssertionError(f"control: controllers other than the scheduler launched {stage_launches}")
    del plane
    torch.cuda.empty_cache()

    # The CPU twin: the same rounds, the same controllers, the CPU engine.
    side: dict = {}
    if beside is not None:
        def run_beside():
            try:
                side["result"] = beside()
            except BaseException as e:  # re-raised on the main thread
                side["error"] = e

        side_thread = threading.Thread(target=run_beside, name="control-beside")
        side_thread.start()
    t0 = time.perf_counter()
    twin = cpworld.ControlPlane(
        engine=SchedulerEngine(device="cpu", flight_recorder=flightrec.FlightRecorder())
    )
    twin_reports = cpworld.run_rounds(twin, objects, clusters)
    twin_s = time.perf_counter() - t0
    if beside is not None:
        side_thread.join()
        if "error" in side:
            raise side["error"]
    for name in cpworld.ROUNDS:
        diff = cpworld.digest_diff(reports[name]["digests"], twin_reports[name]["digests"])
        if diff:
            raise AssertionError(f"control {name}: card store differs from the CPU engine's: {diff}")

    out = {}
    for name in cpworld.ROUNDS:
        report = reports[name]
        row = {k: v for k, v in report.items() if k not in ("digests", "ticks")}
        row["ticks"] = [
            {k: t[k] for k in ("units", "clusters", "wall_ms", "phase1_launches",
                                "fetch_bytes", "fetch_paths", "stages_ms")}
            for t in report["ticks"]
        ]
        row["twin_wall_s"] = twin_reports[name]["wall_s"]
        row["twin_walls_s"] = twin_reports[name]["walls_s"]
        row["store_equal"] = True
        log(f"control {name}: {json.dumps(row)}")
        out[name] = row
    migrate = reports["migrate"]
    summary = {
        "objects": objects, "clusters": clusters, "card_s": card_s, "twin_s": twin_s,
        "engine_ticks": engine_ticks, "panics": {k: v for k, v in panics.items() if v},
        "stage_launches": stage_launches,
        "estimated_capacity": migrate["estimated_capacity"],
        "estimated_capacity_held": migrate["estimated_capacity_held"],
        "gauges": migrate["controllers"]["gauges"],
        "ref_counts": migrate["controllers"]["ref_counts"],
        "readiness_checks": reports["cold"]["readiness_checks"],
        "profile": profile,
        "kernel": {k: {kk: v[kk] for kk in ("shape", "ms", "plain_ms", "bound_ms", "bound_by")}
                   for k, v in kernel.items()},
    }
    log(f"control summary: {json.dumps(summary)}")
    return {"rounds": out, "summary": summary, "kernel": kernel,
            "sync_launches": stage_launches["sync"], "stage_launches": stage_launches,
            "beside": side.get("result")}


PROCESS_ARGS = (
    "--port", "0", "--members", "3", "--create-crds-for-ftcs",
    "--enable-profiling", "--profiling-port", "0",
)
PROCESS_ROUTES = (
    "/livez", "/readyz", "/metrics", "/debug", "/debug/waterfall", "/debug/trace",
)
PROCESS_TIMEOUT_S = 60.0


def process_phase() -> dict:
    """``python -m kubeadmiral_tpu_torch`` (PROCESS_ARGS: the engine on
    the card, leader election on) as a subprocess: its health and
    profiling ports read from its own lines; 200 from every route of
    PROCESS_ROUTES on the health port (``/metrics`` carrying ``engine_``
    series within PROCESS_TIMEOUT_S: the prewarm's warm dispatch) and from ``/debug/profile?mode=device&seconds=1`` on the
    profiling port (a capture with no error, written to a scratch
    directory of the checkout removed afterwards); then SIGTERM, after
    which it must exit 0 within PROCESS_TIMEOUT_S having printed
    ``leadership released`` and ``shutdown: shed_writes=0``.  Prints a
    ``process`` line: start-up, route and shutdown walls, the routes'
    bytes, the ``engine_`` series count and the capture."""
    import queue
    import signal
    import tempfile
    import threading
    import urllib.request
    from pathlib import Path

    root = Path(__file__).resolve().parent
    work = tempfile.mkdtemp(prefix="_profile_", dir=root)
    t0 = time.perf_counter()
    proc = subprocess.Popen(
        [sys.executable, "-m", "kubeadmiral_tpu_torch", *PROCESS_ARGS],
        cwd=root, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
    )
    lines: "queue.Queue[str]" = queue.Queue()
    seen: list[str] = []

    def pump():
        for line in proc.stdout:
            lines.put(line.rstrip("\n"))
        lines.put(None)

    threading.Thread(target=pump, name="process-output", daemon=True).start()

    def wait_for(pattern: str, timeout: float) -> re.Match:
        deadline = time.monotonic() + timeout
        while True:
            for line in seen:
                found = re.search(pattern, line)
                if found:
                    return found
            try:
                line = lines.get(timeout=max(0.0, deadline - time.monotonic()))
            except queue.Empty:
                line = None
            if line is None:
                raise AssertionError(f"process: no line matching {pattern!r}: {seen[-20:]}")
            seen.append(line)

    def get(port: str, route: str) -> bytes:
        with urllib.request.urlopen(f"http://127.0.0.1:{port}{route}", timeout=120) as resp:
            if resp.status != 200:
                raise AssertionError(f"process: {route} answered {resp.status}")
            return resp.read()

    try:
        health = wait_for(r"health endpoints on :(\d+)", 300).group(1)
        prof = wait_for(r"profiling endpoints on :(\d+)", 300).group(1)
        wait_for(r"controller manager running", 300)
        start_s = time.perf_counter() - t0
        t1 = time.perf_counter()
        sizes = {route: len(get(health, route)) for route in PROCESS_ROUTES}
        # The engine's series come with the prewarm thread's warm
        # dispatch, which runs beside the first requests.
        deadline = time.monotonic() + PROCESS_TIMEOUT_S
        while True:
            metrics = get(health, "/metrics").decode()
            engine_series = sum(1 for line in metrics.splitlines() if line.startswith("engine_"))
            if engine_series or time.monotonic() > deadline:
                break
            time.sleep(0.5)
        if not engine_series:
            raise AssertionError("process: /metrics carries no engine_ series")
        capture = json.loads(get(prof, f"/debug/profile?mode=device&seconds=1&dir={work}"))
        if "error" in capture or not capture.get("files"):
            raise AssertionError(f"process: device profile {capture}")
        routes_s = time.perf_counter() - t1
        t1 = time.perf_counter()
        proc.send_signal(signal.SIGTERM)
        rc = proc.wait(timeout=PROCESS_TIMEOUT_S)
        stop_s = time.perf_counter() - t1
        if rc != 0:
            raise AssertionError(f"process: exit {rc} after SIGTERM: {seen[-20:]}")
        for pattern in (r"leadership released", r"shutdown: shed_writes=0\b"):
            wait_for(pattern, 10)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
        shutil.rmtree(work, ignore_errors=True)
    row = {
        "args": list(PROCESS_ARGS), "start_s": start_s, "routes_s": routes_s,
        "stop_s": stop_s, "route_bytes": sizes, "engine_series": engine_series,
        "capture": {k: capture[k] for k in ("seconds", "wall_s", "files")},
    }
    log(f"process: {json.dumps(row)}")
    return row


# The HTTP transport: BENCH_E2E_HTTP_r06.json's 1,000 Deployments over 20
# member apiservers (e2e_objects_per_sec_1000x20_http, in-process farm).
HTTP_SHAPE = (1000, 20)
HTTP_TIMEOUT_S = 300.0  # the wait for it after the control phase


def _watch_counts(clients) -> dict:
    """Events dispatched, reconnect backoffs slept and 410 relists over
    every watch stream of ``clients``."""
    out = {"watch_events": 0, "reconnects": 0, "relists": 0}
    for client in clients:
        for mux in list(client._mux.values()):
            out["watch_events"] += mux.events
            out["reconnects"] += len(mux.reconnect_delays)
            out["relists"] += mux.relists
    return out


def _requests_by_verb(servers) -> dict:
    out: dict[str, int] = {}
    for server in servers:
        for labels, n in server.metrics.counter_family("apiserver_requests_total").items():
            verb = dict(labels).get("verb", "")
            out[verb] = out.get(verb, 0) + int(n)
    return out


def _delta(after: dict, before: dict) -> dict:
    return {k: v - before.get(k, 0) for k, v in sorted(after.items()) if v - before.get(k, 0)}


def http_world(out_dir: str) -> int:
    """The HTTP world on the card, run as ``python3 chip_smoke.py
    --http-world DIR`` by ``http_phase_start``: ``testing/cpworld.py``'s
    world at HTTP_SHAPE over a kwok-lite farm (``testing/kwoklite.py``:
    the host and every member an apiserver on its own socket, bearer
    tokens, members minting service-account tokens), the port's
    ControllerManager with its default engine on the card, through
    cpworld.HTTP_ROUNDS (join, cold, churn, no-op resync, topology,
    partition), each checked by ``run_rounds``.  Per round the phase-1
    launch count is set to 0 just before and read just after, beside
    the dispatch shapes, the apiservers' requests by verb, the watch
    streams' events, reconnects and 410 relists, the member writes,
    batches, sheds, retries and breaker opens, and a fleet scrape of the
    members' /metrics (``runtime/fleetscrape.py``).  Writes
    ``report.json`` (the rounds with their store digests) and the cold
    round's first dispatch (``cold_inputs.pt``) for the kernel check in
    the parent, and the twin comparison there."""
    import torch

    from kubeadmiral_tpu_torch.ops import phase1 as phase1_mod
    from kubeadmiral_tpu_torch.ops.phase1 import phase1
    from kubeadmiral_tpu_torch.runtime import flightrec
    from kubeadmiral_tpu_torch.runtime.fleetscrape import FleetScraper
    from kubeadmiral_tpu_torch.runtime.metrics import Metrics
    from kubeadmiral_tpu_torch.testing import cpworld
    from kubeadmiral_tpu_torch.testing.kwoklite import KwokLiteFarm
    from kubeadmiral_tpu_torch.testing.sample_counts import recorded_dispatches

    if not torch.cuda.is_available():
        print("http world: CUDA is not available", file=sys.stderr)
        return 2
    phase1_mod._library()
    objects, clusters = HTTP_SHAPE
    flightrec.get_default().clear()
    farm = KwokLiteFarm()
    # The host apiserver's requests by verb (the members count theirs).
    farm.host_server.metrics = Metrics()
    try:
        plane = cpworld.ControlPlane(farm=farm)  # the manager's default engine: the card's
        if plane.engine.device.type != "cuda":
            raise AssertionError(f"http: the default engine runs on {plane.engine.device}")
        chunk = plane.engine.chunk_size
        stack = contextlib.ExitStack()
        recording, counted, first = {}, {}, []
        before: dict = {}
        scraper = FleetScraper(roster=farm.scrape_roster)

        def clients():
            return [farm.host, *farm._extra_clients, *farm.fleet.factory._cache.values()]

        def servers():
            return [farm.host_server, *farm.member_servers.values()]

        def on_round(name: str) -> None:
            before["requests"] = _requests_by_verb(servers())
            before["watch"] = _watch_counts(clients())
            recording[name] = stack.enter_context(
                recorded_dispatches(keep=first if name == "cold" else None)
            )
            phase1.launches = 0

        def after_round(name: str, report: dict) -> None:
            counted[name] = phase1.launches
            stack.close()
            shapes = recording.pop(name)
            report["dispatch_shapes"] = sorted({tuple(c) for c in shapes})
            report["dispatches"] = len(shapes)
            report["requests"] = _delta(_requests_by_verb(servers()), before["requests"])
            report["watch"] = _delta(_watch_counts(clients()), before["watch"])
            pane = scraper.scrape()
            report["fleet"] = {
                "instances": len(pane["instances"]),
                "scrape_errors": pane["scrape_errors"],
                "down": sorted(n for n, i in pane["instances"].items() if not i.get("up")),
            }

        t0 = time.perf_counter()
        reports = cpworld.run_rounds(
            plane, objects, clusters, on_round, after_round, rounds=cpworld.HTTP_ROUNDS
        )
        wall_s = time.perf_counter() - t0
        for name, report in reports.items():
            if counted[name] != report["phase1_launches"]:
                raise AssertionError(
                    f"http {name}: {counted[name]} launches counted, "
                    f"{report['phase1_launches']} in its engine ticks"
                )
            want = clusters + (name in ("topology", "partition"))
            fleet = report["fleet"]
            if fleet["instances"] != want or fleet["scrape_errors"] or fleet["down"]:
                raise AssertionError(f"http {name}: fleet scrape {fleet}, {want} members")
        cold = reports["cold"]
        fills = sum(-(-t["units"] // chunk) for t in cold["ticks"])
        if cold["phase1_launches"] < fills:
            raise AssertionError(f"http cold: {cold['phase1_launches']} launches, {fills} chunks filled")
        for name in ("churn", "topology", "partition"):
            if reports[name]["phase1_launches"] < 1:
                raise AssertionError(f"http {name}: the scheduler's ticks launched nothing")
        torch.save({"type": [type(first[0]).__module__, type(first[0]).__name__],
                    "fields": {k: v.cpu() for k, v in first[0]._asdict().items()}},
                   f"{out_dir}/cold_inputs.pt")
        rows = {}
        for name, report in reports.items():
            row = {k: v for k, v in report.items() if k != "ticks"}
            row["ticks"] = [
                {k: t[k] for k in ("units", "clusters", "wall_ms", "phase1_launches", "fetch_bytes")}
                for t in report["ticks"]
            ]
            rows[name] = row
        summary = {
            "objects": objects, "clusters": clusters, "wall_s": wall_s,
            "engine_ticks": plane.engine.tick_seq,
            "panics": {k: v for k, v in plane.panics().items() if v},
        }
        with open(f"{out_dir}/report.json", "w") as f:
            json.dump({"rounds": rows, "summary": summary}, f)
    finally:
        farm.close()
    return 0


# Subprocesses started by this script and still running at its end
# (stopped by stop_started, however main() ends).
_STARTED: list = []


def stop_started() -> None:
    for proc, work in _STARTED:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
        shutil.rmtree(work, ignore_errors=True)


def http_phase_start():
    """Start ``http_world`` in a subprocess (its own interpreter: the
    farm's apiserver threads and the controllers share that process's
    GIL, not this one's); returns (process, scratch directory)."""
    import tempfile
    from pathlib import Path

    root = Path(__file__).resolve().parent
    work = tempfile.mkdtemp(prefix="_http_", dir=root)
    log_file = open(f"{work}/stdout.log", "w")
    proc = subprocess.Popen(
        [sys.executable, str(root / "chip_smoke.py"), "--http-world", work],
        cwd=root, stdout=log_file, stderr=subprocess.STDOUT, text=True,
    )
    log_file.close()
    _STARTED.append((proc, work))
    return proc, work


def http_phase_finish(proc, work: str) -> dict:
    """Wait for ``http_world``, then the same rounds over an in-memory
    ``ClusterFleet`` with ``SchedulerEngine(device="cpu")`` (the partition
    round there the same churn with no fault): every round's store
    digests, host and members, equal the card world's under
    cpworld.transport_masked (cpworld.TRANSPORT_ONLY left out).  The
    kernel against its twin on the cold round's first dispatch, timed
    with its bound.  Prints an ``http <round>`` line per round and an
    ``http summary`` line; returns the rounds, the summary, the kernel
    row and the twin's plane (for ``extension_stage``)."""
    import importlib

    import torch

    from kubeadmiral_tpu_torch.runtime import flightrec, slo
    from kubeadmiral_tpu_torch.scheduler.engine import SchedulerEngine
    from kubeadmiral_tpu_torch.testing import cpworld

    objects, clusters = HTTP_SHAPE
    # The control phase's recorder holds its own pending tokens: the
    # twin's recovery reads a fresh one.
    slo.reset_default()
    t0 = time.perf_counter()
    twin = cpworld.ControlPlane(
        engine=SchedulerEngine(device="cpu", flight_recorder=flightrec.FlightRecorder()),
        transport_masks=True,
    )
    twin_reports = cpworld.run_rounds(twin, objects, clusters, rounds=cpworld.HTTP_ROUNDS)
    twin_s = time.perf_counter() - t0
    try:
        rc = proc.wait(timeout=HTTP_TIMEOUT_S)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.wait()
        rc = "timeout"
    try:
        with open(f"{work}/stdout.log") as f:
            out = f.read()
        if rc != 0:
            raise AssertionError(f"http world: exit {rc}: {out[-4000:]}")
        with open(f"{work}/report.json") as f:
            got = json.load(f)
        saved = torch.load(f"{work}/cold_inputs.pt")
    finally:
        shutil.rmtree(work, ignore_errors=True)
    module, name = saved["type"]
    inp = getattr(importlib.import_module(module), name)(
        **{k: v.cuda() for k, v in saved["fields"].items()}
    )
    kernel = check_phase1("http-cold-chunk", inp, timed=True)
    del inp, saved
    rows = got["rounds"]
    for name in cpworld.HTTP_ROUNDS:
        diff = cpworld.digest_diff(rows[name]["digests"], twin_reports[name]["digests"])
        if diff:
            raise AssertionError(f"http {name}: the HTTP world's store differs from the in-memory twin's: {diff}")
    out_rows = {}
    for name in cpworld.HTTP_ROUNDS:
        row = {k: v for k, v in rows[name].items() if k != "digests"}
        row["twin_wall_s"] = twin_reports[name]["wall_s"]
        row["twin_walls_s"] = twin_reports[name]["walls_s"]
        row["twin_engine_ticks"] = twin_reports[name]["engine_ticks"]
        row["store_equal"] = True
        log(f"http {name}: {json.dumps(row)}")
        out_rows[name] = row
    summary = dict(got["summary"], twin_s=twin_s,
                   kernel={k: kernel[k] for k in ("shape", "ms", "plain_ms", "bound_ms", "bound_by")})
    log(f"http summary: {json.dumps(summary)}")
    return {"rounds": out_rows, "summary": summary, "kernel": kernel, "twin": twin}


EXTENSION_PLUGIN = "ext"


def extension_stage(twin) -> dict:
    """The port's ``ExtensionService`` (``scheduler/extension_service.py``)
    on a socket, batch protocol, serving ``testing/worlds.py:webhook(0)``
    (the seeded stand-in the surface phase ticks with) as filter-batch
    and score-batch handlers; a ``SchedulerController``'s webhook
    evaluator over a ``WebhookPlugin`` registered from
    ``service.webhook_configuration`` feeds a ``want_scores`` tick on a
    fresh card engine over the HTTP world's 1,000 Deployments and its
    first 20 clusters (the twin's units after its last round).  Results
    and score dicts equal a fresh card engine's tick with the stand-in
    in process, and the service sees one POST per plugin (filter-batch,
    score-batch) for the tick.  Prints an ``extension`` line."""
    from kubeadmiral_tpu_torch.federation.schedulerctl import SchedulerController
    from kubeadmiral_tpu_torch.ops.phase1 import phase1
    from kubeadmiral_tpu_torch.scheduler import webhook as W
    from kubeadmiral_tpu_torch.scheduler.engine import SchedulerEngine
    from kubeadmiral_tpu_torch.scheduler.extension_service import ExtensionService
    from kubeadmiral_tpu_torch.testing import cpworld
    from kubeadmiral_tpu_torch.testing.fakekube import FakeKube
    from kubeadmiral_tpu_torch.testing.worlds import webhook

    objects, clusters_n = HTTP_SHAPE
    sched = twin.scheduler
    feds = {cpworld.web_key(i): twin.host.get(twin.ftc.federated.resource, cpworld.web_key(i))
            for i in range(objects)}
    units = [
        dataclasses.replace(
            sched._scheduling_unit(fed, sched._policy_for(fed)),
            enabled_filters=(EXTENSION_PLUGIN,), enabled_scores=(EXTENSION_PLUGIN,),
        )
        for fed in feds.values()
    ]
    clusters = sched._clusters()[:clusters_n]
    by_key = {su.key: su for su in units}
    names = [c.name for c in clusters]
    hook = webhook(0)
    posts: dict[str, int] = {}

    def answers(request: dict):
        cls = [c["metadata"]["name"] for c in request["clusters"]]
        if cls != names:
            raise AssertionError(f"extension: clusters {cls[:3]}...")
        for payload in request["schedulingUnits"]:
            yield hook(by_key[f"{payload.get('namespace', '')}/{payload['name']}"], clusters)

    def filter_batch(request: dict) -> dict:
        posts["filter-batch"] = posts.get("filter-batch", 0) + 1
        return {"selected": [[True] * len(names) if a is None else [bool(x) for x in a[0]]
                             for a in answers(request)]}

    def score_batch(request: dict) -> dict:
        posts["score-batch"] = posts.get("score-batch", 0) + 1
        return {"scores": [[0] * len(names) if a is None else [int(x) for x in a[1]]
                           for a in answers(request)]}

    service = ExtensionService(filter_batch_fn=filter_batch, score_batch_fn=score_batch)
    service.start()
    try:
        config = service.webhook_configuration(EXTENSION_PLUGIN)
        config["spec"].update(filterPath="/filter", scorePath="/score")
        plugin = W.WebhookPlugin(W.parse_webhook_config(config))
        ctl = SchedulerController(FakeKube("extension"), twin.ftc, engine=SchedulerEngine())
        t0 = time.perf_counter()
        evaluate = ctl._webhook_eval({EXTENSION_PLUGIN: plugin}, units, clusters)
        phase1.launches = 0
        got = ctl.engine.schedule(units, clusters, webhook_eval=evaluate, want_scores=True)
        launches = phase1.launches
        wall_ms = (time.perf_counter() - t0) * 1e3
        want = SchedulerEngine().schedule(units, clusters, webhook_eval=hook, want_scores=True)
    finally:
        service.stop()
    assert_results_equal("extension vs stand-in", got, want, scores=True)
    if posts != {"filter-batch": 1, "score-batch": 1}:
        raise AssertionError(f"extension: POSTs {posts}, one per plugin expected")
    if launches < 1:
        raise AssertionError("extension: the tick launched nothing")
    row = {"units": len(units), "clusters": len(clusters), "posts": posts, "launches": launches,
           "wall_ms": wall_ms, "scored_rows": sum(1 for r in got if r.scores),
           "placed_pairs": sum(len(r.clusters) for r in got)}
    log(f"extension: {json.dumps(row)}")
    return row


HTTP_PROCESS_ARGS = ("--port", "0", "--transport", "http", "--members", "3", "--create-crds-for-ftcs")
HTTP_PROCESS_REPLICAS = 9


def process_http_phase() -> dict:
    """``python -m kubeadmiral_tpu_torch`` over HTTP (HTTP_PROCESS_ARGS:
    a kwok-lite farm of a host and three member apiservers, the engine
    on the card, leader election on) as a subprocess: the three members
    Joined and Ready, read from the host apiserver's socket; a
    PropagationPolicy (Divide) and a Deployment of HTTP_PROCESS_REPLICAS
    replicas created through the host socket; its divided copies read
    back from the member sockets with the printed admin tokens, summing
    to the replicas; then SIGTERM, after which it must exit 0 within
    PROCESS_TIMEOUT_S having printed ``shutdown: shed_writes=0``.
    Prints a ``process http`` line."""
    import queue
    import signal
    import threading
    from pathlib import Path

    from kubeadmiral_tpu_torch.federation.clusterctl import FEDERATED_CLUSTERS, JOINED, READY, get_condition
    from kubeadmiral_tpu_torch.models.policy import PROPAGATION_POLICIES, PROPAGATION_POLICY_LABEL
    from kubeadmiral_tpu_torch.transport.client import HttpKube

    root = Path(__file__).resolve().parent
    t0 = time.perf_counter()
    proc = subprocess.Popen(
        [sys.executable, "-m", "kubeadmiral_tpu_torch", *HTTP_PROCESS_ARGS],
        cwd=root, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
    )
    lines: "queue.Queue[str]" = queue.Queue()
    seen: list[str] = []

    def pump():
        for line in proc.stdout:
            lines.put(line.rstrip("\n"))
        lines.put(None)

    threading.Thread(target=pump, name="process-http-output", daemon=True).start()

    def wait_for(pattern: str, timeout: float) -> list:
        deadline = time.monotonic() + timeout
        while True:
            found = [m for m in (re.search(pattern, line) for line in seen) if m]
            if found:
                return found
            try:
                line = lines.get(timeout=max(0.0, deadline - time.monotonic()))
            except queue.Empty:
                line = None
            if line is None:
                raise AssertionError(f"process http: no line matching {pattern!r}: {seen[-20:]}")
            seen.append(line)

    def until(what: str, check, timeout: float = PROCESS_TIMEOUT_S):
        deadline = time.monotonic() + timeout
        while True:
            got = check()
            if got:
                return got
            if time.monotonic() > deadline:
                raise AssertionError(f"process http: {what} within {timeout} s: {seen[-20:]}")
            time.sleep(0.2)

    clients = []
    try:
        wait_for(r"controller manager running", 300)
        host_url = wait_for(r"host apiserver on (\S+)", 10)[0].group(1)
        members = {
            m.group(1): (m.group(2), m.group(3))
            for m in wait_for(r"member (\S+) apiserver on (\S+) \(admin token: (\S+)\)", 10)
        }
        start_s = time.perf_counter() - t0
        if len(members) != 3:
            raise AssertionError(f"process http: members {sorted(members)}")
        host = HttpKube(host_url, name="host")
        clients.append(host)

        def joined():
            objs = host.list(FEDERATED_CLUSTERS)
            ok = [o for o in objs if all(
                (get_condition(o, c) or {}).get("status") == "True" for c in (JOINED, READY))]
            return len(ok) == len(members) and ok

        t1 = time.perf_counter()
        until("the members Joined and Ready", joined)
        join_s = time.perf_counter() - t1
        t1 = time.perf_counter()
        host.create(PROPAGATION_POLICIES, {
            "apiVersion": "core.kubeadmiral.io/v1alpha1", "kind": "PropagationPolicy",
            "metadata": {"name": "pp", "namespace": "default"},
            "spec": {"schedulingMode": "Divide"},
        })
        dep = {
            "apiVersion": "apps/v1", "kind": "Deployment",
            "metadata": {"name": "web", "namespace": "default",
                         "labels": {PROPAGATION_POLICY_LABEL: "pp"}},
            "spec": {
                "replicas": HTTP_PROCESS_REPLICAS,
                "selector": {"matchLabels": {"app": "web"}},
                "template": {"metadata": {"labels": {"app": "web"}}, "spec": {"containers": [
                    {"name": "c", "image": "nginx", "resources": {"requests": {"cpu": "50m"}}}]}},
            },
        }
        host.create("apps/v1/deployments", dep)
        member_clients = {}
        for name, (url, token) in members.items():
            member_clients[name] = HttpKube(url, token=token, name=name)
            clients.append(member_clients[name])

        def divided():
            reps = {}
            for name, client in member_clients.items():
                obj = client.try_get("apps/v1/deployments", "default/web")
                if obj is not None:
                    reps[name] = obj["spec"]["replicas"]
            return sum(reps.values()) == HTTP_PROCESS_REPLICAS and reps

        replicas = until("the divided copies on the members", divided)
        propagate_s = time.perf_counter() - t1
        t1 = time.perf_counter()
        proc.send_signal(signal.SIGTERM)
        rc = proc.wait(timeout=PROCESS_TIMEOUT_S)
        stop_s = time.perf_counter() - t1
        if rc != 0:
            raise AssertionError(f"process http: exit {rc} after SIGTERM: {seen[-20:]}")
        wait_for(r"shutdown: shed_writes=0\b", 10)
    finally:
        for client in clients:
            client.close()
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    row = {"args": list(HTTP_PROCESS_ARGS), "start_s": start_s, "join_s": join_s,
           "propagate_s": propagate_s, "stop_s": stop_s, "replicas": replicas}
    log(f"process http: {json.dumps(row)}")
    return row


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    from kubeadmiral_tpu_torch.convert import to_device
    from kubeadmiral_tpu_torch.ops import phase1 as phase1_mod
    from kubeadmiral_tpu_torch.runtime import flightrec
    from kubeadmiral_tpu_torch.runtime.devprof import DispatchLedger
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
    overhead = ledger_overhead()

    # The HTTP world runs in its own process from here on, beside the
    # phases below (its controllers and apiservers share that process's
    # interpreter lock, not this one's; its engine ticks are a few
    # milliseconds of the card); http_phase_finish collects it after the
    # control phase.
    http_proc, http_work = http_phase_start()

    ticks, dense_ticks, fallback_ticks = {}, {}, {}
    warm, slab_rows, depth_turns, surface = {}, {}, {}, {}
    for cfg in ("3", "5"):
        t0 = time.perf_counter()
        units, clusters, _ = worlds[cfg]
        # A dispatch ledger of its own: its records are this engine's.
        engine = SchedulerEngine(devprof=DispatchLedger())
        tick = run_tick(f"c{cfg} narrow", engine, units, clusters)
        if tick["narrow_m"] is None:
            raise AssertionError(f"c{cfg}: the engine did not take the narrow path")
        tick["ledger"] = ledger_check(f"c{cfg} cold", engine, tick, tick["fallback_dispatches"])
        got = tick.pop("results")
        ticks[cfg] = tick
        if cfg == "5" and tick["fetch_bytes"] != C5_COLD_FETCH_BYTES:
            raise AssertionError(
                f"c5 cold fetch bytes {tick['fetch_bytes']}, not {C5_COLD_FETCH_BYTES}"
            )
        check = units if cfg == "3" else units[:C5_CHECK_ROWS]
        t1 = time.perf_counter()
        want = SchedulerEngine(device="cpu").schedule(check, clusters)
        log(f"cpu engine c{cfg}: {len(check)} rows in {time.perf_counter() - t1:.2f} s")
        assert_results_equal(f"c{cfg} gpu vs cpu", got[: len(check)], want)
        del want
        torch.cuda.empty_cache()
        log(f"phase e2e-c{cfg}: {time.perf_counter() - t0:.2f} s")

        # The window against the sequential dispatch, in turns; c5 over
        # its first C5_BUDGET_OBJECTS objects, as the budget turns.
        t0 = time.perf_counter()
        depth = len(units) if cfg == "3" else C5_BUDGET_OBJECTS
        depth_turns[cfg] = turns_depth(cfg, units[:depth], clusters, got[:depth])
        log(f"phase turns-c{cfg}: {time.perf_counter() - t0:.2f} s")
        t0 = time.perf_counter()
        turns_budget(cfg, units[:depth], clusters, got[:depth],
                     TURN_BUDGETS if cfg == "3" else C5_TURN_BUDGETS)
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
        # Every engine here feeds the process-wide flight recorder; a
        # phase starts from an empty ring, so its ticks evict only their
        # own records, as a deployment's one engine would (the cost of
        # evicting a cold tick's records: recorder_probe).
        flightrec.get_default().clear()
        warm[cfg], slab, resume = warm_phase(cfg, units, clusters, engine, dict(tick), got)
        if cfg == "5":
            # The persistence phase resumes from this converged engine.
            t1 = time.perf_counter()
            snap5, capture5 = capture_snapshot(
                engine, tick["chunks"], resume, [c.name for c in clusters]
            )
            resume5 = resume
            log(f"phase persist-capture-c5: {time.perf_counter() - t1:.2f} s")
        del engine, got, resume
        slab = type(slab)(*(x.cuda() for x in slab))
        slab_rows[cfg] = check_phase1(f"c{cfg}-slab", slab, timed=True)
        del slab
        torch.cuda.empty_cache()
        log(f"phase warm-c{cfg}: {time.perf_counter() - t0:.2f} s")

        # Scores, follower unions and webhook ticks on a fresh engine.
        t0 = time.perf_counter()
        flightrec.get_default().clear()
        surface[cfg] = surface_phase(cfg, units, clusters, ticks[cfg])
        log(f"phase surface-c{cfg}: {time.perf_counter() - t0:.2f} s")

    # Durable state: the kill round on the card at c3's shape, then c5
    # engines resumed from the warm phase's snapshot.
    t0 = time.perf_counter()
    kill = kill_round()
    log(f"phase persist-kill-c3: {time.perf_counter() - t0:.2f} s")
    t0 = time.perf_counter()
    resumed = resume_phase(snap5, resume5, worlds["5"][1], ticks["5"]["chunks"])
    del snap5, resume5
    log(f"phase persist-resume-c5: {time.perf_counter() - t0:.2f} s")

    # The streaming front end over fresh card engines, c3 then c5.
    streams = {}
    for cfg in ("3", "5"):
        gc.collect()
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        streams[cfg] = stream_phase(cfg, *worlds[cfg][:2])
        log(f"phase stream-c{cfg}: {time.perf_counter() - t0:.2f} s")

    # The control plane (the manager's controllers) over the card's engine.
    t0 = time.perf_counter()
    del worlds, units, clusters
    gc.collect()
    # The processes (python -m kubeadmiral_tpu_torch on the card, in
    # memory and over HTTP) run beside the control phase's CPU twin,
    # while the card is idle.
    control = control_phase(
        beside=lambda: {"memory": process_phase(), "http": process_http_phase()}
    )
    process, process_http = control["beside"]["memory"], control["beside"]["http"]
    log(f"phase control and process: {time.perf_counter() - t0:.2f} s")
    t0 = time.perf_counter()
    http = http_phase_finish(http_proc, http_work)
    log(f"phase http: {time.perf_counter() - t0:.2f} s (its twin, the wait, the kernel check)")
    t0 = time.perf_counter()
    extension = extension_stage(http.pop("twin"))
    gc.collect()
    log(f"phase extension: {time.perf_counter() - t0:.2f} s")

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
                              surface["5"]["webhook_chunk"], surface["3"]["webhook_chunk"],
                              control["kernel"]["cold_chunk"], control["kernel"]["churn"],
                              control["kernel"]["migrate"], http["kernel"],
                              streams["5"]["kernel"], streams["3"]["kernel"])
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
                # The persistence phase: launches of the resumed ticks
                # (a fresh resume launches nothing) and of the kill
                # round's successor tick (its churned rows' slabs).
                "launches_persistence": {
                    "c5 fresh resume": resumed["fresh resume"]["phase1_launches"],
                    "c5 stale resume": resumed["stale resume"]["phase1_launches"],
                    "c3 kill round successor": kill["successor_launches"],
                    "c3 dispatch-flush successor": kill["dispatch_flush"]["successor_launches"],
                },
                "snapshot_c5": capture5,
                # The control plane's rounds (the manager's controllers
                # over the card's engine): launches
                # per round, and the kernel at the churn round's shape.
                "launches_control": {
                    name: row["phase1_launches"] for name, row in control["rounds"].items()
                },
                # The same rounds, counted on the path through the port's
                # ControllerManager (its FTC watch starts the controllers,
                # its step_all settles them).
                "launches_control_manager": {
                    name: row["phase1_launches"] for name, row in control["rounds"].items()
                },
                "profile_control_churn": control["summary"]["profile"]["kernel_events"],
                # The dispatch ledger's records per kind on the step-7
                # cold ticks (engines with ledgers of their own).
                "ledger_cold": {
                    f"c{cfg}": {k: v["n"] for k, v in ticks[cfg]["ledger"]["by_program"].items()}
                    for cfg in ("3", "5")
                },
                "process_engine_series": process["engine_series"],
                "ledger_us_per_observe": overhead["us_per_observe"],
                "control_churn": {
                    key: control["kernel"]["churn"][key]
                    for key in ("shape", "ms", "plain_ms", "bound_ms", "bound_by", "ops_ms")
                },
                "control_migrate": {
                    key: control["kernel"]["migrate"][key]
                    for key in ("shape", "ms", "plain_ms", "bound_ms", "bound_by", "ops_ms")
                },
                # The sync stage of the control rounds launches nothing,
                # nor does any other controller but the schedulers.
                "launches_sync": control["sync_launches"],
                "launches_controllers": control["stage_launches"],
                # The stream phase: launches per flush (cold, warm-up,
                # event-log flushes), and the kernel at the second event
                # flush's slab.
                **{
                    f"launches_stream_c{cfg}": streams[cfg]["summary"]["launches"]
                    for cfg in ("3", "5")
                },
                **{
                    f"stream_slab_c{cfg}": {
                        key: streams[cfg]["kernel"][key]
                        for key in ("shape", "ms", "plain_ms", "bound_ms", "bound_by", "ops_ms")
                    }
                    for cfg in ("3", "5")
                },
                # The HTTP world (the manager's controllers over a
                # kwok-lite farm of apiserver sockets, in its own
                # process): launches per round, the kernel at the cold
                # round's first dispatch, the extension tick's launches
                # and the process over HTTP.
                "launches_http": {
                    name: row["phase1_launches"] for name, row in http["rounds"].items()
                },
                "http_cold": {
                    key: http["kernel"][key]
                    for key in ("shape", "ms", "plain_ms", "bound_ms", "bound_by", "ops_ms")
                },
                "launches_extension": extension["launches"],
                "extension_posts": extension["posts"],
                "process_http_replicas": process_http["replicas"],
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
    if len(sys.argv) == 3 and sys.argv[1] == "--http-world":
        sys.exit(http_world(sys.argv[2]))
    try:
        rc = main()
    finally:
        stop_started()
    sys.exit(rc)
