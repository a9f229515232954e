"""Phase 1 of the tick: filters, reason bits and normalised score totals.

Replaces ``kubeadmiral_tpu/ops/pallas_slab.py`` (the Pallas
``_phase1_kernel``).  ``phase1(inp)`` returns the triple
``(feasible bool[B, C], reasons i32[B, C], totals i64[B, C])`` that
``ops.pipeline._phase1`` computes in the JAX package:

* on CUDA tensors it launches the hand-written kernels of
  ``csrc/phase1.cu`` (``sm_90a``: the column planes' prologue, then the
  phase-1 kernel), built with ``nvcc`` at first use into ``_build/`` and
  bound with ``ctypes``; a build or launch failure raises — there is no
  fallback;
* on CPU tensors it runs ``phase1_plain``, the same function written out
  in torch (the kernel's twin, compared with it on the card).

``phase1.launches`` counts the calls that launch on the card, one a call
(never plain-version calls); each such call launches two kernels,
``columns_kernel`` and then ``phase1_kernel``.

A column block of the mesh's clusters axis cannot normalise alone: a
row's two normalisation maxima span every block.  The split pair runs
phase 1 there: ``phase1_partial`` (``kt_phase1_partial``: feasibility,
reasons, the totals without the normalised taint and affinity terms, and
each row's two masked maxima over the block, i32[B, 2]) and, once the
maxima are combined over the row's blocks, ``phase1_finish``
(``kt_phase1_finish``: the normalised terms added in place).  Their plain
twins ``phase1_partial_plain`` and ``phase1_finish_plain``, composed over
any column split, equal ``phase1_plain`` bit for bit.  A partial launch
also counts in ``phase1.launches`` (one a block), and in
``phase1_partial.launches``; ``phase1_finish.launches`` counts the
finishes.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import torch

from kubeadmiral_tpu_torch.ops import filters as F
from kubeadmiral_tpu_torch.ops import reasons as RSN
from kubeadmiral_tpu_torch.ops import scores as S

_PKG = Path(__file__).resolve().parent.parent
SOURCE = _PKG / "csrc" / "phase1.cu"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",  # registers, shared memory and spills, kept in build_log()
)

_lib = None
_lib_lock = threading.Lock()


def phase1_plain(inp):
    """``_phase1`` written out in torch: filter masks, reason bits and
    per-cell score totals over expanded TickInputs planes."""
    feasible, reasons = _filters_plain(inp)
    totals = S.total_scores(
        inp.score_enabled,
        feasible,
        inp.request,
        inp.alloc,
        inp.used,
        inp.taint_counts,
        inp.affinity_scores,
    )
    # Webhook scores only matter on feasible clusters.
    totals = totals + torch.where(feasible, inp.webhook_scores, 0)
    return feasible, reasons, totals


def _filters_plain(inp):
    """Feasibility and reason bits over expanded TickInputs planes."""
    fit_ok = F.resources_fit(inp.request, inp.alloc, inp.used)
    feasible, reasons = F.combine_filters_explain(
        inp.filter_enabled,
        inp.api_ok,
        inp.taint_ok_new,
        inp.taint_ok_cur,
        inp.current_mask,
        fit_ok,
        inp.placement_has,
        inp.placement_ok,
        inp.selector_ok,
    )
    reasons = (
        reasons
        | (~inp.webhook_ok).to(torch.int32) * RSN.REASON_WEBHOOK_FILTER
        | (~inp.cluster_valid[None, :]).to(torch.int32) * RSN.REASON_CLUSTER_INVALID
    )
    return feasible & inp.cluster_valid[None, :] & inp.webhook_ok, reasons


def phase1_partial_plain(inp):
    """The split pair's first half on a column block, in torch:
    (feasible, reasons, partial totals i64 — every term but the
    normalised taint and affinity ones —, maxima [B, 2]: each row's
    masked taint and affinity maxima over the block, 0 where the row does
    not score that plugin; on a block of no column, the dtype's minimum,
    which the rows' maximum over the blocks ignores)."""
    feasible, reasons = _filters_plain(inp)
    enabled = inp.score_enabled
    part = torch.zeros(feasible.shape, dtype=torch.int64, device=feasible.device)
    for idx, fn in (
        (S.S_BALANCED, S.balanced_allocation_score),
        (S.S_LEAST, S.least_allocated_score),
        (S.S_MOST, S.most_allocated_score),
    ):
        part = part + torch.where(enabled[:, idx, None], fn(inp.request, inp.alloc, inp.used), 0)
    part = torch.where(feasible, part, 0) + torch.where(feasible, inp.webhook_scores, 0)
    b, c = feasible.shape
    maxima = []
    for idx, plane in ((S.S_TAINT, inp.taint_counts), (S.S_AFFINITY, inp.affinity_scores)):
        if not c:
            maxima.append(torch.full((b,), torch.iinfo(plane.dtype).min, dtype=plane.dtype,
                                     device=plane.device))
            continue
        top = torch.where(feasible, plane, 0).amax(dim=-1)
        maxima.append(torch.where(enabled[:, idx], top, 0))
    return feasible, reasons, part, torch.stack(maxima, dim=-1)


def phase1_finish_plain(feasible, score_enabled, taint_counts, affinity_scores, maxima, totals):
    """The split pair's second half, in torch: ``totals`` plus the
    normalised taint and affinity terms of the rows' ``maxima`` over the
    whole cluster axis, on feasible cells (a new tensor)."""
    out = totals
    for idx, plane, reverse in (
        (S.S_TAINT, taint_counts, True), (S.S_AFFINITY, affinity_scores, False),
    ):
        term = S.normalize_by(plane, feasible, reverse, maxima[:, 0 if reverse else 1])
        out = out + torch.where(feasible & score_enabled[:, idx, None], term, 0)
    return out


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the phase-1 kernel cannot be built")
    return path


def build() -> Path:
    """Compile csrc/phase1.cu into _build/ (keyed by the source's hash,
    so an edited source rebuilds) and return the library path."""
    src = SOURCE.read_bytes()
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    lib_path = BUILD_DIR / f"libkt_phase1_{digest}.so"
    if lib_path.exists():
        return lib_path
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib_path.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(SOURCE)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(
            f"nvcc failed ({proc.returncode}):\n{proc.stdout}\n{proc.stderr}"
        )
    lib_path.with_suffix(".ptxas.txt").write_text(proc.stdout + proc.stderr)
    os.replace(tmp, lib_path)
    return lib_path


def build_log() -> str:
    """What ptxas said of the built kernel: its registers, shared memory
    and spills."""
    return build().with_suffix(".ptxas.txt").read_text()


def _library():
    global _lib
    with _lib_lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            fn = lib.kt_phase1
            fn.restype = ctypes.c_int
            # 17 input, 3 output and 1 scratch pointers, (B, C, R), stream.
            fn.argtypes = [ctypes.c_void_p] * 21 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
            fn = lib.kt_phase1_partial
            fn.restype = ctypes.c_int
            # kt_phase1's, with the maxima output after the scratch.
            fn.argtypes = [ctypes.c_void_p] * 22 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
            fn = lib.kt_phase1_finish
            fn.restype = ctypes.c_int
            # 5 input pointers, totals in place, (B, C), stream.
            fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 2 + [ctypes.c_void_p]
            _lib = lib
        return _lib


def _checked(name, x, shape, device, dtypes):
    if x.device != device:
        raise ValueError(f"phase1: {name} on {x.device}, expected {device}")
    if x.dtype not in dtypes:
        raise ValueError(f"phase1: {name} is {x.dtype}, expected one of {dtypes}")
    if tuple(x.shape) != shape:
        raise ValueError(f"phase1: {name} has shape {tuple(x.shape)}, expected {shape}")
    if not x.is_contiguous():
        raise ValueError(f"phase1: {name} is not contiguous")
    # Masks go to the kernel as 0/1 bytes: a bool tensor's own storage.
    return x.view(torch.uint8) if x.dtype == torch.bool else x


_MASK, _I32, _I64 = (torch.bool,), (torch.int32,), (torch.int64,)


def _launch_args(inp, device):
    """(input tensors checked for the kernel, outputs, (B, C, R)) of one
    phase-1 launch over expanded TickInputs planes."""
    b, c = inp.api_ok.shape
    r = inp.request.shape[1]
    # The three per-cell score planes are int32, as every featurizer
    # emits them (phase1_plain also takes int64 ones, on the CPU).
    args = [
        _checked("filter_enabled", inp.filter_enabled, (b, F.NUM_FILTER_PLUGINS), device, _MASK),
        _checked("score_enabled", inp.score_enabled, (b, S.NUM_SCORE_PLUGINS), device, _MASK),
        _checked("request", inp.request, (b, r), device, _I64),
        _checked("placement_has", inp.placement_has, (b,), device, _MASK),
    ]
    for name in (
        "api_ok", "taint_ok_new", "taint_ok_cur", "selector_ok",
        "placement_ok", "current_mask", "webhook_ok",
    ):
        args.append(_checked(name, getattr(inp, name), (b, c), device, _MASK))
    for name in ("webhook_scores", "taint_counts", "affinity_scores"):
        args.append(_checked(name, getattr(inp, name), (b, c), device, _I32))
    args += [
        _checked("alloc", inp.alloc, (c, r), device, _I64),
        _checked("used", inp.used, (c, r), device, _I64),
        _checked("cluster_valid", inp.cluster_valid, (c,), device, _MASK),
    ]
    outs = (
        torch.empty((b, c), dtype=torch.bool, device=device),
        torch.empty((b, c), dtype=torch.int32, device=device),
        torch.empty((b, c), dtype=torch.int64, device=device),
    )
    return args, outs, (b, c, r)


def _device_of(t):
    device = t.device
    if device.type not in ("cpu", "cuda"):
        raise ValueError(f"phase1: unsupported device {device}")
    return device


def phase1(inp):
    """The phase-1 triple: the CUDA kernel for CUDA tensors, the plain
    torch version for CPU tensors."""
    device = _device_of(inp.api_ok)
    if device.type == "cpu":
        return phase1_plain(inp)
    lib = _library()
    args, outs, dims = _launch_args(inp, device)
    # Scratch for the kernel's column planes (csrc/phase1.cu:columns_kernel).
    cols = torch.empty((2 * dims[2] + 3, dims[1]), dtype=torch.int64, device=device)
    ptrs = [x.data_ptr() for x in (*args, *outs, cols)]
    # The launch goes to the tensors' card, whichever card is current.
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = lib.kt_phase1(*ptrs, *dims, stream)
    if err != 0:
        raise RuntimeError(f"phase1 kernel launch failed: CUDA error {err}")
    phase1.launches += 1
    return outs


phase1.launches = 0


def phase1_partial(inp):
    """The split pair's first half on a column block: the CUDA kernel
    (``kt_phase1_partial``) for CUDA tensors, ``phase1_partial_plain``
    for CPU tensors.  Returns (feasible, reasons, partial totals, maxima
    i32[B, 2])."""
    device = _device_of(inp.api_ok)
    if device.type == "cpu":
        return phase1_partial_plain(inp)
    lib = _library()
    args, outs, dims = _launch_args(inp, device)
    maxima = torch.empty((dims[0], 2), dtype=torch.int32, device=device)
    # The partial reads no column-plane scratch: None for kt_phase1's `cols`.
    ptrs = [x.data_ptr() for x in (*args, *outs)] + [None, maxima.data_ptr()]
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = lib.kt_phase1_partial(*ptrs, *dims, stream)
    if err != 0:
        raise RuntimeError(f"phase1_partial kernel launch failed: CUDA error {err}")
    phase1.launches += 1
    phase1_partial.launches += 1
    return (*outs, maxima)


phase1_partial.launches = 0


def phase1_finish(feasible, score_enabled, taint_counts, affinity_scores, maxima, totals):
    """The split pair's second half: the CUDA kernel
    (``kt_phase1_finish``, in place on ``totals``) for CUDA tensors,
    ``phase1_finish_plain`` for CPU tensors.  Returns the totals."""
    device = _device_of(totals)
    if device.type == "cpu":
        return phase1_finish_plain(
            feasible, score_enabled, taint_counts, affinity_scores, maxima, totals
        )
    lib = _library()
    b, c = totals.shape
    args = [
        _checked("feasible", feasible, (b, c), device, _MASK),
        _checked("score_enabled", score_enabled, (b, S.NUM_SCORE_PLUGINS), device, _MASK),
        _checked("taint_counts", taint_counts, (b, c), device, _I32),
        _checked("affinity_scores", affinity_scores, (b, c), device, _I32),
        _checked("maxima", maxima, (b, 2), device, _I32),
        _checked("totals", totals, (b, c), device, _I64),
    ]
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = lib.kt_phase1_finish(*[x.data_ptr() for x in args], b, c, stream)
    if err != 0:
        raise RuntimeError(f"phase1_finish kernel launch failed: CUDA error {err}")
    phase1_finish.launches += 1
    return totals


phase1_finish.launches = 0
