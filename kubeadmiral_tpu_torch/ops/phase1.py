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
    feasible = feasible & inp.cluster_valid[None, :] & inp.webhook_ok
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


def phase1(inp):
    """The phase-1 triple: the CUDA kernel for CUDA tensors, the plain
    torch version for CPU tensors."""
    device = inp.api_ok.device
    if device.type == "cpu":
        return phase1_plain(inp)
    if device.type != "cuda":
        raise ValueError(f"phase1: unsupported device {device}")
    lib = _library()
    b, c = inp.api_ok.shape
    r = inp.request.shape[1]
    # The three per-cell score planes are int32, as every featurizer
    # emits them (phase1_plain also takes int64 ones, on the CPU).
    mask, i32, i64 = (torch.bool,), (torch.int32,), (torch.int64,)
    args = [
        _checked("filter_enabled", inp.filter_enabled, (b, F.NUM_FILTER_PLUGINS), device, mask),
        _checked("score_enabled", inp.score_enabled, (b, S.NUM_SCORE_PLUGINS), device, mask),
        _checked("request", inp.request, (b, r), device, i64),
        _checked("placement_has", inp.placement_has, (b,), device, mask),
    ]
    for name in (
        "api_ok", "taint_ok_new", "taint_ok_cur", "selector_ok",
        "placement_ok", "current_mask", "webhook_ok",
    ):
        args.append(_checked(name, getattr(inp, name), (b, c), device, mask))
    for name in ("webhook_scores", "taint_counts", "affinity_scores"):
        args.append(_checked(name, getattr(inp, name), (b, c), device, i32))
    args += [
        _checked("alloc", inp.alloc, (c, r), device, i64),
        _checked("used", inp.used, (c, r), device, i64),
        _checked("cluster_valid", inp.cluster_valid, (c,), device, mask),
    ]
    feasible = torch.empty((b, c), dtype=torch.bool, device=device)
    reasons = torch.empty((b, c), dtype=torch.int32, device=device)
    totals = torch.empty((b, c), dtype=torch.int64, device=device)
    # Scratch for the kernel's column planes (csrc/phase1.cu:columns_kernel).
    cols = torch.empty((2 * r + 3, c), dtype=torch.int64, device=device)
    ptrs = [x.data_ptr() for x in args] + [
        feasible.data_ptr(), reasons.data_ptr(), totals.data_ptr(), cols.data_ptr()
    ]
    # The launch goes to the tensors' card, whichever card is current.
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = lib.kt_phase1(*ptrs, b, c, r, stream)
    if err != 0:
        raise RuntimeError(f"phase1 kernel launch failed: CUDA error {err}")
    phase1.launches += 1
    return feasible, reasons, totals


phase1.launches = 0
