"""Carry state between numpy planes and the port's tensors.

The numpy featurizers (this package's and the JAX package's) produce
NamedTuples of numpy arrays: ``TickInputs``, ``CompactInputs``,
``PlannerInputs``.  ``to_device`` turns any of them (matched by field
names, so the JAX package's tuples convert too) into the port's tuple of
tensors on a device, keeping every integer dtype; ``to_numpy`` brings
the port's outputs back.  The one dtype change: uint32 planes (the FNV
name-hash states) become int64 holding the same values, since torch's
unsigned 32-bit support is limited.
"""

from __future__ import annotations

import numpy as np
import torch

from kubeadmiral_tpu_torch.ops.pipeline import TickInputs, TickOutputs
from kubeadmiral_tpu_torch.ops.planner import PlannerInputs, PlannerOutputs
from kubeadmiral_tpu_torch.scheduler.compact import CompactInputs

_TUPLES = {
    t._fields: t
    for t in (TickInputs, TickOutputs, CompactInputs, PlannerInputs, PlannerOutputs)
}


def tensor(x, device) -> torch.Tensor:
    """One numpy-convertible array as a tensor on ``device``.  The tensor
    never shares memory with ``x``, on the CPU either: the engine keeps
    device copies of host arrays it later patches in place.  On the card
    the copy goes through pinned memory, queued on the current stream
    without waiting for the work already there (a copy from pageable
    memory would wait); the pinned block is not reused before the copy
    has run (PyTorch's caching host allocator records it on the stream),
    and ``x`` may be patched as soon as this returns."""
    arr = np.asarray(x)
    if arr.dtype == np.uint32:
        arr = arr.astype(np.int64)
    if not (arr.flags.c_contiguous and arr.flags.writeable):
        arr = np.array(arr, order="C")  # a writeable C-ordered copy
    host = torch.from_numpy(arr)
    if torch.device(device).type == "cuda":
        return host.pin_memory().to(device, non_blocking=True)
    return host.to(device, copy=True)


def to_device(planes, device):
    """A NamedTuple of arrays -> the port's NamedTuple of tensors."""
    cls = _TUPLES.get(type(planes)._fields)
    if cls is None:
        raise TypeError(f"no port counterpart for {type(planes).__name__}")
    return cls(*(tensor(x, device) for x in planes))


def to_numpy(planes):
    """The port's NamedTuple of tensors -> the same NamedTuple of numpy
    arrays."""
    return type(planes)(*(x.cpu().numpy() for x in planes))
