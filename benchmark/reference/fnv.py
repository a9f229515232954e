"""FNV-1, 32-bit (Go's ``hash/fnv`` ``New32``), the planner's tie-break.

Pattern: ``kubeadmiral_tpu/utils/hashing.py`` (``fnv32``, ``fnv32_extend``)
as of commit 5df33979f11fc4d3c609bdae8857b52774b11979, rewritten over
numpy arrays of states.
"""

from __future__ import annotations

import numpy as np

OFFSET = 2166136261
PRIME = np.uint32(16777619)


def fnv32(data: bytes) -> int:
    h = OFFSET
    for b in data:
        h = ((h * 16777619) & 0xFFFFFFFF) ^ b
    return h


def extend(states: np.ndarray, data: bytes) -> np.ndarray:
    """FNV-1 continued over ``data`` from each uint32 state:
    ``extend(fnv32(a), b) == fnv32(a + b)``."""
    h = states.astype(np.uint32, copy=True)
    with np.errstate(over="ignore"):
        for b in data:
            h = (h * PRIME) ^ np.uint32(b)
    return h
