"""Long-running-service GC tuning.

A control plane serializing/parsing thousands of JSON objects per second
allocates fast enough that default gen0 collections (every ~700
allocations) fire constantly, stalling every worker and transport thread
at each collection.  Collect much less often; the values are the JAX
package's (``kubeadmiral_tpu/runtime/gctune.py``), where they were set
empirically.
"""

from __future__ import annotations

import gc


def tune_gc_for_service() -> None:
    gc.set_threshold(50_000, 50, 50)
