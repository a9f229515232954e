"""Host synchronisations of the engine's chunk dispatches on the card.

A dispatch (pad, upload, expand, tick) should queue work and return: an
operation that waits for the card there stalls the host, and with it the
featurization of the next chunks the pipelined window overlaps.
PyTorch's ``torch.cuda.set_sync_debug_mode`` reports such operations
(blocking copies, reads of a device value); these helpers turn it on
only inside ``SchedulerEngine._queue_chunk``.

* ``counted_dispatch_syncs(engine)``: for the duration, every dispatch
  of ``engine`` records the sites ("file:line") of its synchronising
  operations.
* ``first_chunk_syncs(units, clusters, windowed)``: one dispatch of the
  first chunk of a batch on a fresh engine, as the tick makes it (the
  window's, with the planner's round budget, or the sequential one);
  with ``mode="error"`` the first synchronisation raises.

Both need a CUDA card.
"""

from __future__ import annotations

import contextlib
import time
import warnings

import torch

from kubeadmiral_tpu_torch.ops.planner import RoundBudget
from kubeadmiral_tpu_torch.scheduler import engine as engine_mod


# The message of PyTorch's sync debug warning (c10/cuda/CUDAFunctions.cpp);
# other warnings (the mode's own notice on first use) are not syncs.
SYNC_WARNING = "called a synchronizing CUDA operation"


def _syncs_of(call, mode, found: list, other: list = None):
    """call() with the sync debug mode on; the sites of the sync
    warnings it raised are appended to ``found``, any other warning's
    site and message to ``other``."""
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode(mode)
        try:
            return call()
        finally:
            torch.cuda.set_sync_debug_mode(0)
            for w in caught:
                site = f"{w.filename}:{w.lineno}"
                if SYNC_WARNING in str(w.message):
                    found.append(site)
                elif other is not None:
                    other.append(f"{site}: {w.message}")


@contextlib.contextmanager
def counted_dispatch_syncs(engine, mode="warn"):
    """Yield a list that receives the site of every synchronising
    operation made inside ``engine``'s chunk dispatches."""
    found: list = []
    real = engine._queue_chunk

    def queued(*args, **kwargs):
        return _syncs_of(lambda: real(*args, **kwargs), mode, found)

    engine._queue_chunk = queued
    try:
        yield found
    finally:
        del engine._queue_chunk


def first_chunk_syncs(units, clusters, windowed: bool, mode="warn", mesh="auto") -> dict:
    """One dispatch of the first chunk of ``units`` on a fresh engine on
    the card (over ``mesh``), featurized as the tick does (a cold miss):
    {"sites": the synchronising operations' sites, "other": any other
    warning (site: message), "queue_ms": the dispatch's host time}.
    ``windowed`` gives the planner the window's round budget."""
    engine = engine_mod.SchedulerEngine(mesh=mesh)
    view = engine._cached_view(units, clusters)
    c_bucket, eff_chunk, ladder = engine._tick_geometry(len(view.clusters))
    vocab = engine._vocab_for(view, engine._topo_fingerprint(view))
    chunk = units[:eff_chunk]
    inputs, status, entry, fmt = engine._featurize_chunk(0, chunk, clusters, view, None, vocab)
    b_pad = engine._bucket_rows(len(chunk), ladder, eff_chunk, len(units) > eff_chunk)
    pack_k = engine._pack_k(inputs, c_bucket)
    timings = dict.fromkeys(("featurize", "device"), 0.0)
    budget = RoundBudget(engine_mod.PLANNER_ROUNDS) if windowed else None
    torch.cuda.synchronize()
    found, other = [], []
    t0 = time.perf_counter()
    item = _syncs_of(
        lambda: engine._queue_chunk(
            0, entry, inputs, status, fmt, len(chunk), b_pad, pack_k, view, vocab,
            c_bucket, False, timings, budget,
        ),
        mode,
        found,
        other,
    )
    queue_ms = (time.perf_counter() - t0) * 1e3
    torch.cuda.synchronize()
    del item, engine
    return {"sites": found, "other": other, "queue_ms": queue_ms}
