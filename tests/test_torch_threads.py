"""Ticks from two threads on one port engine.

``SchedulerEngine.schedule`` holds a per-engine lock for the whole tick,
as the JAX engine does: overlapping ticks would race the chunk cache.
Two threads tick one CPU engine over interleaved churn and drift lists;
no two ticks overlap, and every result equals the result of the same
call in a sequential run on another engine.
"""

import threading

import numpy as np

from test_engine_cache import make_world, results_equal
from test_torch_engine import _port

from kubeadmiral_tpu_torch.testing.worlds import churn, drift


def _calls(seed):
    """Six (units, clusters) calls of one thread: churn and drift ticks
    in turns over a world shared with the other thread."""
    units, clusters = make_world(b=48, c=10)
    rng = np.random.default_rng(seed)
    calls = []
    for step in range(6):
        if step % 2 == 0:
            units = churn(rng, units, fraction=0.1)
        else:
            clusters = drift(clusters, int(rng.integers(0, len(clusters))))
        calls.append((units, clusters))
    return calls


def test_two_threads_match_a_sequential_run(monkeypatch):
    kw = dict(chunk_size=16, min_bucket=8)
    engine = _port(**kw)
    plans = [_calls(1), _calls(2)]
    results = [[None] * len(p) for p in plans]
    active, overlaps = [0], []
    inner = engine._schedule

    def watched(*args):
        active[0] += 1
        overlaps.append(active[0])
        try:
            return inner(*args)
        finally:
            active[0] -= 1

    engine._schedule = watched
    start = threading.Barrier(2)
    errors = []

    def run(t):
        try:
            start.wait()
            for i, (units, clusters) in enumerate(plans[t]):
                results[t][i] = engine.schedule(units, clusters)
        except Exception as exc:  # reported below, in the test's thread
            errors.append(exc)

    threads = [threading.Thread(target=run, args=(t,)) for t in range(2)]
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    assert not errors, errors
    assert max(overlaps) == 1, "two ticks ran at once"
    assert len(overlaps) == sum(len(p) for p in plans)

    sequential = _port(**kw)
    for i in range(len(plans[0])):
        for t in range(2):
            results_equal(results[t][i], sequential.schedule(*plans[t][i]))
