"""Webhook ticks (``schedule(webhook_eval=)``) on the port's engine,
beside the JAX engine.

A webhook tick featurizes every chunk dense with the webhook's mask and
score planes (``featurize.featurize``), reads and writes no chunk-cache
entry, and neither hits nor arms the whole-batch no-op gate.  Each case
runs the port's ``SchedulerEngine(device="cpu")`` and a JAX engine
through the same ticks (``test_torch_scores.Pair``: results and score
dicts, ``last_changed``, pack-K hints, overflow rows, ``tick_seq`` and
the cache, fetch, drift and narrow counters equal after every tick), at
depth 1 and, in ``test_case_at_depth_16``, at the window's default 16.
The webhook is ``testing/worlds.py:webhook``: seeded filter and score
planes, rows it leaves unanswered, and rows with scores past the int32
clamp that fail the narrow certificate.
"""

import numpy as np
import pytest

import test_torch_scores
from test_engine_cache import make_world
from test_torch_scores import Pair, scored_equal

from kubeadmiral_tpu_torch.testing.worlds import webhook


def _world(b=96, c=40, seed=3):
    from test_engine_vs_sequential import random_cluster, random_unit

    rng = np.random.default_rng(seed)
    clusters = [random_cluster(rng, j) for j in range(c)]
    names = [cl.name for cl in clusters]
    return [random_unit(rng, i, names) for i in range(b)], clusters


@pytest.mark.parametrize("path", ["narrow", "dense"])
@pytest.mark.parametrize("want_scores", [False, True])
def test_filter_and_score_webhook(monkeypatch, path, want_scores):
    """Filter and score planes on the narrow solve (M = 8 on a bucket of
    64: rows with huge webhook scores fail the certificate and are
    re-solved dense) and on the dense tick."""
    units, clusters = _world()
    narrow_m = 8 if path == "narrow" else 1024
    pair = Pair(monkeypatch, chunk_size=32, min_bucket=8, narrow_m=narrow_m)
    hook = webhook(seed=1, huge_every=8)
    got = pair.tick(units, clusters, webhook_eval=hook, want_scores=want_scores)
    plain = pair.fresh(units, clusters)
    assert sum(a.clusters != b.clusters for a, b in zip(got, plain)) > len(units) // 4
    if path == "narrow":
        assert pair.port.narrow_stats["fallback"] > 0
    else:
        assert pair.port.narrow_stats == {"rows": 0, "fallback": 0}
    assert any(r.scores for r in got) == want_scores
    assert pair.port.cache_stats == {"hit": 0, "patch": 0, "miss": 0}
    assert pair.port._chunk_cache == {}


def test_subset_webhook_tick_between_plain_ticks(monkeypatch):
    """The scheduler controller's rerun: a webhook tick over a subset of
    the list between two plain ticks over the whole list.  The webhook
    tick leaves the cache as it found it; the gate is cleared, so the
    plain tick after it replays chunk by chunk."""
    units, clusters = make_world(b=96, c=12)
    pair = Pair(monkeypatch, chunk_size=32, min_bucket=8)
    first = pair.tick(units, clusters)
    cache = dict(pair.port._chunk_cache)
    stats = dict(pair.port.cache_stats)
    pair.tick(units[10:50], clusters, webhook_eval=webhook(seed=2), want_scores=True)
    assert pair.port.cache_stats == stats
    assert pair.port._chunk_cache == cache
    assert pair.port._noop_gate is None
    before = dict(pair.port.fetch_stats)
    again = pair.tick(units, clusters)
    assert pair.port.fetch_stats["noop"] - before["noop"] == 3
    assert pair.port.cache_stats["hit"] - stats["hit"] == 3
    assert all(a is b for a, b in zip(again, first))


def test_webhook_tick_neither_hits_nor_arms_the_gate(monkeypatch):
    units, clusters = make_world(b=64, c=12)
    pair = Pair(monkeypatch, chunk_size=32, min_bucket=8)
    plain = pair.tick(units, clusters)
    pair.tick(units, clusters)  # the gate replays
    hits = pair.port.cache_stats["hit"]
    hook = webhook(seed=4, reject=0.5)
    hooked = pair.tick(units, clusters, webhook_eval=hook)
    assert any(a.clusters != b.clusters for a, b in zip(hooked, plain))
    assert pair.port._noop_gate is None
    again = pair.tick(units, clusters, webhook_eval=hook)  # no replay either
    assert all(a is not b for a, b in zip(again, hooked))
    scored_equal(again, hooked)
    back = pair.tick(units, clusters)
    assert pair.port.cache_stats["hit"] == hits + 2  # a chunk walk, not the gate
    assert all(a is b for a, b in zip(back, plain))


def test_rows_the_webhook_leaves_unanswered(monkeypatch):
    """Rows for which webhook_eval returns None take no webhook planes:
    they equal a plain tick's rows."""
    units, clusters = _world(b=64, c=20)
    pair = Pair(monkeypatch, chunk_size=32, min_bucket=8)
    hook = webhook(seed=5, silent_every=3)
    got = pair.tick(units, clusters, webhook_eval=hook, want_scores=True)
    plain = pair.fresh(units, clusters, want_scores=True)
    silent = [i for i, u in enumerate(units) if hook(u, clusters) is None]
    assert 0 < len(silent) < len(units)
    scored_equal([got[i] for i in silent], [plain[i] for i in silent])


def test_webhook_chunks_dispatched_again_at_the_drain(monkeypatch):
    """With a planner round budget of 0 every windowed webhook chunk is
    dispatched again with the checked loop at its drain, cache entry or
    none, before its certificate fallback: results equal JAX's."""
    from kubeadmiral_tpu_torch.scheduler import engine as engine_mod

    monkeypatch.setattr(engine_mod, "PLANNER_ROUNDS", 0)
    monkeypatch.setattr(test_torch_scores, "DEPTH", 16)
    units, clusters = _world()
    pair = Pair(monkeypatch, chunk_size=32, min_bucket=8, narrow_m=8)
    pair.tick(units, clusters, webhook_eval=webhook(seed=1, huge_every=8), want_scores=True)
    assert pair.port.planner_reruns == 3  # every chunk
    assert pair.port.narrow_stats["fallback"] > 0


_CASES = [
    pytest.param(lambda mp: test_filter_and_score_webhook(mp, "narrow", True), id="narrow"),
    pytest.param(lambda mp: test_filter_and_score_webhook(mp, "dense", False), id="dense"),
] + [
    pytest.param(fn, id=fn.__name__)
    for fn in (
        test_subset_webhook_tick_between_plain_ticks,
        test_webhook_tick_neither_hits_nor_arms_the_gate,
        test_rows_the_webhook_leaves_unanswered,
    )
]


@pytest.mark.parametrize("case", _CASES)
def test_case_at_depth_16(case, monkeypatch):
    """The cases above with both engines at the pipelined window's
    default depth."""
    monkeypatch.setattr(test_torch_scores, "DEPTH", 16)
    case(monkeypatch)
