"""Steady-state tick sequences: the port's ``SchedulerEngine(device="cpu")``
against the JAX engine tick by tick, and against a fresh port engine's
cold tick under random sequences.

The sequence differential runs seeded config 3 and config 5 worlds of a
few hundred objects over several chunks through cold, churn, no-op,
drift, mass-churn, topology-change and ``dirty_rows=`` ticks.  At every
tick the results equal the JAX engine's and so do the chunks' adaptive
wire widths, ``last_changed`` and the cache, fetch, drift-gate, survivor
and narrow counters, with both engines at the sequential dispatch (port
``pipeline_depth`` 1, JAX ``KT_PIPELINE_DEPTH=1``) and, in the
``_at_depth_16`` tests, at the pipelined window's default depth of 16.
On a drift tick ``last_changed`` holds every row whose result moved.
"""

import copy
import dataclasses

import numpy as np
import pytest
from hypothesis import HealthCheck, given, settings, strategies as st

from test_compact import rich_world
from test_engine_cache import make_world, results_equal
from test_torch_engine import _port

from kubeadmiral_tpu.scheduler.engine import SchedulerEngine as JaxEngine
from kubeadmiral_tpu.scheduler.featurize import featurize_signature as jax_signature
from kubeadmiral_tpu_torch.scheduler.engine import SchedulerEngine
from kubeadmiral_tpu_torch.scheduler.featurize import featurize_signature
from kubeadmiral_tpu_torch.testing.sample_counts import warm_counts
from kubeadmiral_tpu_torch.testing.worlds import build_world, churn, drift


def _relabel(clusters, index):
    out = list(clusters)
    out[index] = dataclasses.replace(
        out[index], labels={**out[index].labels, "extra": "1"}
    )
    return out


def _hints(engine):
    return [e.pack_k_hint for _, e in sorted(engine._chunk_cache.items())]


# (objects, clusters, chunk rows): several chunks each; c5's 300
# clusters bucket to 512, where rows bucket to the ladder and the narrow
# solve runs (M = 128), as at full size.
SEQUENCE_WORLDS = {"3": (300, 40, 64), "5": (600, 300, 128)}


@pytest.mark.parametrize("config", sorted(SEQUENCE_WORLDS))
def test_tick_sequence_matches_jax_engine(config, monkeypatch):
    _tick_sequence(config, monkeypatch, depth=1)


@pytest.mark.parametrize("config", sorted(SEQUENCE_WORLDS))
def test_tick_sequence_matches_jax_engine_at_depth_16(config, monkeypatch):
    _tick_sequence(config, monkeypatch, depth=16)


def _tick_sequence(config, monkeypatch, depth):
    """The sequence on both engines at pipeline depth ``depth``."""
    n, c, chunk = SEQUENCE_WORLDS[config]
    units, clusters, _ = build_world(n, c, config, seed=1)
    monkeypatch.setenv("KT_PIPELINE_DEPTH", str(depth))
    ref = JaxEngine(mesh=None, flight_recorder=None, devprof=None, chunk_size=chunk)
    port = _port(monkeypatch, chunk_size=chunk)
    port.pipeline_depth = depth
    rng = np.random.default_rng(0)
    seen = set()
    gated = []
    prev = None

    counters = ("cache_stats", "fetch_stats", "drift_stats", "survivor_stats", "narrow_stats")

    def tick(kind, units, clusters, drifted=False, **kw):
        before = {name: dict(getattr(port, name)) for name in counters}
        ref_before = {name: dict(getattr(ref, name)) for name in counters}
        got = port.schedule(units, clusters, **kw)
        want = ref.schedule(units, clusters, **kw)
        results_equal(got, want)
        assert _hints(port) == _hints(ref), kind
        assert port.last_changed == ref.last_changed, kind
        for name in counters:
            mine, theirs = getattr(port, name), getattr(ref, name)
            m0, t0 = before[name], ref_before[name]
            assert {k: mine[k] - m0[k] for k in mine} == {
                k: theirs[k] - t0[k] for k in theirs
            }, (kind, name)
        if drifted:
            # None is "every row".
            moved = {i for i, (a, b) in enumerate(zip(got, prev)) if a != b}
            changed = set(range(len(got)) if port.last_changed is None else port.last_changed)
            assert moved <= changed, kind
        f0 = before["fetch_stats"]
        seen.update(k for k in port.fetch_stats if port.fetch_stats[k] > f0[k])
        gated.append(port.drift_stats["gated"] - before["drift_stats"]["gated"])
        return got

    prev = tick("cold", units, clusters)
    for i in range(3):
        units = churn(rng, units)
        prev = tick(f"churn {i}", units, clusters)
    prev = tick("no-op", units, clusters)
    prev = tick("no-op, fresh list", list(units), clusters)
    drifted = drift(clusters)
    prev = tick("drift", units, drifted, drifted=True)
    units = churn(rng, units)
    drifted = drift(drifted, 1)
    prev = tick("churn + drift", units, drifted, drifted=True)
    units = [dataclasses.replace(u, desired_replicas=(u.desired_replicas or 1) + 1) for u in units]
    prev = tick("mass churn", units, drifted)
    relabeled = _relabel(drifted, 2)
    prev = tick("topology change", units, relabeled)
    churned = churn(rng, units)
    dirty = [i for i, (a, b) in enumerate(zip(churned, units)) if a is not b]
    prev = tick("dirty-rows churn", churned, relabeled, dirty_rows=dirty)
    prev = tick("back to the first clusters", churned, clusters)
    prev = tick("churn", churn(rng, churned), clusters)
    assert seen == {"noop", "subbatch", "skip", "delta", "full"}
    assert sum(gated) > 0  # the drift ticks ran the gate


def test_featurize_signature_matches_jax():
    """Deep copies for each side: the memo one package sets on a unit
    would otherwise answer for the other."""
    units, _ = rich_world(b=48, c=14, seed=7)
    mine = copy.deepcopy(units)
    theirs = copy.deepcopy(units)
    assert all(getattr(u, "_featurize_sig", None) is None for u in mine + theirs)
    assert [featurize_signature(u) for u in mine] == [jax_signature(u) for u in theirs]
    assert featurize_signature(mine[0]) is featurize_signature(mine[0])  # memoised
    changed = dataclasses.replace(mine[1], desired_replicas=(mine[1].desired_replicas or 0) + 3)
    assert featurize_signature(changed) != featurize_signature(mine[1])


def test_commit_nsel_aggregates_per_tick():
    """One pack-K vote per tick on the aggregated observations: two
    pieces of one tick cast one shrink vote; the hint halves after the
    second tick's vote (tests/test_multidevice.py's case)."""
    eng = SchedulerEngine(device="cpu")
    entry = type("E", (), {"pack_k_hint": 64, "pack_shrink_votes": 0})()
    narrow = np.ones(32, np.int64)
    eng._observe_nsel(entry, narrow, 256)
    eng._observe_nsel(entry, narrow, 256)
    eng._flush_nsel()
    assert (entry.pack_shrink_votes, entry.pack_k_hint) == (1, 64)
    eng._observe_nsel(entry, narrow, 256)
    eng._observe_nsel(entry, narrow, 256)
    eng._flush_nsel()
    assert (entry.pack_shrink_votes, entry.pack_k_hint) == (0, 32)


@pytest.mark.parametrize(
    "nsel,c_bucket,hint,votes",
    [
        (np.full(40, 3), 64, 0, 0),
        (np.r_[np.full(90, 5), np.full(10, 50)], 512, 16, 0),
        (np.r_[np.full(980, 2), np.full(20, 40)], 5120, 64, 1),
        (np.arange(1, 301), 512, 128, 0),
        (np.full(16, 200), 256, 8, 0),
    ],
)
def test_commit_nsel_matches_jax(nsel, c_bucket, hint, votes):
    """The hint and its votes after one commit equal the JAX engine's."""
    ref = JaxEngine(mesh=None, flight_recorder=None, devprof=None)
    mine = type("E", (), {"pack_k_hint": hint, "pack_shrink_votes": votes})()
    theirs = type("E", (), {"pack_k_hint": hint, "pack_shrink_votes": votes})()
    SchedulerEngine._commit_nsel(mine, nsel, c_bucket)
    ref._commit_nsel(theirs, nsel, c_bucket)
    assert (mine.pack_k_hint, mine.pack_shrink_votes) == (
        theirs.pack_k_hint, theirs.pack_shrink_votes
    )


STEPS = st.lists(
    st.tuples(
        st.sampled_from(["churn", "drift", "noop", "noop-fresh", "churn+drift"]),
        st.integers(0, 2**16),
    ),
    min_size=2,
    max_size=6,
)


@settings(max_examples=12, deadline=None, suppress_health_check=[HealthCheck.function_scoped_fixture])
@given(steps=STEPS)
def test_random_sequences_match_a_fresh_cold_tick(steps, monkeypatch):
    """Random churn, drift and no-op ticks on one warm port engine at the
    sequential dispatch: every tick equals a fresh port engine's cold
    tick."""
    _random_sequence(steps, monkeypatch, depth=1)


@settings(max_examples=12, deadline=None, suppress_health_check=[HealthCheck.function_scoped_fixture])
@given(steps=STEPS)
def test_random_sequences_match_a_fresh_cold_tick_at_depth_16(steps, monkeypatch):
    """The same with the warm engine's window at depth 16."""
    _random_sequence(steps, monkeypatch, depth=16)


def _random_sequence(steps, monkeypatch, depth):
    units, clusters = make_world(b=48, c=10)
    kw = dict(chunk_size=16, min_bucket=8)
    engine = _port(monkeypatch, **kw)
    engine.pipeline_depth = depth
    engine.schedule(units, clusters)
    for kind, seed in steps:
        rng = np.random.default_rng(seed)
        if "churn" in kind:
            units = churn(rng, units, fraction=0.08)
        if "drift" in kind:
            clusters = drift(clusters, int(rng.integers(0, len(clusters))))
        if kind == "noop-fresh":
            units = list(units)
        got = engine.schedule(units, clusters)
        results_equal(got, _port(monkeypatch, **kw).schedule(units, clusters))


def test_warm_counts_follow_the_engine():
    """The CPU sampler behind PERF.md's warm prediction: the churn tick
    runs one narrow slab on the ladder, the no-op tick dispatches
    nothing, the drift tick reuses the device inputs; the full-size plan
    is one 256-row slab over c3's three chunks."""
    got = warm_counts("3", 300, seed=2)
    ticks = got["ticks"]
    assert ticks["cold"]["cache"] == {"miss": 1} and ticks["cold"]["changed_rows"] is None
    assert ticks["churn"]["fetch_paths"] == {"subbatch": 1}
    assert ticks["churn"]["dispatches"][0] == ("narrow", 256, 512)
    assert ticks["noop"]["dispatches"] == [] and ticks["noop"]["fetch_paths"] == {"noop": 1}
    assert ticks["drift"]["cache"] == {"hit": 1}
    assert ticks["drift"]["upload_bytes"]["object"] == 0
    assert 0 < ticks["churn"]["fetch_bytes"] < ticks["cold"]["fetch_bytes"]
    assert got["full_size"]["slabs"] == [[256, 512]] and got["full_size"]["chunks"] == 3
