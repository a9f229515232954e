"""The engine's three-stream survivor revert on the port, beside JAX.

* The programs: ``drift_resolve`` (from the gate-refreshed score plane,
  five changed columns in eight delta slots, the pad slots carrying an
  out-of-range index; the engine cases below run it at one column), ``drift_replan`` and the score-only solve (the port's
  ``drift_survivor``) against the JAX package's ``drift_resolve``,
  ``drift_replan`` and ``drift_scoreonly``, every output plane and the
  certificate, and certified rows
  against the dense tick.  Tolerance 0 (integer math).
* The engine: tests/test_drift_replan.py's three-stream cases (its i64
  key and full-featurization cases run in test_torch_optin_engine.py),
  tests/test_streaming.py's resolve
  cases and tests/test_survivor_unified.py's three-stream oracle cases,
  each run with the test module's engine, recorder and stream globals
  pointed at a ``Twin``: the port's ``SchedulerEngine(device="cpu")``
  and a JAX engine taking the same calls with the same switches, their
  results, ``drift_stats``, ``survivor_stats``, ``narrow_stats``,
  ``fetch_stats``, ``featurize_rows`` and ``last_changed`` equal after
  every tick, and the flight-recorder records of the rows a tick
  re-decided equal; the cases' own assertions then hold on the port.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_drift_replan
import test_streaming
import test_survivor_unified
from test_torch_drift import _delta, _dense_case, _gate_both, _prev_planes, _t, CLUSTER_ONLY
from test_torch_optin_engine import run_case
from test_torch_pipeline import same_planes

from kubeadmiral_tpu.ops import pipeline as JPipe
from kubeadmiral_tpu_torch.convert import to_device, to_numpy
from kubeadmiral_tpu_torch.ops import pipeline as TPipe
from kubeadmiral_tpu_torch.testing.problems import random_tick_inputs


# -- the programs -----------------------------------------------------------------

def _resolve_case(b, c, d_real, nb, seed):
    """A drift's resolve arguments: the new inputs, the stored planes,
    the gate-refreshed score plane (equal in both packages) and the
    delta slots.  The load at the changed columns drops by a tenth:
    scores move, and fit flips for a few rows only."""
    old = random_tick_inputs(b, c, 3, webhook=True, invalid=2, seed=seed)
    rng = np.random.default_rng(seed + 100)
    cols = np.sort(rng.choice(np.nonzero(old.cluster_valid)[0], d_real, replace=False))
    used = np.array(old.used)
    used[cols] = used[cols] * 9 // 10
    new = old._replace(used=used)
    dcpu = np.zeros(d_real, bool)
    out, prev = _prev_planes(old)
    per_object = {k: np.asarray(v) for k, v in new._asdict().items() if k not in CLUSTER_ONLY}
    delta = _delta(old, new, cols, dcpu, nb)
    fin = np.arange(b, dtype=np.int32)
    (_jm, js), (_tm, ts) = _gate_both("dense", per_object, None, prev, delta, fin)
    np.testing.assert_array_equal(ts, js)
    return new, out, ts, delta


@pytest.mark.parametrize(
    "b,c,d_real,nb,m,seed",
    [(72, 24, 5, 8, 8, 2)],
)
def test_resolve_matches_jax(b, c, d_real, nb, m, seed):
    new, out, refreshed, delta = _resolve_case(b, c, d_real, nb, seed)
    ao, uo, an, un, didx, dvalid, _dcpu = delta
    got, cert = TPipe.drift_resolve(
        to_device(new, "cpu"), _t(out.feasible), _t(refreshed), _t(out.reasons),
        _t(ao), _t(uo), _t(an), _t(un), _t(didx), _t(dvalid), m,
    )
    want, want_cert = JPipe.drift_resolve(
        new, jnp.asarray(out.feasible), jnp.asarray(refreshed), jnp.asarray(out.reasons),
        *(jnp.asarray(a) for a in (ao, uo, an, un, didx, dvalid)), m,
    )
    same_planes(to_numpy(got), want, f"resolve m={m}")
    assert cert.dtype == torch.int8
    np.testing.assert_array_equal(cert.numpy(), np.asarray(want_cert))
    ok = cert.numpy() != 0
    assert ok.any() and not ok.all(), ok
    # Certified rows equal the dense tick on the new planes.
    dense = to_numpy(TPipe.schedule_tick(to_device(new, "cpu")))
    for name in ("selected", "replicas", "counted", "feasible", "scores", "reasons"):
        np.testing.assert_array_equal(
            getattr(to_numpy(got), name)[ok], getattr(dense, name)[ok], name
        )


@pytest.mark.parametrize("m,i32_keys", [(8, False)])
def test_replan_and_scoreonly_match_jax(m, i32_keys):
    b, c = 64, 40
    old, new, _cols, _dcpu = _dense_case(b, c, 4, 30 + m)
    out, _prev = _prev_planes(old)
    new_t = to_device(new, "cpu")
    got, cert = TPipe.drift_replan(new_t, _t(out.reasons), _t(out.scores), m)
    want, want_cert = JPipe.drift_replan(
        new, jnp.asarray(out.reasons), jnp.asarray(out.scores), m
    )
    same_planes(to_numpy(got), want, f"replan m={m}")
    np.testing.assert_array_equal(cert.numpy(), np.asarray(want_cert))
    ok = cert.numpy() != 0
    assert ok.any() and not ok.all()
    dense = to_numpy(TPipe.schedule_tick(new_t))
    for name in ("selected", "replicas", "counted", "feasible", "reasons"):
        np.testing.assert_array_equal(
            getattr(to_numpy(got), name)[ok], getattr(dense, name)[ok], name
        )
    got, cert = TPipe.drift_survivor(new_t, _t(out.reasons), m, i32_keys)
    want, want_cert = JPipe.drift_scoreonly(
        new, jnp.asarray(out.reasons), m, i32_keys=i32_keys
    )
    same_planes(to_numpy(got), want, f"scoreonly m={m}")
    np.testing.assert_array_equal(cert.numpy(), np.asarray(want_cert))


# -- the engine -----------------------------------------------------------------

DRIFT_REPLAN_CASES = [
    ("TestReplanScoreOnly", "test_fitflip_drift_engages_both_paths_exactly"),
    ("TestReplanScoreOnly", "test_chain_of_fitflip_drifts_stays_exact"),
    ("TestReplanScoreOnly", "test_planner_spill_forces_replan_fallback"),
    ("TestReplanScoreOnly", "test_kt_replan_off_reverts_to_slabs"),
    ("TestReplanScoreOnly", "test_streaming_interleave_with_fitflips_bit_identical"),
]


@pytest.mark.parametrize("cls,name", DRIFT_REPLAN_CASES, ids=[n for _c, n in DRIFT_REPLAN_CASES])
def test_drift_replan_case(monkeypatch, cls, name):
    run_case(monkeypatch, test_drift_replan, cls, name)


STREAMING_CASES = [
    "test_resolve_settles_score_drift_exactly",
    "test_resolve_chain_stays_exact_across_consecutive_drifts",
    "test_resolve_disabled_falls_back_to_slabs",
]


@pytest.mark.parametrize("name", STREAMING_CASES)
def test_streaming_resolve_case(monkeypatch, name):
    run_case(monkeypatch, test_streaming, "TestDriftResolvePath", name)


@pytest.mark.parametrize(
    "name",
    ["test_unified_replaces_all_three_streams", "test_kt_survivor_unified_off_reverts_to_three_streams"],
)
def test_survivor_unified_oracle_case(monkeypatch, name):
    run_case(monkeypatch, test_survivor_unified, "TestUnifiedSurvivor", name)
