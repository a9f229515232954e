"""A run with the timed path broken underneath comes out not correct.

Each test drives the whole harness on the CPU at a small world, with the
look for a card skipped (``device="cpu"``) and the engine wrapped so that
it fails in one way a cell can: a tick that returns its state unchanged,
half of the objects left undecided, an answer altered where it is made.
No cell runs on more than one chip, so no exchange between chips can be
left out.
"""

import dataclasses

import pytest

from benchmark import harness
from kubeadmiral_tpu_torch.scheduler.engine import SchedulerEngine

SMALL = {"c3-churn": {"objects": 1200, "clusters": 80},
         "c3-revalidate": {"objects": 900, "clusters": 60},
         "c5-churn": {"objects": 1500, "clusters": 150}}
SETUP_TICKS = {"c3-churn": 2, "c3-revalidate": 3, "c5-churn": 2}


def run(cell, factory=None, trace=False, seed=2**31 + 99):
    return harness.run(cell, seed, 2.0, trace, device="cpu", world_override=SMALL[cell],
                       engine_factory=factory, log=lambda msg: None)


class Broken:
    """The engine, with ``schedule`` replaced from the first window tick."""

    def __init__(self, cell, fault):
        self.engine = SchedulerEngine(device="cpu")
        self.fault = fault
        self.calls = 0
        self.setup_ticks = SETUP_TICKS[cell]
        self.last = None

    def __getattr__(self, name):
        return getattr(self.engine, name)

    def schedule(self, units, clusters):
        self.calls += 1
        if self.calls <= self.setup_ticks:
            self.last = self.engine.schedule(units, clusters)
            return self.last
        return self.fault(self, units, clusters)


def unchanged(b, units, clusters):
    return b.last


def half_left_out(b, units, clusters):
    half = len(units) // 2
    return b.engine.schedule(units[:half], clusters) + b.last[half:]


def altered(b, units, clusters):
    out = list(b.engine.schedule(units, clusters))
    for i in b.engine.last_changed or range(len(out)):
        placed = dict(out[i].clusters)
        if placed:
            name = min(placed)
            placed[name] = 1 if placed[name] is None else placed[name] + 1
            out[i] = dataclasses.replace(out[i], clusters=placed)
    return out


@pytest.mark.parametrize("cell", sorted(SMALL))
def test_sound_run_is_correct(cell):
    out = run(cell)
    assert out["correct"], out["checks"]
    assert out["checks"]["rows_checked"]["value"] >= harness.MIN_ROWS
    assert list(out)[-1] == "checks"


@pytest.mark.parametrize("fault", [unchanged, half_left_out, altered])
@pytest.mark.parametrize("cell", sorted(SMALL))
def test_broken_run_is_not_correct(cell, fault):
    out = run(cell, lambda device: Broken(cell, fault))
    assert not out["correct"]
    assert out["checks"]["wrong_rows"]["value"] > 0
    assert out["failed"] > 0


def test_short_result_list_is_not_correct():
    def short(b, units, clusters):
        return b.engine.schedule(units, clusters)[:-1]

    out = run("c3-churn", lambda device: Broken("c3-churn", short))
    assert not out["correct"] and out["checks"]["short_ticks"]["value"] > 0


def test_traced_run_reports_its_metrics_on_the_cpu():
    """Without a card the traced run's host metrics are there and its
    device metrics are silent (nothing to read), never 0."""
    out = run("c3-revalidate", trace=True)
    assert out["correct"]
    assert set(out["metrics"]) == {"featurize_ms.revalidate", "decode_ms.revalidate"}
    assert "busy_s" not in out["device"] and "breakdown" not in out


def test_every_tick_hands_the_engine_fresh_objects():
    """As the controller builds a new unit for each object it reconciles,
    no unit object reaches the engine twice, so every row of every tick is
    signature-checked and none is taken by identity."""
    batches = []  # kept alive, so that no two live objects share an id

    class Watch(Broken):
        def schedule(self, units, clusters):
            assert all(getattr(u, "_featurize_sig", None) is None for u in units)
            batches.append(units)
            return self.engine.schedule(units, clusters)

    out = run("c3-churn", lambda device: Watch("c3-churn", None))
    assert out["correct"]
    assert len(batches) > SETUP_TICKS["c3-churn"]
    assert len({id(u) for units in batches for u in units}) == sum(map(len, batches))
