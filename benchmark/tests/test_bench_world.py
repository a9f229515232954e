"""The generator: deterministic per seed, and equal to its frozen source."""

import json

import numpy as np
import pytest

from benchmark import harness, traffic, world
from benchmark.adapter import Adapter
from kubeadmiral_tpu_torch.testing import worlds

CONFIGS = {"5": "benchmark/configs/c5-100kx5k.json", "3": "benchmark/configs/c3-10kx500.json"}


def small(config, objects, clusters):
    with open(harness.ROOT / CONFIGS[config]) as f:
        cfg = json.load(f)["world"]
    return dict(cfg, objects=objects, clusters=clusters)


@pytest.mark.parametrize("config", sorted(CONFIGS))
def test_world_equals_its_source(config):
    units, clusters, followers = world.build_world(small(config, 400, 90), 2**31 + 7)
    ad = Adapter()
    want_units, want_clusters, want_followers = worlds.build_world(400, 90, config=config, seed=2**31 + 7)
    assert ad.units(units) == want_units
    assert [ad.cluster(c) for c in clusters] == want_clusters
    assert followers == want_followers


@pytest.mark.parametrize("config", sorted(CONFIGS))
def test_world_is_deterministic_per_seed(config):
    cfg = small(config, 300, 40)
    assert world.build_world(cfg, 11) == world.build_world(cfg, 11)
    assert world.build_world(cfg, 11)[0] != world.build_world(cfg, 12)[0]


def test_churn_and_drift_equal_their_source():
    units, clusters, _ = world.build_world(small("5", 500, 30), 3)
    ad = Adapter()
    typed = ad.units(units)
    changed = world.churn(np.random.default_rng(5), units, 0.05)
    want = worlds.churn(np.random.default_rng(5), typed, 0.05)
    got = list(typed)
    for i, rec in changed.items():
        got[i] = ad.unit(rec)
    assert got == want
    assert [i for i in range(len(typed)) if want[i] is not typed[i]] == sorted(changed)
    assert ad.cluster(world.drift(clusters[4])) == worlds.drift([ad.cluster(c) for c in clusters], 4)[4]


def test_respec_changes_every_row_in_range():
    units, _, _ = world.build_world(small("3", 2000, 10), 9)
    second = world.respec(units)
    assert all(a != b for a, b in zip(units, second))
    for rec in second:
        if rec["mode"] == world.DIVIDE:
            assert 1 <= rec["replicas"] <= 99
        else:
            assert 0 <= rec["request"]["cpu"] <= 1750 and rec["request"]["cpu"] % 250 == 0
            assert 0 <= rec["request"]["memory"] < 16 * 256 * world.MI
    assert world.respec(units) == second


def test_traffic_is_deterministic_per_seed():
    units, clusters, _ = world.build_world(small("5", 400, 40), 1)

    def steps(seed, params):
        mix = traffic.Traffic(params, units, clusters, np.random.default_rng([seed, 1]))
        out = []
        for _ in range(6):
            s = mix.step()
            out.append((sorted(s.changed.items()), s.generation, s.drifted,
                        None if s.clusters is None else [c["avail"] for c in s.clusters]))
        return out

    for params in ({"churn_share": 0.01}, {"drift_members": 1}, {"respec": True}):
        assert steps(21, params) == steps(21, params)
    assert steps(21, {"drift_members": 1}) != steps(22, {"drift_members": 1})
    with pytest.raises(ValueError):
        traffic.Traffic({"churn": 0.01}, units, clusters, np.random.default_rng(0))


def test_drift_mix_restores_every_other_tick():
    units, clusters, _ = world.build_world(small("3", 50, 20), 1)
    mix = traffic.Traffic({"drift_members": 1}, units, clusters, np.random.default_rng(4))
    first, back = mix.step(), mix.step()
    (m,) = first.drifted
    assert first.clusters[m]["avail"] == {k: v // 2 for k, v in clusters[m]["avail"].items()}
    assert all(a is b for a, b in zip(back.clusters, clusters))
