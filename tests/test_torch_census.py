"""The port's memory census against the JAX package's.

``project``, ``_geometry`` and ``decide`` in the JAX engine's "rows"
layout, which the port's meshed engine keeps (each lane holds its rows
of every plane), equal the JAX module's at several (objects, clusters,
devices), up to 1M x 10k x 16, on every plane family but the tie-break
plane, which the port does not keep resident (0 where JAX books 4 B a
cell); the totals differ by exactly that family (exact).  More devices
lower the per-device bytes, so c6 shards.  The c5 and c6 figures the
port's card run is held to are pinned here, and ``validate`` runs on
the CPU at a small shape, without a mesh and over 2 and 4 lanes.
"""

import pytest

from kubeadmiral_tpu.runtime import census as jax_census
from kubeadmiral_tpu_torch.parallel.mesh import make_mesh
from kubeadmiral_tpu_torch.runtime import census

SHAPES = [
    (8192, 256, 1), (10_000, 500, 1), (100_000, 5_000, 1), (100_000, 5_000, 4),
    (1_000_000, 10_000, 1), (1_000_000, 10_000, 2), (1_000_000, 10_000, 8),
    (1_000_000, 10_000, 16), (300, 7, 2), (50_000, 2_000, 8),
]


@pytest.fixture(autouse=True)
def _jax_defaults(monkeypatch):
    for var in ("KT_CELL_BUDGET", "KT_MEGACHUNK_ROWS", "KT_SCORE_F16", "KT_HBM_BUDGET_GB"):
        monkeypatch.delenv(var, raising=False)


@pytest.mark.parametrize("b,c,n", SHAPES)
@pytest.mark.parametrize("f16", [False, True])
def test_project_equals_jax_but_the_tiebreak(b, c, n, f16):
    mine = census.project(b, c, n, score_f16=f16)
    theirs = jax_census.project(b, c, n, score_f16=f16)
    assert census._geometry(b, c, n) == jax_census._geometry(b, c, n)
    assert mine["geometry"] == theirs["geometry"]
    assert mine["prev_plane_split"] == theirs["prev_plane_split"]
    for family in ("prev_planes", "per_object", "vectors"):
        assert mine["by_family"][family] == theirs["by_family"][family], family
    assert mine["by_family"]["tiebreak"] == 0
    tiebreak = theirs["by_family"]["tiebreak"]
    assert tiebreak == 4 * theirs["geometry"]["padded_rows"] * theirs["geometry"]["c_bucket"]
    assert mine["total"] == theirs["total"] - tiebreak
    vec = mine["by_family"]["vectors"]
    assert mine["per_device"] == (mine["total"] - vec) // n + vec
    assert mine["prev_planes_per_device"] == mine["by_family"]["prev_planes"] // n
    # The port's layout is the JAX engine's: more devices divide it.
    assert mine["layout"] == "rows"
    assert mine["per_device"] < mine["total"] if n > 1 else mine["per_device"] == mine["total"]
    assert mine["prev_planes_per_device"] * n == mine["by_family"]["prev_planes"]
    assert (mine["score_dtype"], mine["device_count"]) == (theirs["score_dtype"], n)


@pytest.mark.parametrize("cell_budget,megachunk_rows", [(1 << 20, 4096), (4096 * 5120, 512)])
def test_geometry_arguments_equal_jax_environment(monkeypatch, cell_budget, megachunk_rows):
    """The JAX module's KT_CELL_BUDGET / KT_MEGACHUNK_ROWS reads are the
    port's arguments."""
    monkeypatch.setenv("KT_CELL_BUDGET", str(cell_budget))
    monkeypatch.setenv("KT_MEGACHUNK_ROWS", str(megachunk_rows))
    for b, c, n in SHAPES[:6]:
        assert census._geometry(
            b, c, n, cell_budget=cell_budget, megachunk_rows=megachunk_rows
        ) == jax_census._geometry(b, c, n)


def test_c5_and_c6_figures():
    c5 = census.project(100_000, 5_000, 1)
    assert c5["by_family"]["prev_planes"] == 7_864_320_000
    assert c5["per_device"] == 7_900_774_400
    f16 = {
        n: census.project(1_000_000, 10_000, n, score_f16=True)["per_device"]
        for n in (1, 2, 8)
    }
    assert f16 == {1: 133_673_478_144, 2: 66_975_928_320, 8: 16_747_745_280}
    assert census.project(1_000_000, 10_000, 1)["per_device"] == 154_182_623_232
    # The lanes split the rows: more devices divide the padded total,
    # which only the chunk padding changes.
    totals = {n: census.project(1_000_000, 10_000, n, score_f16=True)["total"]
              for n in (1, 2, 8)}
    assert totals == {1: 133_673_478_144, 2: 133_946_839_040, 8: 133_946_839_040}


@pytest.mark.parametrize("b,c,n", SHAPES)
@pytest.mark.parametrize("budget", [16 << 30, 85_000_000_000, 1 << 40])
def test_decide_matches_jax_without_the_tiebreak(b, c, n, budget):
    """decide's verdict against a budget equals the JAX decision made on
    the port's projection (JAX's own, with its tie-break plane, may need
    more devices); its per-device figures are the port's projections."""
    mine = census.decide(b, c, n, budget_bytes=budget)
    plain = census.project(b, c, n, score_f16=False)["per_device"]
    packed = census.project(b, c, n, score_f16=True)["per_device"]
    assert (mine["per_device_i32"], mine["per_device_f16"]) == (plain, packed)
    want = "fits" if plain <= budget else ("compress" if packed <= budget else "shard")
    assert mine["verdict"] == want
    theirs = jax_census.decide(b, c, n, budget_bytes=budget)
    if mine["verdict"] == "shard":
        # The least power-of-two multiple of n that fits.
        least = mine["min_devices"]
        assert census.project(b, c, least, score_f16=True)["per_device"] <= budget
        assert least // 2 == n or (
            census.project(b, c, least // 2, score_f16=True)["per_device"] > budget
        )
        assert least <= theirs["min_devices"]
    assert mine["reasons_i16_would_save"] == theirs["reasons_i16_would_save"]
    # The port's layout splits the rows: a verdict always names a device
    # count, n unless the mesh must grow, and never "over".
    assert mine["layout"] == "rows" and mine["verdict"] != "over"
    assert mine["min_devices"] == n or mine["verdict"] == "shard"
    assert mine["min_devices"] >= n


def test_c6_decisions():
    assert census.BUDGET_BYTES == 16 << 30 == jax_census.hbm_budget_bytes()
    d = census.decide(1_000_000, 10_000, 1)
    assert (d["verdict"], d["min_devices"]) == ("shard", 8)
    assert jax_census.decide(1_000_000, 10_000, 1)["min_devices"] == 16
    card = census.decide(1_000_000, 10_000, 1, budget_bytes=85_000_000_000)
    assert (card["verdict"], card["min_devices"]) == ("shard", 2)
    # The port keeps each lane's rows on its card: c6 splits over two
    # H100s (85,017,493,504 B each) and over eight 16 GiB devices.
    for budget, least in ((16 << 30, 8), (85_017_493_504, 2)):
        port = census.decide(1_000_000, 10_000, 1, budget_bytes=budget)
        assert (port["verdict"], port["min_devices"], port["layout"]) == ("shard", least, "rows")


@pytest.mark.parametrize("lanes", [1, 2, 4])
def test_validate_on_the_cpu(lanes):
    mesh = None if lanes == 1 else make_mesh(["cpu"] * lanes)
    v = census.validate(512, 64, device="cpu", mesh=mesh)
    assert v["ok"], v
    assert v["live"]["by_family"]["tiebreak"] == 0
    assert v["prev_planes_err_pct"] == 0.0 and v["per_device_err_pct"] == 0.0
    # Each lane holds its share of the prev planes, exactly the model's.
    assert len(v["live_prev_planes_by_lane"]) == lanes
    assert set(v["live_prev_planes_by_lane"].values()) == {v["model_prev_planes_per_device"]}
    assert v["lane_err_pct"] <= 15.0
