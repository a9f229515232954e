"""The memory census: does the resident working set fit on the mesh?

A copy of ``kubeadmiral_tpu/runtime/census.py`` for the port.  At c6
scale (1M objects x 10k clusters) the engine's resident planes are
~10^10 cells: six [B, C] output planes per chunk (selected i8, replicas
i32, counted i8, scores i32-or-f16, feasible i8, reasons i32), the
cached per-object input tensors and the [B] companion vectors.  Whether
that fits a device, at how many devices and with which compression, is
a number before a c6 run, not a discovery during it:

* :func:`project` — the analytic inventory: walks the engine's real
  geometry policy (``scheduler.engine.tick_geometry`` and
  ``bucket_rows`` at N devices on the objects axis, so the chunk split,
  padding and ladder rules never drift from the model) and books every
  resident plane family at its device dtype, then per device in the
  JAX engine's "rows" layout, which the port's meshed engine keeps:
  the [B, ...] planes divide across the objects axis, each lane holding
  its rows (``SchedulerEngine.resident_state_bytes``), and the [B]
  vectors book whole on every device, as the JAX model books them (the
  port splits them too, so the model overstates a lane by at most the
  vectors' (N-1)/N, a few bytes a row).  The port keeps no resident
  tie-break plane (the survivor program builds it on its gathered rows),
  so that family is 0 where the JAX model books 4 B a cell.

* :func:`validate` — the honesty check: schedules a small live world,
  walks the actual device buffers
  (``SchedulerEngine.resident_state_bytes``, summed by lane) and
  compares them with the model at the same shape, within 15 %: the
  previous planes in all, and each lane's previous planes and bytes
  against the model's per-device share.  Under a mesh with a clusters
  axis (Nc > 1) each [B, C] plane lies in column blocks, one per entry
  (i, j): every entry's previous planes are checked against the
  model's per-device share divided by Nc, and its bytes against that
  share of the planes plus, on entry (i, 0), the lane's per-object
  inputs and vectors.  ``project`` and ``decide`` stay the
  objects-axis model, as the JAX census is.

* :func:`decide` — the compress-or-shard decision against a per-device
  budget (``budget_bytes``, default 16 GiB, the JAX package's
  ``KT_HBM_BUDGET_GB`` default): ``fits`` as-is; ``compress`` with the
  f16 score plane (``SchedulerEngine(score_f16=True)``, exact behind
  the per-row exactness guard); otherwise ``shard`` with the minimum
  objects-axis device count that fits, compression engaged.

The JAX module's environment reads are arguments with its defaults:
``budget_bytes`` (16 GiB), ``cell_budget`` and ``megachunk_rows`` (the
engine's) and ``score_f16`` (False).
"""

from __future__ import annotations

from typing import Optional

# Device dtype widths of the resident planes (the engine's store sites;
# the reasons plane is i32 on the device — its 10 reason bits would fit
# i16, the next compression lever after scores, which `decide` names).
_PREV_PLANE_BYTES = {
    "selected": 1, "replicas": 4, "counted": 1,
    "scores_i32": 4, "scores_f16": 2,
    "feasible": 1, "reasons": 4,
}
# Compact-format per-object residency per row: the id vectors
# (gvk/tol/sel/pref/place i32 + placement_has i8 + filter/score enables
# i8[5]+i8[5] + request i64[R] + max_clusters/total/... i32) plus the
# sparse entry block and key bytes.  These are shape-dependent; the
# constants below are the JAX model's per-row fixed part (validate()
# checks the prev planes, the family the census is about).
_PER_ROW_FIXED = 96
_SPARSE_ENTRY_BYTES = 6 * 4  # idx/min/max/weight/capacity/cur i32 slots
_KEY_BYTE = 1

# The per-device budget decide() compares against by default.
BUDGET_BYTES = 16 << 30



def _geometry(
    n_objects: int,
    n_clusters: int,
    device_count: int,
    cell_budget: Optional[int] = None,
    megachunk_rows: Optional[int] = None,
):
    """The engine's real geometry at this shape and topology
    (``tick_geometry`` and ``bucket_rows`` at the engine's defaults and
    ``device_count`` devices on the objects axis), so the census can
    model more devices than the machine has."""
    from kubeadmiral_tpu_torch.scheduler import engine as engine_mod

    geo = {}
    if cell_budget is not None:
        geo["cell_budget"] = int(cell_budget)
    if megachunk_rows is not None:
        geo["megachunk_rows"] = int(megachunk_rows)
    c_bucket, eff_chunk, ladder = engine_mod.tick_geometry(
        n_clusters, max(1, device_count), **geo
    )
    n_chunks = -(-n_objects // eff_chunk)
    # Padding follows bucket_rows: a multi-chunk batch pads every chunk
    # (the tail too) to eff_chunk; one chunk pads to its rung or bucket.
    if n_chunks > 1:
        b_pad_total = n_chunks * eff_chunk
    else:
        b_pad_total = engine_mod.bucket_rows(n_objects, ladder, eff_chunk, False)
    return {
        "c_bucket": c_bucket,
        "eff_chunk": eff_chunk,
        "n_chunks": n_chunks,
        "padded_rows": b_pad_total,
    }


def project(
    n_objects: int,
    n_clusters: int,
    device_count: int = 1,
    score_f16: bool = False,
    sparse_entries: int = 8,
    key_len: int = 64,
    cell_budget: Optional[int] = None,
    megachunk_rows: Optional[int] = None,
) -> dict:
    """Analytic resident-plane inventory at (B, C) on an N-device
    objects mesh, in bytes, per device in the "rows" layout.
    ``sparse_entries`` / ``key_len`` size the compact per-object block
    (bench worlds measure ~8 sparse slots and <=64 key bytes)."""
    geo = _geometry(n_objects, n_clusters, device_count, cell_budget, megachunk_rows)
    rows = geo["padded_rows"]
    cells = rows * geo["c_bucket"]
    sco = "scores_f16" if score_f16 else "scores_i32"
    prev = {
        name: cells * width
        for name, width in _PREV_PLANE_BYTES.items()
        if name not in ("scores_i32", "scores_f16")
    }
    prev["scores"] = cells * _PREV_PLANE_BYTES[sco]
    per_object = rows * (
        _PER_ROW_FIXED
        + sparse_entries * _SPARSE_ENTRY_BYTES
        + key_len * _KEY_BYTE
    )
    tiebreak = 0  # no resident tie-break plane in the port
    vectors = rows * 4 + (rows * 1 if score_f16 else 0)  # nfeas + exactness
    total = sum(prev.values()) + per_object + tiebreak + vectors
    prev_planes = sum(prev.values())
    # Rows-sharded planes divide across the mesh; [B] vectors are booked
    # whole on every device (the JAX model's figure).
    per_device = (total - vectors) // device_count + vectors
    prev_per_device = prev_planes // device_count
    return {
        "n_objects": n_objects,
        "n_clusters": n_clusters,
        "device_count": device_count,
        "layout": "rows",
        "score_dtype": "f16" if score_f16 else "i32",
        "geometry": {
            k: geo[k] for k in ("c_bucket", "eff_chunk", "n_chunks",
                                "padded_rows")
        },
        "by_family": {
            "prev_planes": prev_planes,
            "per_object": per_object,
            "tiebreak": tiebreak,
            "vectors": vectors,
        },
        "prev_plane_split": prev,
        "total": total,
        "per_device": per_device,
        "prev_planes_per_device": prev_per_device,
    }


def validate(n_objects: int = 8192, n_clusters: int = 256, device="cuda", mesh="auto") -> dict:
    """Model-vs-live cross check: schedule a real world at a small shape
    on ``device`` (and ``mesh``), walk the actual device buffers and
    compare them with :func:`project` at the same shape and topology:
    the previous planes in all (the c6-dominant family; per-object is
    workload-shaped), and every lane's previous planes and bytes
    against the model's per-device shares.  Returns the numbers and
    their relative errors (each lane's worst)."""
    import numpy as np

    from kubeadmiral_tpu_torch.scheduler.engine import SchedulerEngine

    rng = np.random.default_rng(20260805)
    units, clusters = _census_world(rng, n_objects, n_clusters)
    eng = SchedulerEngine(device=device, mesh=mesh, flight_recorder=None, devprof=None)
    eng.schedule(units, clusters)
    live = eng.resident_state_bytes()
    model = project(
        n_objects, n_clusters,
        device_count=live["device_count"],
        score_f16=eng.score_f16,
    )

    def err(got, want):
        return abs(got - want) / max(1, got)

    lp, mp = live["by_family"]["prev_planes"], model["by_family"]["prev_planes"]
    md, mt = model["prev_planes_per_device"], model["per_device"]
    lanes = live["prev_planes_by_device"]
    nc = 1 if eng.mesh is None else int(eng.mesh.devices.shape[1])
    want_entry = {label: mt for label in live["by_device"]}
    if nc > 1:
        # Entry (i, j) holds 1/Nc of its lane's planes and a copy of the
        # lane's per-object inputs; (i, 0) also the lane's vectors.
        md //= nc
        planes_share = model["by_family"]["prev_planes"] // (model["device_count"] * nc)
        inputs_share = model["by_family"]["per_object"] // model["device_count"]
        rest = mt - model["prev_planes_per_device"]
        first = {eng.mesh.entry_label(i, 0) for i in range(eng.mesh.devices.shape[0])}
        want_entry = {
            label: planes_share + (rest if label in first else inputs_share)
            for label in live["by_device"]
        }
    e = err(lp, mp)
    e_dev = max((err(v, md) for v in lanes.values()), default=1.0)
    e_lane = max((err(v, want_entry[k]) for k, v in live["by_device"].items()), default=1.0)
    return {
        "shape": f"{n_objects}x{n_clusters}",
        "live": live,
        "model_prev_planes": mp,
        "live_prev_planes": lp,
        "prev_planes_err_pct": round(e * 100.0, 2),
        "model_prev_planes_per_device": md,
        "live_prev_planes_per_device": max(lanes.values(), default=0),
        "live_prev_planes_by_lane": dict(lanes),
        "per_device_err_pct": round(e_dev * 100.0, 2),
        "model_per_device": mt,
        "live_by_lane": dict(live["by_device"]),
        "lane_err_pct": round(e_lane * 100.0, 2),
        "ok": e <= 0.15 and e_dev <= 0.15 and e_lane <= 0.15,
    }


def _census_world(rng, b: int, c: int):
    """A small live world for validate(): the JAX bench's world shape."""
    from kubeadmiral_tpu_torch.models.types import (
        ClusterState, MODE_DIVIDE, SchedulingUnit, parse_resources,
    )

    gvk = "apps/v1/Deployment"
    clusters = [
        ClusterState(
            name=f"member-{j:05d}",
            labels={"region": ("us", "eu", "ap")[j % 3], "tier": str(j % 4)},
            allocatable=parse_resources(
                {"cpu": str(16 + j % 32), "memory": f"{64 + j % 128}Gi"}
            ),
            available=parse_resources(
                {"cpu": str(8 + j % 16), "memory": f"{32 + j % 64}Gi"}
            ),
            api_resources=frozenset({gvk}),
        )
        for j in range(c)
    ]
    units = [
        SchedulingUnit(
            gvk=gvk,
            namespace=f"ns-{i % 97}",
            name=f"workload-{i:06d}",
            scheduling_mode=MODE_DIVIDE if i % 4 else "Duplicate",
            desired_replicas=(i % 50) + 1 if i % 4 else None,
            resource_request=parse_resources(
                {"cpu": f"{(i % 4) * 250}m", "memory": f"{(i % 8) * 256}Mi"}
            ),
            max_clusters=(i % 20) + 1 if i % 5 == 0 else None,
        )
        for i in range(b)
    ]
    return units, clusters


def decide(
    n_objects: int,
    n_clusters: int,
    device_count: int,
    budget_bytes: int = BUDGET_BYTES,
    cell_budget: Optional[int] = None,
    megachunk_rows: Optional[int] = None,
) -> dict:
    """The compress-or-shard decision at (B, C, N) against the budget,
    per device in the "rows" layout:

    * ``fits``      — i32 scores fit per device as-is;
    * ``compress``  — over budget at i32, under with the f16 score plane
                      (``SchedulerEngine(score_f16=True)``);
    * ``shard``     — over budget even compressed, and a larger mesh
                      fits: the verdict carries the minimum
                      objects-axis device count that does (compression
                      engaged), i.e. how much further the mesh must
                      scale out.
    """
    geo = {"cell_budget": cell_budget, "megachunk_rows": megachunk_rows}
    plain = project(n_objects, n_clusters, device_count, score_f16=False, **geo)
    packed = project(n_objects, n_clusters, device_count, score_f16=True, **geo)
    if plain["per_device"] <= budget_bytes:
        verdict, engaged = "fits", plain
    elif packed["per_device"] <= budget_bytes:
        verdict, engaged = "compress", packed
    else:
        verdict, engaged = "shard", packed
    min_devices = device_count
    if verdict == "shard":
        n = device_count
        while n < 4096:
            n *= 2
            if project(n_objects, n_clusters, n, score_f16=True, **geo)[
                "per_device"
            ] <= budget_bytes:
                break
        min_devices = n
    over = engaged["per_device"] > budget_bytes
    return {
        "verdict": verdict,
        "layout": "rows",
        "budget_bytes": budget_bytes,
        "per_device_i32": plain["per_device"],
        "per_device_f16": packed["per_device"],
        "per_device": engaged["per_device"],
        "over_budget": bool(over),
        "min_devices": min_devices,
        "projection": engaged,
        # The next lever if even sharding is unpalatable: the reasons
        # plane's 10 reason bits fit i16 (the flight recorder already
        # stores i16 host-side) — halves another i32 plane.
        "reasons_i16_would_save": engaged["geometry"]["padded_rows"]
        * engaged["geometry"]["c_bucket"] * 2 // device_count,
    }
