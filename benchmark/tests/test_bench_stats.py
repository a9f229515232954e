"""The yardstick's arithmetic gives known answers on synthetic inputs."""

import numpy as np
import pytest

from benchmark.reference.planes import Block, Clusters, Memo
from benchmark.yardstick import devtrace, roofline, stats
from benchmark.yardstick.readings import Readings

PHASE1 = r"\b(columns_kernel|phase1_kernel)\b"


def test_percentile_is_a_measured_value():
    vals = list(range(1, 101))
    assert stats.percentile(vals, 95) == 95
    assert stats.percentile(vals, 50) == 50
    assert stats.percentile([3.0], 95) == 3.0
    assert stats.percentile([5, 1, 4, 2, 3], 95) == 5
    with pytest.raises(ValueError):
        stats.percentile([], 95)


def test_rate_and_spread():
    assert stats.rate(10_000, 0.5) == 20_000
    with pytest.raises(ValueError):
        stats.rate(1, 0)
    # quartiles 2.25 and 6.75 (statistics' exclusive method) about a median of 4.5
    assert stats.spread([1, 2, 3, 4, 5, 6, 7, 8]) == pytest.approx(1.0)


def test_union_and_gaps():
    iv = [(0, 2), (1, 3), (5, 6), (9, 12)]
    assert stats.union_length(iv, 0, 10) == 3 + 1 + 1
    assert stats.gaps(iv, 0, 10) == [(3, 5), (6, 9)]
    assert stats.gaps([], 0, 4) == [(0, 4)]


def event(cat, name, ts, dur):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}


def test_device_trace_busy_idle_and_breakdown():
    events = [
        event("kernel", "void phase1_kernel<4, true, false>(Args)", 10, 20),
        event("kernel", "columns_kernel(Args)", 5, 5),
        event("kernel", "void at::native::sort_kernel<long>(at::native::(anonymous namespace)::Args)", 25, 15),
        event("gpu_memcpy", "Memcpy DtoH (Device -> Pinned)", 150, 10),
        event("gpu_user_annotation", "tick", 0, 200),  # not device work
        event("cpu_op", "aten::copy_", 0, 200),  # not traced, ignored
        event("cuda_runtime", "cudaLaunchKernel", 0, 4),
        event("cuda_runtime", "cudaStreamSynchronize", 60, 85),
        event("cuda_runtime", "cudaMemcpyAsync", 149, 3),
        event("cuda_runtime", "cudaLaunchKernel", 195, 5),
    ]
    t = devtrace.DeviceTrace(events, ticks=2, window_s=250e-6)
    # busy: [5, 40) and [150, 160)
    assert t.busy_s == pytest.approx(45e-6)
    r = Readings([], t)
    assert r.idle_pct() == pytest.approx(100 * (1 - 45 / 250))
    assert r.traced_device_ms(PHASE1) == pytest.approx(25e-3 / 2)
    assert r.traced_device_ms(PHASE1, matching=False) == pytest.approx(25e-3 / 2)
    bd = t.breakdown()
    assert bd["device_ops"][0] == ["phase1_kernel<4, true, false>(Args)", pytest.approx(20e-6)]
    assert ["sort_kernel<long>(Args)", pytest.approx(15e-6)] in bd["device_ops"]
    # gaps inside [0, 200): [0, 5), [40, 150), [160, 200)
    assert bd["idle_gaps"] == [["cudaStreamSynchronize", pytest.approx(110e-6)],
                               [devtrace.NO_CALL, pytest.approx(40e-6)],
                               ["cudaLaunchKernel", pytest.approx(5e-6)]]


def test_readings_without_a_device_are_silent():
    r = Readings([{"timings": {"decode": 0.0, "featurize": 0.002}, "objects": 5, "wall_s": 0.1,
                   "counters": {"fetch_bytes_total": 30, "phase1.launches": 4},
                   "deltas": {"fetch_bytes_total": 10, "phase1.launches": 1}},
                  {"timings": {"decode": 0.0, "featurize": 0.004}, "objects": 5, "wall_s": 0.3,
                   "counters": {"fetch_bytes_total": 60, "phase1.launches": 4},
                   "deltas": {"fetch_bytes_total": 30, "phase1.launches": 0}}])
    assert r.stage_ms("decode") is None
    assert r.stage_ms("featurize") == pytest.approx(3.0)
    assert r.per_tick("wall_s") == pytest.approx(0.2)
    assert r.counter("phase1.launches") == 0.5
    assert r.counter("fetch_bytes_total") == 20
    assert r.gauge("fetch_bytes_total") == 45
    assert r.counter("no_such_counter") is None and r.gauge("no_such_counter") is None
    assert r.idle_pct() is None and r.traced_device_ms(PHASE1) is None
    assert r.phase1_bound_ms() is None


def test_roofline_counts_known_work():
    """One cluster, two rows: the byte and operation counts by hand."""
    clusters = [{"name": "m0", "labels": {}, "taints": [], "alloc": {"cpu": 4000, "memory": 8 << 30},
                 "avail": {"cpu": 2000, "memory": 4 << 30}, "api": ["apps/v1/Deployment"]}]
    base = {"gvk": "apps/v1/Deployment", "namespace": "n", "mode": "Divide", "replicas": 3,
            "tolerations": [], "affinity": None, "max_clusters": None, "avoid_disruption": False,
            "capacity": None, "scores": ["ClusterResourcesMostAllocated"]}
    units = [dict(base, name="a", request={"cpu": 1000, "memory": 1 << 30}),
             dict(base, name="b", request={"cpu": 0, "memory": 0})]
    cl = Clusters(clusters)
    w = roofline.block_work(Block(units, cl, Memo(cl)))
    assert w["feasible"] == 2 and w["fit_cells"] == 1
    assert w["scored"] == [0, 0, 0, 0, 2]
    # most: two resources a row, each kept (alloc != 0, req <= alloc), quotient
    # small; the memory ones divide by 8 GiB, past 2^30
    assert (w["div_short"], w["div_short64"], w["div_exact"]) == (4, 2, 0)
    b = roofline.bound(w)
    r = 2
    nbytes = 2 * (11 + 8 * r) + 4 * 2 + 2 + 1 + 2 * 8 * r + 4 * 2 + 13 * 2
    assert b["bytes"] == nbytes
    ops = 10 * 2 + 2 * 10 + 5 * r * 1 + 4 * 2 + 20 * 2 + 2 * 2 + 13 * 2 + 20 * 2
    assert b["int_ops"] == ops
    assert b["bound_ms"] == pytest.approx(max(nbytes / roofline.HBM_BYTES_PER_S, ops / roofline.INT32_OPS_PER_S,
                                              8 / roofline.CONV_OPS_PER_S) * 1e3)
    assert roofline.add([w, w])["cells"] == 4


def test_roofline_share_of_a_known_time():
    r = Readings([])
    r.trace = devtrace.DeviceTrace([event("kernel", "phase1_kernel", 0, 500)], ticks=1, window_s=1e-3)
    r.traced_worlds = [(None, None)]
    r.phase1_bound_ms = lambda: 0.125
    from benchmark import harness

    read = harness.load_metric("phase1_roofline.revalidate")
    assert read(r) == pytest.approx(100 * 0.125 / 0.5)
    assert np.isfinite(read(r))


def test_collector_pauses_are_counted_by_generation():
    import gc

    from benchmark.harness import GcPauses

    with GcPauses() as pauses:
        gc.collect()
    gc.collect()
    assert pauses.count == [0, 0, 1] and pauses.seconds[2] > 0
    assert str(pauses).startswith("gen0 0 passes")
