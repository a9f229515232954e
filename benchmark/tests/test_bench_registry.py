"""A cell, configuration, traffic mix and per-layer metric added as new
files and BENCHMARK.json entries are found by name, no file edited."""

import importlib.util
import json
import shutil

from benchmark import harness


def test_each_metric_file_declares_its_entry():
    """A metric's file names its layer, unit, source and the end-to-end
    metric it moves, as its BENCHMARK.json entry does."""
    for m in harness.load_spec()["per_layer"]:
        path = harness.ROOT / "benchmark" / "metrics" / f"{m['name']}.py"
        spec = importlib.util.spec_from_file_location("metric", path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        assert (mod.LAYER, mod.UNIT, mod.SOURCE, mod.MOVES) == (
            m["layer"], m["unit"], m["source"], m["moves"]), m["name"]


def test_new_files_are_found_by_name(tmp_path):
    root = tmp_path / "checkout"
    shutil.copytree(harness.ROOT / "benchmark", root / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    spec = harness.load_spec()
    before = {p.relative_to(root): p.read_bytes() for p in (root / "benchmark").rglob("*") if p.is_file()}

    cfg = json.loads((root / "benchmark/configs/c3-10kx500.json").read_text())
    cfg["name"] = "c3-tiny"
    cfg["world"].update(objects=600, clusters=40)
    (root / "benchmark/configs/c3-tiny.json").write_text(json.dumps(cfg))
    (root / "benchmark/traffic/churn_drift.json").write_text(
        json.dumps({"churn_share": 0.02, "drift_members": 2}))
    (root / "benchmark/metrics/objects.tick.py").write_text(
        "LAYER = 'engine'\nUNIT = 'objects'\nSOURCE = 'program_counter'\nMOVES = 'tick_ms'\n\n\n"
        "def read(r):\n    return r.per_tick('objects')\n")
    # Counters the harness names nowhere: rows the chunk cache patched and
    # object bytes uploaded a tick.
    (root / "benchmark/metrics/patched_chunks.tick.py").write_text(
        "LAYER = 'engine'\nUNIT = 'chunks'\nSOURCE = 'program_counter'\nMOVES = 'tick_ms'\n\n\n"
        "def read(r):\n    return r.counter('cache_stats.patch')\n")
    (root / "benchmark/metrics/upload_bytes.tick.py").write_text(
        "LAYER = 'engine'\nUNIT = 'B'\nSOURCE = 'program_counter'\nMOVES = 'tick_ms'\n\n\n"
        "def read(r):\n    return r.counter('upload_bytes.object')\n")
    spec["configs"].append({"name": "c3-tiny", "source": "test", "file": "benchmark/configs/c3-tiny.json",
                            "reduced": ["objects", "clusters"], "why": "test"})
    spec["workloads"].append({"name": "c3-tiny.churn_drift", "config": "c3-tiny",
                              "traffic": "churn_drift", "chips": 1, "why": "test"})
    spec["end_to_end"][0]["workloads"].append("c3-tiny.churn_drift")
    for name, unit in (("objects.tick", "objects"), ("patched_chunks.tick", "chunks"),
                       ("upload_bytes.tick", "B")):
        spec["per_layer"].append({"name": name, "unit": unit, "better": "higher",
                                  "source": "program_counter", "layer": "engine", "moves": "tick_ms",
                                  "workloads": ["c3-tiny.churn_drift"]})
    (root / "BENCHMARK.json").write_text(json.dumps(spec))

    for trace in (False, True):
        out = harness.run("c3-tiny.churn_drift", 5, 1.0, trace, device="cpu", root=root,
                          log=lambda msg: None)
        assert out["correct"], out["checks"]
        if trace:
            assert out["metrics"]["objects.tick"]["value"] == 600
            # A churn tick patches the one chunk its rows fall in.
            assert out["metrics"]["patched_chunks.tick"]["value"] > 0
            assert out["metrics"]["upload_bytes.tick"]["value"] > 0
        else:
            assert set(out["metrics"]) == {"tick_ms", "setup_s"}
    after = {p.relative_to(root): p.read_bytes() for p in (root / "benchmark").rglob("*")
             if p.is_file() and "__pycache__" not in p.parts}
    assert {k: v for k, v in after.items() if k in before} == before
