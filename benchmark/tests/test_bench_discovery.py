"""The harness finds a configuration, a cell, a traffic mix and a
per-layer metric by name alone: a new cell's files are picked up with no
edit of a file the benchmark has."""
import json
import shutil

from benchmark.harness import common

ROOT = common.ROOT


def test_every_cell_of_benchmark_json_resolves():
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    for w in bench["workloads"]:
        cell, config, kind, params = common.load_cell(w["name"])
        assert cell["config"] == w["config"]
        assert cell["traffic"] == w["traffic"]
        assert cell["chips"] == w["chips"] and cell["why"] == w["why"]
        assert common.traffic_module(kind).run
        assert "limits" in params
        e2e = common.metrics_of(bench, w["name"], trace=False)
        layer = common.metrics_of(bench, w["name"], trace=True)
        assert any(m["name"] == "setup_s" for m in e2e) and len(e2e) >= 2
        assert layer
        for m in layer:
            assert common.metric_path(m["name"]).is_file()
    for c in bench["configs"]:
        assert (ROOT / c["file"]).is_file()
        assert common.config_file(c["name"]) == ROOT / c["file"]


def test_a_new_cell_and_metric_are_found_by_name(tmp_path, monkeypatch):
    copy = tmp_path / "benchmark"
    shutil.copytree(common.BENCH_DIR, copy,
                    ignore=shutil.ignore_patterns("__pycache__"))
    (copy / "traffic" / "view_arc_short.json").write_text(json.dumps(
        {"kind": "views", "params": {"pool": 8, "check_views": 2,
                                     "row_block": 1024, "trace_views": 4}}))
    (copy / "workloads" / "cp_views_short.json").write_text(json.dumps(
        {"config": "spinnerf_cp", "traffic": "view_arc_short", "chips": 1,
         "why": "a test cell", "limits": {"rgb_mean_err": 1.0}}))
    (copy / "metrics" / "launches_per_view.py").write_text(
        "def read(ctx, out, meta):\n    return 1.5\n")
    monkeypatch.setattr(common, "BENCH_DIR", copy)
    cell, config, kind, params = common.load_cell("cp_views_short")
    assert kind == "views" and params["pool"] == 8
    assert params["limits"] == {"rgb_mean_err": 1.0}
    assert config == json.loads(
        (copy / "configs" / "spinnerf_cp.json").read_text())
    assert common.metric_module("launches_per_view.views").read(
        None, None, None) == 1.5
    # a quantity split by cell kind falls back to the quantity's reader
    assert common.metric_path("idle_share.new_kind").name == "idle_share.py"


def test_metrics_of_follows_workloads_keys():
    bench = {"end_to_end": [
        {"name": "a_ms", "workloads": ["x"]}, {"name": "setup_s"}],
        "per_layer": [{"name": "p.x", "moves": "a_ms", "workloads": ["x"]},
                      {"name": "p.any", "moves": "a_ms"},
                      {"name": "p.y", "moves": "b_ms", "workloads": ["y"]}]}
    assert [m["name"] for m in common.metrics_of(bench, "x", False)] == \
        ["a_ms", "setup_s"]
    assert [m["name"] for m in common.metrics_of(bench, "x", True)] == \
        ["p.x", "p.any"]
    assert [m["name"] for m in common.metrics_of(bench, "z", True)] == []
