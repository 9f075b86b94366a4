"""The idle-share, launch and breakdown arithmetic on a small chrome trace
written here."""
import json

import pytest

from benchmark.harness import trace as tr


def _ev(name, cat, ts, dur):
    return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur,
            "pid": 1, "tid": 1}


@pytest.fixture
def trace_file(tmp_path):
    evs = [_ev(tr.WINDOW, "user_annotation", 0, 100),
           _ev("void k1<1>(float*)", "kernel", 10, 20),
           _ev("void k1<2>(float*)", "kernel", 20, 20),       # overlaps
           _ev("Memcpy DtoH", "gpu_memcpy", 50, 10),
           _ev("k2", "kernel", 90, 20),                       # crosses the end
           _ev("k3", "kernel", 120, 10),                      # outside
           _ev("bench.step", "user_annotation", 55, 40),
           _ev("aten::mm", "cpu_op", 70, 10),
           {"ph": "i", "name": "marker", "ts": 5}]
    p = tmp_path / "trace.json"
    p.write_text(json.dumps({"traceEvents": evs}))
    return p


def test_busy_idle_and_launches(trace_file):
    evs = tr.load(str(trace_file))
    s = tr.summarize(evs)
    assert s["span"] == (0.0, 100.0)
    # union within the window: [10, 40] + [50, 60] + [90, 100]
    assert s["busy_s"] == pytest.approx(50e-6)
    assert s["window_s"] == pytest.approx(100e-6)
    assert tr.idle_share(s) == pytest.approx(50.0)
    assert s["launches"] == 4
    assert tr.kernel_seconds(evs, s["span"], r"k1<") == pytest.approx(40e-6)


def test_breakdown(trace_file):
    s = tr.summarize(tr.load(str(trace_file)))
    ops = dict(s["breakdown"]["device_ops"])
    assert ops["k1"] == pytest.approx(40e-6)
    assert ops["k2"] == pytest.approx(20e-6)
    gaps = s["breakdown"]["idle_gaps"]
    assert gaps[0] == ["bench.step:aten::mm", pytest.approx(30e-6)]
    assert [g[1] for g in gaps] == pytest.approx([30e-6, 10e-6, 10e-6])
