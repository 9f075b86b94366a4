"""The attribution of the traced window to the program's spans
(harness/spans.py) and its readers, on a chrome trace written here and on
a real CPU profile of a tiny forward and backward."""
import json

import pytest

from benchmark.harness import common, spans
from benchmark.harness import trace as tr

HOST, BWD, DEV = 1, 2, 7
DEVICE_LANE = spans.DEVICE_LANE


def _ev(name, cat, ts, dur, tid=HOST, **args):
    e = {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur,
         "pid": 0 if tid == DEV else 1, "tid": tid}
    if args:
        e["args"] = args
    return e


def _op(name, ts, dur, seq, fwd, tid=HOST):
    return _ev(name, "cpu_op", ts, dur, tid, **{"Sequence number": seq,
                                                "Fwd thread id": fwd})


def _launch(ts, corr, tid=HOST, name="cudaLaunchKernel"):
    return _ev(name, "cuda_runtime", ts, 2, tid, correlation=corr)


def _kernel(name, ts, dur, corr=None, cat="kernel"):
    return _ev(name, cat, ts, dur, DEV,
               **({} if corr is None else {"correlation": corr}))


def _events():
    return [
        _ev(tr.WINDOW, "user_annotation", 0, 1000),
        _ev("bench.step", "user_annotation", 100, 800),
        # the span's forward: the embedding makes node 5 (the detach
        # before it records the number it will take)
        _ev("gbnerf.field.hash_encode", "user_annotation", 110, 90),
        _ev("gbnerf.field.hash_encode", DEVICE_LANE, 300, 40, DEV),
        _op("aten::detach_", 115, 3, 5, 0),
        _op("aten::embedding", 120, 30, 5, 0),
        _launch(125, 1),
        _kernel("gather", 300, 40, 1),
        # after the span: node 6, its kernel and backward not the span's
        _op("aten::mul", 210, 10, 6, 0),
        _launch(212, 2),
        _kernel("mul", 350, 10, 2),
        # the backward, on the autograd thread; its forward thread is the
        # profiler's thread 1, which is trace thread HOST
        _op(spans.BACKWARD + "EmbeddingBackward0", 500, 100, 5, 1, BWD),
        _launch(510, 3, BWD),
        _launch(520, 4, BWD, "cudaMemsetAsync"),
        _kernel("scatter", 610, 40, 3),
        _kernel("Memset (Device)", 605, 7, 4, "gpu_memset"),
        _op(spans.BACKWARD + "MulBackward0", 620, 80, 6, 1, BWD),
        _launch(630, 5, BWD),
        _kernel("mul_bwd", 700, 20, 5),
        # a re-linearised backward's own graph on the autograd thread
        # (profiler thread 2): its node 5 is not the span's node 5
        _op("aten::sin", 515, 2, 5, 0, BWD),
        _op("aten::cos", 530, 2, 9, 0, BWD),
        _op(spans.BACKWARD + "SinBackward0", 720, 10, 5, 2, BWD),
        _launch(722, 6, BWD),
        _kernel("sin_bwd", 750, 10, 6),
        _op(spans.BACKWARD + "CosBackward0", 732, 5, 9, 2, BWD),
        # device work that no host launch of the trace made
        _kernel("orphan", 900, 10, 99),
        _kernel("no_corr", 920, 10),
        # host spans over idle device time
        _ev("gbnerf.data.batch", "user_annotation", 20, 70),
        _ev("gbnerf.text.encode", "user_annotation", 30, 30),
        _ev("gbnerf.text.encode", "user_annotation", 330, 50),
        _ev("gbnerf.data.batch", "user_annotation", 400, 50),
        # syncs: two in the step (one on the autograd thread), a blocking
        # copy, a copy that does not block, and the window's closing sync
        _ev("cudaStreamSynchronize", "cuda_runtime", 800, 10),
        _ev("cudaStreamSynchronize", "cuda_runtime", 640, 5, BWD),
        _ev("cudaMemcpyAsync", "cuda_runtime", 820, 5),
        _ev("cudaMemcpy", "cuda_runtime", 830, 5),
        _ev("cudaDeviceSynchronize", "cuda_runtime", 950, 40),
    ]


@pytest.fixture
def ctx(tmp_path):
    p = tmp_path / "trace.json"
    p.write_text(json.dumps({"traceEvents": _events()}))
    evs = tr.load(str(p))
    c = common.Context(config={}, params={}, seed=0, seconds=0.0, trace=True,
                       device=None, t_process=0.0, scratch=tmp_path)
    c.trace_events, c.trace_summary = evs, tr.summarize(evs)
    return c


def test_span_device_time_takes_its_backward_by_sequence_number(ctx):
    at = spans.of(ctx)
    hosts = at.host_intervals("gbnerf.field.hash_encode")
    assert hosts == [((1, HOST), (110.0, 200.0)),
                     ((1, BWD), (500.0, 600.0))]
    # the gather 40 µs and the scatter with its memset, [605, 650]
    assert at.device_ms("gbnerf.field.hash_encode") == pytest.approx(0.085)
    assert at.device_ms("gbnerf.lora.apply") is None


def test_idle_under_spans_is_split_and_counted_once(ctx):
    at = spans.of(ctx)
    # idle: [0, 300], [340, 350], [360, 605], [650, 700], [720, 750],
    # [760, 900], [910, 920], [930, 1000]; batch ∪ encode on the host:
    # [20, 90] (an encode inside it), [330, 380], [400, 450]
    assert at.idle_ms(("gbnerf.data.batch", "gbnerf.text.encode")) == \
        pytest.approx((70 + 10 + 20 + 50) * 1e-3)
    assert at.idle_ms(("gbnerf.nothing",)) is None


def test_syncs_inside_the_steps_only(ctx):
    at = spans.of(ctx)
    got = sorted((iv[0], n) for _, iv, n in at.step_syncs())
    assert got == [(640.0, "cudaStreamSynchronize"),
                   (800.0, "cudaStreamSynchronize"), (830.0, "cudaMemcpy")]
    assert at.label((1, BWD), (640.0, 645.0)) == \
        "bench.step:" + spans.BACKWARD + "MulBackward0>" + \
        spans.BACKWARD + "MulBackward0"


def test_coverage_is_the_share_launched_from_the_host(ctx, capsys):
    spans.of(ctx)
    assert spans.of(ctx).coverage() == pytest.approx(125 / 145)
    assert capsys.readouterr().err.count("spans coverage: 0.86") == 1


@pytest.mark.parametrize("metric, value", [
    ("hash_encode_ms.stage1", 0.085 / 2),
    ("batch_idle_ms.lora", 0.150 / 2),
    ("syncs_per_step.lora", 3 / 2),
    ("adapter_ms.lora", None),
    ("attn_bwd_ms.lora", None),
    ("resample_ms.views", None),
])
def test_readers(ctx, metric, value):
    """The readers divide by the steps traced; a span the program does
    not open (as the parent's program opens none) reads None, no error."""
    got = common.metric_module(metric).read(ctx, {"work": {"steps": 2}},
                                            {"name": metric})
    assert got == (None if value is None else pytest.approx(value))


def test_readers_without_a_trace_read_none(ctx):
    ctx.trace_events = ctx.trace_summary = None
    for m in ("hash_encode_ms", "batch_idle_ms", "syncs_per_step",
              "resample_ms"):
        assert common.metric_module(m).read(ctx, {"work": {"views": 3}},
                                            {}) is None


def test_a_real_backward_is_found_under_its_forward_span(tmp_path):
    """A CPU profile: the embedding's backward (on the CPU it runs on the
    calling thread; the hand-written trace above has the autograd thread)
    is the span's by its sequence number; the multiply after the span
    and its backward are not."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    table = torch.randn(16, 4, requires_grad=True)
    idx = torch.tensor([1, 3, 3, 7])
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with record_function(tr.WINDOW):
            with record_function("gbnerf.field.hash_encode"):
                feats = torch.nn.functional.embedding(idx, table)
            (feats * 2.0).sum().backward()
    prof.export_chrome_trace(str(tmp_path / "t.json"))
    evs = tr.load(str(tmp_path / "t.json"))
    at = spans.Attribution(evs, tr.window_span(evs))
    hosts = {iv for _, iv in at.host_intervals("gbnerf.field.hash_encode")}

    def bwd(name):
        found = [e for e in evs if e.get("name") == spans.BACKWARD + name]
        assert len(found) == 1, name
        return found[0]
    emb, mul = bwd("EmbeddingBackward0"), bwd("MulBackward0")
    assert (emb["ts"], emb["ts"] + emb["dur"]) in hosts
    assert (mul["ts"], mul["ts"] + mul["dur"]) not in hosts
    assert len(hosts) == 2


def test_the_cli_lists_spans_and_syncs_of_a_kept_trace(tmp_path, capsys):
    import gzip

    path = tmp_path / "kept.json.gz"
    with gzip.open(path, "wt") as fh:
        json.dump({"traceEvents": _events()}, fh)
    assert spans.main([str(path), "--per", "2"]) == 0
    got = json.loads(capsys.readouterr().out)
    assert got["device_ms"]["gbnerf.field.hash_encode"] == \
        pytest.approx(0.0425)
    assert dict(got["kinds_ms"]["gbnerf.field.hash_encode"]) == \
        pytest.approx({"gather": 0.02, "scatter": 0.02, "Memset": 0.0035})
    assert got["spans"]["gbnerf.data.batch"] == 1.0
    assert got["batch_idle_ms"] == pytest.approx(0.075)
    assert got["syncs_per_step"] == 1.5
    assert got["syncs"]["cudaMemcpy @ bench.step"] == 0.5
