"""Port vs JAX: the profiling helpers (utils/profiling.py) on the same
inputs, exactly (they compute booleans, counts and host times); the trace
and its summary on the CPU; the three profilers end to end on the CPU at
tiny sizes; and the device rule of every entry point: without a card and
without ``--device cpu`` each exits non-zero with a message naming the
flag, and never falls back to the CPU."""
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gbnerf_tpu.utils.profiling as jprof
import gbnerf_tpu_torch.utils.profiling as tprof
from gbnerf_tpu_torch import run as trun
from gbnerf_tpu_torch.ops import cp_pallas as tcpp
from gbnerf_tpu_torch.tools import (prof_attention, prof_field, prof_guidance,
                                    prof_train)
from gbnerf_tpu_torch.tools import trace_summary

torch.set_num_threads(1)


def _tree(rng, bad):
    a = rng.standard_normal((4, 5)).astype(np.float32)
    b = rng.standard_normal((7,)).astype(np.float32)
    if bad is not None:
        b[3] = bad
    return {"w": a, "nested": [b, {"c": np.arange(3, dtype=np.int32)}]}


def _to(tree, fn):
    if isinstance(tree, dict):
        return {k: _to(v, fn) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to(v, fn) for v in tree]
    return fn(tree)


@pytest.mark.parametrize("bad", [None, np.nan, np.inf, -np.inf])
def test_nan_guard_matches_jax(rng, bad):
    tree = _tree(rng, bad)
    got = tprof.nan_guard(_to(tree, torch.from_numpy))
    ref = jprof.nan_guard(_to(tree, jnp.asarray))
    assert isinstance(got, torch.Tensor) and got.dtype == torch.bool
    assert got.dim() == 0 and bool(got) == bool(ref) == (bad is not None)


def test_nan_guard_ignores_integer_leaves_as_jax_does():
    tree = {"i": np.array([1, 2], np.int64)}
    assert bool(tprof.nan_guard(_to(tree, torch.from_numpy))) is False
    assert bool(jprof.nan_guard(_to(tree, jnp.asarray))) is False


def test_step_timer_matches_jax(monkeypatch):
    """The same clock readings give the same rates, the first (warm-up)
    interval left out of the steady rate."""
    clock = [0.0, 5.0, 5.5, 6.5, 6.75]
    rates = {}
    for name, mod in (("jax", jprof), ("torch", tprof)):
        it = iter(clock)
        monkeypatch.setattr(mod.time, "perf_counter", lambda: next(it))
        timer = mod.StepTimer()
        ticks = [timer.tick(n) for n in (1, 2, 4, 1)]
        rates[name] = (ticks, timer.steady_rate, timer.steps)
        monkeypatch.undo()
    assert rates["torch"] == rates["jax"]
    assert rates["torch"][1] == 7 / 1.75


@pytest.mark.parametrize("value", [0.5, float("nan"), float("inf"),
                                   float("-inf")])
def test_check_metrics_matches_jax(value):
    results = []
    for mod, conv in ((jprof, jnp.asarray), (tprof, torch.tensor)):
        try:
            mod.check_metrics({"loss": conv(1.0), "psnr": conv(value)}, 7)
            results.append(None)
        except FloatingPointError as e:
            results.append(str(e))
    assert results[0] == results[1]
    assert (results[0] is None) == np.isfinite(value)


def test_trace_writes_a_trace_that_the_summary_reads(tmp_path):
    a = torch.randn(64, 64)
    with tprof.trace(str(tmp_path)) as prof:
        for _ in range(3):
            with tprof.annotate("step"):
                (a @ a).relu().sum()
    assert prof is not None
    doc = json.loads((tmp_path / tprof.TRACE_FILE).read_text())
    assert any(e.get("name") == "step" for e in doc["traceEvents"])
    s = trace_summary.summarize(str(tmp_path), n_calls=3, untraced_ms=1e3)
    assert s["device"] == "cpu" and s["busy_ms"] > 0
    assert {"aten::mm", "aten::relu"} <= {k for k, _, _ in s["kinds"]}
    # self times: the parent aten::matmul holds less than its aten::mm
    ms = {k: v for k, v, _ in s["kernels"]}
    assert ms["aten::mm"] > 0 and 0 < s["idle_share"] < 1
    assert sum(ms.values()) == pytest.approx(s["busy_ms"])


def test_annotate_is_a_shared_no_op_unless_a_profiler_records(tmp_path):
    """Without a profiler annotate hands back one shared nullcontext, so no
    record_function is made; under ``trace`` it records the name given."""
    import contextlib

    from torch.profiler import record_function

    off = tprof.annotate(tprof.SPAN_HASH_ENCODE)
    assert off is tprof.annotate("another") is tprof._NO_SPAN
    assert isinstance(off, contextlib.nullcontext)
    assert not isinstance(off, record_function)
    with off, off:                       # reusable and reentrant
        pass
    with tprof.trace(str(tmp_path)):
        on = tprof.annotate("gbnerf.test.span")
        assert isinstance(on, record_function)
        with on:
            torch.ones(3).sum()
    assert tprof.annotate("after") is tprof._NO_SPAN
    doc = json.loads((tmp_path / tprof.TRACE_FILE).read_text())
    assert any(e.get("name") == "gbnerf.test.span"
               for e in doc["traceEvents"])


def _span_case_batch(tmp_path):
    from gbnerf_tpu_torch.train.lora_trainer import DreamBoothInpaintDataset
    from gbnerf_tpu_torch.utils.png import write_png

    rng = np.random.default_rng(0)
    (tmp_path / "img").mkdir()
    (tmp_path / "mask").mkdir()
    for i in range(2):
        write_png(str(tmp_path / "img" / f"{i}.png"),
                  rng.integers(0, 256, (20, 28, 3), dtype=np.uint8))
        write_png(str(tmp_path / "mask" / f"{i}.png"),
                  (rng.random((20, 28)) > 0.5).astype(np.uint8) * 255)
    ds = DreamBoothInpaintDataset(str(tmp_path / "img"),
                                  mask_dir=str(tmp_path / "mask"),
                                  resolution=16, default_caption="a cat")

    def call():
        imgs, masks, caps, imasks = ds.batch(np.random.default_rng(3), 3)
        assert caps == ["a cat"] * 3
        return [imgs, masks, imasks]
    return call


def _write_decode_dir(tmp_path, n=3):
    from gbnerf_tpu_torch.utils.png import write_png

    rng = np.random.default_rng(1)
    d = tmp_path / "decode"
    d.mkdir(exist_ok=True)
    for i in range(n):
        write_png(str(d / f"{i}.png"),
                  rng.integers(0, 256, (18, 22, 3), dtype=np.uint8))
    return d


def _span_case_decode(tmp_path):
    from gbnerf_tpu_torch.train.lora_trainer import DreamBoothInpaintDataset

    d = _write_decode_dir(tmp_path)

    def call():
        ds = DreamBoothInpaintDataset(str(d), resolution=12)
        imgs, masks, caps, imasks = ds.batch(np.random.default_rng(4), 3)
        assert imasks is None and ds.decodes == 3
        return [imgs, masks]
    return call


def _tiny_text():
    from gbnerf_tpu_torch.guidance.text import (CLIPTextConfig,
                                                CLIPTextEncoder)

    torch.manual_seed(0)
    return CLIPTextEncoder(CLIPTextConfig(vocab_size=64, max_length=8,
                                          width=16, layers=1, heads=2))


def _span_case_text(tmp_path):
    text = _tiny_text()
    ids = torch.randint(0, 64, (2, 8), generator=torch.Generator()
                        .manual_seed(1))

    def call():
        with torch.no_grad():
            return [text(ids)]
    return call


def _span_case_lora(tmp_path):
    from gbnerf_tpu_torch.guidance import lora

    text = _tiny_text()
    g = torch.Generator().manual_seed(2)
    ad = {k: (v if k.endswith("lora_A") else torch.randn(v.shape,
                                                         generator=g))
          for k, v in lora.init_lora(text, rank=2, targets=lora.TEXT_TARGETS,
                                     generator=g).items()}
    assert ad

    def call():
        eff = lora.apply_lora(text, ad, alpha=4.0)
        return [eff[k] for k in sorted(eff)]
    return call


def _span_case_attention(tmp_path):
    from gbnerf_tpu_torch.ops import attention

    g = torch.Generator().manual_seed(4)
    q, k, v, dout = (torch.randn(2, 32, 8, generator=g) for _ in range(4))

    def call():
        qq, kk, vv = (x.clone().requires_grad_(True) for x in (q, k, v))
        out = attention._Attend.apply(qq, kk, vv, 0.35)
        grads = torch.autograd.grad(out, (qq, kk, vv), dout)
        return [out.detach(), *grads]
    return call


def _span_case_hash(tmp_path):
    from gbnerf_tpu_torch.core.fields import hash_encode

    g = torch.Generator().manual_seed(5)
    x = torch.rand(40, 3, generator=g)
    table = torch.randn(3, 64, 2, generator=g)

    def call():
        xx, tt = x.clone().requires_grad_(True), \
            table.clone().requires_grad_(True)
        out = hash_encode(xx, tt, base_res=2, per_level_scale=2.0)
        grads = torch.autograd.grad((out * out).sum(), (xx, tt))
        return [out.detach(), *grads]
    return call


def _span_case_resample(tmp_path):
    from gbnerf_tpu_torch.core.render import render_rays

    g = torch.Generator().manual_seed(6)
    w = torch.randn(3, 4, generator=g)
    rays_o = torch.randn(6, 3, generator=g)
    rays_d = torch.nn.functional.normalize(torch.randn(6, 3, generator=g),
                                           dim=-1)

    def field(pts, viewdirs, sigma_only=False):
        return torch.sin(pts @ w)

    def call():
        out = render_rays(field, field, rays_o, rays_d, rays_d,
                          torch.full((6, 1), 0.5), torch.full((6, 1), 3.0),
                          N_samples=16, N_importance=8, perturb=True,
                          generator=torch.Generator().manual_seed(7))
        return [t for t in out if isinstance(t, torch.Tensor)]
    return call


def _tiny_unet(sd_version="1.5"):
    from gbnerf_tpu_torch.guidance.unet import UNet2DCondition, UNetConfig

    torch.manual_seed(0)
    cfg = UNetConfig.sdxl_tiny() if sd_version == "xl" else UNetConfig.tiny()
    return UNet2DCondition(cfg)


def _span_case_transformer(tmp_path):
    unet = _tiny_unet()
    g = torch.Generator().manual_seed(8)
    x = torch.randn(1, 8, 8, 9, generator=g)
    ctx = torch.randn(1, 5, 32, generator=g)

    def call():
        with torch.no_grad():
            return [unet(x, 10.0, ctx)]
    return call


SPAN_CASES = {
    tprof.SPAN_DATA_BATCH: _span_case_batch,
    tprof.SPAN_UNET_TRANSFORMER: _span_case_transformer,
    tprof.SPAN_DATA_DECODE: _span_case_decode,
    tprof.SPAN_TEXT_ENCODE: _span_case_text,
    tprof.SPAN_LORA_APPLY: _span_case_lora,
    tprof.SPAN_ATTN_BWD: _span_case_attention,
    tprof.SPAN_HASH_ENCODE: _span_case_hash,
    tprof.SPAN_RESAMPLE: _span_case_resample,
}


@pytest.mark.parametrize("span", sorted(SPAN_CASES))
def test_hot_path_span_is_traced_and_leaves_outputs_bit_equal(span,
                                                              tmp_path):
    """Each of the port's eight spans shows in a trace of a tiny CPU call of
    its function, and the call's outputs (and gradients) with the profiler
    on are bit-equal to those without it."""
    call = SPAN_CASES[span](tmp_path)
    off = call()
    with tprof.trace(str(tmp_path / "trace")):
        on = call()
    doc = json.loads((tmp_path / "trace" / tprof.TRACE_FILE).read_text())
    names = {e.get("name") for e in doc["traceEvents"]}
    assert span in names
    assert span.startswith("gbnerf.")
    assert len(on) == len(off) > 0
    for a, b in zip(on, off):
        if isinstance(a, torch.Tensor):
            assert a.dtype == b.dtype and torch.equal(a, b)
        else:
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("sd_version", ["1.5", "xl"])
def test_transformer_span_is_one_a_transformer_call(sd_version, tmp_path):
    """Traced, a UNet forward opens ``gbnerf.unet.transformer`` once a
    Transformer2D it runs (SD1.x: one block each; SDXL: its depth of
    blocks inside one span)."""
    from gbnerf_tpu_torch.guidance.blocks import (BasicTransformerBlock,
                                                  Transformer2D)

    unet = _tiny_unet(sd_version)
    cfg = unet.config
    n_tf = sum(isinstance(m, Transformer2D) for m in unet.modules())
    n_blocks = sum(isinstance(m, BasicTransformerBlock)
                   for m in unet.modules())
    # SD1.x tiny: 6 down, 1 mid, 9 up, one block each; SDXL tiny: 4 + 6
    # down, 3 mid, 9 + 6 up blocks in 2 + 2, 1, 3 + 3 transformers
    assert (n_tf, n_blocks) == ((16, 16) if sd_version == "1.5"
                                else (11, 28))
    added = None
    if cfg.addition_embed_type:
        added = {"text_embeds": torch.zeros(1, 16),
                 "time_ids": torch.full((1, 6), 64.0)}
    with tprof.trace(str(tmp_path / "trace")), torch.no_grad():
        unet(torch.zeros(1, 8, 8, 9), 10.0,
             torch.zeros(1, 5, cfg.cross_attention_dim), added)
    doc = json.loads((tmp_path / "trace" / tprof.TRACE_FILE).read_text())
    spans = [e for e in doc["traceEvents"]
             if e.get("name") == tprof.SPAN_UNET_TRANSFORMER
             and e.get("ph") == "X" and e.get("cat") != "gpu_user_annotation"]
    assert len(spans) == n_tf


def test_attention_routing_counter_counts_self_attention_by_route():
    """ops/attention.py's ROUTES: the tiny UNet's self-attention calls (one
    a transformer block, all short: plain) by head width; a long call
    whose length is a multiple of the query tile on the k7 route, another
    on the plain fallback; cross attention is not counted."""
    from gbnerf_tpu_torch.guidance.blocks import BasicTransformerBlock
    from gbnerf_tpu_torch.ops import attention

    unet = _tiny_unet("xl")
    n_blocks = sum(isinstance(m, BasicTransformerBlock)
                   for m in unet.modules())
    attention.ROUTES.clear()
    with torch.no_grad():
        unet(torch.zeros(1, 8, 8, 9), 10.0, torch.zeros(1, 5, 40),
             {"text_embeds": torch.zeros(1, 16),
              "time_ids": torch.full((1, 6), 64.0)})
    assert dict(attention.ROUTES) == {("plain", 8): n_blocks}
    attention.ROUTES.clear()
    q, odd = torch.zeros(1, 2, 1024, 16), torch.zeros(1, 2, 1100, 16)
    attention.self_attention(q, q, q, scale=0.25)           # 1024 % 256 = 0
    attention.self_attention(odd, odd, odd, scale=0.25)     # 1100 % 256 ≠ 0
    attention.self_attention(q, q[:, :, :77], q[:, :, :77], scale=0.25)
    assert dict(attention.ROUTES) == {("k7", 16): 1, ("plain", 16): 1}
    attention.ROUTES.clear()


def test_decode_span_is_at_build_and_in_a_batch_only_on_a_miss(tmp_path):
    """Traced: building the dataset opens one ``gbnerf.data.decode`` a
    file; the batches that follow open none inside ``gbnerf.data.batch``
    until a file is rewritten, whose next batch holds exactly one."""
    from gbnerf_tpu_torch.train.lora_trainer import DreamBoothInpaintDataset
    from gbnerf_tpu_torch.utils.png import write_png

    d = _write_decode_dir(tmp_path)
    rng = np.random.default_rng(2)
    with tprof.trace(str(tmp_path / "trace")):
        ds = DreamBoothInpaintDataset(str(d), resolution=12)
        for _ in range(3):
            ds.batch(rng, 8)
        write_png(str(d / "0.png"), np.zeros((30, 10, 3), np.uint8))
        ds.batch(rng, 16)
    doc = json.loads((tmp_path / "trace" / tprof.TRACE_FILE).read_text())

    def spans(name):
        return sorted((e["ts"], e["ts"] + e["dur"]) for e in
                      doc["traceEvents"]
                      if e.get("name") == name and e.get("ph") == "X")

    decodes, batches = spans(tprof.SPAN_DATA_DECODE), \
        spans(tprof.SPAN_DATA_BATCH)
    assert len(decodes) == 4 and len(batches) == 4 and ds.decodes == 4
    inside = [[s for s in decodes if b0 <= s[0] and s[1] <= b1]
              for b0, b1 in batches]
    assert [len(x) for x in inside] == [0, 0, 0, 1]
    assert all(s[1] <= batches[0][0] for s in decodes[:3])


def test_trace_summary_reads_device_kernels(tmp_path):
    """A trace with device events sums those, not the host's ops: the
    format the profiler exports on a machine with a card."""
    evs = [{"ph": "X", "cat": "cpu_op", "name": "aten::mm", "ts": 0,
            "dur": 50, "pid": 1, "tid": 1},
           {"ph": "X", "cat": "kernel", "name": "void gemm<128, 2>(float*)",
            "ts": 10, "dur": 30, "pid": 0, "tid": 7},
           {"ph": "X", "cat": "kernel", "name": "void gemm<64, 2>(float*)",
            "ts": 45, "dur": 10, "pid": 0, "tid": 7},
           {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy HtoD",
            "ts": 60, "dur": 4, "pid": 0, "tid": 8},
           {"ph": "X", "cat": "kernel", "dur": 0, "ts": 70, "pid": 0,
            "tid": 7, "name": "(anonymous namespace)::k<true>(int)"}]
    (tmp_path / "trace.json").write_text(json.dumps(
        {"traceEvents": evs, "deviceProperties": [{"name": "Card"}]}))
    s = trace_summary.summarize(str(tmp_path / "trace.json"), n_calls=2,
                                untraced_ms=0.1)
    assert s["device"] == "cuda" and s["device_name"] == "Card"
    assert s["busy_ms"] == pytest.approx(0.022) and s["launches"] == 2
    assert s["kinds"][0] == ("gemm", pytest.approx(0.02), 1.0)
    assert s["kinds"][-1][0] == "k"
    assert len(s["kernels"]) == 4 and s["idle_share"] == pytest.approx(0.78)


def test_prof_field_runs_on_the_cpu(capsys):
    lines = prof_field.main(["--device", "cpu", "--rays", "64", "--reps",
                             "1"])
    names = [l["component"] for l in lines]
    assert names == ["full_render", "encode_dense_plain",
                     "encode_dense_kernel", "encode_kr", "mlp_heads",
                     "resample+merge", "raw2outputs_128"]
    printed = [json.loads(l) for l in capsys.readouterr().out.splitlines()]
    assert printed == lines
    assert all(l["device"] == "cpu" and l["ms"] > 0 for l in lines)


def test_encode_kr_computes_the_encode(rng):
    """The profiled KR formulation is the same function: within the bf16
    rounding of its three products' outputs (3 · 2^-8 relative)."""
    x = torch.from_numpy(rng.random((200, 3)).astype(np.float32))
    x[0], x[1] = 0.0, 1.0
    ul = torch.from_numpy(rng.standard_normal((3, 257, 8)).astype(
        np.float32))
    ref = tcpp.encode_plain(x, ul, 257)
    torch.testing.assert_close(prof_field.encode_kr(x, ul), ref,
                               rtol=3 * 2.0 ** -8,
                               atol=1e-6 * float(ref.abs().max()))


def test_prof_train_runs_on_the_cpu(capsys, tmp_path):
    s = prof_train.main(["--device", "cpu", "--rays", "32", "--reps", "2",
                         "--bank", "512", "--proposal", "--out",
                         str(tmp_path)])
    out = capsys.readouterr().out
    assert "traced, loss:" in out and "--- by kernel kind" in out
    assert (tmp_path / "trace.json").is_file()
    assert s["device"] == "cpu" and s["busy_ms"] > 0 and s["step_ms"] > 0
    assert any(k == "_FieldBackward" for k, _, _ in s["kinds"])


def test_prof_guidance_runs_on_the_cpu(capsys):
    lines = prof_guidance.main(["--device", "cpu", "--tiny", "--size", "64",
                                "--reps", "1"])
    assert [l.get("comp", l.get("stage")) for l in lines] == [
        "built", "full_guidance_step_fwd+bwd", "unet_fwd_B3",
        "vae_encode_fwd_B1", "vae_encode_fwd+bwd_B1"]
    assert all(l["device"] == "cpu" for l in lines)
    assert all(l["ms"] > 0 for l in lines[1:])


def _run_argv(tmp_path):
    cfg = tmp_path / "cfg.txt"
    cfg.write_text(f"datadir = {tmp_path}\nbasedir = {tmp_path}\n")
    return ["--config", str(cfg)]


@pytest.mark.parametrize("entry", ["run", "prof_field", "prof_train",
                                   "prof_guidance", "train_lora",
                                   "train_tiny_prior", "run_ablation"])
def test_entry_points_refuse_to_start_without_a_card(monkeypatch, tmp_path,
                                                     entry):
    """No card and no --device cpu: a non-zero exit whose message names the
    flag, before any work (the default is the card, with no fallback)."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    from gbnerf_tpu_torch import train_lora
    from gbnerf_tpu_torch.tools import run_ablation, train_tiny_prior

    main = {"run": trun.main, "prof_field": prof_field.main,
            "prof_train": prof_train.main,
            "prof_guidance": prof_guidance.main,
            "train_lora": train_lora.main,
            "train_tiny_prior": train_tiny_prior.main,
            "run_ablation": run_ablation.main}[entry]
    argv = {"run": _run_argv(tmp_path),
            "train_lora": ["--instance_data_dir", str(tmp_path)],
            "train_tiny_prior": [str(tmp_path / "p.msgpack")],
            "run_ablation": [str(tmp_path / "abl"), "--production",
                             "--colmap", "--lindisp", "--combine", "sds",
                             "--arms", "prior,priorNL"]}.get(entry, [])
    for extra in ([], ["--device", "cuda"], ["--device", "cuda:0"]):
        with pytest.raises(SystemExit) as e:
            main(argv + extra)
        assert isinstance(e.value.code, str) and "--device cpu" in \
            e.value.code


def test_card_only_timers_refuse_the_cpu(monkeypatch):
    """graph_ms (CUDA-graph replay) and prof_attention (K7's plans) need a
    card and say so; they never time the CPU under a device's name."""
    with pytest.raises(ValueError, match="card"):
        tprof.graph_ms(lambda: None, torch.device("cpu"), 2)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="card"):
        prof_attention.main(["--reps", "2"])


def test_prof_field_kernels_refuses_the_cpu(monkeypatch):
    """The field kernels' timer (K1/K2/K4/K5) needs a card and says so."""
    from gbnerf_tpu_torch.tools import prof_field_kernels

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="card"):
        prof_field_kernels.main(["--reps", "2"])


def test_prof_field_bwd_parts_refuses_the_cpu(monkeypatch):
    """The K4/K5 parts timer needs a card and says so, before it builds."""
    from gbnerf_tpu_torch.tools import prof_field_bwd_parts

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="card"):
        prof_field_bwd_parts.main(["--reps", "2"])


def test_prof_field_bwd_parts_copies_take_their_parts_out():
    """Every copy of the parts timer finds its anchors in the committed
    csrc/field_fused_bwd.cu and field_tile.cuh (a source change that moves
    them raises here, not on the card) and differs from the kernel."""
    from gbnerf_tpu_torch.ops._build import CSRC_DIR
    from gbnerf_tpu_torch.tools import prof_field_bwd_parts as parts

    src = {f: (CSRC_DIR / f).read_text() for f in (parts.BWD, parts.TILE)}
    copies = parts.variants(src)
    assert copies["kernel"] == src
    assert set(copies) == {"kernel", *parts.PARTS}
    for name in parts.PARTS:
        assert copies[name] != src, name


def test_prof_field_fwd_parts_refuses_the_cpu(monkeypatch):
    """The K1/K2 parts timer needs a card and says so, before it builds."""
    from gbnerf_tpu_torch.tools import prof_field_fwd_parts

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="card"):
        prof_field_fwd_parts.main(["--reps", "2"])


def test_prof_field_fwd_parts_copies_take_their_parts_out():
    """Every copy of the K1/K2 parts timer finds its anchors in the
    committed csrc/field_fused.cu and differs from the kernel; an anchor
    the source no longer holds as often as the copy says raises. A source
    change that moves an anchor raises here, not on the card."""
    from gbnerf_tpu_torch.ops._build import CSRC_DIR
    from gbnerf_tpu_torch.tools import prof_field_fwd_parts as parts

    src = {parts.FWD: (CSRC_DIR / parts.FWD).read_text()}
    copies = parts.variants(src, parts.PARTS)
    assert copies["kernel"] == src
    assert set(copies) == {"kernel", *parts.PARTS}
    for name in parts.PARTS:
        assert copies[name] != src, name
    with pytest.raises(ValueError, match="no_color"):
        parts.variants(src, {"no_color": parts.PARTS["no_color"]
                             + parts.PARTS["no_color"]})


def test_default_device_raises_without_a_card(monkeypatch):
    from gbnerf_tpu_torch.config import Config
    from gbnerf_tpu_torch.train import loop

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for fn in (loop.default_device, lambda: loop.train(Config()),
               lambda: loop.render_only(Config())):
        with pytest.raises(RuntimeError, match="--device cpu"):
            fn()
    assert loop.device_from_flag("cpu") == torch.device("cpu")
