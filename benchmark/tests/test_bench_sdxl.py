"""The sdxl_lora cell at a size the CPU holds (the SDXL topology at tiny
widths, the port's plain paths for its kernels), against the cell's own
limits: a sound run is correct; the faults and the control (the reference
in fp8 put in the program's place) are not. And counts/sdxl.py's K7 calls
at the cell's own shapes against the reference's modules walked on the
meta device."""
import time

import pytest
import torch

from benchmark.counts import sd as sd_counts
from benchmark.counts import sdxl
from benchmark.harness import checks as ck
from benchmark.harness import common, faults
from benchmark.reference import sd as ref_sd
from benchmark.reference import sdxl as ref
from benchmark.tests import tiny

CELL = "sdxl_lora"
TINY = {
    "unet": {"block_out_channels": [32, 64, 96],
             "attention_head_dim": [4, 8, 12],
             "transformer_layers_per_block": [1, 2, 3],
             "cross_attention_dim": 40, "addition_time_embed_dim": 8,
             "projection_class_embeddings_input_dim": 16 + 6 * 8},
    "vae": {"block_out_channels": [16, 16, 32, 32], "layers_per_block": 1},
    "text_encoder": {"hidden_size": 16, "intermediate_size": 64,
                     "num_hidden_layers": 2, "num_attention_heads": 2},
    "text_encoder_2": {"hidden_size": 24, "intermediate_size": 96,
                       "num_hidden_layers": 2, "num_attention_heads": 2,
                       "projection_dim": 16},
    "sd_dtype": "float32",
    "lora": {"rank": 4, "lora_alpha": 4, "train_batch_size": 2,
             "resolution": 64, "time_ids": [64, 64, 0, 0, 64, 64]},
}
PARAMS = {"n_images": 4, "trace_steps": 1}


def context(tmp_path, seed=7):
    cell, config, kind, params = common.load_cell(CELL)
    ctx = common.Context(config=tiny.merged(config, TINY),
                         params=tiny.merged(params, PARAMS), seed=seed,
                         seconds=0.3, trace=False,
                         device=torch.device("cpu"),
                         t_process=time.perf_counter(), scratch=tmp_path)
    ctx.kind = kind
    return ctx


def run(tmp_path):
    ctx = context(tmp_path)
    return common.traffic_module(ctx.kind).run(ctx)


def test_sound_run_is_correct(tmp_path):
    out = run(tmp_path)
    assert ck.all_within(out["checks"]), out["checks"]
    assert out["attempted"] > 0 and out["failed"] == 0
    # the tiny stack's self-attention is short: every call plain, at the
    # UNet's one head width (8) and the VAE's (32)
    assert set(out["readings"]["routes"]) == {"plain/8", "plain/32"}


@pytest.mark.parametrize("fault", ["unchanged", "half_batch"])
def test_fault_is_not_correct(fault, tmp_path):
    with faults.planted(fault):
        out = run(tmp_path)
    assert not ck.all_within(out["checks"]), out["checks"]


def test_control_is_not_correct(tmp_path):
    ctx = context(tmp_path)
    checks, _ = common.traffic_module(ctx.kind).control(ctx)
    assert not ck.all_within(checks), checks


def test_k7_calls_match_the_reference_modules(monkeypatch):
    """Walk the reference's UNet and VAE encoder at the cell's shapes on
    the meta device, recording every self-attention call of ≥ LONG
    tokens."""
    _, c, _, _ = common.load_cell(CELL)
    L = c["lora"]
    B, res = L["train_batch_size"], L["resolution"]
    seen = {}
    plain = ref_sd.attention

    def attention(q, k, v, scale):
        n, d = q.shape[-2], q.shape[-1]
        if k.shape[-2] == n and n >= sd_counts.LONG:
            key = (q[..., 0, 0].numel(), n, d)
            seen[key] = seen.get(key, 0) + 1
        return plain(q, k, v, scale)

    monkeypatch.setattr(ref_sd, "attention", attention)
    lat = res // 8
    with torch.device("meta"), torch.no_grad():
        unet, vae = ref.UNet(c["unet"]), ref.VAE(c["vae"])
        unet(torch.zeros(B, lat, lat, 9), torch.zeros(B),
             torch.zeros(B, 77, c["unet"]["cross_attention_dim"]),
             torch.zeros(B, c["text_encoder_2"]["projection_dim"]),
             torch.zeros(B, 6))
        for _ in range(2):              # the image's and the masked image's
            ref.encode(vae, torch.zeros(B, res, res, 3),
                       torch.zeros(B, lat, lat, 4), 0.13025)
    want = sorted((bh, n, d, calls) for (bh, n, d), calls in seen.items())
    assert sorted(sdxl.long_self_attention(c, B)) == want
    # the published widths: 10 blocks at 64² latents (10 heads of 64 a
    # sample), 60 at 32² (20 of 64), the VAE's mid block at 128²
    assert want == [(B, 16384, 512, 2), (10 * B, 4096, 64, 10),
                    (20 * B, 1024, 64, 60)]
