"""The FLOP and byte counts of benchmark/counts/ against hand counts at
small shapes."""
import math

import pytest
import torch

from benchmark.counts import nerf as nc
from benchmark.counts import sd
from benchmark.harness import common, peaks


def test_attention_work():
    # q·kᵀ and p·v: 2·N²·D each a head; q, k, v, out once, 2 bytes each
    assert sd.attention_work(2, 8, 4) == (4 * 2 * 8 * 8 * 4, 4 * 2 * 8 * 4 * 2)


def test_long_self_attention_of_the_lora_cell():
    _, c, _, _ = common.load_cell("cp_lora")
    # 64² latents: the 4096-token level (320 ch, 8 heads of 40) and the
    # 1024-token level (640, 80) run 2 down + 3 up transformers each; the
    # VAE's mid block at 64² (512 ch, one head) twice a sample
    assert sd.long_self_attention(c, 4) == [(32, 4096, 40, 5),
                                            (32, 1024, 80, 5),
                                            (4, 4096, 512, 2)]


def test_head_macs_and_field_call():
    assert nc.head_macs(80, True) == 80 * 64 + 64 * 16
    assert nc.head_macs(80, False) == 80 * 64 + 64 * 16 + 31 * 64 \
        + 64 * 64 + 64 * 3
    w = nc.field_call_work(10, 8, 5, False)
    macs = 8 * 64 + 64 * 16 + 31 * 64 + 64 * 64 + 64 * 3
    assert w == {"bf16_flops": 2.0 * 10 * macs, "f32_ops": 10 * 8 * 11.0,
                 "bytes": 10 * (12 + 16 + 64) + 3 * 5 * 8 * 4 + macs * 4.0}
    s = nc.field_call_work(10, 8, 5, True)
    assert s["bytes"] == 10 * 28 + 3 * 5 * 8 * 4 + (8 * 64 + 64 * 16) * 4


class _Cfg:
    class field:
        field_type, cp_resolutions, cp_rank = "cp", (5, 9), 4

    class render:
        N_samples, N_importance = 4, 4

    class train:
        N_rand = 3


def test_view_and_step_work():
    w = nc.view_work(_Cfg, 3, 5, block=8)          # 15 rays, blocks 8 + 7
    feat = 8
    assert w["calls"] == 2
    assert w["flops"] == 2.0 * 15 * (4 * nc.head_macs(feat, True)
                                     + 8 * nc.head_macs(feat, False))
    assert w["k1"]["bytes"] == sum(
        nc.field_call_work(n * 8, feat, 9, False)["bytes"] for n in (8, 7))
    assert nc.stage1_step_flops(None, _Cfg) == \
        3 * 2.0 * (3 * 3 * 12) * nc.head_macs(feat, False)


def test_flop_counter_convention():
    # two FLOPs a multiply-add, as the published peaks count them
    from torch.utils.flop_counter import FlopCounterMode

    with torch.device("meta"):
        lin = torch.nn.Linear(8, 16, bias=False)
        with FlopCounterMode(display=False) as fc:
            lin(torch.zeros(4, 8))
    assert fc.get_total_flops() == 2 * 4 * 8 * 16


def test_roofline():
    assert peaks.roofline_s(989e12, 0) == pytest.approx(1.0)
    assert peaks.roofline_s(0, 3.35e12) == pytest.approx(1.0)
    assert math.isclose(peaks.roofline_s(1e12, 1e12),
                        max(1e12 / 989e12, 1e12 / 3.35e12))
