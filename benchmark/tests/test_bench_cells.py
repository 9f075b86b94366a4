"""Each cell's run at a size the CPU holds (tests/tiny.py: the same
traffic kinds, the port's plain paths for its kernels), against the
cell's own limits: a sound run is correct; the control (the reference in
the next lower precision put in the program's place) and each fault the
cell can have (harness/faults.py) are not."""
import pytest

from benchmark.harness import checks as ck
from benchmark.harness import common, faults
from benchmark.tests import tiny

FAULTS = {"cp_lora": ("unchanged", "half_batch"),
          "hash_stage1": ("unchanged", "half_batch"),
          "cp_views": ("altered",)}


@pytest.mark.parametrize("cell", sorted(FAULTS))
def test_sound_run_is_correct(cell, tmp_path):
    out = tiny.run(cell, scratch=tmp_path)
    assert ck.all_within(out["checks"]), out["checks"]
    assert out["attempted"] > 0 and out["failed"] == 0


@pytest.mark.parametrize("cell,fault", [(c, f) for c in sorted(FAULTS)
                                        for f in FAULTS[c]])
def test_fault_is_not_correct(cell, fault, tmp_path):
    with faults.planted(fault):
        out = tiny.run(cell, scratch=tmp_path)
    assert not ck.all_within(out["checks"]), out["checks"]


@pytest.mark.parametrize("cell", ["cp_lora", "cp_views"])
def test_control_is_not_correct(cell, tmp_path):
    ctx = tiny.context(cell, scratch=tmp_path)
    checks, _ = common.traffic_module(ctx.kind).control(ctx)
    assert not ck.all_within(checks), checks


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("TF32 exists only on the card")
    return torch.device("cuda:0")


@pytest.mark.cuda
@pytest.mark.parametrize("seed", [7, 8, 9])
def test_stage1_control_is_not_correct(card, seed, tmp_path):
    # at the cell's own size: the card holds it
    cell, config, kind, params = common.load_cell("hash_stage1")
    ctx = common.Context(config=config, params=params, seed=seed,
                         seconds=1.0, trace=False, device=card,
                         t_process=0.0, scratch=tmp_path)
    checks, _ = common.traffic_module(kind).control(ctx)
    assert not ck.all_within(checks), checks
