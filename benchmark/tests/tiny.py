"""Tiny versions of the cells, for the CPU tests: the same traffic kinds,
configurations cut to a size the CPU runs in seconds (the port's plain
paths stand in for its kernels there)."""
from __future__ import annotations

import copy
import time
from pathlib import Path

from benchmark.harness import common

TINY = {
    "spinnerf_cp": {
        "unet": {"block_out_channels": [32, 64, 64, 64],
                 "attention_head_dim": 2, "cross_attention_dim": 32},
        "vae": {"block_out_channels": [16, 16, 32, 32],
                "layers_per_block": 1},
        "text_encoder": {"hidden_size": 32, "intermediate_size": 128,
                         "num_hidden_layers": 2, "num_attention_heads": 2},
        "sd_dtype": "float32",
        "lora": {"rank": 4, "lora_alpha": 4, "train_batch_size": 2,
                 "resolution": 64},
        "scene": {"n_train": 4, "n_test": 1, "H": 24, "W": 32},
        "flags": {"cp_resolutions": "5,9,17", "cp_rank": "4",
                  "chunk": "256"},
    },
    "spinnerf_hash": {
        "scene": {"n_train": 4, "n_test": 1, "H": 24, "W": 32},
        "flags": {"n_levels": "4", "log2_hashmap_size": "10",
                  "N_rand": "64"},
    },
}
PARAMS = {
    "cp_lora": {"n_images": 4, "trace_steps": 1},
    "hash_stage1": {"trace_steps": 2},
    "cp_views": {"pool": 3, "check_views": 2,
                 "row_block": 256, "trace_views": 2},
}


def merged(base: dict, over: dict) -> dict:
    out = copy.deepcopy(base)
    for k, v in over.items():
        out[k] = merged(out[k], v) if isinstance(v, dict) and \
            isinstance(out.get(k), dict) else v
    return out


def context(cell_name: str, seed: int = 7, trace: bool = False,
            seconds: float = 0.3, scratch: Path = None,
            limits: dict = None) -> common.Context:
    import torch

    cell, config, kind, params = common.load_cell(cell_name)
    params = merged(params, PARAMS[cell_name])
    if limits is not None:
        params["limits"] = limits
    config = merged(config, TINY[cell["config"]])
    ctx = common.Context(config=config, params=params, seed=seed,
                         seconds=seconds, trace=trace,
                         device=torch.device("cpu"),
                         t_process=time.perf_counter(), scratch=scratch)
    ctx.kind = kind
    return ctx


def run(cell_name: str, **kw) -> dict:
    ctx = context(cell_name, **kw)
    out = common.traffic_module(ctx.kind).run(ctx)
    out["ctx"] = ctx
    return out
