"""The readings that a cell's limits are set from, on the card at the
cell's own size: the program's numbers compared (each seed a full run of
the traffic kind with a short window) and the control's (the reference in
the lower precision put in the program's place), in one process.

    python3 benchmark/tools/calibrate.py --workload cp_lora \
        --seeds 11,12,13 --control-seeds 11,12,13 --seconds 2 \
        [--out chiprun_out/calib]

Prints one JSON line a reading and writes them to OUT/<cell>.jsonl.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import os
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
sys.path[:] = [str(ROOT)] + [p for p in sys.path
                             if Path(p or ".").resolve() != Path(__file__)
                             .resolve().parent]
os.environ.setdefault("USE_FLAX", "0")

from benchmark.harness import common, faults  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--witness-seeds", default="",
                    help="seeds of the witness: the reference rounded to "
                    "the configuration's own precision")
    ap.add_argument("--witness", default="bf16")
    ap.add_argument("--fault", default=None,
                    help="plant this fault (harness/faults.py) under the "
                    "program's runs")
    ap.add_argument("--seconds", type=float, default=2.0)
    ap.add_argument("--out", default="chiprun_out/calib")
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("calibrate needs a CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda:0")
    _, config, kind_name, params = common.load_cell(args.workload)
    kind = common.traffic_module(kind_name)
    os.makedirs(args.out, exist_ok=True)
    sink = open(os.path.join(args.out, f"{args.workload}.jsonl"), "a")
    common.card_state("at the start")

    def emit(rec):
        line = json.dumps(rec)
        print(line, flush=True)
        sink.write(line + "\n")
        sink.flush()

    def ctx_for(seed):
        scratch = Path(os.environ.get("TMPDIR") or "/tmp") / \
            f"gbnerf_calib_{seed}"
        scratch.mkdir(parents=True, exist_ok=True)
        return common.Context(config=config, params=params, seed=seed,
                              seconds=args.seconds, trace=False, device=dev,
                              t_process=time.perf_counter(), scratch=scratch)

    for s in [int(x) for x in args.seeds.split(",") if x]:
        ctx = ctx_for(s)
        t0 = time.perf_counter()
        with (faults.planted(args.fault) if args.fault
              else contextlib.nullcontext()):
            out = kind.run(ctx)
        emit({"cell": args.workload, "seed": s,
              "side": f"fault {args.fault}" if args.fault else "program",
              "end_to_end": out["end_to_end"], "setup_s": ctx.setup_s,
              "seconds": time.perf_counter() - t0,
              "readings": out.get("readings")})
        torch.cuda.empty_cache()
    for side, seeds, prec in (("control", args.control_seeds, None),
                              ("witness", args.witness_seeds, args.witness)):
        for s in [int(x) for x in seeds.split(",") if x]:
            ctx = ctx_for(s)
            t0 = time.perf_counter()
            _, readings = (kind.control(ctx) if prec is None
                           else kind.control(ctx, precision=prec))
            emit({"cell": args.workload, "side": side, "seed": s,
                  "precision": prec, "seconds": time.perf_counter() - t0,
                  "readings": readings})
            torch.cuda.empty_cache()
    common.card_state("at the end")
    return 0


if __name__ == "__main__":
    sys.exit(main())
