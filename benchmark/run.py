"""The benchmark of gbnerf_tpu_torch on NVIDIA GPUs.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

run from the root of a checkout. The cell is benchmark/workloads/<cell>.json;
it names its configuration (benchmark/configs/<config>.json) and its
traffic mix (benchmark/traffic/<mix>.json), whose kind
(benchmark/traffic/<kind>.py) builds the inputs from the seed, runs the
port's entry through the timed window and compares what it produced
with the plain reference (benchmark/reference/). With --trace 0 the
result carries the cell's end-to-end metrics, with --trace 1 its
per-layer metrics, each read by benchmark/metrics/<metric>.py from the
traced window. The last line of standard output is the result, a JSON
object; the numbers compared with the reference are printed beside their
limits as the last lines of standard error too.

The run exits with 2 and prints no result without as many CUDA devices as
the cell asks for, and with 3 if a JAX module was loaded.
"""
from __future__ import annotations

import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import shutil  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
sys.path[:] = [str(ROOT)] + [p for p in sys.path
                             if Path(p or ".").resolve() != ROOT / "benchmark"]
# the program's build and kernel caches, at fixed paths inside the checkout
os.environ.setdefault("TORCH_EXTENSIONS_DIR",
                      str(ROOT / "build" / "torch_extensions"))
os.environ.setdefault("TRITON_CACHE_DIR", str(ROOT / "build" / "triton"))
os.environ.setdefault("USE_FLAX", "0")

from benchmark.harness import checks as ck  # noqa: E402
from benchmark.harness import common  # noqa: E402


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--keep-trace", default=None,
                    help="also write the traced window's chrome trace, "
                    "gzipped, to this path")
    return ap.parse_args(argv)


def per_layer(ctx, out: dict, wanted) -> dict:
    """{metric: {value, unit}} of the per-layer readers that found
    something to read."""
    got = {}
    for m in wanted:
        v = common.metric_module(m["name"]).read(ctx, out, m)
        if v is not None:
            got[m["name"]] = {"value": v, "unit": m["unit"]}
    return got


def main(argv=None) -> int:
    args = parse_args(argv)
    bench = common.load_json(ROOT / "BENCHMARK.json")
    cell, config, kind, params = common.load_cell(args.workload)

    import torch

    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < int(cell["chips"]):
        print(f"{args.workload} needs {cell['chips']} CUDA device(s); "
              f"found {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    dev = torch.device("cuda:0")
    common.card_state("at the start")
    scratch = Path(os.environ.get("TMPDIR") or "/tmp") / \
        f"gbnerf_bench_{os.getpid()}"
    scratch.mkdir(parents=True, exist_ok=True)
    ctx = common.Context(config=config, params=params, seed=args.seed,
                         seconds=args.seconds, trace=bool(args.trace),
                         device=dev, t_process=T_PROCESS, scratch=scratch)
    ctx.keep_trace = args.keep_trace
    try:
        out = common.traffic_module(kind).run(ctx)
        wanted = common.metrics_of(bench, args.workload, bool(args.trace))
        if args.trace:
            metrics = per_layer(ctx, out, wanted)
        else:
            metrics = {m["name"]: {"value": out["end_to_end"][m["name"]],
                                   "unit": m["unit"]}
                       for m in wanted if m["name"] != "setup_s"}
            metrics["setup_s"] = {"value": ctx.setup_s, "unit": "s"}
    finally:
        shutil.rmtree(scratch, ignore_errors=True)
    found = common.forbidden_modules()
    if found:
        print(f"JAX modules were loaded: {found}", file=sys.stderr)
        return 3
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(dev),
              "count": int(cell["chips"]),
              "memory_peak_bytes": ctx.memory_peak}
    breakdown = None
    if args.trace:
        s = ctx.trace_summary
        device.update(busy_s=s["busy_s"], window_s=s["window_s"])
        breakdown = s["breakdown"]
    checks = out["checks"]
    correct = ck.all_within(checks)
    print(f"readings: {json.dumps(out.get('readings', {}))}",
          file=sys.stderr)
    for name, v, lim in checks:
        print(f"check {name}: {v!r} (limit {lim!r})", file=sys.stderr)
    print(common.result_line(correct=correct, attempted=out["attempted"],
                             failed=out["failed"], metrics=metrics,
                             device=device, checks=checks,
                             breakdown=breakdown), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
