"""The table of tools/quality_runs.sh's results.

    python -m gbnerf_tpu_torch.tools.quality_table RESULTS [RESULTS ...]

For every run and arm under each RESULTS dir (``<run>/<arm>.metrics.jsonl``):
the last held-out eval (masked, unmasked and full PSNR, four decimals) at
its step, and the median ms a step over the run's i_print records (the
train loop's ``iters_per_sec``); for the prior and LoRA trainers, the
seconds their logs report. Prints a markdown table, then one JSON line.
"""
from __future__ import annotations

import glob
import json
import os
import re
import sys

import numpy as np


def arm_rows(res_dir):
    rows = []
    for path in sorted(glob.glob(os.path.join(res_dir, "*",
                                              "*.metrics.jsonl"))):
        run = os.path.basename(os.path.dirname(path))
        arm = os.path.basename(path).removesuffix(".metrics.jsonl")
        with open(path) as fh:
            recs = [json.loads(line) for line in fh]
        ev = [r for r in recs if "eval_psnr" in r]
        ms = [1e3 / r["iters_per_sec"] for r in recs if r.get("iters_per_sec")]
        row = {"results": res_dir, "run": run, "arm": arm,
               "ms_median": round(float(np.median(ms)), 2) if ms else None,
               "records": len(ms)}
        if ev:
            row["iter"] = ev[-1]["iter"]
            for k in ("eval_psnr_masked", "eval_psnr_unmasked", "eval_psnr"):
                row[k.removeprefix("eval_")] = round(ev[-1][k], 4)
        rows.append(row)
    for path in sorted(glob.glob(os.path.join(res_dir, "*", "*.log"))):
        with open(path, errors="replace") as fh:
            text = fh.read()
        # the prior's "phase B: N UNet steps in S s", the LoRA's "N steps
        # in S s"
        for m in re.finditer(r"^\[(\w+)\] (?:phase (\w): )?(\d+) (?:\w+ )?"
                             r"steps in ([\d.]+) s", text, re.M):
            rows.append({"results": res_dir,
                         "run": os.path.basename(os.path.dirname(path)),
                         "arm": " ".join(x for x in (m[1], m[2]) if x),
                         "steps": int(m[3]), "seconds": float(m[4])})
    return rows


def main(argv=None):
    dirs = sys.argv[1:] if argv is None else argv
    rows = [r for d in dirs for r in arm_rows(d)]
    print("| results | run | arm | masked | unmasked | full | iter | "
          "ms a step | s |")
    print("|---" * 9 + "|")
    for r in rows:
        print("| " + " | ".join(str(r.get(k, "—")) for k in (
            "results", "run", "arm", "psnr_masked", "psnr_unmasked", "psnr",
            "iter", "ms_median", "seconds")) + " |")
    print(json.dumps(rows))
    return rows


if __name__ == "__main__":
    main()
