"""mfu.<cell kind>: the model FLOPs of the traced window's steps (or
views), counted on the plain reference at the cell's shapes
(benchmark/counts/), over the traced window's length times the H100's
published bf16 peak (989 TFLOP/s), in %."""
from benchmark.harness import peaks


def read(ctx, out, meta):
    s, flops = ctx.trace_summary, out.get("work", {}).get("flops")
    if s is None or not flops or s["window_s"] <= 0:
        return None
    return 100.0 * flops / (s["window_s"] * peaks.BF16_FLOPS)
