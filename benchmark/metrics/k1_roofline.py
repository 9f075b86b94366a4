"""k1_roofline.<cell kind>: K1's (csrc/field_fused.cu, the full field's
forward: field_fused_kernel<false, ...>) share of its roofline, in %: the
least time the H100's published peaks allow for the fine pass's points of
the traced views (counts/field.py, chip_smoke.py's kernel_bound: the
largest of the heads' bf16 FLOPs over 989 TFLOP/s, the encode's f32
operations over 67 TFLOP/s and the bytes over 3.35 TB/s) over K1's device
time in the traced window."""
from benchmark.harness import peaks
from benchmark.harness import trace as tr

KERNEL = r"field_fused_kernel<false"


def read(ctx, out, meta):
    w = out.get("work", {}).get("k1")
    if ctx.trace_summary is None or not w:
        return None
    bound = max(w["bf16_flops"] / peaks.BF16_FLOPS,
                w["f32_ops"] / peaks.F32_FLOPS,
                w["bytes"] / peaks.HBM_BYTES_PER_S)
    t = tr.kernel_seconds(ctx.trace_events, ctx.trace_summary["span"],
                          KERNEL)
    return None if t <= 0 else 100.0 * bound / t
