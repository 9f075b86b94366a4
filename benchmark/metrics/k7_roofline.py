"""k7_roofline.<cell kind>: K7's (csrc/attention.cu) share of its
roofline, in %: the least time the H100's published peaks allow for the
long self-attention calls of the traced steps (counts/sd.py: the larger
of their FLOPs over 989 TFLOP/s and their bytes over 3.35 TB/s, call by
call) over the device time of K7's kernels (the forward and the merge of
a key split) in the traced window."""
from benchmark.harness import peaks
from benchmark.harness import trace as tr

KERNELS = r"attn_fwd_wg|attn_fwd_wide|attn_merge"


def read(ctx, out, meta):
    calls = out.get("work", {}).get("k7_calls")
    if ctx.trace_summary is None or not calls:
        return None
    from benchmark.counts.sd import attention_work

    steps = out["work"]["steps"]
    bound = sum(n_calls * peaks.roofline_s(*attention_work(bh, n, d))
                for bh, n, d, n_calls in calls) * steps
    t = tr.kernel_seconds(ctx.trace_events, ctx.trace_summary["span"],
                          KERNELS)
    return None if t <= 0 else 100.0 * bound / t
