"""idle_share.<cell kind>: the device's idle share of the traced window,
1 − (the union of its kernel, copy and memset intervals) / the window,
in % (harness/trace.py)."""
from benchmark.harness import trace as tr


def read(ctx, out, meta):
    s = ctx.trace_summary
    return None if s is None else tr.idle_share(s)
