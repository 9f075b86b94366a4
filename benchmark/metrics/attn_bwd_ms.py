"""attn_bwd_ms.<cell kind>: the device ms a step of the program's span
``gbnerf.attn.bwd`` (ops/attention.py::_Attend.backward: K7's
re-linearised plain backward, on the autograd thread)
(harness/spans.py); None where the program opens no such span."""
from benchmark.harness import spans

SPAN = "gbnerf.attn.bwd"


def read(ctx, out, meta):
    return spans.span_device_ms(ctx, out, SPAN)
