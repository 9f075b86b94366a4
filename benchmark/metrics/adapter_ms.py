"""adapter_ms.<cell kind>: the device ms a step of the program's span
``gbnerf.lora.apply`` (guidance/lora.py::apply_lora: the A·B merges and
W + s·Δ of every adapted kernel) and of the backward of what it ran
(harness/spans.py); None where the program opens no such span."""
from benchmark.harness import spans

SPAN = "gbnerf.lora.apply"


def read(ctx, out, meta):
    return spans.span_device_ms(ctx, out, SPAN)
