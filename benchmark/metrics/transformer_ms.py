"""transformer_ms.<cell kind>: the device ms a step of the program's span
``gbnerf.unet.transformer`` (guidance/blocks.py::Transformer2D: a UNet's
spatial transformer, its norm, projections and every block, K7 among
them) and of the backward of what it ran (harness/spans.py); None where
the program opens no such span."""
from benchmark.harness import spans

SPAN = "gbnerf.unet.transformer"


def read(ctx, out, meta):
    return spans.span_device_ms(ctx, out, SPAN)
