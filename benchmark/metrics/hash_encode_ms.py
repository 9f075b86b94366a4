"""hash_encode_ms.<cell kind>: the device ms a step of the program's span
``gbnerf.field.hash_encode`` (core/fields.py::hash_encode: the index
math, the table's gather and the trilinear sum) and of its backward, the
table's scatter-add among it (harness/spans.py); None where the program
opens no such span."""
from benchmark.harness import spans

SPAN = "gbnerf.field.hash_encode"


def read(ctx, out, meta):
    return spans.span_device_ms(ctx, out, SPAN)
