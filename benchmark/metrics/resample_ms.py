"""resample_ms.<cell kind>: the device ms a view of the program's span
``gbnerf.render.resample`` (core/render.py::render_rays: the fine
samples' draw and their merge, K3) (harness/spans.py); None where the
program opens no such span."""
from benchmark.harness import spans

SPAN = "gbnerf.render.resample"


def read(ctx, out, meta):
    return spans.span_device_ms(ctx, out, SPAN, key="views")
