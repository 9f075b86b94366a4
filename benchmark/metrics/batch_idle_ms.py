"""batch_idle_ms.<cell kind>: the ms a step in which the device is idle
while the host is inside the program's spans ``gbnerf.data.batch``
(train/lora_trainer.py::DreamBoothInpaintDataset.batch: PNG decode and
area resize, random masks, captions, instance masks) or
``gbnerf.text.encode`` (guidance/text.py::CLIPTextEncoder.forward)
(harness/spans.py); None where the program opens neither."""
from benchmark.harness import spans


def read(ctx, out, meta):
    at, n = spans.of(ctx), spans.per(out, "steps")
    if at is None or n is None:
        return None
    ms = at.idle_ms(spans.BATCH_SPANS)
    return None if ms is None else ms / n
