"""Faults planted under the port, for the calibration on the card and the
CPU tests: each must make ``correct`` come out false.

- ``unchanged``: the optimizer's step returns the state unchanged;
- ``half_batch``: half of each batch left out, the loss the mean over the
  rest (the LoRA step's samples; the stage-1 step's rays of each stream);
- ``altered``: each view's rgb map altered where it is produced.
"""
from __future__ import annotations

import contextlib


@contextlib.contextmanager
def planted(name: str):
    import torch

    from gbnerf_tpu_torch.train import lora_trainer as lt
    from gbnerf_tpu_torch.train import step as st

    saved = []
    missing = object()

    def patch(obj, attr, value):
        # the object's own attribute (a class may inherit it: restoring
        # the inherited one would pin it to the subclass)
        saved.append((obj, attr, vars(obj).get(attr, missing)))
        setattr(obj, attr, value)

    if name == "unchanged":
        for cls in (torch.optim.Adam, torch.optim.AdamW):
            patch(cls, "step", lambda self, closure=None: None)
    elif name == "half_batch":
        make_lora = lt.make_lora_train_step

        def make(*a, **k):
            init_fn, step = make_lora(*a, **k)

            def half(adapters, opt, batch, generator=None, draws=None):
                img = batch["image"]
                if draws is None:
                    draws = lt.draw_step(generator, img.shape[0],
                                         img.shape[1] // 8, img.device)
                b = img.shape[0] // 2
                return step(adapters, opt,
                            {k: (v[:b] if v is not None else None)
                             for k, v in batch.items()},
                            draws={k: v[:b] for k, v in draws.items()})

            half.loss_fn = step.loss_fn
            return init_fn, half

        patch(lt, "make_lora_train_step", make)
        sample = st.sample_batch
        patch(st, "sample_batch", lambda stream, n, generator=None, idx=None:
              {k: v[:n // 2] for k, v in
               sample(stream, n, generator, idx).items()})
    elif name == "altered":
        make_image = st.make_image_renderer

        def make(render_fn, *, block=8192):
            image = make_image(render_fn, block=block)

            def altered(rays_o, rays_d):
                out = dict(image(rays_o, rays_d))
                out["rgb"] = out["rgb"] + 0.05
                return out

            return altered

        patch(st, "make_image_renderer", make)
    else:
        raise ValueError(f"no fault {name!r}")
    try:
        yield
    finally:
        for obj, attr, value in reversed(saved):
            if value is missing:
                delattr(obj, attr)
            else:
                setattr(obj, attr, value)
