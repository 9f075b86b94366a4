"""gbnerf_tpu_torch — the PyTorch/CUDA port of gbnerf_tpu, for NVIDIA Hopper.

The JAX package ``gbnerf_tpu`` is the reference: this package keeps its
layout and its module and function names so that each counterpart is easy
to find, and its tests hold every module against the JAX function it
replaces on the same inputs.

Layer map (mirrors gbnerf_tpu):
  core/   rays, encodings, fields, sampling, volume rendering, normal maps
  ops/    hand-written CUDA kernels (csrc/) with their plain PyTorch versions
  guidance/ the SD1.5-inpainting stack (UNet, VAE, CLIP text), schedule,
          score distillation
  data/   LLFF/COLMAP loaders (numpy), ray banks
  train/  train state, losses, the stage-1 and stage-2 steps and loop,
          checkpoints, render functions, eval renders
  utils/  metrics, profiling (trace, StepTimer, nan_guard, annotate: a
          span only while a profiler records; the hot path's six spans
          gbnerf.data.batch, .text.encode, .lora.apply, .attn.bwd,
          .field.hash_encode, .render.resample)
  tools/  profilers: prof_field, prof_train, prof_guidance, trace_summary
  config.py  the config schema, a copy of the JAX package's
  run.py  the CLI (``python -m gbnerf_tpu_torch.run --config …``)

This package imports ``torch`` and never ``jax``, and nothing of
``gbnerf_tpu``: the machine with the card has no JAX. Its entry points run
on the card and refuse to start without one unless the caller asks for
the CPU (``--device cpu``), where every kernel runs its plain version.
"""

__version__ = "0.1.0"
