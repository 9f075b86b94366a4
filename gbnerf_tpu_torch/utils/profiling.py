"""Tracing, profiling and numerical-health helpers.

Port of gbnerf_tpu/utils/profiling.py:

  - ``trace(logdir)``: a ``torch.profiler`` trace (CPU and, on a machine
    with a card, CUDA activity) around a code region, exported on exit as a
    chrome trace, ``logdir/trace.json`` (chrome://tracing, Perfetto;
    tools/trace_summary.py sums it by kernel).
  - ``annotate(name)``: a named span in that trace
    (``torch.profiler.record_function``) while a profiler is recording,
    else one shared ``contextlib.nullcontext()``: a span costs a flag
    test when nothing profiles. The spans go through the profiler alone,
    on its clock, and show on the device lane as ``gpu_user_annotation``.
    The port's own spans on its hot path (the ``SPAN_*`` names here):
    ``gbnerf.data.batch`` (the LoRA dataset's batch), ``gbnerf.data.decode``
    (one instance's image, mask and caption read and resized, once when
    the dataset is built and again where its files change: inside a batch
    a miss), ``gbnerf.text.encode``
    (every CLIP text tower), ``gbnerf.unet.transformer`` (a UNet's
    spatial transformer, guidance/blocks.py::Transformer2D, all its
    blocks), ``gbnerf.lora.apply`` (the adapters' merges),
    ``gbnerf.attn.bwd`` (K7's backward), ``gbnerf.field.hash_encode`` (the
    hash grid's encode) and ``gbnerf.render.resample`` (the fine samples'
    draw and merge).
  - ``StepTimer``: steps/sec with the first (warm-up) interval excluded.
  - ``time_ms``: a call's mean time after a warm-up call, with CUDA events
    on a card (the host clock on the CPU).
  - ``graph_ms``: a call's mean device time on a card with the host out of
    the loop (calls captured into one CUDA graph and replayed).
  - ``nan_guard``: whether any floating tensor holds a non-finite value, as
    one device bool tensor (one fused reduction, no host sync).
  - ``check_metrics``: the host-side guard of the cadenced log path.

A device's clock runs apart from the host's: time device work with CUDA
events or a ``synchronize()`` before reading the host clock.
"""
from __future__ import annotations

import contextlib
import os
import time
from typing import Dict, Iterable, Iterator

import torch
import torch.autograd.profiler as _autograd_profiler
from torch.profiler import ProfilerActivity, profile, record_function

TRACE_FILE = "trace.json"

SPAN_DATA_BATCH = "gbnerf.data.batch"
SPAN_DATA_DECODE = "gbnerf.data.decode"
SPAN_TEXT_ENCODE = "gbnerf.text.encode"
SPAN_UNET_TRANSFORMER = "gbnerf.unet.transformer"
SPAN_LORA_APPLY = "gbnerf.lora.apply"
SPAN_ATTN_BWD = "gbnerf.attn.bwd"
SPAN_HASH_ENCODE = "gbnerf.field.hash_encode"
SPAN_RESAMPLE = "gbnerf.render.resample"

_NO_SPAN = contextlib.nullcontext()


@contextlib.contextmanager
def trace(logdir: str) -> Iterator[profile]:
    """Profile the region; on exit write ``logdir/trace.json``. Yields the
    ``torch.profiler.profile`` (its ``key_averages()`` are there too)."""
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(logdir, TRACE_FILE))


def annotate(name: str):
    """A span named ``name`` while a profiler records, else the shared
    no-op context."""
    if _autograd_profiler._is_profiler_enabled:
        return record_function(name)
    return _NO_SPAN


class StepTimer:
    """steps/sec with the first (warm-up) interval excluded."""

    def __init__(self):
        self.t0 = time.perf_counter()
        self.steps = 0
        self.total = 0.0
        self.intervals = 0

    def tick(self, n: int = 1) -> float:
        now = time.perf_counter()
        dt = now - self.t0
        self.t0 = now
        self.intervals += 1
        if self.intervals > 1:  # skip the warm-up interval
            self.steps += n
            self.total += dt
        return n / dt if dt > 0 else float("inf")

    @property
    def steady_rate(self) -> float:
        return self.steps / self.total if self.total > 0 else 0.0


def time_ms(fn, device: torch.device, reps: int) -> float:
    """Mean ms per call of fn() over reps calls, after one warm-up call."""
    fn()
    if torch.device(device).type == "cuda":
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        stop.record()
        torch.cuda.synchronize(device)
        return start.elapsed_time(stop) / reps
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    return (time.perf_counter() - t0) * 1e3 / reps


def graph_ms(fn, device: torch.device, reps: int) -> float:
    """Mean device ms per call of fn() on a card, the host out of the loop:
    reps calls captured into one CUDA graph (after one warm-up call), the
    graph replayed once to warm it and once under CUDA events. time_ms's
    back-to-back calls wait on the host where a call's kernels take less
    time than its Python and launch work; this does not."""
    if torch.device(device).type != "cuda":
        raise ValueError("graph_ms: CUDA graphs need a card")
    fn()
    torch.cuda.synchronize(device)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, capture_error_mode="thread_local"):
        for _ in range(reps):
            fn()
    graph.replay()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    stop.record()
    torch.cuda.synchronize(device)
    return start.elapsed_time(stop) / reps


def _leaves(tree) -> Iterable[torch.Tensor]:
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _leaves(v)


def nan_guard(tree) -> torch.Tensor:
    """A bool tensor on the leaves' device: True if ANY floating leaf of
    the (nested dict/list/tuple) tree holds a non-finite value. One
    ``isfinite`` reduction per leaf, combined on the device; no host sync
    until the caller reads it."""
    bad = None
    for leaf in _leaves(tree):
        if not leaf.is_floating_point():
            continue
        b = ~torch.isfinite(leaf).all()
        bad = b if bad is None else bad | b
    return torch.zeros((), dtype=torch.bool) if bad is None else bad


def check_metrics(metrics: Dict[str, torch.Tensor], step: int) -> None:
    """Host-side guard for the cadenced log path (cheap: metrics only)."""
    for k, v in metrics.items():
        val = float(v)
        if val != val or val in (float("inf"), float("-inf")):
            raise FloatingPointError(
                f"[step {step}] metric {k!r} is non-finite: {val}")
