"""Trace arithmetic: device busy time, idle share, launches and the
breakdown, from a torch.profiler chrome trace.

Busy time by kernel follows gbnerf_tpu_torch/tools/trace_summary.py
(commit e283e2e): device events are the chrome trace's "kernel",
"gpu_memcpy" and "gpu_memset" events. Unlike that tool, busy time here is
the union of the device intervals (streams may overlap), and the idle
share is taken over the traced window itself: the span of the
``WINDOW`` annotation that the harness puts around the traced steps, and
not another run's untraced time.
"""
from __future__ import annotations

import collections
import json
import re
from typing import Dict, List, Optional, Sequence, Tuple

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
WINDOW = "bench.window"          # the traced window's annotation
SPAN_PREFIX = "bench."           # the benchmark's own spans


def load(path: str) -> List[dict]:
    """The complete ("X") events of a chrome trace file."""
    with open(path) as fh:
        doc = json.load(fh)
    evs = doc["traceEvents"] if isinstance(doc, dict) else doc
    return [e for e in evs if e.get("ph") == "X" and "dur" in e
            and "ts" in e]


def window_span(evs: Sequence[dict]) -> Tuple[float, float]:
    """(start, end) in µs of the window annotation on the host."""
    spans = [e for e in evs if e.get("name") == WINDOW
             and e.get("cat") != "gpu_user_annotation"]
    if not spans:
        raise ValueError(f"the trace has no {WINDOW!r} span")
    e = max(spans, key=lambda e: float(e["dur"]))
    return float(e["ts"]), float(e["ts"]) + float(e["dur"])


def device_events(evs: Sequence[dict], span: Tuple[float, float]
                  ) -> List[dict]:
    """Device events that overlap the span."""
    lo, hi = span
    return [e for e in evs if e.get("cat") in DEVICE_CATS
            and float(e["ts"]) < hi and float(e["ts"]) + float(e["dur"]) > lo]


def union(intervals: Sequence[Tuple[float, float]],
          span: Tuple[float, float]) -> List[Tuple[float, float]]:
    """The merged intervals, clipped to the span, sorted."""
    lo, hi = span
    cut = sorted((max(a, lo), min(b, hi)) for a, b in intervals
                 if min(b, hi) > max(a, lo))
    out: List[List[float]] = []
    for a, b in cut:
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def busy_us(evs: Sequence[dict], span: Tuple[float, float]) -> float:
    """µs of the span in which some device operation ran."""
    iv = [(float(e["ts"]), float(e["ts"]) + float(e["dur"]))
          for e in device_events(evs, span)]
    return sum(b - a for a, b in union(iv, span))


def kind(name: str) -> str:
    """A kernel's name without ``void``, anonymous namespaces, template
    arguments and parameters (trace_summary.py's ``_kind``)."""
    name = re.sub(r"^void ", "", name).replace("(anonymous namespace)::", "")
    return re.split(r"[<(]", name, maxsplit=1)[0].strip() or name


def device_ops(evs: Sequence[dict], span: Tuple[float, float],
               top: int = 10) -> List[Tuple[str, float]]:
    """The device operations (by kind) that took most time: [(kind, s)]."""
    tot: Dict[str, float] = collections.Counter()
    for e in device_events(evs, span):
        tot[kind(e.get("name", ""))] += float(e["dur"]) * 1e-6
    return sorted(tot.items(), key=lambda kv: -kv[1])[:top]


def kernel_seconds(evs: Sequence[dict], span: Tuple[float, float],
                   pattern: str) -> float:
    """Seconds of the device events whose full name matches the regex."""
    rx = re.compile(pattern)
    return sum(float(e["dur"]) for e in device_events(evs, span)
               if rx.search(e.get("name", ""))) * 1e-6


def launches(evs: Sequence[dict], span: Tuple[float, float]) -> int:
    """Device operations that started inside the span."""
    lo, hi = span
    return sum(1 for e in device_events(evs, span)
               if lo <= float(e["ts"]) < hi)


def idle_gaps(evs: Sequence[dict], span: Tuple[float, float],
              top: int = 10) -> List[Tuple[str, float]]:
    """The longest idle gaps of the device inside the span, each named by
    what the host was doing at the gap's middle: the innermost benchmark
    span there, and inside it the outermost CPU operation, if any."""
    lo, hi = span
    iv = union([(float(e["ts"]), float(e["ts"]) + float(e["dur"]))
                for e in device_events(evs, span)], span)
    gaps, t = [], lo
    for a, b in iv:
        if a > t:
            gaps.append((t, a))
        t = b
    if hi > t:
        gaps.append((t, hi))
    gaps = sorted(gaps, key=lambda g: g[0] - g[1])[:top]
    host = [e for e in evs if e.get("cat") in ("cpu_op", "user_annotation",
                                                "python_function")]
    out = []
    for a, b in gaps:
        mid = 0.5 * (a + b)
        cover = [e for e in host if float(e["ts"]) <= mid
                 < float(e["ts"]) + float(e["dur"])
                 and e.get("name") != WINDOW]
        spans = [e for e in cover if e.get("name", "").startswith(SPAN_PREFIX)]
        ops = [e for e in cover if e.get("cat") == "cpu_op"]
        label = min(spans, key=lambda e: float(e["dur"]))["name"] if spans \
            else "host"
        if ops:
            label += ":" + max(ops, key=lambda e: float(e["dur"]))["name"]
        out.append((label, (b - a) * 1e-6))
    return out


def summarize(evs: Sequence[dict]) -> dict:
    """The traced window's numbers: busy_s, window_s, launches and the
    breakdown that the result line carries."""
    span = window_span(evs)
    return {"span": span, "window_s": (span[1] - span[0]) * 1e-6,
            "busy_s": busy_us(evs, span) * 1e-6,
            "launches": launches(evs, span),
            "breakdown": {"device_ops": [list(x) for x in
                                         device_ops(evs, span)],
                          "idle_gaps": [list(x) for x in
                                        idle_gaps(evs, span)]}}


def idle_share(summary: dict) -> Optional[float]:
    """1 − busy / window, in %; None without a window."""
    w = summary.get("window_s") or 0.0
    return None if w <= 0 else 100.0 * (1.0 - summary["busy_s"] / w)
