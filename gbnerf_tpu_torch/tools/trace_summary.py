"""Summarise a torch.profiler chrome trace: device self-time by kernel.

The twin of tools/trace_summary.py (which reads a jax.profiler trace). It
reads the ``trace.json`` that ``utils/profiling.trace`` writes (or any
``export_chrome_trace`` file) and sums, per call of the traced region:

  - the device's busy time: CUDA kernels, copies and memsets (on a trace
    taken without a card, the CPU ops' self time, and the "device" is the
    CPU);
  - by kernel kind (the name without template arguments and parameters)
    and by individual kernel, with launch counts;
  - the device's idle share of an untraced time of the region, when given
    (1 − busy / untraced).

    python -m gbnerf_tpu_torch.tools.trace_summary DIR_OR_FILE [n_calls] \\
        [untraced_ms]
"""
from __future__ import annotations

import collections
import json
import os
import re
import sys
from typing import Optional

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def load_events(path: str) -> dict:
    """The parsed chrome trace: ``path`` is the file or the directory that
    ``utils/profiling.trace`` wrote it into."""
    if os.path.isdir(path):
        path = os.path.join(path, "trace.json")
    with open(path) as fh:
        return json.load(fh)


def _cpu_self_times(evs):
    """(name, self µs) of each CPU op: its duration less its children's,
    nesting by time on each thread."""
    out = []
    by_thread = collections.defaultdict(list)
    for e in evs:
        by_thread[(e.get("pid"), e.get("tid"))].append(e)
    for items in by_thread.values():
        items.sort(key=lambda e: (e["ts"], -e["dur"]))
        stack = []                     # [end, index into out]
        for e in items:
            while stack and stack[-1][0] <= e["ts"]:
                stack.pop()
            if stack:
                out[stack[-1][1]][1] -= e["dur"]
            out.append([e.get("name", ""), float(e["dur"])])
            stack.append((e["ts"] + e["dur"], len(out) - 1))
    return out


def _kind(name: str) -> str:
    """A kernel's name without ``void``, anonymous namespaces, template
    arguments and parameters."""
    name = re.sub(r"^void ", "", name).replace("(anonymous namespace)::", "")
    return re.split(r"[<(]", name, maxsplit=1)[0].strip() or name


def summarize(path: str, n_calls: int = 1,
              untraced_ms: Optional[float] = None) -> dict:
    """Device time of the trace at ``path``, per call of the traced region.

    → {"device": "cuda" | "cpu", "device_name", "busy_ms", "launches",
    "kinds": [(kind, ms, launches)], "kernels": [(name, ms, launches)]
    (both sorted by time, per call), "idle_share" (None without
    untraced_ms)}."""
    doc = load_events(path)
    evs = doc["traceEvents"] if isinstance(doc, dict) else doc
    evs = [e for e in evs if e.get("ph") == "X" and "dur" in e]
    dev = [e for e in evs if e.get("cat") in DEVICE_CATS]
    if dev:
        where, times = "cuda", [(e.get("name", ""), float(e["dur"]))
                                for e in dev]
        props = doc.get("deviceProperties") if isinstance(doc, dict) else None
        name = props[0].get("name") if props else None
    else:
        where, name = "cpu", "cpu"
        times = _cpu_self_times([e for e in evs if e.get("cat") == "cpu_op"])
    kinds, kernels = collections.Counter(), collections.Counter()
    kind_n, kernel_n = collections.Counter(), collections.Counter()
    for n, us in times:
        kinds[_kind(n)] += us
        kind_n[_kind(n)] += 1
        kernels[n] += us
        kernel_n[n] += 1
    busy_ms = sum(kernels.values()) / 1e3 / n_calls
    return {
        "device": where, "device_name": name, "n_calls": n_calls,
        "busy_ms": busy_ms, "launches": len(times) / n_calls,
        "kinds": [(k, v / 1e3 / n_calls, kind_n[k] / n_calls)
                  for k, v in kinds.most_common()],
        "kernels": [(k, v / 1e3 / n_calls, kernel_n[k] / n_calls)
                    for k, v in kernels.most_common()],
        "idle_share": (None if not untraced_ms
                       else 1.0 - busy_ms / untraced_ms),
    }


def print_summary(s: dict, top: int = 25) -> None:
    idle = ("" if s["idle_share"] is None
            else f"; idle share {s['idle_share']:.3f} of the untraced time")
    print(f"device ({s['device']}: {s['device_name']}) op time: "
          f"{s['busy_ms']:.3f} ms/call ({s['n_calls']} calls), "
          f"{s['launches']:.0f} launches/call in {len(s['kernels'])} "
          f"kernels{idle}")
    print("--- by kernel kind")
    for k, ms, n in s["kinds"][:top]:
        print(f"{ms:9.3f} ms/call x{n:6.0f}  {k[:100]}")
    print("--- top individual kernels")
    for k, ms, n in s["kernels"][:12]:
        print(f"{ms:9.3f} ms/call x{n:6.0f}  {k[:100]}")


def main(argv=None) -> None:
    argv = sys.argv[1:] if argv is None else argv
    if not argv:
        raise SystemExit(__doc__)
    print_summary(summarize(argv[0], int(argv[1]) if len(argv) > 1 else 1,
                            float(argv[2]) if len(argv) > 2 else None))


if __name__ == "__main__":
    main()
