"""Attribution of the traced window to the program's own spans: the device
time a span caused, forward and backward; the device's idle time under a
span on the host; the stream syncs of a step; and the share of the
window's device time that maps to a host launch at all.

The program opens its spans (``gbnerf.*``, gbnerf_tpu_torch/utils/
profiling.py) only while a profiler records, so they share one clock with
the device events. A span's device time is that of the device events
whose ``correlation`` matches a host launch (a launch, copy or memset
call of either CUDA API: any host event with a ``correlation`` arg) made
inside the span on its thread, or inside the backward of an operation
the span ran: an ``autograd::engine::evaluate_function: …`` event whose
``Sequence number`` is that of a forward operation inside the span, on
the forward thread. Sequence numbers count per thread, and an operation that creates
no autograd node records the number the next one will take, so the node
of a (thread, number) is made by the last forward operation that records
it; a backward event names its forward thread by the profiler's own
``Fwd thread id``, mapped here to a trace thread by the forward
operations that share its numbers.

    python3 -m benchmark.harness.spans <trace.json[.gz]> [--per N]

prints the attribution of a trace kept with ``run.py --keep-trace``: every
``gbnerf.`` span's device ms, the idle ms under the LoRA batch, and each
stream sync of the steps by the innermost ``gbnerf.``/``bench.`` span and
the host operations around it.
"""
from __future__ import annotations

import bisect
import collections
import sys
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

from . import trace as tr

SYNC_CALLS = ("cudaStreamSynchronize", "cudaDeviceSynchronize",
              "cudaEventSynchronize", "cudaMemcpy")
STEP_SPANS = ("bench.batch", "bench.step", "bench.render", "bench.to_host")
BACKWARD = "autograd::engine::evaluate_function: "
PORT_PREFIX = "gbnerf."
BATCH_SPANS = ("gbnerf.data.batch", "gbnerf.text.encode")
DEVICE_LANE = "gpu_user_annotation"

Interval = Tuple[float, float]


def _args(e: dict) -> dict:
    return e.get("args") or {}


def _iv(e: dict) -> Interval:
    return float(e["ts"]), float(e["ts"]) + float(e["dur"])


class _Sorted:
    """Items of one thread sorted by start, for the items that start
    inside an interval."""

    def __init__(self, items: Iterable[Tuple[float, object]]):
        pairs = sorted(items, key=lambda p: p[0])
        self.ts = [p[0] for p in pairs]
        self.items = [p[1] for p in pairs]

    def within(self, a: float, b: float) -> List[object]:
        return self.items[bisect.bisect_left(self.ts, a):
                          bisect.bisect_left(self.ts, b)]


class Attribution:
    """The indexes of one traced window, built once."""

    def __init__(self, evs: Sequence[dict], window: Interval):
        self.window = window
        lo, hi = window
        self.host_spans: Dict[str, List[Tuple[object, Interval]]] = \
            collections.defaultdict(list)
        launches = collections.defaultdict(list)
        self.device: Dict[object, List[Tuple[Interval, str]]] = \
            collections.defaultdict(list)
        self.busy: List[Interval] = []
        self.syncs: List[Tuple[object, Interval, str]] = []
        forward = {}                   # (tid, seq) → start of its creator
        backward = collections.defaultdict(list)  # (fwd id, seq) → events
        ops = collections.defaultdict(list)
        for e in evs:
            cat, name, a = e.get("cat"), e.get("name", ""), _args(e)
            iv = _iv(e)
            if cat in tr.DEVICE_CATS:
                if iv[0] < hi and iv[1] > lo:
                    self.busy.append(iv)
                    if "correlation" in a:
                        self.device[a["correlation"]].append((iv, name))
                continue
            if cat == DEVICE_LANE:
                continue
            tid = (e.get("pid"), e.get("tid"))
            if cat == "user_annotation":
                self.host_spans[name].append((tid, iv))
            if "correlation" in a:
                launches[tid].append((iv[0], a["correlation"]))
            if name in SYNC_CALLS:
                self.syncs.append((tid, iv, name))
            if cat != "cpu_op":
                continue
            ops[tid].append((iv[0], (iv, name)))
            seq = a.get("Sequence number")
            if seq is None:
                continue
            fwd_id = a.get("Fwd thread id") or 0
            if name.startswith(BACKWARD) and fwd_id:
                backward[(fwd_id, seq)].append((tid, iv))
            elif not fwd_id:
                key = (tid, seq)
                forward[key] = max(forward.get(key, iv[0]), iv[0])
        self.launches = {t: _Sorted(v) for t, v in launches.items()}
        self.ops = {t: _Sorted(v) for t, v in ops.items()}
        # Fwd thread id → the trace thread whose forward operations made
        # the nodes: the thread most backward events' numbers point to
        tids_of = collections.defaultdict(set)
        for t, s in forward:
            tids_of[s].add(t)
        votes = collections.defaultdict(collections.Counter)
        for fwd_id, s in backward:
            for t in tids_of.get(s, ()):
                votes[fwd_id][t] += len(backward[(fwd_id, s)])
        thread_of = {f: c.most_common(1)[0][0] for f, c in votes.items()}
        self.backward = collections.defaultdict(list)
        for (fwd_id, s), bwd in backward.items():
            if fwd_id in thread_of:
                self.backward[(thread_of[fwd_id], s)] += bwd
        by_tid = collections.defaultdict(list)
        for (t, s), ts in forward.items():
            by_tid[t].append((ts, s))
        self.creators = {t: _Sorted(v) for t, v in by_tid.items()}

    # -- (a) the device time a span caused
    def host_intervals(self, name: str) -> List[Tuple[object, Interval]]:
        """(thread, interval) of every instance of the span and of every
        backward event of an operation that it ran."""
        out = []
        for tid, (a, b) in self.spans(name):
            out.append((tid, (a, b)))
            made = self.creators.get(tid)
            for s in (made.within(a, b) if made else ()):
                out += self.backward.get((tid, s), ())
        return out

    def device_events(self, name: str) -> Optional[List[Tuple[Interval,
                                                                str]]]:
        """The device events launched by the span or by the backward of
        an operation it ran; None where the span is not in the trace."""
        host = self.host_intervals(name)
        if not host:
            return None
        corrs = set()
        for tid, (a, b) in host:
            lc = self.launches.get(tid)
            corrs.update(lc.within(a, b) if lc else ())
        return [x for c in corrs for x in self.device.get(c, ())]

    def device_ms(self, name: str) -> Optional[float]:
        """ms of the window in which a device operation of the span
        (device_events) was running; None where the span is not in the
        trace."""
        evs = self.device_events(name)
        if evs is None:
            return None
        return sum(b - a for a, b in tr.union([iv for iv, _ in evs],
                                              self.window)) * 1e-3

    def spans(self, name: str) -> List[Tuple[object, Interval]]:
        """The host spans of that name that overlap the window."""
        lo, hi = self.window
        return [(t, iv) for t, iv in self.host_spans.get(name, ())
                if iv[0] < hi and iv[1] > lo]

    # -- (b) the device's idle time under spans on the host
    def idle(self) -> List[Interval]:
        lo, hi = self.window
        out, t = [], lo
        for a, b in tr.union(self.busy, self.window):
            if a > t:
                out.append((t, a))
            t = b
        if hi > t:
            out.append((t, hi))
        return out

    def idle_ms(self, names: Sequence[str]) -> Optional[float]:
        """ms of the window in which the device was idle while the host
        was inside one of the spans; None where none is in the trace."""
        host = [iv for n in names for _, iv in self.spans(n)]
        if not host:
            return None
        host = tr.union(host, self.window)
        total, j = 0.0, 0
        for a, b in self.idle():
            while j < len(host) and host[j][1] <= a:
                j += 1
            k = j
            while k < len(host) and host[k][0] < b:
                total += min(b, host[k][1]) - max(a, host[k][0])
                k += 1
        return total * 1e-3

    # -- (c) the stream syncs of the steps
    def step_syncs(self, steps: Sequence[str] = STEP_SPANS
                   ) -> List[Tuple[object, Interval, str]]:
        """The sync calls whose host interval lies inside one of the
        traffic's per-step spans (on any thread: a backward's syncs hold
        the step too); the harness's closing sync lies outside them."""
        host = tr.union([iv for n in steps for _, iv in self.spans(n)],
                        self.window)
        starts = [a for a, _ in host]
        out = []
        for tid, (a, b), name in self.syncs:
            i = bisect.bisect_right(starts, a) - 1
            if i >= 0 and b <= host[i][1]:
                out.append((tid, (a, b), name))
        return out

    def label(self, tid, iv: Interval) -> str:
        """The innermost gbnerf./bench. span around a host interval (one on
        its own thread first), then its outermost and innermost CPU
        operations."""
        a, b = iv
        around = [(t, x, n) for n, sp in self.host_spans.items()
                  if n.startswith((PORT_PREFIX, tr.SPAN_PREFIX))
                  and n != tr.WINDOW
                  for t, x in sp if x[0] <= a and b <= x[1]]
        own = [s for s in around if s[0] == tid] or around
        name = min(own, key=lambda s: s[1][1] - s[1][0])[2] if own \
            else "host"
        cover = [v for v in (self.ops[tid].items if tid in self.ops else ())
                 if v[0][0] <= a and b <= v[0][1]]
        if cover:
            cover.sort(key=lambda v: v[0][0] - v[0][1])
            name += f":{cover[0][1]}>{cover[-1][1]}"
        return name

    # -- (d) coverage
    def coverage(self) -> Optional[float]:
        """Share of the window's device time in events that map to a host
        launch by correlation."""
        busy = sum(b - a for a, b in tr.union(self.busy, self.window))
        if busy <= 0:
            return None
        host = set()
        for lc in self.launches.values():
            host.update(lc.items)
        iv = [x for c, xs in self.device.items() if c in host
              for x, _ in xs]
        return sum(b - a for a, b in tr.union(iv, self.window)) / busy


def of(ctx) -> Optional[Attribution]:
    """The traced window's attribution, built once a run (kept on the
    context); prints the coverage on standard error when built."""
    if ctx.trace_events is None or ctx.trace_summary is None:
        return None
    got = getattr(ctx, "_span_attribution", None)
    if got is None:
        got = Attribution(ctx.trace_events, ctx.trace_summary["span"])
        ctx._span_attribution = got
        print(f"spans coverage: {got.coverage()}", file=sys.stderr,
              flush=True)
    return got


def per(out: dict, key: str) -> Optional[int]:
    """The steps (or views) the traced window ran, from the traffic's
    work."""
    n = out.get("work", {}).get(key)
    return n if n else None


def span_device_ms(ctx, out: dict, span: str, key: str = "steps"
                   ) -> Optional[float]:
    """A span's device ms a step (or view); None without the span."""
    at, n = of(ctx), per(out, key)
    if at is None or n is None:
        return None
    ms = at.device_ms(span)
    return None if ms is None else ms / n


def _kinds(evs, n: int, top: int = 6) -> List[Tuple[str, float]]:
    """The kernel kinds that took most of a span's device time: [(kind,
    ms a step)], their own durations summed."""
    tot = collections.Counter()
    for (a, b), name in evs:
        tot[tr.kind(name)] += (b - a) * 1e-3 / n
    return tot.most_common(top)


def main(argv=None) -> int:
    import argparse
    import gzip
    import json
    import tempfile

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("trace")
    ap.add_argument("--per", type=int, default=1,
                    help="steps or views in the traced window")
    args = ap.parse_args(argv)
    opener = gzip.open if args.trace.endswith(".gz") else open
    with opener(args.trace, "rb") as fh, \
            tempfile.NamedTemporaryFile(suffix=".json") as tmp:
        tmp.write(fh.read())
        tmp.flush()
        evs = tr.load(tmp.name)
    at = Attribution(evs, tr.window_span(evs))
    names = sorted(n for n in at.host_spans if n.startswith(PORT_PREFIX))
    syncs = at.step_syncs()
    by = collections.Counter(f"{n} @ {at.label(t, iv)}"
                             for t, iv, n in syncs)
    idle = at.idle_ms(BATCH_SPANS)
    print(json.dumps({
        "coverage": at.coverage(), "per": args.per,
        "device_ms": {n: at.device_ms(n) / args.per for n in names},
        "kinds_ms": {n: _kinds(at.device_events(n), args.per)
                     for n in names},
        "spans": {n: len(at.spans(n)) / args.per for n in names},
        "batch_idle_ms": None if idle is None else idle / args.per,
        "syncs_per_step": len(syncs) / args.per,
        "syncs": {k: v / args.per for k, v in by.most_common()},
    }, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
