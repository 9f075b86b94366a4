"""The run context that run.py hands a traffic kind, and what every kind
shares: finding files by name, the card's readings, the set-up clock, the
traced window, the result line and the guard against JAX.

A traffic kind (``traffic/<kind>.py``) exposes ``run(ctx) -> dict`` with
the keys ``attempted``, ``failed``, ``end_to_end`` ({metric: value}),
``checks`` ([(name, value, limit)]: correct when every value ≤ its limit)
and ``work`` (what the per-layer readers need: steps or views traced,
FLOPs and bytes a step). It calls, in this order, ``ctx.window_opens()``
before its first timed step, ``ctx.traced(fn)`` for the traced window
when ``ctx.trace``, and ``ctx.read_memory_peak()`` before it frees the
program's state and runs the reference.
"""
from __future__ import annotations

import contextlib
import importlib.util
import json
import subprocess
import sys
import tempfile
import time
from pathlib import Path
from typing import Callable, List, Optional

BENCH_DIR = Path(__file__).resolve().parents[1]
ROOT = BENCH_DIR.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "gbnerf_tpu")


def sub_seed(seed: int, k: int) -> int:
    return (int(seed) * 1_000_003 + k) % (2 ** 63)


def load_json(path: Path) -> dict:
    with open(path) as fh:
        return json.load(fh)


def cell_file(name: str) -> Path:
    return BENCH_DIR / "workloads" / f"{name}.json"


def config_file(name: str) -> Path:
    return BENCH_DIR / "configs" / f"{name}.json"


def mix_file(name: str) -> Path:
    return BENCH_DIR / "traffic" / f"{name}.json"


def load_cell(name: str):
    """A cell by name → (cell, config, kind, params): the cell's file
    names its configuration and its traffic mix; the mix names its kind
    (traffic/<kind>.py) and its parameters, to which the cell's limits
    are added."""
    cell = load_json(cell_file(name))
    config = load_json(config_file(cell["config"]))
    mix = load_json(mix_file(cell["traffic"]))
    params = dict(mix["params"], limits=cell["limits"])
    return cell, config, mix["kind"], params


def load_module(path: Path, name: str):
    """A module of the benchmark loaded from its file (names may hold
    dots, which a plain import would read as packages)."""
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def traffic_module(kind: str):
    return load_module(BENCH_DIR / "traffic" / f"{kind}.py",
                       f"_bench_traffic_{kind}")


def metric_path(name: str) -> Path:
    """metrics/<name>.py, else the reader of the quantity before the first
    dot (metrics/idle_share.py reads idle_share.lora, .stage1, ...)."""
    own = BENCH_DIR / "metrics" / f"{name}.py"
    return own if own.is_file() else \
        BENCH_DIR / "metrics" / f"{name.split('.')[0]}.py"


def metric_module(name: str):
    return load_module(metric_path(name), "_bench_metric_" +
                       name.replace(".", "_").replace("-", "_"))


def metrics_of(bench: dict, cell: str, trace: bool) -> List[dict]:
    """The metrics a cell reports: its end-to-end ones (trace 0) or its
    per-layer ones (trace 1), as BENCHMARK.json lists them."""
    e2e = [m for m in bench["end_to_end"]
           if "workloads" not in m or cell in m["workloads"]]
    if not trace:
        return e2e
    names = {m["name"] for m in e2e}
    return [m for m in bench["per_layer"]
            if (cell in m["workloads"] if "workloads" in m
                else m["moves"] in names)]


def forbidden_modules() -> List[str]:
    """Loaded modules whose top-level name is JAX's or the JAX package's,
    compared as whole names."""
    return sorted({m.split(".", 1)[0] for m in list(sys.modules)
                   if m.split(".", 1)[0] in FORBIDDEN})


def nvidia_smi(fields: str) -> List[str]:
    """One nvidia-smi query of the first card → its values, or [] where
    nvidia-smi cannot be read."""
    try:
        out = subprocess.run(
            ["nvidia-smi", f"--query-gpu={fields}",
             "--format=csv,noheader,nounits"], capture_output=True,
            text=True, timeout=30).stdout
    except (OSError, subprocess.SubprocessError):
        return []
    lines = out.strip().splitlines()
    return [v.strip() for v in lines[0].split(",")] if lines else []


def card_state(tag: str) -> None:
    vals = nvidia_smi("name,power.limit,clocks.sm,temperature.gpu,"
                      "power.draw")
    print(f"card {tag}: " + json.dumps(dict(zip(
        ("name", "power_limit_w", "sm_clock_mhz", "temperature_c",
         "power_draw_w"), vals))), flush=True)


class Context:
    def __init__(self, *, config: dict, params: dict, seed: int,
                 seconds: float, trace: bool, device, t_process: float,
                 scratch: Optional[Path] = None):
        self.config, self.params = config, params
        self.seed, self.seconds, self.trace = int(seed), seconds, trace
        self.device = device
        self.t_process = t_process
        self.setup_s: Optional[float] = None
        self.memory_peak: Optional[int] = None
        self.trace_summary: Optional[dict] = None
        self.trace_events: Optional[list] = None
        self.scratch = scratch or Path(tempfile.mkdtemp(prefix="bench_"))
        self.keep_trace: Optional[str] = None

    # -- the clock and the card
    def mark(self, phase: str) -> None:
        """Print the seconds since the process started at the end of a
        set-up phase (standard error)."""
        self.sync()
        print(f"setup {phase}: {time.perf_counter() - self.t_process:.3f} s",
              file=sys.stderr, flush=True)

    def sync(self) -> None:
        import torch

        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def window_opens(self) -> float:
        """Before the first timed step: set-up ends here. Resets the
        peak-memory reading, so that it covers the window."""
        import torch

        self.sync()
        if self.device.type == "cuda":
            card_state("at the window's start")
            torch.cuda.reset_peak_memory_stats(self.device)
        now = time.perf_counter()
        self.setup_s = now - self.t_process
        return now

    def window_closes(self) -> float:
        self.sync()
        now = time.perf_counter()
        if self.device.type == "cuda":
            card_state("at the window's end")
        return now

    def read_memory_peak(self) -> None:
        import torch

        self.sync()
        if self.device.type == "cuda":
            self.memory_peak = int(torch.cuda.max_memory_allocated(
                self.device))
        else:
            self.memory_peak = 0

    def traced(self, fn: Callable[[], None]) -> dict:
        """Run fn under torch.profiler inside the window annotation and
        keep the trace's summary (trace.summarize) and its events."""
        from torch.profiler import ProfilerActivity, profile, record_function

        from . import trace as tr

        acts = [ProfilerActivity.CPU]
        if self.device.type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        self.sync()
        with profile(activities=acts) as prof:
            with record_function(tr.WINDOW):
                fn()
                self.sync()
        path = self.scratch / "trace.json"
        prof.export_chrome_trace(str(path))
        evs = tr.load(str(path))
        if self.keep_trace:
            import gzip
            import shutil

            with open(path, "rb") as a, gzip.open(self.keep_trace, "wb") as b:
                shutil.copyfileobj(a, b)
        path.unlink()
        self.trace_events = evs
        self.trace_summary = tr.summarize(evs)
        return self.trace_summary


def span(name: str):
    """A span of the benchmark's own in the trace (cheap when no profiler
    runs)."""
    from torch.profiler import record_function

    return record_function("bench." + name)


def result_line(*, correct: bool, attempted: int, failed: int,
                metrics: dict, device: dict, checks: list,
                breakdown: Optional[dict] = None) -> str:
    out = {"correct": correct, "attempted": attempted, "failed": failed,
           "metrics": metrics, "device": device}
    if breakdown is not None:
        out["breakdown"] = breakdown
    out["checks"] = {n: {"value": v, "limit": lim} for n, v, lim in checks}
    return json.dumps(out)


@contextlib.contextmanager
def _tf32(on: bool):
    import torch

    mm, cd = torch.backends.cuda.matmul, torch.backends.cudnn
    old = (mm.allow_tf32, cd.allow_tf32)
    mm.allow_tf32, cd.allow_tf32 = on, on
    try:
        yield
    finally:
        mm.allow_tf32, cd.allow_tf32 = old


def no_tf32():
    """f32 products in f32 inside the block (the reference's precision)."""
    return _tf32(False)


def tf32():
    """f32 products in TF32 inside the block (a control's precision)."""
    return _tf32(True)
