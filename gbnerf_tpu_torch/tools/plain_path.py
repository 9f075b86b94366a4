"""Run the port's training CLI with the render's kernels off on the card.

    python -m gbnerf_tpu_torch.tools.plain_path --config CFG [run.py flags]

The same command line as ``python -m gbnerf_tpu_torch.run``, with K1/K2
(the fused CP field) through ``ops/field_fused.py::field_plain``, K4/K5
(its backward) through ``field_bwd_plain`` and K3 (the z-merge) through
``ops/resample.py::merge128_plain``: the kernels' plain PyTorch versions
on the same CUDA tensors. It measures what the kernels' bf16 arithmetic is
worth over a whole run against the plain path; the kernels stay the
port's main path. ``plain_kernels`` is the context manager that swaps
them (chip_smoke.py uses it for its plain-path checks).
"""
from __future__ import annotations

import contextlib
import sys


@contextlib.contextmanager
def plain_kernels():
    """The render's kernels off: K1/K2 through ``field_plain``, K4/K5
    through ``field_bwd_plain`` and K3 through ``merge128_plain``, on the
    same tensors (no launch counted)."""
    from ..ops import field_fused as ff
    from ..ops import resample as rs

    saved = ff._launch, ff._launch_bwd, rs._launch_merge

    def field(x01, sh, ulines, Ws, *, sigma_only):
        return ff.field_plain(x01, sh, ulines, Ws, sigma_only=sigma_only)

    def field_bwd(x01, sh, ulines, Ws, g, *, sigma_only, need_dx, need_dsh):
        dx, dsh, dul, dWs = ff.field_bwd_plain(x01, sh, ulines, Ws, g,
                                               sigma_only=sigma_only)
        return (dx if need_dx else None, dsh if need_dsh else None, dul,
                dWs)

    ff._launch, ff._launch_bwd, rs._launch_merge = (field, field_bwd,
                                                    rs.merge128_plain)
    try:
        yield
    finally:
        ff._launch, ff._launch_bwd, rs._launch_merge = saved


def main(argv=None):
    from .. import run

    print("[plain_path] K1-K5 and K3 off: their plain versions on the "
          "device", flush=True)
    with plain_kernels():
        return run.main(sys.argv[1:] if argv is None else argv)


if __name__ == "__main__":
    main()
