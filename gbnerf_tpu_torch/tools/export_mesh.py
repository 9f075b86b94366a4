"""Export a trained σ field as a triangle mesh (.obj, or a coloured .ply).

The twin of tools/export_mesh.py, with the port's checkpoints:

    python -m gbnerf_tpu_torch.tools.export_mesh --config cfg.txt \\
        [--res 128] [--iso 10] [--bound 2.0] [--color] [--out mesh.obj] \\
        [--device cuda|cpu]

Restores the experiment's latest checkpoint (as --render_only does),
evaluates σ of the fine field (the coarse one without a fine) on a res³
grid inside [−bound, bound]³ on the device (K2 for a CP field on the
card), runs marching tetrahedra on the host (utils/mesh.py) and, with
--color, queries the vertex colours on the device (K1). Runs on the first
CUDA device unless --device cpu; exits with a message without a card.
"""
from __future__ import annotations

import argparse
import os
import time


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(
        description=__doc__.split("\n\n")[0],
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--config", required=True)
    ap.add_argument("--res", type=int, default=128)
    ap.add_argument("--iso", type=float, default=10.0,
                    help="raw-σ threshold (stable-dreamfusion default 10)")
    ap.add_argument("--bound", type=float, default=None,
                    help="grid half-width; default cp_bound or 2.0")
    ap.add_argument("--color", action="store_true",
                    help="query vertex colors (writes .ply)")
    ap.add_argument("--out", default=None)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; an error without a card) or cpu")
    args = ap.parse_args(argv)

    import torch

    from ..config import load_reference_config
    from ..core.fields import make_field_fn
    from ..train.checkpoint import CheckpointManager
    from ..train.loop import device_from_flag
    from ..train.state import create_train_state
    from ..utils.mesh import extract_field_mesh, write_obj, write_ply

    device = device_from_flag(args.device)
    cfg = load_reference_config(args.config)
    t = cfg.train
    expdir = os.path.join(t.basedir, t.expname)
    state, coarse, fine = create_train_state(
        cfg, torch.Generator().manual_seed(t.seed), device)
    ckpt = CheckpointManager(os.path.join(expdir, "ckpt"))
    step = ckpt.latest_step()
    if step is None:
        raise SystemExit(f"no checkpoint found under {expdir}/ckpt")
    ckpt.restore(state)
    field_fn = make_field_fn(fine if fine is not None else coarse)

    bound = args.bound
    if bound is None:
        bound = getattr(cfg.field, "cp_bound", None) or 2.0
    out = args.out or os.path.join(
        expdir, f"mesh_{step:06d}.{'ply' if args.color else 'obj'}")

    times = {}
    res = extract_field_mesh(field_fn, resolution=args.res, bound=bound,
                             iso=args.iso, color=args.color, device=device,
                             times=times)
    verts, faces = res[0], res[1]
    if len(faces) == 0:
        raise SystemExit(
            f"empty mesh at iso={args.iso}: the σ grid never crosses the "
            "threshold — try a lower --iso or a larger --bound")
    t0 = time.perf_counter()
    if args.color:
        write_ply(out, verts, faces, res[2])
    else:
        write_obj(out, verts, faces)
    times["write_s"] = time.perf_counter() - t0
    print(f"export_mesh: step {step}, {len(verts)} verts / {len(faces)} "
          f"faces -> {out}")
    print("export_mesh: seconds " + ", ".join(f"{k} {v:.3f}"
                                              for k, v in times.items()))
    return {"out": out, "step": step, "verts": verts, "faces": faces,
            "colors": res[2] if args.color else None, "times": times}


if __name__ == "__main__":
    main()
