"""Traffic kind "stage1": DS-NeRF stage 1 at the recipe, a closed loop of
train steps as train/loop.py::train runs them with first_stage = True.

Set-up makes the seeded SPIn-NeRF-sized scene (inputs/scene.py), the
port's ray banks on the card, the coarse and fine fields (the port's
modules, the benchmark's seeded weights) and one training object: the
state, its Adam and make_train_step_stage1's step, which draws N_rand
rays from each stream (colour, inpainted disparity, COLMAP depth) and
renders them. It drives that object through its first three steps,
keeping their losses, the first gradient (Adam's first moment after step
1) and the fields after step 3; the window runs on from there.
``stage1_step_ms`` is the window over the steps it completed.

After the window the program's state is freed and the plain reference
(reference/nerf.py) follows the first three steps from the same scene,
weights and draws.
"""
from __future__ import annotations

import time

from benchmark.harness import checks as ck
from benchmark.harness import nerf as hn
from benchmark.harness import weights as wt
from benchmark.harness.common import span, sub_seed
from benchmark.inputs import scene as sc


def leaves(state) -> dict:
    """{coarse.<name> | fine.<name>: parameter}."""
    out = {f"coarse.{k}": v for k, v in state.coarse.named_parameters()}
    out.update({f"fine.{k}": v for k, v in state.fine.named_parameters()})
    return out


def run(ctx) -> dict:
    import torch

    from gbnerf_tpu_torch.data.rays_bank import build_ray_banks
    from gbnerf_tpu_torch.train.loop import banks_to_device
    from gbnerf_tpu_torch.train.state import create_train_state
    from gbnerf_tpu_torch.train.step import make_train_step_stage1

    c, p, dev, seed = ctx.config, ctx.params, ctx.device, ctx.seed
    cfg = hn.port_config(c["flags"], ctx.scratch)
    s = c["scene"]
    scene = sc.spinnerf_scene(s["n_train"], s["H"], s["W"], s["n_test"],
                              seed=sub_seed(seed, 0))
    banks = build_ray_banks(scene["images"], scene["masks"],
                            scene["inpainted_depths"], scene["poses"],
                            scene["hwf"][2], scene["depth_gts"])
    banks_dev = banks_to_device(banks, dev)
    ctx.mark("the scene and its banks")
    state, coarse, fine = create_train_state(
        cfg, torch.Generator().manual_seed(0), dev)
    wt.fill_field(coarse, sub_seed(seed, 1))
    wt.fill_field(fine, sub_seed(seed, 2))
    step = make_train_step_stage1(cfg, coarse, fine, scene["near"],
                                  scene["far"], hwf=scene["hwf"])
    gen = torch.Generator(device=dev).manual_seed(sub_seed(seed, 3))
    params = leaves(state)
    p0 = {k: v.detach().clone() for k, v in params.items()}

    def one_step():
        with span("step"):
            return step(state, banks_dev, gen)[1]

    losses = [one_step()["loss"]]
    opt = state.optimizer
    g1 = ck.norms({k: ck.first_moment(opt, v) / 0.1
                   for k, v in params.items()})
    losses += [one_step()["loss"] for _ in range(2)]
    d3 = ck.norms({k: v.detach() - p0[k] for k, v in params.items()})
    losses = [float(x) for x in losses]
    ctx.mark("the first three steps")

    out = {"attempted": 0, "failed": 0, "end_to_end": {}, "work": {}}
    t0 = ctx.window_opens()
    if ctx.trace:
        n = p["trace_steps"]
        ctx.traced(lambda: [one_step() for _ in range(n)])
    else:
        n = 0
        while True:
            one_step()
            n += 1
            if time.perf_counter() - t0 >= ctx.seconds:
                break
        t1 = ctx.window_closes()
        out["end_to_end"]["stage1_step_ms"] = (t1 - t0) * 1e3 / n
    out["attempted"] = out["work"]["steps"] = n
    ctx.read_memory_peak()
    del state, coarse, fine, step, opt, params, banks_dev
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    ref = follow(c, cfg, scene, p0, seed, dev)
    out["checks"], out["readings"] = ck.training_checks(
        losses, g1, d3, ref, p["limits"])
    if ctx.trace:
        from benchmark.counts import nerf as nc

        out["work"]["flops"] = n * nc.stage1_step_flops(c, cfg)
    return out


def follow(c: dict, cfg, scene: dict, p0: dict, seed: int, dev,
           steps: int = 3, precision: str = "f32") -> dict:
    """The reference's first ``steps`` steps from the fields' initial
    parameters p0 → {losses, grad_norms (a dict a step), change_norms}."""
    import torch

    from benchmark.harness.common import no_tf32, tf32
    from benchmark.reference import nerf as ref

    ref.PRECISION["products"] = "f32" if precision == "tf32" else precision
    try:
        with (tf32() if precision == "tf32" else no_tf32()):
            prm = {k: v.detach().clone().float().requires_grad_(True)
                   for k, v in p0.items()}
            split = {w: {k.split(".", 1)[1]: v for k, v in prm.items()
                         if k.startswith(w + ".")} for w in ("coarse", "fine")}
            h = c["flags"]
            hc = {"bound": float(h.get("bound", 100.0)),
                  "base_res": int(h.get("base_res", 16))}

            def field(pts, vd, sigma_only=False, fine=False):
                return ref.hash_field(split["fine" if fine else "coarse"],
                                      hc, pts, vd, sigma_only)

            bk = ref.banks(scene, dev)
            gen = torch.Generator(device=dev).manual_seed(sub_seed(seed, 3))
            adam = ref.Adam(prm, cfg.train.lrate, cfg.train.lrate_decay)
            loss_cfg = {"render": hn.render_dict(cfg),
                        "depth_lambda": cfg.data.depth_lambda,
                        "sdepth_lambda": cfg.data.sdepth_lambda}
            losses, grads = [], []
            for _ in range(steps):
                for v in prm.values():
                    v.grad = None
                loss = ref.stage1_loss(field, bk, scene["near"],
                                       scene["far"], loss_cfg,
                                       cfg.train.N_rand, gen)
                loss.backward()
                losses.append(float(loss.detach()))
                grads.append(ck.norms({k: v.grad for k, v in prm.items()}))
                adam.step()
            change = ck.norms({k: v.detach() - p0[k].float()
                            for k, v in prm.items()})
    finally:
        ref.PRECISION["products"] = "f32"
    return {"losses": losses, "grad_norms": grads, "change_norms": change}


def control(ctx, precision: str = "tf32"):
    """The control: the reference with TF32 products (the configuration
    states float32 with TF32 off) put in the program's place, held
    against the reference by the run's own checks → (checks, readings)."""
    import torch

    from gbnerf_tpu_torch.train.state import create_train_state

    c, dev, seed = ctx.config, ctx.device, ctx.seed
    cfg = hn.port_config(c["flags"], ctx.scratch)
    s = c["scene"]
    scene = sc.spinnerf_scene(s["n_train"], s["H"], s["W"], s["n_test"],
                              seed=sub_seed(seed, 0))
    state, coarse, fine = create_train_state(
        cfg, torch.Generator().manual_seed(0), dev)
    wt.fill_field(coarse, sub_seed(seed, 1))
    wt.fill_field(fine, sub_seed(seed, 2))
    p0 = {k: v.detach().clone() for k, v in leaves(state).items()}
    del state, coarse, fine
    want = follow(c, cfg, scene, p0, seed, dev)
    got = follow(c, cfg, scene, p0, seed, dev, precision=precision)
    return ck.training_checks(got["losses"], got["grad_norms"][0],
                              got["change_norms"], want, ctx.params["limits"])
