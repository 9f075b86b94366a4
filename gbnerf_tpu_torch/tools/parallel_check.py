"""Multi-rank steps of the port, for holding them against one process.

    python -m torch.distributed.run --standalone --nproc_per_node 2 \\
        -m gbnerf_tpu_torch.tools.parallel_check SPEC.pt [--device cpu] \\
        [--dist_backend gloo]

SPEC.pt (``torch.save`` of {"cases": [...], "out": path}, written by the
caller) lists cases; every rank runs each on the mesh the case names and
rank 0 writes their results to ``out`` (``torch.save``). The same
``run_case`` runs in the caller's process with mesh None: that is the
one-process step the results are held against. Cases ("kind"):

- "stage1": one make_train_step_stage1 step from the given field state on
  the given banks (injected indices ``idx`` or draws from a generator
  seeded ``seed``) → loss, metrics, averaged gradients, the parameters
  after, the step's seconds; with ``repeat``, the step again from the same state (are the
  parameters and Adam moments bit-equal?); with ``steps``, that many more
  steps, each timed;
- "stage2": the same for make_train_step_stage2 on a view table
  (``scene_dev``), with a toy guidance ("toy") or the SD stack (tiny or
  full, random from ``seed``, the case config's guidance options),
  tensor-parallel over the mesh's ``model`` axis under "tp" (and then
  the UNet's parameter bytes on the fullest rank); the SD stack in the
  spec's ``dtype`` (default bf16 for "full", f32 for "tiny"); with
  ``sd_order`` "alt", cuDNN's benchmarked convolution algorithms and
  cuBLAS's bf16 reduced-precision reductions flipped for the case (the
  same step in another order of summation); with ``sds_record``, each
  score-distillation injection's masked latent gradient g (``sds_g``, on
  the CPU) and Σ|latents·g| (``sds_abs``);
- "sd_step": one score-distillation step (sd_train_step, csd) on an image
  with the SD stack as in stage2 → loss, the image's gradient and the
  UNet's parameter bytes on the fullest rank;
- "lora": one make_lora_train_step step (``lora_kw``) from adapters
  drawn with ``seed`` on a global batch with injected draws → loss and
  the adapters' averaged gradients.

Each rank counts its kernel launches; the results hold their sum over
the ranks (``launches``). Nothing here imports JAX: the tests spawn it.
"""
from __future__ import annotations

import argparse
import contextlib
import copy
import time

import torch

MESH_AXES = {1: ("data",), 2: ("data", "model")}


def _launch_counts():
    from ..ops import attention, cp_pallas, field_fused, resample

    return (field_fused.LAUNCHES, resample.LAUNCHES, attention.LAUNCHES,
            cp_pallas.LAUNCHES)


def zero_launches() -> None:
    for counts in _launch_counts():
        for k in counts:
            counts[k] = 0


def launches() -> dict:
    return {k: v for counts in _launch_counts() for k, v in counts.items()}


def make_case_mesh(shape, axes=None):
    """A mesh of the given shape over every rank (None: none)."""
    from ..parallel.mesh import make_mesh, make_mesh_2d

    if shape is None:
        return None
    axes = tuple(axes or MESH_AXES[len(shape)])
    if len(shape) == 1:
        return make_mesh(axis=axes[0])
    return make_mesh_2d(shape[0], shape[1], axes=axes)


def _to(tree, device):
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    if isinstance(tree, torch.Tensor):
        return tree.to(device)
    return tree


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _fields(case, device):
    from ..train.state import create_train_state

    state, coarse, fine = create_train_state(
        case["cfg"], torch.Generator().manual_seed(0), device)
    if case.get("float64"):              # the NeRF MLP in float64
        for m in (coarse, fine):
            if m is not None:
                m.double().compute_dtype = torch.float64
    if case.get("fields") is not None:
        coarse.load_state_dict(case["fields"]["coarse"])
        if fine is not None:
            fine.load_state_dict(case["fields"]["fine"])
    return state, coarse, fine


def build_sd(spec, device, mesh=None):
    """The SD stack of a case's guidance spec: {"sd": "tiny" | "full",
    "seed", "latent_size", "tp"}; with "tp", its UNet and VAE
    tensor-parallel over the mesh's ``model`` axis."""
    from ..config import GuidanceConfig
    from ..guidance.stable import build_sd_modules
    from ..guidance.text import CLIPTextConfig
    from ..guidance.unet import UNetConfig
    from ..guidance.vae import VAEConfig
    from ..parallel.mesh import axis_size
    from ..parallel.tp import shard_params_tp

    gcfg = spec.get("gcfg") or GuidanceConfig(sd_tiny=spec["sd"] == "tiny")
    kw = {}
    if spec["sd"] == "tiny":
        kw = dict(unet_config=UNetConfig.tiny(), vae_config=VAEConfig.tiny(),
                  text_config=CLIPTextConfig(vocab_size=49408, width=32,
                                             layers=2, heads=2),
                  dtype=torch.float32)
    if spec.get("dtype"):
        kw["dtype"] = getattr(torch, spec["dtype"])
    mods = build_sd_modules(
        gcfg, torch.Generator(device=device).manual_seed(spec["seed"]),
        device=device, latent_size=spec["latent_size"], **kw)
    if spec.get("tp") and axis_size(mesh, "model") > 1:
        shard_params_tp(mods.unet, mesh)
        shard_params_tp(mods.vae, mesh)
    return gcfg, mods


def _grads(modules: dict) -> dict:
    return {n: {k: p.grad.detach().cpu().clone()
                for k, p in m.named_parameters() if p.grad is not None}
            for n, m in modules.items() if m is not None}


def _params(modules: dict) -> dict:
    return {n: {k: v.detach().cpu().clone()
                for k, v in m.state_dict().items()}
            for n, m in modules.items() if m is not None}


def _bit_equal(a, b) -> bool:
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_bit_equal(a[k], b[k])
                                            for k in a)
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(_bit_equal(x, y)
                                        for x, y in zip(a, b))
    if isinstance(a, torch.Tensor):
        return torch.equal(a, b)
    return a == b


def _step_case(case, device, mesh, make_step, call):
    """One step (and the repeat and timed steps) of a train-step case."""
    state, coarse, fine = _fields(case, device)
    step = make_step(case, coarse, fine, mesh)
    gen = torch.Generator(device=device).manual_seed(case.get("seed", 0))
    snap = copy.deepcopy(state.state_dict())
    gen_state = gen.get_state()
    zero_launches()
    _sync(device)
    t0 = time.perf_counter()
    _, m = call(step, state, gen)
    _sync(device)
    step_s = time.perf_counter() - t0
    out = {"loss": float(m["loss"]), "first_step_s": step_s,
           "metrics": {k: float(v) for k, v in m.items()},
           "grads": _grads({"coarse": coarse, "fine": fine}),
           "params": _params({"coarse": coarse, "fine": fine}),
           "launches": launches()}
    if case.get("repeat"):
        first = copy.deepcopy(state.state_dict())
        state.load_state_dict(copy.deepcopy(snap))
        gen.set_state(gen_state)
        call(step, state, gen)
        out["repeat_equal"] = _bit_equal(first, state.state_dict())
    ms = []
    for _ in range(case.get("steps", 0)):
        _sync(device)
        t0 = time.perf_counter()
        _, m = call(step, state, gen)
        _sync(device)
        ms.append((time.perf_counter() - t0) * 1e3)
    if ms:
        out["step_ms"] = ms
        out["last_loss"] = float(m["loss"])
    return out


def _stage1(case, device, mesh):
    from ..train.step import make_train_step_stage1

    def make(case, coarse, fine, mesh):
        return make_train_step_stage1(case["cfg"], coarse, fine, case["near"],
                                      case["far"], mesh=mesh,
                                      mesh_axis=case.get("axis", "data"),
                                      hwf=case.get("hwf"))

    banks = _to(case["banks"], device)
    idx = _to(case.get("idx"), device)
    return _step_case(case, device, mesh, make,
                      lambda step, state, gen: step(state, banks, gen,
                                                    idx=idx))


def toy_guidance(step_i, combin, normal_map, mask, generator=None, *,
                 rgbs4=None, masks4=None, masked_latents=None, draws=None):
    """The toy guidance of the JAX package's stage-2 dry run: the mean
    squares of the composite, the normal map and the colla views."""
    loss = torch.mean(combin ** 2)
    if normal_map is not None:
        loss = loss + torch.mean(normal_map ** 2)
    if rgbs4 is not None:
        loss = loss + torch.mean(rgbs4 ** 2)
    return loss


@contextlib.contextmanager
def _sds_record(out: dict):
    """Within the block, each score-distillation injection's masked,
    nan-scrubbed latent gradient g is appended to out["sds_g"] (f32, on the
    CPU) and Σ|latents·g| to out["sds_abs"]: the scale of the SDS scalar
    Σ latents·g's terms, which cancel."""
    from ..guidance import stable

    inner = stable.inject_gradient
    out.update(sds_g=[], sds_abs=[])

    def inject(latents, grad, mask=None):
        g = torch.nan_to_num(grad)
        if mask is not None:
            g = g * mask
        out["sds_abs"].append(float(torch.sum(torch.abs(
            latents.detach().double() * g.double()))))
        out["sds_g"].append(g.detach().float().cpu())
        return inner(latents, grad, mask)

    stable.inject_gradient = inject
    try:
        yield
    finally:
        stable.inject_gradient = inner


@contextlib.contextmanager
def _reduction_order(order):
    """order "alt": cuDNN's benchmarked convolution algorithms and the
    flipped cuBLAS bf16 reduced-precision reduction, for the block."""
    if order != "alt":
        yield
        return
    cudnn, mm = torch.backends.cudnn, torch.backends.cuda.matmul
    old = (cudnn.benchmark, mm.allow_bf16_reduced_precision_reduction)
    cudnn.benchmark = True
    mm.allow_bf16_reduced_precision_reduction = not old[1]
    try:
        yield
    finally:
        cudnn.benchmark, mm.allow_bf16_reduced_precision_reduction = old


def _stage2(case, device, mesh):
    from ..guidance.stable import make_guidance_fn
    from ..train.step import make_train_step_stage2

    spec, mods = case["guidance"], None
    if spec == "toy":
        guidance_fn = toy_guidance
    else:
        gcfg, mods = build_sd(dict(spec, gcfg=case["cfg"].guidance), device,
                              mesh)
        guidance_fn = make_guidance_fn(mods, case["cfg"].guidance,
                                       n_iters=case["cfg"].train.N_iters)

    def make(case, coarse, fine, mesh):
        return make_train_step_stage2(case["cfg"], coarse, fine, case["near"],
                                      case["far"], case["hwf"],
                                      guidance_fn=guidance_fn, mesh=mesh,
                                      mesh_axis=case.get("axis", "data"))

    scene_dev = _to(case["scene_dev"], device)
    banks = _to(case["banks"], device)
    idx = _to(case.get("idx"), device)
    draws = _to(case.get("draws"), device)
    rec = {}
    record = case.get("sds_record")
    if record and (case.get("repeat") or case.get("steps")):
        raise ValueError("sds_record holds one step: no repeat, no steps")
    with _reduction_order(case.get("sd_order")), (
            _sds_record(rec) if record else contextlib.nullcontext()):
        out = _step_case(case, device, mesh, make,
                         lambda step, state, gen: step(
                             state, scene_dev, banks, gen, idx=idx,
                             draws=draws))
    out.update(rec)
    if mods is not None:
        from ..parallel.tp import sharded_bytes_per_device

        out["unet_bytes_max"] = sharded_bytes_per_device(mods.unet, mesh)
    return out


def _sd_step(case, device, mesh):
    from ..guidance.stable import sd_train_step
    from ..parallel.tp import sharded_bytes_per_device

    spec = case["guidance"]
    gcfg, mods = build_sd(spec, device, mesh)
    rgb = case["rgb"].to(device).clone().requires_grad_(True)
    draws = _to(case["draws"], device)
    zero_launches()
    loss = sd_train_step(mods, gcfg, case["step_i"], rgb,
                         case["mask"].to(device), None,
                         embeds=mods.embeds_rgb, guidance_scale=7.5,
                         mode="csd", **draws)
    loss.backward()
    _sync(device)
    return {"loss": float(loss), "grad": rgb.grad.detach().cpu(),
            "launches": launches(),
            "unet_bytes_max": sharded_bytes_per_device(mods.unet, mesh)}


def _lora(case, device, mesh):
    from ..guidance.lora import lora_param_count
    from ..train.lora_trainer import make_lora_train_step

    _, mods = build_sd(case["guidance"], device, mesh)
    init_fn, step = make_lora_train_step(mods, mesh=mesh, **case["lora_kw"])
    ad, opt = init_fn(torch.Generator(device=device).manual_seed(
        case["seed"]))
    zero_launches()
    m = step(ad, opt, _to(case["batch"], device),
             draws=_to(case["draws"], device))
    _sync(device)
    return {"loss": float(m["loss"]), "launches": launches(),
            "grads": {k: v.grad.detach().cpu() for k, v in ad.items()},
            "adapters": {k: v.detach().cpu() for k, v in ad.items()},
            "count": lora_param_count(ad)}


KINDS = {"stage1": _stage1, "stage2": _stage2, "sd_step": _sd_step,
         "lora": _lora}


def run_case(case: dict, device, mesh=None) -> dict:
    """One case on this rank (mesh None: the one-process step). With a
    mesh, ``launches`` is the sum over the ranks."""
    import torch.distributed as dist

    out = KINDS[case["kind"]](case, torch.device(device), mesh)
    if mesh is not None:
        keys = sorted(out["launches"])
        t = torch.tensor([float(out["launches"][k]) for k in keys],
                         dtype=torch.float64, device=device)
        dist.all_reduce(t)
        out["launches"] = {k: int(v) for k, v in zip(keys, t.tolist())}
        out["world"] = dist.get_world_size()
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("spec", help="torch.save'd {'cases': [...], 'out': path}")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--dist_backend", default=None,
                    help="nccl (default on the card) or gloo")
    args = ap.parse_args(argv)

    import torch.distributed as dist

    from ..ops import _build
    from ..parallel.mesh import init_distributed, rank
    from ..train.loop import device_from_flag

    torch.set_num_threads(1)
    device = init_distributed(device_from_flag(args.device),
                              args.dist_backend)
    if device.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        _build.load_library()
    spec = torch.load(args.spec, weights_only=False)
    results = []
    for case in spec["cases"]:
        mesh = make_case_mesh(case.get("mesh"), case.get("mesh_axes"))
        t0 = time.perf_counter()
        res = run_case(case, device, mesh)
        res["seconds"] = time.perf_counter() - t0
        res["backend"] = dist.get_backend() if dist.is_initialized() else None
        results.append(res)
    if rank() == 0:
        torch.save(results, spec["out"])
    if dist.is_initialized():
        dist.barrier()
        dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
