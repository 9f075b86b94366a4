"""LoRA: low-rank adapters on the SD UNet (and the CLIP text tower).

Port of gbnerf_tpu/guidance/lora.py. Rank/α 32 adapters on the attention
projections (to_q/k/v/out), the feed-forward (ff.net_0.proj / ff.net_2)
and the transformers' 1×1 projection convs; optional rank-4 text-encoder
adapters on q/k/v/out_proj.

**The file format is the JAX package's.** Adapters are a flat dict keyed
by the target's flax path joined by "." plus ``lora_A`` / ``lora_B``
(``down_0_attentions_0.transformer_blocks_0.attn1.to_q.kernel.lora_A``);
A is [I_flat, r] and B [r, O] in flax's orientation, I_flat the kernel's
fan-in in flax's (h, w, i) order. The targets are selected by the JAX
package's patterns on those flax paths (convert.flax_key names each port
parameter), and a file written by one package merges identically in the
other (safetensors, through guidance/weights.py's reader and writer).

Layouts: a Dense target's torch weight [O, I] is the flax kernelᵀ, so its
delta is (A@B)ᵀ; a conv's delta is (A@B).reshape(kh, kw, I, O) → OIHW.
The sum W' = W + (α/r)·delta is taken in f32 and rounded to W's dtype once
(the JAX package adds into f32 params and rounds to bf16 in the layer; an
add in bf16 would lose updates below W's half-ulp).

Training is functional, as in the JAX package: ``apply_lora`` returns the
effective weights {name: W'} for ``torch.func.functional_call`` over the
frozen module, and gradients flow only into A and B. The A init is an
argument (``init_lora(..., a_init=)``) or drawn from a generator or, as
the JAX package draws it, from a JaxKey.
"""
from __future__ import annotations

import re
from typing import Dict, Iterator, Optional, Tuple

import torch
from torch import nn

from .. import convert
from ..utils import jax_random as jr
from ..utils.profiling import SPAN_LORA_APPLY, annotate

DEFAULT_TARGETS = (
    r".*/attn[12]/to_q/kernel$",
    r".*/attn[12]/to_k/kernel$",
    r".*/attn[12]/to_v/kernel$",
    r".*/attn[12]/to_out_0/kernel$",
    r".*/ff/net_0/proj/kernel$",
    r".*/ff/net_2/kernel$",
    r".*/proj_in/kernel$",
    r".*/proj_out/kernel$",
)

TEXT_TARGETS = (
    r".*/(q_proj|k_proj|v_proj|out_proj)/kernel$",
)

Adapters = Dict[str, torch.Tensor]


def _rules(module: nn.Module):
    """The name rules of ``module``'s flax twin (the text tower's differ)."""
    from .text import CLIPTextEncoder

    return (convert._TEXT_RULES_INV if isinstance(module, CLIPTextEncoder)
            else convert._SD_RULES_INV)


def _kernel_params(module: nn.Module) -> Iterator[Tuple[str, str,
                                                        nn.Parameter]]:
    """(port name, flax path joined by ".", parameter) of every Conv and
    Dense weight of ``module``."""
    rules = _rules(module)
    for name, p in module.named_parameters():
        if name.endswith(".weight") and p.dim() in (2, 4):
            yield name, convert.flax_key(name, p.dim(), rules), p


def _match(path: str, patterns) -> bool:
    s = path.replace(".", "/")
    return any(re.match(p, s) for p in patterns)


def _fan(p: torch.Tensor) -> Tuple[int, int]:
    """(I_flat, O) of a torch weight in flax's orientation."""
    return p[0].numel(), p.shape[0]


def lora_targets(module: nn.Module, targets=DEFAULT_TARGETS
                 ) -> Dict[str, str]:
    """{flax kernel path: port parameter name} of the weights the patterns
    select."""
    return {path: name for name, path, _ in _kernel_params(module)
            if _match(path, targets)}


def init_lora(module: nn.Module, *, rank: int = 32, targets=DEFAULT_TARGETS,
              generator=None, a_init: Optional[Adapters] = None
              ) -> Adapters:
    """The adapters of every selected kernel: A [I_flat, r] normal/√r (or
    ``a_init[path + ".lora_A"]``), B [r, O] zeros (identity at init), f32,
    on the module's device. generator: a torch.Generator, or a JaxKey: the
    JAX package's A, ``normal(keys[i % 4096])`` of ``split(key, 4096)``
    with i the kernel's rank among the selected ones in the order of the
    JAX tree's leaves (its dicts' keys sorted, as jit returns them), so by
    flax path, not by the port's module order."""
    sel = [(name, path, p) for name, path, p in _kernel_params(module)
           if _match(path, targets)]
    keys = {}
    if jr.is_jax(generator):
        split = jr.key_split(generator, 4096)
        order = sorted(sel, key=lambda s: tuple(s[1].split(".")))
        keys = {path: split[i % 4096] for i, (_, path, _) in
                enumerate(order)}
    out: Adapters = {}
    for name, path, p in sel:
        i_flat, o = _fan(p)
        key = path + ".lora_A"
        if a_init is not None:
            a = torch.as_tensor(a_init[key], dtype=torch.float32,
                                device=p.device).clone()
        elif keys:
            a = jr.normal(keys[path], (i_flat, rank), torch.float32,
                          p.device) / torch.tensor(
                              rank ** 0.5, dtype=torch.float32)
        else:
            a = torch.randn((i_flat, rank), generator=generator,
                            device=p.device) / rank ** 0.5
        out[key] = a
        out[path + ".lora_B"] = torch.zeros((rank, o), device=p.device)
    return out


def _delta(p: torch.Tensor, a: torch.Tensor, b: torch.Tensor
           ) -> torch.Tensor:
    """(A@B) in flax's kernel layout → the torch weight's layout, f32."""
    d = a.float() @ b.float()                          # [I_flat, O]
    if p.dim() == 2:
        return d.t()
    o, i, kh, kw = p.shape
    return d.reshape(kh, kw, i, o).permute(3, 2, 0, 1)


def _scale(adapters: Adapters, rank: Optional[int],
           alpha: Optional[float]) -> float:
    if rank is None:
        rank = next(v.shape[1] for k, v in adapters.items()
                    if k.endswith(".lora_A"))
    return (alpha if alpha is not None else rank) / rank


def apply_lora(module: nn.Module, adapters: Adapters, *, rank: Optional[int]
               = None, alpha: Optional[float] = None
               ) -> Dict[str, torch.Tensor]:
    """The effective weights {port name: W + (α/r)·delta} of every adapted
    kernel, for ``torch.func.functional_call``; an adapter whose path is
    not a kernel of ``module`` is skipped, as the JAX package's apply_lora
    skips it (merge_lora_strict refuses it)."""
    scale = _scale(adapters, rank, alpha) if adapters else 1.0
    out = {}
    with annotate(SPAN_LORA_APPLY):
        for name, path, p in _kernel_params(module):
            a = adapters.get(path + ".lora_A")
            if a is None:
                continue
            b = adapters[path + ".lora_B"]
            out[name] = (p.float() + scale * _delta(p, a, b)).to(p.dtype)
    return out


def lora_param_count(adapters: Adapters) -> int:
    return sum(v.numel() for v in adapters.values())


def save_lora(adapters: Adapters, path: str) -> None:
    """Adapters → safetensors with the flax-path keys."""
    from .weights import write_safetensors

    write_safetensors(path, {k: v.detach().float() for k, v in
                             adapters.items()})


def load_lora(path: str) -> Adapters:
    from .weights import read_safetensors

    return {k: v.clone() for k, v in read_safetensors(path).items()}


def split_adapters(path: str) -> Tuple[Adapters, Optional[Adapters]]:
    """A train_lora checkpoint → (UNet adapters, text adapters or None).
    With text adapters the trainer writes {"unet": …, "text": …}, whose
    flat keys start with "unet." / "text."; a bare UNet tree's roots are
    UNet module names, never exactly those."""
    flat = load_lora(path)
    roots = {k.split(".", 1)[0] for k in flat}
    if roots <= {"unet", "text"} and "unet" in roots:
        parts = {r: {k.split(".", 1)[1]: v for k, v in flat.items()
                     if k.split(".", 1)[0] == r} for r in roots}
        return parts["unet"], parts.get("text")
    return flat, None


def merge_lora_strict(module: nn.Module, adapters: Adapters, *,
                      alpha: Optional[float] = None, what: str = "unet",
                      source: str = "?") -> nn.Module:
    """Merge adapters into ``module``'s weights in place, refusing loudly
    any adapter that does not fit (no such kernel, A's rows ≠ the fan-in,
    B ≠ [r, O]) or a file with none: a tiny-vs-full or width mismatch must
    not silently leave the guidance prior unadapted."""
    kernels = {path: p for _, path, p in _kernel_params(module)}
    bad, n = [], 0
    for key, a in adapters.items():
        if not key.endswith(".lora_A"):
            continue
        tgt = key[:-len(".lora_A")]
        shown = tgt.replace(".", "/")
        p = kernels.get(tgt)
        if p is None:
            bad.append(f"{shown} (no such param)")
            continue
        i_flat, o = _fan(p)
        if a.shape[0] != i_flat:
            bad.append(f"{shown} (lora_A rows {a.shape[0]} != base fan-in "
                       f"{i_flat})")
            continue
        b = adapters.get(tgt + ".lora_B")
        b_shape = None if b is None else tuple(b.shape)
        if b_shape != (a.shape[1], o):
            bad.append(f"{shown} (lora_B {b_shape} != ({a.shape[1]}, {o}))")
            continue
        n += 1
    if bad or n == 0:
        raise ValueError(
            f"LoRA checkpoint {source} does not fit the {what} it is being "
            f"loaded into ({n} adapters matched, {len(bad)} mismatched"
            + (": " + "; ".join(bad[:5]) if bad else "")
            + "). The adapters must be trained on the SAME stack config "
            "(tiny vs full, width) as the guidance run.")
    dev = next(module.parameters()).device
    adapters = {k: v.to(dev) for k, v in adapters.items()}
    eff = apply_lora(module, adapters, alpha=alpha)
    params = dict(module.named_parameters())
    with torch.no_grad():
        for name, w in eff.items():
            params[name].copy_(w)
    return module
