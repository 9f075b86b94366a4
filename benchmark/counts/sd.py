"""Work of the SD stack at a cell's shapes, counted on the plain reference.

``lora_step_flops``: the model FLOPs of one LoRA step, counted by
torch's FlopCounterMode over the reference (reference/sd.py) run on the
meta device: the text tower on the batch's captions, the two VAE encodes
of each sample, the UNet's forward and the backward that the adapters'
gradients need (no weight gradient of the frozen stack). Products only,
as FlopCounterMode counts them (2 per multiply-add).

``long_self_attention``: the self-attention calls of one LoRA step whose
sequences reach 1024 tokens (the UNet's 64² and 32² levels and the VAE's
mid block), the calls a flash kernel serves, with ``attention_work``'s
FLOPs and bytes for each: the FLOP and byte counts of chip_smoke.py's
attention_bound (commit e283e2e) without its SFU term, which rests on
the clock nvidia-smi reads and is no published peak.
"""
from __future__ import annotations

from typing import List, Tuple

LONG = 1024


def attention_work(bh: int, n: int, d: int, in_bytes: int = 2
                   ) -> Tuple[float, float]:
    """(FLOPs, bytes) of one attention call: q·kᵀ and p·v, 2·N²·D each
    per head; q, k and v read once and the output written once."""
    return 4.0 * bh * n * n * d, 4.0 * bh * n * d * in_bytes


def long_self_attention(c: dict, batch: int
                        ) -> List[Tuple[int, int, int, int]]:
    """[(bh, n, d, calls)] of one LoRA step's self-attention at ≥ LONG
    tokens: the UNet's transformers (down: layers_per_block a level, up:
    one more) and the VAE encoder's mid block, twice a sample (the image
    and the masked image)."""
    uc, vc, L = c["unet"], c["vae"], c["lora"]
    lat = L["resolution"] // 8
    heads = uc["attention_head_dim"]
    lpb = uc["layers_per_block"]
    out = []
    for i, (ch, kind) in enumerate(zip(uc["block_out_channels"],
                                       uc["down_block_types"])):
        n = (lat >> i) ** 2
        if kind == "CrossAttnDownBlock2D" and n >= LONG:
            out.append((batch * heads, n, ch // heads, 2 * lpb + 1))
    n_vae = (L["resolution"] >> (len(vc["block_out_channels"]) - 1)) ** 2
    if n_vae >= LONG:
        out.append((batch, n_vae, vc["block_out_channels"][-1], 2))
    return out


def lora_step_flops(c: dict) -> float:
    """FLOPs of one LoRA step (see the module note)."""
    import torch
    from torch.utils.flop_counter import FlopCounterMode

    from benchmark.reference import sd as ref

    uc, vc, tc, L = c["unet"], c["vae"], c["text_encoder"], c["lora"]
    B, res, rank = L["train_batch_size"], L["resolution"], L["rank"]
    lat = res // 8
    with torch.device("meta"):
        unet, vae, text = ref.UNet(uc), ref.VAE(vc), ref.CLIPText(tc)
        for m in (unet, vae, text):
            m.requires_grad_(False)
        params = dict(unet.named_parameters())
        ad = {}
        for n in ref.lora_targets(unet):
            ad[n + ".A"] = torch.zeros((params[n][0].numel(), rank),
                                       requires_grad=True)
            ad[n + ".B"] = torch.zeros((rank, params[n].shape[0]),
                                       requires_grad=True)
        shape = (lat, lat, vc["latent_channels"])
        sample = {"image": torch.zeros((res, res, 3)),
                  "mask": torch.zeros((res, res)),
                  "instance_mask": torch.zeros((res, res)),
                  "embeds": torch.zeros((tc["max_position_embeddings"],
                                         tc["hidden_size"])),
                  "t": torch.zeros((), dtype=torch.long),
                  "noise": torch.zeros(shape), "enc_eps": torch.zeros(shape),
                  "enc_masked_eps": torch.zeros(shape)}
        ac = torch.zeros(1000)
        ids = torch.zeros((B, tc["max_position_embeddings"]),
                          dtype=torch.long)
        counter = FlopCounterMode(display=False)
        with counter:
            with torch.no_grad():
                text(ids)
            for _ in range(B):
                ref.lora_loss(unet, vae, ad, 1.0, sample, ac).backward()
    return float(counter.get_total_flops())
