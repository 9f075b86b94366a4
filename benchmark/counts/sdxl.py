"""Work of the SDXL-inpainting stack at a cell's shapes, counted on the plain
reference (reference/sdxl.py).

``lora_step_flops``: the model FLOPs of one LoRA step, counted by torch's
FlopCounterMode over the reference run on the meta device: both text
towers on the batch's captions, the two VAE encodes of each sample, the
UNet's forward and the backward that the adapters' gradients need (no
weight gradient of the frozen stack). Products only, 2 per multiply-add.

``long_self_attention``: the self-attention calls of one LoRA step whose
sequences reach counts/sd.py's LONG tokens, the calls K7 serves: each
transformer of a level with attention runs its depth of blocks (down
blocks: layers_per_block transformers, up blocks one more, the mid block
one at the last level's depth), and the VAE encoder's mid block twice a
sample (the image and the masked image), one head of the last width.
"""
from __future__ import annotations

from typing import List, Tuple

from benchmark.counts.sd import LONG


def long_self_attention(c: dict, batch: int
                        ) -> List[Tuple[int, int, int, int]]:
    """[(bh, n, d, calls)] of one LoRA step's self-attention at ≥ LONG
    tokens."""
    uc, vc, L = c["unet"], c["vae"], c["lora"]
    lat = L["resolution"] // 8
    chs = uc["block_out_channels"]
    heads, depth = uc["attention_head_dim"], uc["transformer_layers_per_block"]
    lpb, last = uc["layers_per_block"], len(chs) - 1
    down = [t.startswith("CrossAttn") for t in uc["down_block_types"]]
    up = [t.startswith("CrossAttn") for t in uc["up_block_types"]][::-1]
    out = []
    for i, ch in enumerate(chs):
        n = (lat >> i) ** 2
        transformers = (lpb * down[i] + (lpb + 1) * up[i]
                        + (1 if i == last else 0))
        if transformers and n >= LONG:
            out.append((batch * heads[i], n, ch // heads[i],
                        transformers * depth[i]))
    n_vae = (L["resolution"] >> (len(vc["block_out_channels"]) - 1)) ** 2
    if n_vae >= LONG:
        out.append((batch, n_vae, vc["block_out_channels"][-1], 2))
    return out


def lora_step_flops(c: dict) -> float:
    """FLOPs of one LoRA step (see the module note)."""
    import torch
    from torch.utils.flop_counter import FlopCounterMode

    from benchmark.reference import sdxl as ref

    uc, vc, tc, L = c["unet"], c["vae"], c["text_encoder"], c["lora"]
    B, res, rank = L["train_batch_size"], L["resolution"], L["rank"]
    lat = res // 8
    width = c["text_encoder"]["hidden_size"] + \
        c["text_encoder_2"]["hidden_size"]
    with torch.device("meta"):
        unet, vae = ref.UNet(uc), ref.VAE(vc)
        text1 = ref.CLIPText(tc)
        text2 = ref.CLIPText(c["text_encoder_2"])
        for m in (unet, vae, text1, text2):
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
                                         width)),
                  "pooled": torch.zeros(
                      (c["text_encoder_2"]["projection_dim"],)),
                  "time_ids": torch.zeros(6),
                  "t": torch.zeros((), dtype=torch.long),
                  "noise": torch.zeros(shape), "enc_eps": torch.zeros(shape),
                  "enc_masked_eps": torch.zeros(shape)}
        ac = torch.zeros(1000)
        ids = torch.zeros((B, tc["max_position_embeddings"]),
                          dtype=torch.long)
        counter = FlopCounterMode(display=False)
        with counter:
            with torch.no_grad():
                ref.encode_text(text1, text2, ids)
            for _ in range(B):
                ref.lora_loss(unet, vae, ad, 1.0, sample, ac,
                              vc["scaling_factor"]).backward()
    return float(counter.get_total_flops())
