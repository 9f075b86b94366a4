"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense
rates without sparsity, at the full 700 W power limit). Every roofline
and mfu share of the benchmark is taken against these, with the card's
power limit printed beside it."""

BF16_FLOPS = 989e12          # bf16 / fp16 tensor cores
TF32_FLOPS = 495e12
F32_FLOPS = 67e12            # f32 outside the tensor cores
HBM_BYTES_PER_S = 3.35e12
HBM_BYTES = 80e9


def roofline_s(flops: float, nbytes: float, flop_rate: float = BF16_FLOPS
               ) -> float:
    """The least time the card could take: the larger of the operations
    over the peak rate and the bytes over the memory rate."""
    return max(flops / flop_rate, nbytes / HBM_BYTES_PER_S)
