"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense
rates, at the full 700 W power limit)."""

#: float32 outside the tensor cores, a fused multiply-add counted as two
FLOAT32_OPS_PER_S = 67e12
#: HBM3
BYTES_PER_S = 3.35e12


def least_seconds(ops, nbytes):
    """The least time the card could take: operations over the float32
    rate or bytes over the memory rate, whichever is larger."""
    return max(ops / FLOAT32_OPS_PER_S, nbytes / BYTES_PER_S)
