"""Peaks of the card and the counted work of the kernels: the yardstick of
every roofline share the benchmark reports."""

# NVIDIA H100 SXM data sheet, dense rates at the full 700 W limit
PEAK_BYTES_PER_S = 3.35e12     # HBM3
PEAK_F32_PER_S = 67e12         # float32 outside the tensor cores


def least_seconds(flops: float, nbytes: float) -> float:
    """The least time the card could take: the larger of the operations
    over the float32 peak and the bytes over the memory peak."""
    return max(flops / PEAK_F32_PER_S, nbytes / PEAK_BYTES_PER_S)
