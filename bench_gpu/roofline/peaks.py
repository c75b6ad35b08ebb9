"""Published peaks of one NVIDIA H100 SXM (data sheet; dense, at the full
700 W power limit), and the least time a piece of work can take on it."""

HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12  # float32 outside the tensor cores


def bound_s(nbytes: float, ops: float) -> float:
    """The larger of the bytes at the memory's peak and the float32
    operations at the cores' peak, in seconds."""
    return max(nbytes / HBM_BYTES_PER_S, ops / F32_OPS_PER_S)
