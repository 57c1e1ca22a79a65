"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense, at
the full 700 W power limit); a run logs the card's own limit beside them."""

HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12


def bound_s(n_bytes: float, n_ops: float = 0.0) -> float:
    """The least time the work can take: the larger of its bytes over the
    memory bandwidth and its float32 operations over the float32 peak."""
    return max(n_bytes / HBM_BYTES_PER_S, n_ops / F32_OPS_PER_S)
