"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense
rates, at the full 700 W power limit). A share of a roofline is stated
against these, with the card's power limit beside it."""

F32_OPS_PER_S = 67e12          # float32 outside the tensor cores
TF32_OPS_PER_S = 495e12
BF16_OPS_PER_S = 989e12
INT8_OPS_PER_S = 1979e12
HBM_BYTES_PER_S = 3.35e12      # HBM3


def bound_s(ops: float, nbytes: float, ops_per_s: float = F32_OPS_PER_S):
    """The least time of a call: the larger of its operations at the peak
    rate and its bytes at the HBM rate. Returns (seconds, "operations" or
    "bytes")."""
    t_o, t_b = ops / ops_per_s, nbytes / HBM_BYTES_PER_S
    return max(t_o, t_b), ("bytes" if t_b >= t_o else "operations")
