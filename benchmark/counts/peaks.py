"""The table of peaks: one NVIDIA H100 SXM 80 GB, NVIDIA's datasheet,
dense rates, at the full 700 W power limit (a run prints the card's own
limit beside every share it reports).  The port runs FP32 outside the
tensor cores, so FP32 is its peak."""

FP32_FLOPS = 67e12  # FP32, outside the tensor cores
HBM_BYTES_PER_S = 3.35e12  # HBM3
