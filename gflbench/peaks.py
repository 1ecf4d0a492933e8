"""The peaks of one NVIDIA H100 SXM, the yardstick of every roofline and
utilization share the benchmark reports.

NVIDIA's H100 SXM data sheet at the full 700 W power limit, dense rates
without sparsity.  A card set below that limit runs slower under load, so
a share against these peaks is read beside the card's name and power
limit (``nvidia-smi``).
"""
HBM_BYTES_PER_S = 3.35e12        # HBM3, 80 GB
F32_FLOPS_PER_S = 67e12          # fp32 outside the tensor cores, FMA = 2
BF16_FLOPS_PER_S = 989e12        # bf16 tensor cores, dense
