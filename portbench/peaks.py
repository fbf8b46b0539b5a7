"""Published peaks of one NVIDIA H100 SXM (NVIDIA data sheet, dense rates
without sparsity, at the full 700 W power limit).

A card may run below 700 W; the harness prints the card's ``power.limit``
beside every result, and roofline shares are stated against these peaks.
A configuration names its operation peak by key (``peak_flops``).
"""

FLOPS = {"bf16_dense": 989e12}   # bf16 / fp16 tensor cores
HBM_BYTES_PER_S = 3.35e12
