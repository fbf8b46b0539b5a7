"""Device capability description for the CUDA path.

One spec: the NVIDIA H100 SXM the kernels are written for (NVIDIA data sheet
and Hopper white paper, 700 W part).  ``plan_works_on_device`` budgets each
kernel's per-CTA shared memory and its thread-block clusters against it,
and ``chip_smoke.py`` reads its peaks for roofline shares.  A card may run below 700 W; the peaks assume the
full power limit.
"""
from __future__ import annotations

import dataclasses

import torch

__all__ = ["DeviceSpec", "H100", "device_spec"]


@dataclasses.dataclass(frozen=True)
class DeviceSpec:
    kind: str
    sm_count: int
    smem_per_block_bytes: int  # opt-in dynamic shared memory per block
    smem_per_sm_bytes: int     # shared memory of one SM (shared with L1)
    max_cluster: int           # CTAs of the largest portable block cluster
    hbm_bandwidth: float       # bytes/s
    bf16_flops: float          # dense tensor-core peak, FLOP/s
    fp32_flops: float          # CUDA-core fp32 peak, FLOP/s


H100 = DeviceSpec(
    kind="H100 SXM",
    sm_count=132,
    smem_per_block_bytes=232448,  # 227 KB
    smem_per_sm_bytes=233472,     # 228 KB
    max_cluster=8,
    hbm_bandwidth=3.35e12,
    bf16_flops=989e12,
    fp32_flops=67e12,
)


def device_spec(device) -> DeviceSpec:
    """The spec the kernels budget against on ``device`` (a CUDA device)."""
    device = torch.device(device)
    if device.type != "cuda":
        raise ValueError(f"no kernel device spec for {device}")
    return H100
