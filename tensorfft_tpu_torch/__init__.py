"""tensorfft_tpu_torch — the PyTorch / CUDA port of tensorfft_tpu.

Power-of-two complex FFTs computed as Cooley-Tukey stages of DFT-matrix
products with fp32 accumulation, on split-planar (re, im) tensors.  On CUDA
tensors the transforms run in hand-written kernels for the NVIDIA H100
(``csrc/``, built with nvcc at first use); on CPU tensors they run the plain
torch versions of the same kernels.  Every function runs on the device of its
input tensors.  This package imports torch and numpy, never jax.

Public API:
    create_plan, FFTPlan, Precision, Strategy   — planning
    fft_split, ifft_split                       — 1D C2C on split planes
    fft, ifft                                   — complex convenience wrappers
    rfft_split, irfft_split                     — 1D R2C / C2R on real rows
    rfft, irfft                                 — their host-array wrappers
    fft_convolve_real                           — circular convolution via R2C
    plan_works_on_device                        — device check
"""

from tensorfft_tpu_torch.plan import (
    FFTPlan,
    Precision,
    Strategy,
    create_plan,
    plan_works_on_device,
)
from tensorfft_tpu_torch.fft import fft, fft_split, ifft, ifft_split
from tensorfft_tpu_torch.rfft import irfft, irfft_split, rfft, rfft_split
from tensorfft_tpu_torch.models.fft_conv import fft_convolve_real

__version__ = "0.1.0"

__all__ = [
    "FFTPlan",
    "Precision",
    "Strategy",
    "create_plan",
    "plan_works_on_device",
    "fft",
    "ifft",
    "fft_split",
    "ifft_split",
    "rfft",
    "irfft",
    "rfft_split",
    "irfft_split",
    "fft_convolve_real",
    "__version__",
]
