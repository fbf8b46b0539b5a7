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
    fftn_split, ifftn_split                     — N-D C2C on split planes
    fftn, ifftn, fft2, ifft2                    — their host-array wrappers
    rfft_split, irfft_split                     — 1D R2C / C2R on real rows
    rfft, irfft                                 — their host-array wrappers
    rfftn_split, irfftn_split, rfftn, irfftn    — N-D R2C / C2R
    fft_convolve_2d                             — circular 2D convolution
    fft_convolve_real                           — circular convolution via R2C
    fft_split_any, ifft_split_any, fft_any, ifft_any — any length (Bluestein)
    fftshift, ifftshift, fftshift_split, ifftshift_split, fftfreq, rfftfreq,
    window                                      — spectral utilities
    plan_works_on_device                        — device check
"""

from tensorfft_tpu_torch.plan import (
    FFTPlan,
    Precision,
    Strategy,
    create_plan,
    plan_works_on_device,
)
from tensorfft_tpu_torch.fft import (
    fft,
    fft2,
    fft_split,
    fftn,
    fftn_split,
    ifft,
    ifft2,
    ifft_split,
    ifftn,
    ifftn_split,
)
from tensorfft_tpu_torch.rfft import (
    irfft,
    irfft_split,
    irfftn,
    irfftn_split,
    rfft,
    rfft_split,
    rfftn,
    rfftn_split,
)
from tensorfft_tpu_torch.models.fft_conv import fft_convolve_2d, fft_convolve_real
from tensorfft_tpu_torch.bluestein import (
    fft_any,
    fft_split_any,
    ifft_any,
    ifft_split_any,
)
from tensorfft_tpu_torch.spectral import (
    fftfreq,
    fftshift,
    fftshift_split,
    ifftshift,
    ifftshift_split,
    rfftfreq,
    window,
)

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
    "fftn_split",
    "ifftn_split",
    "fftn",
    "ifftn",
    "fft2",
    "ifft2",
    "rfftn_split",
    "irfftn_split",
    "rfftn",
    "irfftn",
    "fft_convolve_2d",
    "fft_convolve_real",
    "fft_any",
    "ifft_any",
    "fft_split_any",
    "ifft_split_any",
    "fftshift",
    "ifftshift",
    "fftshift_split",
    "ifftshift_split",
    "fftfreq",
    "rfftfreq",
    "window",
    "__version__",
]
