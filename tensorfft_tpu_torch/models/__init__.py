"""Applications built on the transforms: FFT-based convolution (the JAX
package's config 3 and 4) and the spectral Poisson solve (config 5)."""

from tensorfft_tpu_torch.models.fft_conv import fft_convolve_2d, fft_convolve_real
from tensorfft_tpu_torch.models.poisson import poisson_solve_3d

__all__ = ["fft_convolve_2d", "fft_convolve_real", "poisson_solve_3d"]
