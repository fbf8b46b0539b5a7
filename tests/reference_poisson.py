"""Plain reference of the periodic spectral Poisson solve.

``torch.fft.rfftn`` of f in float64, divided by the Laplacian's eigenvalues
(the formula of ``_spectral_laplacian`` in the JAX package: discrete
-4 sin^2(pi k / n) / h^2 per axis, or continuous -(2 pi k / L)^2), the mean
mode zeroed, then ``torch.fft.irfftn`` back: u in float64.  It imports torch
alone: nothing of the port and nothing of JAX.
"""
import math

import torch


def eigenvalues(n, length, discrete, bins=None, device=None):
    """float64 eigenvalues along one axis in ``fftfreq`` order (the first
    ``bins`` of them)."""
    k = torch.fft.fftfreq(n, dtype=torch.float64, device=device) * n
    if discrete:
        lam = -4.0 / (length / n) ** 2 * torch.sin(math.pi * k / n) ** 2
    else:
        lam = -(2 * math.pi * k / length) ** 2
    return lam[:bins]


def laplacian(shape, lengths=(1.0, 1.0, 1.0), discrete=True, device=None):
    """lambda over the half spectrum (nx, ny, nz/2+1), float64."""
    nx, ny, nz = shape
    lx, ly, lz = lengths
    return (eigenvalues(nx, lx, discrete, device=device)[:, None, None]
            + eigenvalues(ny, ly, discrete, device=device)[None, :, None]
            + eigenvalues(nz, lz, discrete, nz // 2 + 1, device)[None, None, :])


def solve(f, lengths=(1.0, 1.0, 1.0), discrete=True):
    """float64 u with laplacian(u) = f - mean(f), zero mean, periodic."""
    f = torch.as_tensor(f).to(torch.float64)
    lam = laplacian(tuple(f.shape), lengths, discrete, f.device)
    lam[0, 0, 0] = 1.0
    spec = torch.fft.rfftn(f) / lam
    spec[0, 0, 0] = 0.0
    return torch.fft.irfftn(spec, s=tuple(f.shape))
