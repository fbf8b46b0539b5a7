"""Plain reference of the N-D complex-to-complex transform of split planes.

``torch.fft.fftn`` on complex128 over the given axes: sign -1 forward and +1
inverse, each axis scaled by the library's convention (``"forward"``: 1/n
per axis forward, the inverse unscaled; ``"none"``: the inverse 1/n per
axis; ``"ortho"``: n^-1/2 per axis both ways).  It imports torch alone:
nothing of the port and nothing of JAX.
"""
import math

import torch

_SCALES = {
    "forward": {True: lambda n: 1.0 / n, False: lambda n: 1.0},
    "none": {True: lambda n: 1.0, False: lambda n: 1.0 / n},
    "ortho": {True: lambda n: n ** -0.5, False: lambda n: n ** -0.5},
}


def fftn(re, im, axes=None, forward=True, scaling="forward"):
    """complex128: the DFT of ``re + i im`` over ``axes`` (all by default)."""
    x = torch.complex(torch.as_tensor(re).to(torch.float64),
                      torch.as_tensor(im).to(torch.float64))
    axes = tuple(range(x.ndim)) if axes is None else tuple(axes)
    n = math.prod(x.shape[a] for a in axes)
    # torch.fft.ifftn divides by n; the unscaled sum with sign +1 is n times it.
    y = torch.fft.fftn(x, dim=axes) if forward else torch.fft.ifftn(x, dim=axes) * n
    return y * _SCALES[scaling][forward](n)
