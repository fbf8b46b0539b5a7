"""Spectral-analysis utilities: shifts, frequency grids, window functions.

The standard vocabulary around the transform for users coming from
numpy.fft / scipy.signal.  The shifts are ``torch.roll``s on the input's
device; grids and windows are built in fp64 NumPy, as the JAX package
builds them, and handed to the device as tensors of ``dtype`` (the card by
default), bit-identical to the JAX package's values.
"""
from __future__ import annotations

import numpy as np
import torch

__all__ = [
    "fftshift", "ifftshift", "fftshift_split", "ifftshift_split",
    "fftfreq", "rfftfreq", "window",
]


def _norm_axes(x, axes):
    if axes is None:
        return tuple(range(x.ndim))
    if isinstance(axes, int):
        return (axes % x.ndim,)
    return tuple(a % x.ndim for a in axes)


def _roll(x, axes, sign):
    x = torch.as_tensor(x)
    dims = _norm_axes(x, axes)
    if not dims:
        return x
    return torch.roll(x, [sign * (x.shape[d] // 2) for d in dims], dims)


def fftshift(x, axes=None):
    """Shift the zero-frequency bin to the center (numpy.fft.fftshift)."""
    return _roll(x, axes, 1)


def ifftshift(x, axes=None):
    """Inverse of :func:`fftshift` (exact also for odd lengths)."""
    return _roll(x, axes, -1)


def fftshift_split(re, im, axes=None):
    """fftshift on split planar (re, im) planes."""
    return fftshift(re, axes), fftshift(im, axes)


def ifftshift_split(re, im, axes=None):
    return ifftshift(re, axes), ifftshift(im, axes)


def fftfreq(n: int, d: float = 1.0, dtype=torch.float32, device="cuda"):
    """Frequency grid of an n-point C2C transform (numpy.fft.fftfreq)."""
    return torch.from_numpy(np.fft.fftfreq(n, d)).to(device, dtype)


def rfftfreq(n: int, d: float = 1.0, dtype=torch.float32, device="cuda"):
    """Frequency grid of the n-point R2C transform (numpy.fft.rfftfreq)."""
    return torch.from_numpy(np.fft.rfftfreq(n, d)).to(device, dtype)


_WINDOWS = {
    "rect": lambda n: np.ones(n),
    "hann": lambda n: np.hanning(n),
    "hamming": lambda n: np.hamming(n),
    "blackman": lambda n: np.blackman(n),
    "bartlett": lambda n: np.bartlett(n),
    "kaiser14": lambda n: np.kaiser(n, 14.0),
}


def window(kind: str, n: int, dtype=torch.float32, periodic: bool = False,
           device="cuda"):
    """Window function of length ``n`` (fp64-accurate, cast to ``dtype``).

    ``periodic=True`` returns the DFT-even variant (the n-point slice of the
    (n+1)-point symmetric window) — the right choice when the windowed frame
    feeds an FFT for spectral analysis; the default symmetric variant is the
    filter-design convention (matching numpy's window functions).
    """
    try:
        fn = _WINDOWS[kind]
    except KeyError:
        raise ValueError(
            f"unknown window {kind!r}; available: {sorted(_WINDOWS)}"
        ) from None
    w = fn(n + 1)[:n] if periodic else fn(n)
    return torch.from_numpy(np.ascontiguousarray(w, np.float64)).to(device, dtype)
