"""fp64 reference oracle and the complex64 baseline.

The oracle is NumPy's float64 FFT on host arrays, 1/N-scaled by default to
the library's forward convention, bit-identical to the JAX package's.  On a
CUDA tensor (or with ``device="cuda"``) it is ``torch.fft.fft`` in
complex128 on the card: the role cuFFT Z2Z plays as ground truth in the
original Tensor-FFT harness, and the only way to afford the oracle at
N = 2^28, where numpy's costs tens of seconds per plane.

``torch_baseline`` is ``torch.fft.fft`` in complex64 on the input's device:
the "cuFFT fp32" comparison, never an implementation.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

__all__ = ["fft_oracle", "fftn_oracle", "torch_baseline"]


def _divisor(scaling: str, n: int) -> float:
    """What an n-point DFT is divided by under ``scaling`` (division, as
    the JAX package's oracle does, so the numpy results stay its bits)."""
    if scaling == "forward":
        return n
    if scaling == "ortho":
        return np.sqrt(n)
    if scaling == "none":
        return 1
    raise ValueError(f"bad scaling {scaling!r}")


def _on_card(x, device) -> bool:
    if device is not None:
        return torch.device(device).type != "cpu"
    return isinstance(x, torch.Tensor) and x.device.type != "cpu"


def fft_oracle(re, im, scaling: str = "forward", axis: int = -1, device=None):
    """fp64 forward FFT of a split-complex signal, 1/N-scaled by default.

    Host arrays (and CPU tensors) give numpy float64 planes from
    ``np.fft.fft``.  A CUDA tensor, or ``device="cuda"``, gives float64
    tensors from ``torch.fft.fft`` in complex128 on that device.
    """
    if _on_card(re, device):
        return _oracle_torch(re, im, scaling, axis,
                             torch.device(device) if device is not None
                             else re.device)
    x = _host64(re) + 1j * _host64(im)
    out = np.fft.fft(x, axis=axis) / _divisor(scaling, x.shape[axis])
    return out.real.copy(), out.imag.copy()


def _oracle_torch(re, im, scaling, axis, dev):
    """The oracle in complex128 torch on ``dev``."""
    x = torch.complex(torch.as_tensor(re).to(dev, torch.float64),
                      torch.as_tensor(im).to(dev, torch.float64))
    out = torch.fft.fft(x, dim=axis)
    del x
    out /= _divisor(scaling, out.shape[axis])
    return out.real.contiguous(), out.imag.contiguous()


def fftn_oracle(re, im, axes=None, scaling: str = "forward"):
    """fp64 N-D forward FFT of split-complex host arrays over ``axes`` (all
    by default), 1/prod(N)-scaled by default."""
    x = _host64(re) + 1j * _host64(im)
    out = np.fft.fftn(x, axes=axes)
    if axes is None:
        axes = range(x.ndim)
    out = out / _divisor(scaling, int(np.prod([x.shape[a] for a in axes])))
    return out.real.copy(), out.imag.copy()


def torch_baseline(re, im, scaling: str = "forward"
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``torch.fft.fft`` in complex64 along the last axis, on the input's
    device (cuFFT on the card): float32 (re, im) tensors."""
    x = torch.complex(torch.as_tensor(re).to(torch.float32),
                      torch.as_tensor(im).to(torch.float32))
    out = torch.fft.fft(x, dim=-1)
    out = out / _divisor(scaling, x.shape[-1])
    return out.real, out.imag


def _host64(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().to(torch.float64).numpy()
    return np.asarray(x, dtype=np.float64)
