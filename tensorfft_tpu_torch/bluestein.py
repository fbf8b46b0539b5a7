"""Arbitrary-length FFTs via Bluestein's algorithm (chirp-Z).

Any length N is expressed as a circular convolution of chirp-premultiplied
data with a chirp kernel, both carried by the power-of-two pipeline:

    y[n] = x[n] * a[n],          a[n] = exp(-i*pi*n^2/N)
    X[k] = a[k] * (y (*) b)[k],  b[n] = exp(+i*pi*n^2/N)  (circular, M-pt)

with M = next power of two >= 2N-1.  The chirp tables and the kernel's
M-point spectrum are fp64-accurate host constants (phases reduced mod 2N
before the complex exponential, so n^2 never loses precision to fp64
rounding at large N), cached per (N, device).  The device runs two M-point
transforms through :func:`fft_split` / :func:`ifft_split` (on the card,
kernel A for M <= 16384 and kernels B and C above) and three elementwise
complex products in fp32.

Scaling follows the library convention: 'forward' returns the 1/N-scaled
DFT (progressively scaled inside the M-point transforms), 'none' and
'ortho' analogous.
"""
from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F

from tensorfft_tpu_torch import plan as _plan_mod
from tensorfft_tpu_torch.fft import (_to_complex, _to_split,
                                     fft_split as _fft_split,
                                     ifft_split as _ifft_split, stage_scales)
from tensorfft_tpu_torch.plan import is_power_of_2

__all__ = ["fft_split_any", "ifft_split_any", "fft_any", "ifft_any"]


def _next_pow2(n: int) -> int:
    m = 1
    while m < n:
        m *= 2
    return m


@functools.lru_cache(maxsize=64)
def _tables(n: int, device: torch.device):
    """Chirp a[n] (conjugated pre/post multiplier) and the M-point spectrum
    of the chirp kernel b, both fp64 on the host; returns them as fp32
    tensors on ``device``, with M."""
    m = _next_pow2(2 * n - 1)
    idx = np.arange(n, dtype=np.int64)
    # n^2 mod 2N keeps the phase argument small: exp(-i*pi*k/N) has period
    # 2N in k, and (n^2 mod 2N) is exact integer math where n^2 itself would
    # exceed fp64's 53-bit mantissa for N > ~2^26.
    sq = (idx * idx) % (2 * n)
    phase = -np.pi * sq / n
    a = np.cos(phase) + 1j * np.sin(phase)        # exp(-i pi n^2 / N)
    b = np.zeros(m, np.complex128)
    b[:n] = np.conj(a)                            # exp(+i pi n^2 / N)
    b[m - n + 1:] = np.conj(a)[1:][::-1]          # b[m-k] = b[k]
    b_hat = np.fft.fft(b)                         # unnormalized, fp64

    def dev(x):
        return torch.from_numpy(np.ascontiguousarray(x)).to(device, torch.float32)

    return dev(a.real), dev(a.imag), dev(b_hat.real), dev(b_hat.imag), m


def _cmul(ar, ai, br, bi):
    return ar * br - ai * bi, ar * bi + ai * br


def fft_split_any(re, im, forward: bool = True, scaling: str = "forward",
                  precision: str = "float32", **plan_kwargs):
    """FFT of ANY length along the last axis on split planar tensors, on
    their device.

    Power-of-two lengths delegate to :func:`fft_split`; other lengths run
    Bluestein.  ``precision`` defaults to float32 (the chirp products run in
    fp32 either way; bf16 storage through the 2N-point convolution costs
    ~1 decimal digit — opt in explicitly if wanted).  The M-point plan reads
    the tuner cache (``tuning="auto"``) unless ``tuning=`` is passed, which
    then applies to that plan.  Outputs are in the policy's storage dtype.
    """
    re = torch.as_tensor(re)
    im = torch.as_tensor(im)
    n = re.shape[-1]
    if n < 1 or re.shape != im.shape:
        raise ValueError(f"bad split input shapes {tuple(re.shape)} / {tuple(im.shape)}")
    storage = _plan_mod.Precision(precision).storage_dtype
    if n == 1:
        # The 1-point DFT is the identity: every convention's scale is 1.
        stage_scales((1,), scaling, forward)  # raises on a bad scaling
        return re.to(storage), im.to(storage)
    if is_power_of_2(n):
        plan = _plan_mod.create_plan(n, precision=precision, scaling=scaling,
                                     **plan_kwargs)
        fn = _fft_split if forward else _ifft_split
        return fn(re, im, plan)

    a_re, a_im, bh_re, bh_im, m = _tables(n, re.device)
    if not forward:
        a_im, bh_im = -a_im, -bh_im
    y_re, y_im = _cmul(re.to(torch.float32), im.to(torch.float32), a_re, a_im)
    y_re = F.pad(y_re, (0, m - n))
    y_im = F.pad(y_im, (0, m - n))

    # M-point circular convolution.  The 'none' convention is NumPy's
    # (stage_scales: forward unscaled, inverse carries 1/M), so
    # ifft_none(fft_none(y) * b_hat) IS the convolution — no extra scale.
    m_kwargs = dict(plan_kwargs)
    m_kwargs.setdefault("tuning", "auto")
    mplan = _plan_mod.create_plan(m, precision=precision, scaling="none",
                                  **m_kwargs)
    f_re, f_im = _fft_split(y_re, y_im, mplan)
    g_re, g_im = _cmul(f_re.to(torch.float32), f_im.to(torch.float32),
                       bh_re, bh_im)
    c_re, c_im = _ifft_split(g_re, g_im, mplan)
    c_re = c_re.to(torch.float32)[..., :n]
    c_im = c_im.to(torch.float32)[..., :n]
    o_re, o_im = _cmul(c_re, c_im, a_re, a_im)

    # The core above computes the UNSCALED sum (e^{-} forward, e^{+}
    # inverse); apply the library convention, as one stage of length N.
    (s,) = stage_scales((n,), scaling, forward)
    if s != 1.0:
        o_re = o_re * s
        o_im = o_im * s
    # Match the pow2 delegation's output contract (storage-dtype planes).
    return o_re.to(storage), o_im.to(storage)


def ifft_split_any(re, im, scaling: str = "forward", **kw):
    """Inverse of :func:`fft_split_any` (same conventions as ifft_split)."""
    return fft_split_any(re, im, forward=False, scaling=scaling, **kw)


def fft_any(x, *, device="cuda", **kw):
    """Host-boundary convenience wrapper (any length, run on ``device``,
    returns NumPy complex64)."""
    return _to_complex(*fft_split_any(*_to_split(x, device), **kw))


def ifft_any(x, *, device="cuda", **kw):
    """Inverse of :func:`fft_any` (same host-boundary contract)."""
    return _to_complex(*ifft_split_any(*_to_split(x, device), **kw))
