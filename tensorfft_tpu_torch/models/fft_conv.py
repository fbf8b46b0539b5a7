"""FFT-based circular convolution (port of ``tensorfft_tpu/models/fft_conv.py``).

conv(a, b) = IFFT(FFT(a) * FFT(b)).  The 2D variant runs the row-column
2D transforms (the JAX package's config 3: K4 on the last two axes); the
real 1D variant runs the R2C/C2R pair.
"""
from __future__ import annotations

import torch

from tensorfft_tpu_torch.fft import fftn_split, ifftn_split
from tensorfft_tpu_torch.plan import create_plan
from tensorfft_tpu_torch.rfft import irfft_split, rfft_split

__all__ = ["fft_convolve_2d", "fft_convolve_real"]


def _cmul(a_re, a_im, b_re, b_im):
    return a_re * b_re - a_im * b_im, a_re * b_im + a_im * b_re


def fft_convolve_2d(image, kernel, precision: str = "float32"):
    """Circular 2D convolution of ``image`` with ``kernel`` (same trailing
    shape) over the last two axes, as ifft2(fft2(image) * fft2(kernel)), on
    their device; real inputs, float32 output."""
    image = torch.as_tensor(image).to(torch.float32)
    kernel = torch.as_tensor(kernel).to(torch.float32)
    if image.shape[-2:] != kernel.shape[-2:]:
        raise ValueError(f"shape mismatch {tuple(image.shape)} vs {tuple(kernel.shape)}")
    axes = (-2, -1)
    fi_re, fi_im = fftn_split(image, torch.zeros_like(image), axes=axes,
                              precision=precision)
    fk_re, fk_im = fftn_split(kernel, torch.zeros_like(kernel), axes=axes,
                              precision=precision)
    # The product stays fp32 whatever the plan stores.
    p_re, p_im = _cmul(fi_re.to(torch.float32), fi_im.to(torch.float32),
                       fk_re.to(torch.float32), fk_im.to(torch.float32))
    o_re, _ = ifftn_split(p_re, p_im, axes=axes, precision=precision)
    # Both forward transforms scale by 1/(H*W) and the inverse not at all, so
    # the product carries one 1/(H*W) too many.
    return o_re.to(torch.float32) * (image.shape[-2] * image.shape[-1])


def fft_convolve_real(a, b, precision: str = "float32"):
    """Circular 1D convolution of two real signals along the last axis, on
    their device; returns float32."""
    a = torch.as_tensor(a).to(torch.float32)
    b = torch.as_tensor(b).to(torch.float32)
    n = a.shape[-1]
    if b.shape[-1] != n:
        raise ValueError("signals must have equal length")
    plan = create_plan(n // 2, precision=precision)
    fa_re, fa_im = rfft_split(a, plan)
    fb_re, fb_im = rfft_split(b, plan)
    # The product stays fp32 whatever the plan stores; the C2R pass takes it
    # uncast.
    p_re, p_im = _cmul(fa_re.to(torch.float32), fa_im.to(torch.float32),
                       fb_re.to(torch.float32), fb_im.to(torch.float32))
    out = irfft_split(p_re, p_im, plan)
    return out.to(torch.float32) * n
