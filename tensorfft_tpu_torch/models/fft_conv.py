"""FFT-based circular convolution (port of ``tensorfft_tpu/models/fft_conv.py``).

conv(a, b) = IFFT(FFT(a) * FFT(b)).  The 2D variant runs the row-column
2D transforms (the JAX package's config 3: K4 on the last two axes); the
real 1D variant runs the R2C/C2R pair.  Both take the spectra's product
through ``ops/spectral_cuda.py:spectral_product`` (on the card one launch of
``tfft::spectral_product_kernel``, where the JAX package runs ``_cmul``'s
four products, difference and sum as separate XLA operations); CPU tensors
take its plain version, which rounds at the same steps in fp32, so the two
give the same bits.
"""
from __future__ import annotations

import torch

from tensorfft_tpu_torch import tracing
from tensorfft_tpu_torch.fft import fftn_split, ifftn_split
from tensorfft_tpu_torch.ops import spectral_cuda
from tensorfft_tpu_torch.plan import create_plan
from tensorfft_tpu_torch.rfft import irfft_split, rfft_split

__all__ = ["fft_convolve_2d", "fft_convolve_real"]

# Calls since import (``tracing.counters()["models"]``).
model_counts = {"conv2d_calls": 0, "conv_real_calls": 0}


@tracing.spanned("tfft.model.conv2d")
def fft_convolve_2d(image, kernel, precision: str = "float32"):
    """Circular 2D convolution of ``image`` with ``kernel`` (same trailing
    shape) over the last two axes, as ifft2(fft2(image) * fft2(kernel)), on
    their device; real inputs, float32 output.  A kernel with fewer leading
    axes than the image is broadcast over them."""
    image = torch.as_tensor(image).to(torch.float32)
    kernel = torch.as_tensor(kernel).to(torch.float32)
    if image.shape[-2:] != kernel.shape[-2:]:
        raise ValueError(f"shape mismatch {tuple(image.shape)} vs {tuple(kernel.shape)}")
    axes = (-2, -1)
    fi_re, fi_im = fftn_split(image, torch.zeros_like(image), axes=axes,
                              precision=precision)
    fk_re, fk_im = fftn_split(kernel, torch.zeros_like(kernel), axes=axes,
                              precision=precision)
    # The product is fp32 whatever the plan stores.
    p_re, p_im = spectral_cuda.spectral_product(fi_re, fi_im, fk_re, fk_im)
    o_re, _ = ifftn_split(p_re, p_im, axes=axes, precision=precision)
    model_counts["conv2d_calls"] += 1
    # Both forward transforms scale by 1/(H*W) and the inverse not at all, so
    # the product carries one 1/(H*W) too many.
    return o_re.to(torch.float32) * (image.shape[-2] * image.shape[-1])


@tracing.spanned("tfft.model.conv_real")
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
    # The product is fp32 whatever the plan stores; the C2R pass takes it
    # uncast.
    p_re, p_im = spectral_cuda.spectral_product(fa_re, fa_im, fb_re, fb_im)
    out = irfft_split(p_re, p_im, plan)
    model_counts["conv_real_calls"] += 1
    return out.to(torch.float32) * n
