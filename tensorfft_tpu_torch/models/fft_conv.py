"""FFT-based circular convolution (port of ``tensorfft_tpu/models/fft_conv.py``).

conv(a, b) = IFFT(FFT(a) * FFT(b)); the real 1D variant runs the R2C/C2R
pair.  ``fft_convolve_2d`` waits for the N-D transforms.
"""
from __future__ import annotations

import torch

from tensorfft_tpu_torch.plan import create_plan
from tensorfft_tpu_torch.rfft import irfft_split, rfft_split

__all__ = ["fft_convolve_real"]


def _cmul(a_re, a_im, b_re, b_im):
    return a_re * b_re - a_im * b_im, a_re * b_im + a_im * b_re


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
