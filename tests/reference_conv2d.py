"""Plain reference of the circular 2D convolution.

``torch.fft.ifft2(torch.fft.fft2(image) * torch.fft.fft2(kernel)).real``
over the last two axes, in float64, with torch's broadcasting of the
leading axes (a kernel of fewer leading axes convolves every image).  It
imports torch alone: nothing of the port and nothing of JAX.

It computes in float64 where a plain reference is usually float32: for an
FFT float64 is the stronger yardstick, since its own error (about 1e-16 of
the output's scale) is far below what either of the port's policies reads,
so a tolerance measures the port alone.
"""
import torch


def convolve(image, kernel):
    """float64 circular convolution of real ``image`` and ``kernel`` over
    their last two axes."""
    a = torch.as_tensor(image).to(torch.float64)
    b = torch.as_tensor(kernel).to(torch.float64)
    return torch.fft.ifft2(torch.fft.fft2(a) * torch.fft.fft2(b)).real
