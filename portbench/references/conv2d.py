"""Plain reference of the circular 2D convolution of an image with a kernel.

Plain PyTorch in float64 (``torch.fft.ifft2`` of ``torch.fft.fft2`` of the
image times that of the kernel, the real part), on whatever device the
planes are on.  It imports torch, the 1D reference (``references/c2c.py``)
and the benchmark's ``spec`` and ``r2c_work`` alone: nothing of the program.
It takes the pool's (rows, N) planes, the ``re`` plane's rows as images and
the ``im`` plane's as kernels, and returns the convolution + 0i as
complex128 (rows, H, W), so the check's "row" is a line of the output along
its last axis.  The frame's shape is the configuration's, of the cells that
run the ``conv2d`` entry (``r2c_work.entry_config``, which refuses cells of
different frames).  The FFT scaling convention does not move the output.

Float64 where a plain reference is usually float32: for an FFT float64 is
the stronger yardstick, its own error far below the program's.

``CONTROLS`` put the reference in the program's place one precision below
float32, each returning the output in float32 as the program does, whatever
``out_dtype``:

* ``bf16_storage``: both spectra and their product rounded to bf16 between
  the steps, the transforms in float64;
* ``bf16_products``: every transform axis by axis (the last first) as
  stages of DFTs of at most ``c2c.RADIX`` points with bf16 operands, DFT
  matrices and twiddles, fp32 accumulation (complex64 matrix products) and
  fp32 storage between stages and axes, and the product in fp32: the
  float32 policy's bf16x3 without its compensation terms.
"""
from __future__ import annotations

import math

import torch

from portbench import r2c_work, spec

c2c = spec.load_module("references", "c2c")


def _frames(plane: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """The (rows, N) plane as (rows, H, W) frames in ``dtype``."""
    rows, n = plane.shape
    shape = tuple(int(s) for s in r2c_work.entry_config("conv2d", ("shape",))["shape"])
    if math.prod(shape) != n:
        raise ValueError(f"N = {n} is not a frame of the configuration's {shape}")
    return plane.to(dtype).reshape(rows, *shape)


def _check(direction: str, scaling: str) -> None:
    if direction != "forward":
        raise ValueError(f"the convolution has one direction, forward; got {direction!r}")
    if scaling not in c2c._SCALES:
        raise ValueError(f"bad scaling {scaling!r}")


def transform(re: torch.Tensor, im: torch.Tensor, direction: str,
              scaling: str) -> torch.Tensor:
    """complex128 (rows, H, W): the circular convolution of each image of
    ``re`` with the kernel of ``im`` in its row, + 0i."""
    _check(direction, scaling)
    image, kernel = _frames(re, torch.float64), _frames(im, torch.float64)
    out = torch.fft.ifft2(torch.fft.fft2(image) * torch.fft.fft2(kernel)).real
    return torch.complex(out, torch.zeros_like(out))


def bf16_storage(re: torch.Tensor, im: torch.Tensor, direction: str,
                 scaling: str, out_dtype: torch.dtype):
    """The convolution in float64 from spectra and a product stored as bf16
    (module docstring)."""
    _check(direction, scaling)
    image, kernel = _frames(re, torch.float64), _frames(im, torch.float64)
    product = c2c.bf16(c2c.bf16(torch.fft.fft2(image)) * c2c.bf16(torch.fft.fft2(kernel)))
    out = torch.fft.ifft2(product).real.to(torch.float32)
    return out, torch.zeros_like(out)


def _staged(x: torch.Tensor, sign: float) -> torch.Tensor:
    """The unnormalised DFT along the last axis of complex64 ``x`` (B, N) in
    stages of at most ``c2c.RADIX`` points (``c2c.staged_dft``'s order): each
    stage's operands, DFT matrix and twiddles rounded to bf16, its products
    summed in fp32, its output stored in fp32."""
    b, n = x.shape
    r = c2c._factor(n)
    m = n // r
    x = x.reshape(b, r, m)                      # element m * j + q at [j, q]
    w = c2c._twiddle(r, r, r, sign, c2c.bf16, x)
    y = torch.einsum("bjq,jk->bkq", c2c.bf16(x), w)
    if m == 1:
        return y.reshape(b, n)
    y = y * c2c._twiddle(r, m, n, sign, c2c.bf16, x)
    z = _staged(y.reshape(b * r, m), sign).reshape(b, r, m)
    return z.transpose(1, 2).reshape(b, n)     # bin k + r * k2 at [k2, k]


def _staged_2d(x: torch.Tensor, sign: float) -> torch.Tensor:
    """``_staged`` along the last axis of (rows, H, W), then along the
    second-to-last."""
    for dim in (-1, -2):
        moved = x.movedim(dim, -1)
        lines = _staged(moved.reshape(-1, moved.shape[-1]), sign)
        x = lines.reshape(moved.shape).movedim(-1, dim)
    return x


def bf16_products(re: torch.Tensor, im: torch.Tensor, direction: str,
                  scaling: str, out_dtype: torch.dtype):
    """The convolution with bf16 operands in every transform stage and fp32
    accumulation (module docstring)."""
    _check(direction, scaling)
    image, kernel = _frames(re, torch.float32), _frames(im, torch.float32)
    spectra = [_staged_2d(torch.complex(f, torch.zeros_like(f)), -1.0) for f in (image, kernel)]
    out = _staged_2d(spectra[0] * spectra[1], 1.0).real / image[0].numel()
    return out, torch.zeros_like(out)


CONTROLS = {"bf16_storage": bf16_storage, "bf16_products": bf16_products}
