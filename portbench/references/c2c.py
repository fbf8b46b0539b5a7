"""Plain reference of the batched 1D complex-to-complex transform.

Plain PyTorch in float64 (``torch.fft`` on complex128), on whatever device
the planes are on.  It imports torch alone: nothing of the program.  It takes
the same input planes the program is given and works the scaling out from
the configuration, never from the program's plan.

``CONTROLS`` are this reference put in the program's place in a precision
below the configuration's (bf16 storage, fp32 accumulation), each a
``control(re, im, direction, scaling, out_dtype)``:

* ``fp8_storage``: both planes stored as fp8 (e4m3, with one scale per row
  mapping its largest magnitude to the format's largest value) on the way in
  and on the way out, the precision below bf16 storage;
* ``bf16_accumulate``: the transform as stages of DFTs of at most
  ``RADIX`` points (Cooley-Tukey, the largest factor first), each output
  summed term by term in a bf16 accumulator, the precision below fp32
  accumulation; the DFT matrices, twiddles and the state between stages are
  bf16, each product is formed in fp32.
"""
from __future__ import annotations

import math

import torch

# The factor each direction's unnormalised sum is multiplied by.
_SCALES = {
    "forward": {"forward": lambda n: 1.0 / n, "inverse": lambda n: 1.0},
    "none": {"forward": lambda n: 1.0, "inverse": lambda n: 1.0 / n},
    "ortho": {"forward": lambda n: n ** -0.5, "inverse": lambda n: n ** -0.5},
}
_SIGNS = {"forward": -1.0, "inverse": 1.0}

FP8 = torch.float8_e4m3fn
FP8_MAX = 448.0
RADIX = 128


def transform(re: torch.Tensor, im: torch.Tensor, direction: str,
              scaling: str) -> torch.Tensor:
    """complex128 (B, N): the DFT along the last axis, sign -1 forward and +1
    inverse, times the scaling convention's factor."""
    x = torch.complex(re.to(torch.float64), im.to(torch.float64))
    n = x.shape[-1]
    if direction == "forward":
        y = torch.fft.fft(x, dim=-1)
    elif direction == "inverse":
        y = torch.fft.ifft(x, dim=-1) * n
    else:
        raise ValueError(f"bad direction {direction!r}")
    return y * _SCALES[scaling][direction](n)


def fp8_round(re: torch.Tensor, im: torch.Tensor):
    """Both planes through fp8 e4m3 with one scale per row (float64 out)."""
    re, im = re.to(torch.float64), im.to(torch.float64)
    amax = torch.maximum(re.abs().amax(-1, keepdim=True),
                         im.abs().amax(-1, keepdim=True))
    scale = FP8_MAX / torch.where(amax > 0, amax, torch.ones_like(amax))
    return tuple((p * scale).to(torch.float32).to(FP8).to(torch.float64) / scale
                 for p in (re, im))


def fp8_storage(re: torch.Tensor, im: torch.Tensor, direction: str,
                scaling: str, out_dtype: torch.dtype):
    """The reference computed from fp8 planes and stored as fp8 planes."""
    y = transform(*fp8_round(re, im), direction, scaling)
    o_re, o_im = fp8_round(y.real, y.imag)
    return o_re.to(out_dtype), o_im.to(out_dtype)


def bf16(z: torch.Tensor) -> torch.Tensor:
    """A complex tensor with its real and imaginary parts rounded to bf16."""
    parts = torch.view_as_real(z).to(torch.bfloat16).to(torch.view_as_real(z).dtype)
    return torch.view_as_complex(parts.contiguous())


def _factor(n: int) -> int:
    return next(r for r in range(min(n, RADIX), 0, -1) if n % r == 0)


def _twiddle(rows: int, cols: int, n: int, sign: float, rnd, like: torch.Tensor):
    """exp(sign 2 pi i j k / n) for j < rows, k < cols, rounded by ``rnd``."""
    j = torch.arange(rows, dtype=torch.float64, device=like.device)
    k = torch.arange(cols, dtype=torch.float64, device=like.device)
    phase = (sign * 2.0 * math.pi / n) * torch.remainder(torch.outer(j, k), n)
    return rnd(torch.polar(torch.ones_like(phase), phase).to(like.dtype))


def staged_dft(x: torch.Tensor, sign: float, rnd=lambda z: z) -> torch.Tensor:
    """The unnormalised DFT along the last axis of complex ``x`` (B, N) in
    stages of at most ``RADIX`` points.  Each stage output is a sum over its
    inputs taken one term at a time, ``rnd`` applied to the running sum after
    every term and to every DFT matrix, twiddle and stage output."""
    b, n = x.shape
    r = _factor(n)
    m = n // r
    x = x.reshape(b, r, m)                      # element m * j + q at [j, q]
    w = _twiddle(r, r, r, sign, rnd, x)         # the r-point DFT matrix
    acc = torch.zeros_like(x)
    for j in range(r):                          # y[k, q] = sum_j x[j, q] w[j, k]
        acc = rnd(acc + x[:, j:j + 1, :] * w[j].reshape(1, r, 1))
    if m == 1:
        return acc.reshape(b, n)
    acc = rnd(acc * _twiddle(r, m, n, sign, rnd, x))
    y = staged_dft(acc.reshape(b * r, m), sign, rnd).reshape(b, r, m)
    return y.transpose(1, 2).reshape(b, n)     # bin k + r * k2 at [k2, k]


def bf16_accumulate(re: torch.Tensor, im: torch.Tensor, direction: str,
                    scaling: str, out_dtype: torch.dtype):
    """The transform in stages with bf16 accumulation (module docstring)."""
    x = bf16(torch.complex(re.to(torch.float32), im.to(torch.float32)))
    y = staged_dft(x, _SIGNS[direction], bf16) * _SCALES[scaling][direction](x.shape[-1])
    return y.real.to(out_dtype), y.imag.to(out_dtype)


CONTROLS = {"fp8_storage": fp8_storage, "bf16_accumulate": bf16_accumulate}
