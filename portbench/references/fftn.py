"""Plain reference of the 3-D complex-to-complex transform of a cube.

Plain PyTorch in float64 (``torch.fft.fftn`` on complex128 over the last
three axes), on whatever device the planes are on.  It imports torch and the
1D reference (``references/c2c.py``) alone: nothing of the program.  It takes
the pool's (rows, N) planes, works the cube's side out from N (and refuses
an N that is no cube) and returns (rows, side, side, side), so the check's
"row" is a line along the last axis.  The scaling is the configuration's,
applied per axis: for the whole grid that is the 1D factor of N.

``CONTROLS`` put the reference in the program's place one precision down,
axis by axis (the last axis first), each rounding where the program stores:

* ``fp8_storage``: the planes stored as fp8 (e4m3, one scale per line along
  the axis about to be transformed) on the way in and after every axis;
* ``bf16_accumulate``: every axis as stages of at most 128 points with bf16
  accumulation, bf16 matrices, twiddles and state (``c2c.bf16_accumulate``
  on the lines along that axis).
"""
from __future__ import annotations

import torch

from portbench import spec

c2c = spec.load_module("references", "c2c")
AXES = (-1, -2, -3)   # the order the controls transform in


def cube_side(n: int) -> int:
    side = round(n ** (1.0 / 3.0))
    if side < 1 or side ** 3 != n:
        raise ValueError(f"N = {n} is not a cube")
    return side


def transform(re: torch.Tensor, im: torch.Tensor, direction: str,
              scaling: str) -> torch.Tensor:
    """complex128 (rows, side, side, side): the DFT over the cube, sign -1
    forward and +1 inverse, times the scaling convention's factor."""
    rows, n = re.shape
    side = cube_side(n)
    x = torch.complex(re.to(torch.float64), im.to(torch.float64))
    x = x.reshape(rows, side, side, side)
    if direction == "forward":
        y = torch.fft.fftn(x, dim=AXES)
    elif direction == "inverse":
        y = torch.fft.ifftn(x, dim=AXES).mul_(n)
    else:
        raise ValueError(f"bad direction {direction!r}")
    return y.mul_(c2c._SCALES[scaling][direction](n))


def _axis_by_axis(re, im, each):
    """(rows, side, side, side) planes after ``each(re, im)`` on the lines
    along every axis in turn; ``each`` maps (lines, side) planes to planes
    of the same shape."""
    rows, n = re.shape
    side = cube_side(n)
    re, im = (p.reshape(rows, side, side, side) for p in (re, im))
    for axis in AXES:
        moved = [p.movedim(axis, -1) for p in (re, im)]
        shape = moved[0].shape
        out = each(*(p.reshape(-1, side) for p in moved))
        re, im = (p.reshape(shape).movedim(-1, axis) for p in out)
    return re, im


def fp8_storage(re: torch.Tensor, im: torch.Tensor, direction: str,
                scaling: str, out_dtype: torch.dtype):
    """The reference, axis by axis, from fp8 planes and stored as fp8."""
    def each(r, i):
        y = c2c.transform(*c2c.fp8_round(r, i), direction, scaling)
        return c2c.fp8_round(y.real, y.imag)

    return tuple(p.to(out_dtype) for p in _axis_by_axis(re, im, each))


def bf16_accumulate(re: torch.Tensor, im: torch.Tensor, direction: str,
                    scaling: str, out_dtype: torch.dtype):
    """Every axis in stages with bf16 accumulation (module docstring)."""
    def each(r, i):
        return c2c.bf16_accumulate(r, i, direction, scaling, torch.float32)

    return tuple(p.to(out_dtype) for p in _axis_by_axis(re, im, each))


CONTROLS = {"fp8_storage": fp8_storage, "bf16_accumulate": bf16_accumulate}
