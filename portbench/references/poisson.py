"""Plain reference of the periodic spectral Poisson solve on a cube.

Plain PyTorch in float64 (``torch.fft.rfftn`` of f, divided by the
Laplacian's eigenvalues with the mean mode zeroed, ``torch.fft.irfftn``
back), on whatever device the planes are on.  It imports torch, the 1D
and N-D references (``references/c2c.py``, ``references/fftn.py``) and the
benchmark's ``spec`` and ``r2c_work`` alone: nothing of the program.  It takes the pool's (rows, N) planes, solves the
``re`` plane's grids as f (``im`` is not read), works the cube's side out
from N (and refuses an N that is no cube) and returns u + 0i as complex128
(rows, side, side, side), so the check's "row" is a line of u along the last
axis.  The lengths and the eigenvalues (discrete or continuous) are those
of the configuration of the cells that run the ``poisson`` entry
(``r2c_work.entry_config``); the planes cannot tell two such
configurations apart, so cells that differ in either are refused.  The FFT
scaling convention does not move u.

``CONTROLS`` put the reference in the program's place one precision down,
each storing where the program stores (after the last axis's real
transform, after each further axis, after the scale) and returning u in
float32, as the program does, whatever ``out_dtype``:

* ``fp8_storage``: f and every stored spectrum as fp8 (e4m3, one scale per
  line along the last axis of the layout at hand), the transforms in
  float64;
* ``bf16_accumulate``: every axis as stages of at most 128 points with bf16
  accumulation, bf16 matrices, twiddles and state (``c2c.staged_dft``), the
  last axis as a complex transform of the full line (f + 0i forward; the
  Hermitian line rebuilt from the half spectrum inverse); the scale in
  float32, stored as bf16.
"""
from __future__ import annotations

import math

import torch

from portbench import r2c_work, spec

c2c = spec.load_module("references", "c2c")
fftn = spec.load_module("references", "fftn")


def _eigenvalues(n: int, length: float, discrete: bool, device) -> torch.Tensor:
    k = torch.fft.fftfreq(n, dtype=torch.float64, device=device) * n
    if discrete:
        return -4.0 / (length / n) ** 2 * torch.sin(math.pi * k / n) ** 2
    return -(2 * math.pi * k / length) ** 2


def laplacian(side: int, device) -> torch.Tensor:
    """lambda over the half spectrum (side, side, side/2+1), float64, with
    the configuration's lengths and eigenvalues; 1 at the mean mode."""
    config = r2c_work.entry_config("poisson", ("lengths", "discrete"))
    lx, ly, lz = (float(x) for x in config["lengths"])
    discrete = bool(config["discrete"])
    lam = (_eigenvalues(side, lx, discrete, device)[:, None, None]
           + _eigenvalues(side, ly, discrete, device)[None, :, None]
           + _eigenvalues(side, lz, discrete, device)[None, None, : side // 2 + 1])
    lam[0, 0, 0] = 1.0
    return lam


def _grids(re: torch.Tensor):
    rows, n = re.shape
    side = fftn.cube_side(n)
    return re.reshape(rows, side, side, side), side


def _check(direction: str, scaling: str) -> None:
    if direction != "forward":
        raise ValueError(f"the solve has one direction, forward; got {direction!r}")
    if scaling not in c2c._SCALES:
        raise ValueError(f"bad scaling {scaling!r}")


def transform(re: torch.Tensor, im: torch.Tensor, direction: str,
              scaling: str) -> torch.Tensor:
    """complex128 (rows, side, side, side): u + 0i with laplacian(u) =
    f - mean(f), zero-mean u, for each grid f of ``re``."""
    _check(direction, scaling)
    f, side = _grids(re.to(torch.float64))
    spectrum = torch.fft.rfftn(f, dim=(-3, -2, -1)).div_(laplacian(side, re.device))
    spectrum[:, 0, 0, 0] = 0.0
    u = torch.fft.irfftn(spectrum, s=(side,) * 3, dim=(-3, -2, -1))
    return torch.complex(u, torch.zeros_like(u))


def _fp8_lines(z: torch.Tensor) -> torch.Tensor:
    """A complex (or real) tensor through fp8, one scale per last-axis line."""
    lines = z.reshape(-1, z.shape[-1])
    if not z.is_complex():
        return c2c.fp8_round(lines, torch.zeros_like(lines))[0].reshape(z.shape)
    return torch.complex(*c2c.fp8_round(lines.real, lines.imag)).reshape(z.shape)


def fp8_storage(re: torch.Tensor, im: torch.Tensor, direction: str,
                scaling: str, out_dtype: torch.dtype):
    """The solve in float64 from fp8 storage (module docstring)."""
    _check(direction, scaling)
    f, side = _grids(re.to(torch.float64))
    x = torch.fft.rfft(_fp8_lines(f), dim=-1)
    for dim in (-2, -3):
        x = torch.fft.fft(_fp8_lines(x), dim=dim)
    x = _fp8_lines(x) / laplacian(side, re.device)
    x[:, 0, 0, 0] = 0.0
    for dim in (-3, -2):
        x = torch.fft.ifft(_fp8_lines(x), dim=dim)
    u = _fp8_lines(torch.fft.irfft(_fp8_lines(x), n=side, dim=-1))
    return u.to(torch.float32), torch.zeros_like(u, dtype=torch.float32)


def _staged(x: torch.Tensor, dim: int, sign: float, scale: float) -> torch.Tensor:
    """The DFT along ``dim`` of complex ``x`` in stages with bf16
    accumulation, times ``scale``, stored as bf16."""
    moved = x.movedim(dim, -1)
    lines = moved.reshape(-1, moved.shape[-1])
    y = c2c.bf16(c2c.staged_dft(lines, sign, c2c.bf16) * scale)
    return y.reshape(moved.shape).movedim(-1, dim)


def bf16_accumulate(re: torch.Tensor, im: torch.Tensor, direction: str,
                    scaling: str, out_dtype: torch.dtype):
    """The solve with bf16 accumulation in every transform (module
    docstring)."""
    _check(direction, scaling)
    f, side = _grids(re.to(torch.float32))
    half = side // 2 + 1
    x = c2c.bf16(torch.complex(f, torch.zeros_like(f)))
    x = _staged(x, -1, -1.0, 1.0 / side)[..., :half]
    for dim in (-2, -3):
        x = _staged(x, dim, -1.0, 1.0 / side)
    x = c2c.bf16(x / laplacian(side, re.device).to(torch.float32))
    x[:, 0, 0, 0] = 0.0
    for dim in (-3, -2):
        x = _staged(x, dim, 1.0, 1.0)
    # The full Hermitian line: X[side - k] = conj(X[k]) for 0 < k < side/2.
    mirror = x[..., 1: side - half + 1].flip(-1).conj()
    u = _staged(torch.cat([x, mirror], dim=-1), -1, 1.0, 1.0).real
    return u.to(torch.float32), torch.zeros_like(u)


CONTROLS = {"fp8_storage": fp8_storage, "bf16_accumulate": bf16_accumulate}
