"""Spectral Poisson solver on the 3-D real transforms (port of
``tensorfft_tpu/models/poisson.py``, BASELINE.md config 5).

Solves  laplacian(u) = f  with periodic boundary conditions on an
(nx, ny, nz) grid: forward 3-D transform of f, divide by the eigenvalues of
the spectral Laplacian, -4 sum(sin^2(pi k / n)) / h^2 (or the continuous
-|2 pi k / L|^2), zero the mean mode, inverse 3-D transform.

Departures from the JAX package, each giving the same u in exact arithmetic:

* the transforms are real-to-complex (``rfftn_split``, then
  ``irfftn_split``) where JAX runs the complex ``pencil_fft_3d`` on
  (f, 0): half the work and half the spectrum's bytes;
* 1/lambda is computed per element from three 1-D eigenvalue tables, one
  per axis, by ``ops/spectral_cuda.py:poisson_scale`` (the kernel
  ``tfft::poisson_scale_kernel`` on the card), where JAX multiplies by full
  (nx, ny, nz) float32 tables of 1/lambda and of the mask;
* it runs on f's device alone: ``mesh`` may be None or hold one device.
  The distributed pencil path is ROADMAP Queue 1 item 2.

nz must be a length ``rfft_split`` takes (even, its half a planned length).
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from tensorfft_tpu_torch import tracing
from tensorfft_tpu_torch.ops import spectral_cuda
from tensorfft_tpu_torch.rfft import irfftn_split, rfftn_split

__all__ = ["poisson_solve_3d", "eigenvalue_tables"]

# Solves since import (``tracing.counters()["models"]``).
model_counts = {"poisson_solves": 0}


def _eigenvalues(n: int, length: float, discrete: bool) -> np.ndarray:
    """The Laplacian's eigenvalues along one axis, in fp64, in the order of
    ``fftfreq`` (``_spectral_laplacian`` of the JAX package, one axis)."""
    k = np.fft.fftfreq(n) * n
    if discrete:
        return -4.0 / (length / n) ** 2 * np.sin(np.pi * k / n) ** 2
    return -(2 * np.pi * k / length) ** 2


def eigenvalue_tables(shape, lengths=(1.0, 1.0, 1.0), discrete: bool = True):
    """(k0, k1, k2): the fp64 eigenvalues along each axis of an (nx, ny, nz)
    grid, k2 over the nz/2+1 bins of the half spectrum; lambda at (i, j, k)
    is k0[i] + k1[j] + k2[k]."""
    nx, ny, nz = shape
    lx, ly, lz = lengths
    return (_eigenvalues(nx, lx, discrete), _eigenvalues(ny, ly, discrete),
            _eigenvalues(nz, lz, discrete)[: nz // 2 + 1])


@functools.lru_cache(maxsize=16)
def device_tables(shape, lengths, discrete: bool, device):
    """``eigenvalue_tables`` rounded once to fp32, on ``device``."""
    return tuple(torch.from_numpy(t.astype(np.float32)).to(device)
                 for t in eigenvalue_tables(shape, lengths, discrete))


def _mesh_devices(mesh) -> int:
    """Devices of ``mesh``: a ``torch.distributed`` DeviceMesh, a mesh with
    a ``devices`` array (as JAX's), or a sequence of devices."""
    if mesh is None:
        return 1
    if hasattr(mesh, "mesh"):
        return int(mesh.mesh.numel())
    return int(np.size(np.asarray(getattr(mesh, "devices", mesh), dtype=object)))


@tracing.spanned("tfft.model.poisson")
def poisson_solve_3d(f, mesh=None, axis_name: str = "sp", lengths=(1.0, 1.0, 1.0),
                     discrete: bool = True, precision: str = "float32", *,
                     device="cuda"):
    """Solve laplacian(u) = f (periodic, zero-mean u) on f's device.

    ``f``: real (nx, ny, nz) tensor or array.  A tensor is solved on its own
    device; an array (or anything else that is not a tensor) is moved to
    ``device`` first, as ``rfftn`` does.  Returns the real float32 u of the
    same shape, on that device.  ``mesh`` (None or one device) and
    ``axis_name`` are the JAX signature's; ``precision`` is the transforms'
    policy.
    """
    if _mesh_devices(mesh) > 1:
        raise NotImplementedError(
            "poisson_solve_3d runs on one device; the distributed pencil path "
            "is ROADMAP Queue 1 item 2")
    if not isinstance(f, torch.Tensor):
        f = torch.as_tensor(np.asarray(f)).to(device)
    if f.ndim != 3:
        raise ValueError(f"poisson_solve_3d expects an (nx, ny, nz) grid, got {tuple(f.shape)}")
    if f.dtype not in (torch.bfloat16, torch.float32):
        f = f.to(torch.float32)
    shape = tuple(f.shape)
    k0, k1, k2 = device_tables(shape, tuple(float(x) for x in lengths), bool(discrete),
                               f.device)
    re, im = rfftn_split(f, precision=precision)
    re, im = spectral_cuda.poisson_scale(re, im, k0, k1, k2)
    u = irfftn_split(re, im, precision=precision)
    model_counts["poisson_solves"] += 1
    return u.to(torch.float32)
