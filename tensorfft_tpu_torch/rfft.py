"""Real-to-complex (R2C) and complex-to-real (C2R) transforms.

Port of ``tensorfft_tpu/rfft.py``.  A real signal of length N is packed as a
complex signal z[m] = x[2m] + i x[2m+1] of length M = N/2, transformed with
the complex pipeline, and untangled into the N/2+1 bins of the NumPy rfft
convention (``ops/rfft_cuda.py`` has the formulas).  The plan is for the
half length M, and its strategy picks the route:

  fused route (M <= max_fused_length):
      forward  pack_split (K7) -> kernel A -> untangle_fwd (K9)
      inverse  retangle_inv (K10) -> kernel A -> interleave_split (K8)
  four-step route (larger M):
      forward  four_step_fft_packed_real (K5: packed kernel B, kernel C)
               -> untangle_fwd (K9)
      inverse  retangle_inv (K10)
               -> four_step_fft_to_real (K6: kernel B, interleaving kernel C)

CUDA tensors launch the kernels; CPU tensors run their plain versions.  The
JAX package's ``epilogue`` knob, which chose between two bit-identical
implementations for the TPU, has no counterpart.  ``rfftn_split`` and
``irfftn_split`` run R2C/C2R along the last axis and the N-D C2C transforms
(``fft.fftn_split``) along the others.

Each ``rfft_split`` / ``irfft_split`` call runs inside a ``tfft.r2c`` span
while a profiler records; ``r2c_counts`` counts the calls and the bytes
the path's own casts and copies wrote (``tracing.counters()["r2c"]``).
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from tensorfft_tpu_torch import tracing
from tensorfft_tpu_torch.fft import (
    _fft_split_core,
    _to_complex,
    _to_split,
    fftn_split,
    four_step_call_kwargs,
    ifftn_split,
)
from tensorfft_tpu_torch.ops import four_step_cuda, rfft_cuda
from tensorfft_tpu_torch.plan import FFTPlan, Strategy, create_plan

__all__ = ["rfft_split", "irfft_split", "rfft", "irfft", "rfftn_split",
           "irfftn_split", "rfftn", "irfftn"]


# What the R2C path has done since import (``tracing.counters()["r2c"]``).
r2c_counts = {"calls": 0, "copy_bytes": 0}


def _counted(new: torch.Tensor, old: torch.Tensor) -> torch.Tensor:
    """``new``, its bytes counted in ``r2c_counts["copy_bytes"]`` when a cast
    or a copy made it (it does not share ``old``'s buffer)."""
    if new.untyped_storage().data_ptr() != old.untyped_storage().data_ptr():
        r2c_counts["copy_bytes"] += new.numel() * new.element_size()
    return new


def _half_length_plan(m: int, plan: Optional[FFTPlan], plan_kwargs) -> FFTPlan:
    if plan is None:
        return create_plan(m, **plan_kwargs)
    if plan.fft_length != m:
        raise ValueError(f"plan must be for fft_length {m}, got {plan.fft_length}")
    return plan


def _fused_pack_ok(plan: FFTPlan) -> bool:
    """Whether the pack and interleave ride the four-step passes (K5, K6)."""
    return (plan.resolve_strategy() is Strategy.FOUR_STEP
            and plan.four_step_split is not None)


def _output_scale(plan: FFTPlan, forward: bool) -> float:
    # The half-length Z already carries the plan's scaling over length M; the
    # untangle contributes the remaining factor so the total matches the
    # convention over length N = 2M.
    if plan.scaling == "forward":
        return 0.25 if forward else 1.0
    if plan.scaling == "none":
        return 0.5
    if plan.scaling == "ortho":
        # Z carries M^-1/2; total target (2M)^-1/2.
        return 0.5 / np.sqrt(2.0)
    raise ValueError(plan.scaling)


def _inverse_pre_scale(plan: FFTPlan) -> float:
    # Z[k] = A + i*w*B reconstructs the (1/M)-scaled Z exactly from the
    # (1/N)-scaled X ('forward'); other conventions rescale accordingly.
    if plan.scaling == "forward":
        return 1.0
    if plan.scaling == "none":
        return 0.5
    if plan.scaling == "ortho":
        return np.sqrt(0.5)
    raise ValueError(plan.scaling)


@tracing.spanned("tfft.r2c")
def rfft_split(x, plan: Optional[FFTPlan] = None, **plan_kwargs):
    """Forward R2C FFT of a real tensor along the last axis.

    ``plan`` is for the half length N/2.  Returns (re, im) of shape
    (..., N/2 + 1) in the plan's storage dtype, on x's device, scaled by 1/N
    under the default 'forward' convention (matching :func:`fft_split`).
    """
    x = torch.as_tensor(x)
    n = x.shape[-1]
    if n % 2:
        raise ValueError(f"rfft length must be even, got {n}")
    m = n // 2
    plan = _half_length_plan(m, plan, plan_kwargs)
    storage = plan.precision.storage_dtype
    batch_shape = x.shape[:-1]
    b = int(np.prod(batch_shape)) if batch_shape else 1
    r2c_counts["calls"] += 1
    x2 = _counted(x.reshape(b, n).to(storage).contiguous(), x)
    if _fused_pack_ok(plan):
        Z_re, Z_im = four_step_cuda.four_step_fft_packed_real(
            x2, **four_step_call_kwargs(plan, forward=True))
    else:
        z_re, z_im = rfft_cuda.pack_split(x2)
        Z_re, Z_im = _fft_split_core(z_re, z_im, plan, True)
    o_re, o_im = rfft_cuda.untangle_fwd(
        _counted(Z_re.to(storage).contiguous(), Z_re),
        _counted(Z_im.to(storage).contiguous(), Z_im), n=n,
        scale=float(_output_scale(plan, forward=True)))
    return (o_re.reshape(*batch_shape, m + 1),
            o_im.reshape(*batch_shape, m + 1))


@tracing.spanned("tfft.r2c")
def irfft_split(re, im, plan: Optional[FFTPlan] = None, n: Optional[int] = None,
                **plan_kwargs):
    """Inverse of :func:`rfft_split`: (..., N/2+1) spectrum -> (..., N) real
    in the plan's storage dtype.  The planes may be bfloat16 or float32 (any
    float dtype on the CPU) whatever the plan stores."""
    re = torch.as_tensor(re)
    im = torch.as_tensor(im)
    if re.shape != im.shape:
        raise ValueError(f"re/im shape mismatch: {tuple(re.shape)} vs {tuple(im.shape)}")
    m_plus = re.shape[-1]
    m = m_plus - 1
    n = 2 * m if n is None else n
    if n != 2 * m:
        raise ValueError(f"irfft expects n = 2*(bins-1) = {2 * m}, got {n}")
    plan = _half_length_plan(m, plan, plan_kwargs)
    storage = plan.precision.storage_dtype
    batch_shape = re.shape[:-1]
    b = int(np.prod(batch_shape)) if batch_shape else 1
    r2c_counts["calls"] += 1
    z_re, z_im = rfft_cuda.retangle_inv(
        _counted(re.reshape(b, m_plus).contiguous(), re),
        _counted(im.reshape(b, m_plus).contiguous(), im),
        n=n, scale=float(_inverse_pre_scale(plan)), out_dtype=storage)
    if _fused_pack_ok(plan):
        x = four_step_cuda.four_step_fft_to_real(
            z_re, z_im, **four_step_call_kwargs(plan, forward=False))
    else:
        o_re, o_im = _fft_split_core(z_re, z_im, plan, False)
        x = rfft_cuda.interleave_split(_counted(o_re.to(storage).contiguous(), o_re),
                                       _counted(o_im.to(storage).contiguous(), o_im))
    return _counted(x.reshape(*batch_shape, n).to(storage), x)


def rfft(x, plan: Optional[FFTPlan] = None, *, device="cuda", **plan_kwargs):
    """Host-boundary convenience wrapper over :func:`rfft_split`: moves a real
    array to ``device`` and returns the spectrum as NumPy complex64."""
    x = x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)
    return _to_complex(*rfft_split(torch.from_numpy(np.array(x)).to(device),
                                   plan, **plan_kwargs))


def irfft(x, plan: Optional[FFTPlan] = None, n: Optional[int] = None, *,
          device="cuda", **plan_kwargs):
    """Inverse of :func:`rfft` (same host-boundary contract); returns the
    real signal as NumPy float32."""
    out = irfft_split(*_to_split(x, device), plan, n=n, **plan_kwargs)
    return out.to(torch.float32).cpu().numpy()


def _last_axis_axes(ndim, axes, what):
    axes = tuple(range(ndim)) if axes is None else tuple(a % ndim for a in axes)
    if ndim - 1 not in axes:
        raise ValueError(f"{what} requires the last axis in axes")
    return tuple(a for a in axes if a != ndim - 1)


def rfftn_split(x, axes=None, **plan_kwargs):
    """N-dimensional R2C: :func:`rfft_split` along the last axis, then C2C
    along the other ``axes`` (``numpy.fft.rfftn`` semantics on split
    planes).  Returns (re, im) of shape (..., n_last/2 + 1); the scaling is
    the plans' per axis (1/prod(shape[axes]) under 'forward')."""
    x = torch.as_tensor(x)
    rest = _last_axis_axes(x.ndim, axes, "rfftn_split")
    re, im = rfft_split(x, **plan_kwargs)
    if rest:
        re, im = fftn_split(re, im, axes=rest, **plan_kwargs)
    return re, im


def irfftn_split(re, im, axes=None, n: Optional[int] = None, **plan_kwargs):
    """Inverse of :func:`rfftn_split`: inverse C2C along the other axes,
    then C2R along the last."""
    re = torch.as_tensor(re)
    im = torch.as_tensor(im)
    rest = _last_axis_axes(re.ndim, axes, "irfftn_split")
    if rest:
        re, im = ifftn_split(re, im, axes=rest, **plan_kwargs)
    return irfft_split(re, im, n=n, **plan_kwargs)


def rfftn(x, axes=None, *, device="cuda", **plan_kwargs):
    """Host-boundary wrapper over :func:`rfftn_split`: moves a real array to
    ``device`` and returns the spectrum as NumPy complex64."""
    x = x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)
    return _to_complex(*rfftn_split(torch.from_numpy(np.array(x)).to(device),
                                    axes, **plan_kwargs))


def irfftn(x, axes=None, n: Optional[int] = None, *, device="cuda",
           **plan_kwargs):
    """Inverse of :func:`rfftn` (same host-boundary contract); returns the
    real array as NumPy float32."""
    out = irfftn_split(*_to_split(x, device), axes, n=n, **plan_kwargs)
    return out.to(torch.float32).cpu().numpy()
