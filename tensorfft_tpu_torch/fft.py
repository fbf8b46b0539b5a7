"""Public FFT execution layer (1D complex-to-complex).

Transforms run along the last axis of split-planar (re, im) tensors, on the
device the tensors are on.  Strategies (``plan.resolve_strategy()``):

  * FUSED      — kernel A: one CTA per (B, N) row, whole transform in shared
                 memory (``ops/fused_cuda.py``), or a thread-block cluster
                 of 2, 4 or 8 CTAs per row past what one CTA holds
                 (``fused_cuda.fit_cta``); under a plan with
                 ``fused_layout="batch_major"`` and a batch that tiles
                 (``_batch_major_ok``), K3: a tile of rows per CTA
                 (``four_step_cuda.fused_fft_batch_major``).
  * FOUR_STEP  — kernels B and C: Bailey column pass with the four-step
                 twiddle, then the transposing row pass
                 (``ops/four_step_cuda.py``).
  * STAGED     — plain-torch stage loop (``ops/stages_torch.py``).
  * TORCH      — ``torch.fft.fft`` in complex64, the comparison baseline.

CPU tensors run the plain-torch versions of the kernels, CUDA tensors the
kernels themselves.  Every kernel runs the plan's stage engine and numeric
knobs (``grouped``, ``complex_mult``, ``state_dtype``).

The N-D transforms (``fftn_split``, ``ifftn_split``, ``fftn``, ``ifftn``,
``fft2``, ``ifft2``) are row-column decompositions over the 1D engine.  A
transform over the last two axes with both lengths on the FUSED route runs
as K4, the 2D row-column kernels (``four_step_cuda.fft2_fused``); any other
axis runs ``fft_split`` along it, one axis at a time in the order given,
after an explicit relayout that moves the axis last (``_relayout``), or,
where its planes allow (``_column_tile``), as kernel A's pipelined tiles
landed straight from the strided planes (``_columns``), with no copy.
``nd_counts`` counts the 2D branch's calls, the per-axis passes and the
bytes the relayout copied (``tracing.counters()["nd"]``).
"""
from __future__ import annotations

import functools
import os
from typing import Optional, Tuple

import numpy as np
import torch

from tensorfft_tpu_torch import dft, tracing
from tensorfft_tpu_torch.ops import four_step_cuda, fused_cuda, stages_torch
from tensorfft_tpu_torch.plan import FFTPlan, Strategy, create_plan, is_power_of_2
from tensorfft_tpu_torch.tuning import cache as tuner_cache

__all__ = ["fft", "ifft", "fft_split", "ifft_split", "stage_scales",
           "four_step_call_kwargs", "fftn_split", "ifftn_split", "fftn",
           "ifftn", "fft2", "ifft2"]


def stage_scales(radices, scaling: str, forward: bool) -> Tuple[float, ...]:
    """Per-stage progressive scale factors.

    'forward' scales the forward transform by 1/N, one 1/radix per stage,
    and leaves the inverse unscaled; 'none' is the NumPy convention.
    """
    if scaling == "forward":
        return tuple(1.0 / r for r in radices) if forward else tuple(1.0 for _ in radices)
    if scaling == "none":
        return tuple(1.0 for _ in radices) if forward else tuple(1.0 / r for r in radices)
    if scaling == "ortho":
        return tuple(r ** -0.5 for r in radices)
    raise ValueError(f"bad scaling {scaling!r}")


def four_step_call_kwargs(plan: FFTPlan, forward: bool) -> dict:
    """Keyword arguments of ``ops.four_step_cuda.four_step_fft`` (and of its
    R2C variants) for ``plan``: every knob the JAX package's call passes;
    ``lane_tile`` and ``k1_tile`` decide the narrow-panel state rule."""
    n1, n2 = plan.four_step_split
    return dict(
        n1=n1, n2=n2,
        radices1=plan.col_radices, radices2=plan.row_radices,
        scales1=stage_scales(plan.col_radices, plan.scaling, forward),
        scales2=stage_scales(plan.row_radices, plan.scaling, forward),
        sign=dft.FORWARD if forward else dft.INVERSE,
        lane_tile=plan.lane_tile,
        algorithm=plan.precision.dot_algorithm,
        grouped=plan.grouped,
        state_dtype=plan.state_dtype,
        complex_mult=plan.complex_mult,
        first_dot=plan.first_dot,
        engine=plan.engine,
        k1_tile=plan.k1_tile,
    )


@tracing.spanned("tfft.dispatch")
def _fft_split_core(re, im, plan: FFTPlan, forward: bool):
    """Transform (B, N) planes already in the storage dtype."""
    strategy = plan.resolve_strategy()
    sign = dft.FORWARD if forward else dft.INVERSE
    if strategy is Strategy.FOUR_STEP:
        return four_step_cuda.four_step_fft(
            re, im, **four_step_call_kwargs(plan, forward))
    if strategy is Strategy.FUSED:
        # Both kernels read (B, N) rows; "transform_major" is kernel A here.
        fused = (four_step_cuda.fused_fft_batch_major
                 if _batch_major_ok(plan, re.shape[0]) else fused_cuda.fused_fft)
        return fused(re, im, **_fused_kwargs(plan, forward))
    scales = stage_scales(plan.radices, plan.scaling, forward)
    if strategy is Strategy.STAGED:
        o_re, o_im = stages_torch.apply_stages(
            re.T, im.T, plan.radices, scales, sign,
            algorithm=plan.precision.dot_algorithm,
        )
        return o_re.T, o_im.T
    if strategy is Strategy.TORCH:
        x = torch.complex(re.to(torch.float32), im.to(torch.float32))
        x = torch.fft.fft(x, dim=-1) if forward else torch.fft.ifft(x, dim=-1)
        total = float(np.prod(scales))
        if not forward:
            total *= plan.fft_length  # torch.fft.ifft already applies 1/N
        x = x * total
        return x.real, x.imag
    raise ValueError(f"unhandled strategy {strategy}")


def _fused_kwargs(plan: FFTPlan, forward: bool) -> dict:
    """Keyword arguments of kernel A (``fused_cuda.fused_fft``, and of K3
    and ``fused_cuda.fused_fft_columns``) for a FUSED ``plan``."""
    return dict(
        radices=plan.radices,
        scales=stage_scales(plan.radices, plan.scaling, forward),
        sign=dft.FORWARD if forward else dft.INVERSE,
        algorithm=plan.precision.dot_algorithm,
        grouped=plan.grouped, state_dtype=plan.state_dtype,
        complex_mult=plan.complex_mult, engine=plan.engine,
        first_dot=plan.first_dot,
    )


def _batch_major_ok(plan: FFTPlan, b: int) -> bool:
    """Whether a FUSED plan runs K3 on a batch of ``b`` rows: the JAX
    package's rule (``tensorfft_tpu/fft.py:_batch_major_ok``), kept as it is
    so both packages choose the same kernel.  Only ``fused_layout=
    "batch_major"`` asks for it, and the row tile (the largest power-of-two
    divisor of b, capped at 128) must hold at least 8 rows or the whole
    batch; "auto" and "transform_major" run kernel A.
    """
    if plan.fused_layout != "batch_major":
        return False
    rt = 1
    while rt * 2 <= 128 and b % (rt * 2) == 0:
        rt *= 2
    return rt >= 8 or rt == b


def _ensure_plan(n: int, plan: Optional[FFTPlan], **kwargs) -> FFTPlan:
    if plan is None:
        return create_plan(n, **kwargs)
    if plan.fft_length != n:
        raise ValueError(
            f"plan is for fft_length {plan.fft_length}, data has {n}"
        )
    return plan


def _as_planes(re, im):
    re = torch.as_tensor(re)
    im = torch.as_tensor(im)
    if re.shape != im.shape:
        raise ValueError(f"re/im shape mismatch: {tuple(re.shape)} vs {tuple(im.shape)}")
    if re.device != im.device:
        raise ValueError(f"re/im on different devices: {re.device} vs {im.device}")
    return re, im


@tracing.spanned("tfft.entry")
def _run(re, im, plan, forward, plan_kwargs):
    re, im = _as_planes(re, im)
    plan = _ensure_plan(re.shape[-1], plan, **plan_kwargs)
    storage = plan.precision.storage_dtype
    batch_shape, n = re.shape[:-1], re.shape[-1]
    b = int(np.prod(batch_shape)) if batch_shape else 1
    re2 = re.to(storage).reshape(b, n).contiguous()
    im2 = im.to(storage).reshape(b, n).contiguous()
    o_re, o_im = _fft_split_core(re2, im2, plan, forward)
    return (o_re.to(storage).reshape(*batch_shape, n),
            o_im.to(storage).reshape(*batch_shape, n))


def fft_split(re, im, plan: Optional[FFTPlan] = None, **plan_kwargs):
    """Forward FFT of split-planar tensors along the last axis.

    Leading axes are batch.  Inputs are cast to the plan's storage dtype;
    the result is in that dtype, on the inputs' device.  With the default
    plan the output is scaled by 1/N.
    """
    return _run(re, im, plan, True, plan_kwargs)


def ifft_split(re, im, plan: Optional[FFTPlan] = None, **plan_kwargs):
    """Inverse FFT of split-planar tensors; the exact inverse of
    :func:`fft_split` under the plan's scaling convention."""
    return _run(re, im, plan, False, plan_kwargs)


def _to_split(x, device):
    """Split a complex (or real) array into planar tensors on ``device``."""
    x = x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)
    if np.iscomplexobj(x):
        re, im = x.real.copy(), x.imag.copy()
    else:
        re, im = x, np.zeros_like(x)
    return torch.from_numpy(re).to(device), torch.from_numpy(im).to(device)


def _to_complex(re, im):
    return (re.to(torch.float32).cpu().numpy()
            + 1j * im.to(torch.float32).cpu().numpy()).astype(np.complex64)


def fft(x, plan: Optional[FFTPlan] = None, *, device="cuda", **plan_kwargs):
    """Forward FFT of a complex (or real) array along the last axis.

    Host-boundary convenience wrapper over :func:`fft_split`: splits the
    array on the host, runs on ``device`` (the card unless the caller asks
    for the CPU), and returns a NumPy complex64 array.  Use
    :func:`fft_split` to stay on the device.
    """
    re, im = _to_split(x, device)
    return _to_complex(*fft_split(re, im, plan, **plan_kwargs))


def ifft(x, plan: Optional[FFTPlan] = None, *, device="cuda", **plan_kwargs):
    """Inverse of :func:`fft` (same host-boundary contract)."""
    re, im = _to_split(x, device)
    return _to_complex(*ifft_split(re, im, plan, **plan_kwargs))


# ---------------------------------------------------------------------------
# Multi-dimensional transforms (port of tensorfft_tpu/fft.py:303-431).
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=64)
def _cached_plan(n, items, context):
    return create_plan(n, **dict(items))


def _nd_plan(n, plan_kwargs):
    """``create_plan(n, **plan_kwargs)`` for the N-D dispatch, which plans
    its axes on every call.  A plan with ``tuning="auto"`` reads the tuner
    cache file, and the forward's plans come before its first launch, so
    the card waits on the file system: on an H100 machine whose checkout is
    on a network file system that wait swung the step's tail by several
    percent.  So a plan is kept per arguments and, under ``tuning="auto"``,
    per ``TENSORFFT_TUNER_CACHE`` and per file this process's ``TunerCache``
    has saved since; a file rewritten by another process is not read again.
    Arguments that do not hash are planned afresh."""
    items = tuple(sorted(plan_kwargs.items()))
    try:
        hash(items)
    except TypeError:
        return create_plan(n, **plan_kwargs)
    context = None
    if plan_kwargs.get("tuning") == "auto":
        context = (os.environ.get("TENSORFFT_TUNER_CACHE"), tuner_cache.writes)
    return _cached_plan(n, items, context)


def _fft2_plans(h, w, plan_kwargs):
    """The (plan_h, plan_w) of the fused 2D branch, or None when the
    transform takes the per-axis loop."""
    if h < 8 or not (is_power_of_2(h) and is_power_of_2(w)):
        return None
    plan_h = _nd_plan(h, plan_kwargs)
    plan_w = _nd_plan(w, plan_kwargs)
    if (plan_h.resolve_strategy() is Strategy.FUSED
            and plan_w.resolve_strategy() is Strategy.FUSED):
        return plan_h, plan_w
    return None


# What the N-D dispatch has done since import (``tracing.counters()["nd"]``).
nd_counts = {"fft2_branch": 0, "axis_passes": 0, "relayout_bytes": 0}


@tracing.spanned("tfft.nd.fft2")
def _fft2_branch(re, im, plan_h, plan_w, forward):
    """The trailing two axes as K4; returns planes of ``re``'s shape."""
    nd_counts["fft2_branch"] += 1
    h, w = re.shape[-2], re.shape[-1]
    batch_shape = re.shape[:-2]
    b = int(np.prod(batch_shape)) if batch_shape else 1
    storage = plan_h.precision.storage_dtype
    # No first_dot: K4 runs the plain first stage, as fft2_fused does in the
    # JAX package.
    o_re, o_im = four_step_cuda.fft2_fused(
        re.to(storage).reshape(b, h, w).contiguous(),
        im.to(storage).reshape(b, h, w).contiguous(),
        radices1=plan_h.radices, radices2=plan_w.radices,
        scales1=stage_scales(plan_h.radices, plan_h.scaling, forward),
        scales2=stage_scales(plan_w.radices, plan_w.scaling, forward),
        sign=dft.FORWARD if forward else dft.INVERSE,
        algorithm=plan_h.precision.dot_algorithm,
        grouped=(plan_h.grouped, plan_w.grouped),
        state_dtype=(plan_h.state_dtype
                     if plan_h.state_dtype == plan_w.state_dtype
                     else "float32"),
        complex_mult=(plan_h.complex_mult
                      if plan_h.complex_mult == plan_w.complex_mult
                      else "block"),
        engine=(plan_h.engine if plan_h.engine == plan_w.engine
                else "stacked"),
    )
    return (o_re.reshape(*batch_shape, h, w),
            o_im.reshape(*batch_shape, h, w))


@tracing.spanned("tfft.nd.relayout")
def _relayout(re, im, ax, storage):
    """Both planes with axis ``ax`` moved last, cast to ``storage`` and made
    contiguous, in that order: ``_run`` then finds (B, N) rows to view and
    copies nothing."""
    out = []
    for x in (re, im):
        moved = torch.movedim(x, ax, -1).to(storage)
        dense = moved.contiguous()
        if dense is not moved:
            nd_counts["relayout_bytes"] += dense.numel() * dense.element_size()
        out.append(dense)
    return out


def _column_tile(re, im, ax, plan: FFTPlan) -> int:
    """The lines a tile when the pass along ``ax`` lands its tiles straight
    from the planes (``_columns``), else 0 (the pass takes ``_relayout``):
    CUDA planes already in the plan's storage dtype, a FUSED plan on kernel
    A (not K3), and ``fused_cuda.column_tile``'s rule on their shape,
    strides and pointers (dense bf16 planes, 16-byte aligned, the pipelined
    kernel's lines, its tile at least 8 lines and dividing the lines after
    the axis)."""
    storage = plan.precision.storage_dtype
    if (re.device.type != "cuda" or re.dtype is not storage
            or im.dtype is not storage
            or plan.resolve_strategy() is not Strategy.FUSED
            or _batch_major_ok(plan, re.numel() // re.shape[ax])):
        return 0
    return fused_cuda.column_tile(
        re.shape, (re.stride(), im.stride()), ax, re.dtype,
        (re.data_ptr(), im.data_ptr()), fused_cuda.multiprocessors(re.device),
        radices=plan.radices, algorithm=plan.precision.dot_algorithm,
        engine=plan.engine, grouped=plan.grouped,
        complex_mult=plan.complex_mult, state_dtype=plan.state_dtype)


@tracing.spanned("tfft.entry")
def _columns(re, im, ax, plan: FFTPlan, forward: bool, tile: int):
    """The pass along ``ax`` as kernel A's tiles landed straight from the
    planes: both planes with the axis moved last and made contiguous, as
    ``_relayout`` then ``_run`` give them, bit for bit, with no copy."""
    return fused_cuda.fused_fft_columns(re, im, ax, tile=tile,
                                        **_fused_kwargs(plan, forward))


def _fftn_split(re, im, axes, plans, forward, plan_kwargs):
    axes_norm = tuple(a % re.ndim for a in axes)
    last_two = {re.ndim - 2, re.ndim - 1}
    if len(axes_norm) >= 3 and re.ndim >= 2 and last_two <= set(axes_norm) and not plans:
        # N-D: peel the trailing two axes through the 2D branch, then run the
        # remaining axes through the per-axis loop.
        re, im = _fftn_split(re, im, (re.ndim - 2, re.ndim - 1), plans,
                             forward, plan_kwargs)
        rest = tuple(a for a in axes_norm if a < re.ndim - 2)
        return _fftn_split(re, im, rest, plans, forward, plan_kwargs)
    # Inner plans read the tuner cache unless the caller passes tuning=.
    kw = dict(plan_kwargs)
    kw.setdefault("tuning", "auto")
    if len(axes_norm) == 2 and re.ndim >= 2 and set(axes_norm) == last_two and not plans:
        fused = _fft2_plans(re.shape[-2], re.shape[-1], kw)
        if fused is not None:
            return _fft2_branch(re, im, *fused, forward)

    # Every pass rounds to the storage dtype, so the order of ``axes`` counts.
    for ax in axes:
        n = re.shape[ax]
        plan = plans.get(n) if isinstance(plans, dict) else None
        plan = _nd_plan(n, kw) if plan is None else _ensure_plan(n, plan)
        nd_counts["axis_passes"] += 1
        tile = _column_tile(re, im, ax, plan)
        if tile:
            re_m, im_m = _columns(re, im, ax, plan, forward, tile)
        else:
            re_m, im_m = _relayout(re, im, ax, plan.precision.storage_dtype)
            re_m, im_m = _run(re_m, im_m, plan, forward, {})
        re = torch.movedim(re_m, -1, ax)
        im = torch.movedim(im_m, -1, ax)
    return re, im


@tracing.spanned("tfft.nd")
def _fftn_call(re, im, axes, plans, forward, plan_kwargs):
    """One ``fftn_split`` / ``ifftn_split`` call: one ``tfft.nd`` span
    around the whole dispatch, however deep it recurses."""
    re, im = _as_planes(re, im)
    axes = tuple(range(re.ndim)) if axes is None else tuple(axes)
    return _fftn_split(re, im, axes, plans or {}, forward, plan_kwargs)


def fftn_split(re, im, axes=None, plans=None, **plan_kwargs):
    """N-dimensional forward FFT of split-planar tensors over ``axes`` (all
    by default), on their device.  ``plans`` maps a length to its plan for
    the per-axis loop; the default scaling is 1/N per axis.  The result is
    in the plans' storage dtype."""
    return _fftn_call(re, im, axes, plans, True, plan_kwargs)


def ifftn_split(re, im, axes=None, plans=None, **plan_kwargs):
    """Inverse of :func:`fftn_split` under the plans' scaling convention."""
    return _fftn_call(re, im, axes, plans, False, plan_kwargs)


def fftn(x, axes=None, plans=None, *, device="cuda", **plan_kwargs):
    """N-dimensional FFT of a complex (or real) array, run on ``device``;
    returns NumPy complex64 (the host-boundary contract of :func:`fft`)."""
    re, im = _to_split(x, device)
    return _to_complex(*fftn_split(re, im, axes, plans, **plan_kwargs))


def ifftn(x, axes=None, plans=None, *, device="cuda", **plan_kwargs):
    """Inverse of :func:`fftn` (same host-boundary contract)."""
    re, im = _to_split(x, device)
    return _to_complex(*ifftn_split(re, im, axes, plans, **plan_kwargs))


def fft2(x, axes=(-2, -1), plans=None, *, device="cuda", **plan_kwargs):
    """2D FFT over ``axes`` (the last two by default); see :func:`fftn`."""
    return fftn(x, axes, plans, device=device, **plan_kwargs)


def ifft2(x, axes=(-2, -1), plans=None, *, device="cuda", **plan_kwargs):
    """Inverse of :func:`fft2`."""
    return ifftn(x, axes, plans, device=device, **plan_kwargs)
