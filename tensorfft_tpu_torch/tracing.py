"""Spans and counters inside the port, read through ``torch.profiler``.

To see them, run the profiler around your own calls and export its trace::

    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        out = tfft.fft_split(re, im, plan)
        torch.cuda.synchronize()
    prof.export_chrome_trace("trace.json")   # or prof.key_averages().table()

The spans are ``torch.profiler.record_function`` ranges (category
``user_annotation`` in the chrome trace), on the profiler's own clock beside
torch's ``cpu_op`` events and the CUDA runtime's launch events:

``tfft.entry``
    one ``fft_split`` / ``ifft_split`` call, and each axis of the N-D
    per-axis loop: the casts, the reshape to (B, N) rows, ``contiguous`` and
    the output's conversion back.
``tfft.dispatch``
    the transform of (B, N) rows in the storage dtype
    (``fft._fft_split_core``, also reached from ``rfft_split`` and
    ``irfft_split``): the strategy, the call's arguments, the table lookups
    and the output allocation.
``tfft.launch.<symbol>``
    one call of a C launcher, named without its ``tfft_`` prefix
    (``fused_fft``, ``four_step_col``, ``four_step_row``, ...): the device
    context, the stream, the ctypes call and the CUDA runtime's launch.  A
    kernel on the device timeline shares its ``correlation`` id with a launch
    event inside exactly one of these spans, which names it: kernels B and C
    are one symbol, ``four_step_tc_kernel``, launched by ``four_step_col``
    and ``four_step_row``.

``tfft.nd``
    one ``fftn_split`` / ``ifftn_split`` call (also under ``fftn``,
    ``rfftn_split`` and ``fft_convolve_2d``), however deep its dispatch
    recurses.  Inside it:
``tfft.nd.fft2``
    the 2D branch: the trailing two axes as K4 (``fft2_col`` then
    ``fft2_row``), with its casts and reshapes;
``tfft.nd.relayout``
    each pass of the per-axis loop that copies: the move of its axis last,
    the cast and the copy that makes the planes contiguous.  The pass's
    ``tfft.entry`` follows it and copies nothing.  A pass whose tiles land
    straight from the strided planes (``fused_cuda.fused_fft_columns``,
    launcher ``fused_fft_cols``) has no such span: its ``tfft.entry`` holds
    the launch.

``tfft.r2c``
    one ``rfft_split`` / ``irfft_split`` call (also under ``rfftn_split``,
    ``irfftn_split`` and the models): the pack or the retangle, the
    half-length transform and the untangle or the interleave, with the
    path's own casts and copies (``irfft_split``'s copy of a permuted
    spectrum into rows among them).
``tfft.model.poisson``
    one ``models.poisson_solve_3d`` call: its ``rfftn_split`` (a
    ``tfft.r2c`` span, then a ``tfft.nd`` span), the spectral scale (the
    ``tfft.launch.poisson_scale`` launch on the card), its ``irfftn_split``
    (a ``tfft.nd`` span, then a ``tfft.r2c`` span) and the cast of u to
    float32.
``tfft.model.conv2d``
    one ``models.fft_convolve_2d`` call: the two forward ``fftn_split``
    calls (each a ``tfft.nd`` span, the image's first), the spectra's
    product (the ``tfft.launch.spectral_product`` launch on the card), the
    inverse ``ifftn_split`` (a third ``tfft.nd`` span) and the output's
    scale by H * W.
``tfft.model.conv_real``
    one ``models.fft_convolve_real`` call: two ``rfft_split`` calls, the
    product and an ``irfft_split`` call (three ``tfft.r2c`` spans).

A call's spans nest on one thread; the ``tfft.entry`` span that holds a
span is the call it belongs to.  The spans are made only while a profiler
records (``torch.autograd._profiler_enabled()``); otherwise each site costs
that one check (and a launch a shared null context).  There is no setting.

:func:`counters` returns what the package counts anyway, with or without a
profiler.
"""
from __future__ import annotations

import contextlib
import functools

import torch

__all__ = ["spanned", "launch_span", "counters"]

LAUNCH_PREFIX = "tfft.launch."
_OFF = contextlib.nullcontext()
_profiler_enabled = torch.autograd._profiler_enabled

# C launcher (its ``tfft_`` prefix dropped) -> (ops module, counted wrapper).
_LAUNCHERS = {
    "fused_fft": ("fused_cuda", "fused_fft"),
    "fused_fft_cols": ("fused_cuda", "fused_fft_columns"),
    "fused_batch_major": ("four_step_cuda", "fused_fft_batch_major"),
    "four_step_col": ("four_step_cuda", "column_pass"),
    "four_step_row": ("four_step_cuda", "row_pass"),
    "four_step_col_packed": ("four_step_cuda", "column_pass_packed"),
    "four_step_row_interleave": ("four_step_cuda", "row_pass_interleave"),
    "fft2_col": ("four_step_cuda", "fft2_column_pass"),
    "fft2_row": ("four_step_cuda", "fft2_row_pass"),
    "pack_split": ("rfft_cuda", "pack_split"),
    "interleave_split": ("rfft_cuda", "interleave_split"),
    "untangle_fwd": ("rfft_cuda", "untangle_fwd"),
    "retangle_inv": ("rfft_cuda", "retangle_inv"),
    "poisson_scale": ("spectral_cuda", "poisson_scale"),
    "spectral_product": ("spectral_cuda", "spectral_product"),
}

# The cached builders of kernel operands: each miss computes the tables on
# the host and, all but the two numpy ones, copies them to the device.
_TABLE_BUILDERS = {
    "mma_tables": ("fused_cuda", "mma_tables"),
    "kernel_tables": ("fused_cuda", "kernel_tables"),
    "four_step_tables": ("four_step_cuda", "four_step_tables"),
    "device_pq": ("four_step_cuda", "_device_pq"),
    "phase_tables": ("rfft_cuda", "phase_tables"),
    "device_phase": ("rfft_cuda", "_device_phase"),
    "poisson_tables": ("poisson", "device_tables"),
}


def spanned(name: str):
    """Decorator: the function runs inside a profiler span named ``name``
    while a profiler records, and is called directly otherwise."""
    def decorate(fn):
        @functools.wraps(fn)
        def traced(*args, **kwargs):
            if _profiler_enabled():
                with torch.profiler.record_function(name):
                    return fn(*args, **kwargs)
            return fn(*args, **kwargs)
        return traced
    return decorate


def launch_span(symbol: str):
    """The ``tfft.launch.<symbol>`` span of one call of C launcher
    ``symbol`` (``tfft_four_step_col`` -> ``tfft.launch.four_step_col``);
    the name is built only while a profiler records."""
    if _profiler_enabled():
        return torch.profiler.record_function(
            LAUNCH_PREFIX + symbol.removeprefix("tfft_"))
    return _OFF


def counters() -> dict:
    """What the package has counted since it was imported, in one dict:

    ``launches``
        kernel launches per C launcher (the names of the launch spans), the
        counted wrappers' ``launches``;
    ``variants``
        the same launches per variant, for the launchers whose wrapper
        counts them (``variant_launches``: the engine, knobs and kernel in
        effect, e.g. ``fused_fft``'s ``pipelined,tile16,mma`` for kernel A's
        pipelined kernel on tiles of 16 rows, ``fused_fft_cols``'s
        ``pipelined,tile16,cols,mma`` for its tiles landed from strided
        planes, ``ops/fused_cuda.py:variant``);
    ``table_builds``
        builds per cached table builder (``cache_info().misses``).  After
        the first call of each plan this stays put; a count that keeps
        rising means the calls cycle through more plans, lengths or devices
        than a builder's cache holds (64 keys), so calls rebuild tables on
        the host and copy them to the device again;
    ``nd``
        the N-D dispatch (``fft.nd_counts``): ``fft2_branch``, calls of the
        2D branch; ``axis_passes``, passes of the per-axis loop (those
        that land from the strided planes too); ``relayout_bytes``, bytes
        the relayout wrote, both planes (it reads as many);
    ``r2c``
        the R2C path (``rfft.r2c_counts``): ``calls`` and ``copy_bytes``;
    ``models``
        calls of each model: ``poisson_solves``, ``conv2d_calls``
        (``fft_convolve_2d``) and ``conv_real_calls``
        (``fft_convolve_real``).
    """
    from tensorfft_tpu_torch.fft import nd_counts
    from tensorfft_tpu_torch.models import fft_conv, poisson
    from tensorfft_tpu_torch.ops import four_step_cuda, fused_cuda, rfft_cuda, spectral_cuda
    from tensorfft_tpu_torch.rfft import r2c_counts

    modules = {"fused_cuda": fused_cuda, "four_step_cuda": four_step_cuda,
               "rfft_cuda": rfft_cuda, "spectral_cuda": spectral_cuda,
               "poisson": poisson}
    return {
        "launches": {symbol: getattr(modules[m], f).launches
                     for symbol, (m, f) in _LAUNCHERS.items()},
        "variants": {symbol: dict(getattr(modules[m], f).variant_launches)
                     for symbol, (m, f) in _LAUNCHERS.items()
                     if hasattr(getattr(modules[m], f), "variant_launches")},
        "table_builds": {name: getattr(modules[m], f).cache_info().misses
                         for name, (m, f) in _TABLE_BUILDERS.items()},
        "nd": dict(nd_counts),
        "r2c": dict(r2c_counts),
        "models": {**poisson.model_counts, **fft_conv.model_counts},
    }
