"""The FFT image convolution through the port's public API:
``tensorfft_tpu_torch.models.fft_convolve_2d`` of one image with one kernel
a row, with the configuration's precision and no plans (the library's
default plan for each axis).

The direction is ``forward`` (one convolution a call), so the check's
numbers are ``fwd_rel_rms`` and ``fwd_max_err``.  The pool's (rows, N)
``re`` plane is viewed as (rows, *shape) images and its ``im`` plane as
(rows, *shape) kernels, with no copy, and the batch is convolved in one
call, image r with kernel r.  The output is the convolution as (rows,
*shape) float32, and a zero imaginary plane expanded to it (a view of one
zero made at the first call, so the timed calls allocate nothing for it).
"""
from __future__ import annotations

import math

import torch

from tensorfft_tpu_torch.models import fft_convolve_2d

from portbench import work

SPANS = {"forward": "fft_convolve_2d"}


def frame_shape(config: dict):
    """The frame's shape, checked against the configuration's N."""
    shape = tuple(int(s) for s in config["shape"])
    if len(shape) != 2 or math.prod(shape) != int(config["n"]):
        raise ValueError(f"shape {shape} is not a 2-D frame of n = {config['n']}")
    return shape


def make(config: dict) -> dict:
    """direction -> callable(re, im) -> (out, zeros)."""
    shape = frame_shape(config)
    precision = config["precision"]
    zeros = {}

    def convolve(re, im):
        out = fft_convolve_2d(re.view(re.shape[0], *shape), im.view(im.shape[0], *shape),
                              precision=precision)
        if out.device not in zeros:
            zeros[out.device] = torch.zeros((), dtype=out.dtype, device=out.device)
        return out, zeros[out.device].expand(out.shape)

    return {"forward": convolve}


def work_of_call(config: dict, rows: int):
    """(operations, compulsory bytes) of one call on ``rows`` frames: three
    transforms of N points of real data at heFFTe's real count, 2.5 N log2 N
    each (the product and the scale are not counted), and the image and the
    kernel read once in the storage dtype and the output written once in
    float32."""
    n = math.prod(frame_shape(config))
    return (3 * work.c2c_flops(n, rows) / 2,
            (2 * work.STORAGE_BYTES[config["precision"]] + 4) * n * rows)
