"""The 3-D complex-to-complex transform through the port's public API:
``fftn_split`` forward and ``ifftn_split`` inverse over the last three axes,
with no plans (the library's default plan for each axis) and the
configuration's precision.

The pool's (rows, N) planes are viewed as (rows, *shape) with no copy, so a
call on one row is a bare call on one grid; the outputs are returned as the
program gives them, views included.
"""
from __future__ import annotations

import math

import tensorfft_tpu_torch as tfft

from portbench import work

SPANS = {"forward": "fftn_split", "inverse": "ifftn_split"}
AXES = (-3, -2, -1)


def grid_shape(config: dict):
    """The grid's shape, checked against the configuration's N."""
    shape = tuple(int(s) for s in config["shape"])
    if len(shape) != len(AXES) or math.prod(shape) != int(config["n"]):
        raise ValueError(f"shape {shape} is not a 3-D grid of n = {config['n']}")
    return shape


def make(config: dict) -> dict:
    """direction -> callable(re, im) -> (re, im)."""
    shape = grid_shape(config)
    precision = config["precision"]

    def call(transform):
        def run(re, im):
            return transform(re.view(re.shape[0], *shape), im.view(im.shape[0], *shape),
                             axes=AXES, precision=precision)
        return run

    return {"forward": call(tfft.fftn_split), "inverse": call(tfft.ifftn_split)}


def work_of_call(config: dict, rows: int):
    """(operations, compulsory bytes) of one call on ``rows`` grids: a grid
    of N points counts as one N-point transform."""
    n = math.prod(grid_shape(config))
    return work.c2c_flops(n, rows), work.c2c_bytes(n, rows, config["precision"])
