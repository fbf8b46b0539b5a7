"""The periodic Poisson solve through the port's public API:
``tensorfft_tpu_torch.models.poisson_solve_3d`` on one real grid a row, with
the configuration's precision, lengths and eigenvalues, and no plans (the
library's default plan for each axis).

The direction is ``forward`` (one solve a call), so the check's numbers are
``fwd_rel_rms`` and ``fwd_max_err``.  The pool's (rows, N) ``re`` plane is
viewed as (rows, *shape) with no copy and each grid is solved as f; ``im``
is not read.  The output is u as (rows, *shape) float32, and a zero
imaginary plane expanded to it (a view of one zero made at the first call,
so the timed calls allocate nothing for it).  Importing this module imports
the model, so a program without it fails here, before any kernel is built.
"""
from __future__ import annotations

import math

import torch

from tensorfft_tpu_torch.models import poisson_solve_3d

from portbench import work

SPANS = {"forward": "poisson_solve_3d"}


def grid_shape(config: dict):
    """The grid's shape, checked against the configuration's N."""
    shape = tuple(int(s) for s in config["shape"])
    if len(shape) != 3 or math.prod(shape) != int(config["n"]):
        raise ValueError(f"shape {shape} is not a 3-D grid of n = {config['n']}")
    return shape


def make(config: dict) -> dict:
    """direction -> callable(re, im) -> (u, zeros)."""
    shape = grid_shape(config)
    kwargs = dict(precision=config["precision"], discrete=bool(config["discrete"]),
                  lengths=tuple(float(x) for x in config["lengths"]))
    zeros = {}

    def solve(re, im):
        grids = re.view(re.shape[0], *shape)
        us = [poisson_solve_3d(f, **kwargs) for f in grids]
        u = us[0].unsqueeze(0) if len(us) == 1 else torch.stack(us)
        if u.device not in zeros:
            zeros[u.device] = torch.zeros((), dtype=u.dtype, device=u.device)
        return u, zeros[u.device].expand(u.shape)

    return {"forward": solve}


def work_of_call(config: dict, rows: int):
    """(operations, compulsory bytes) of one call on ``rows`` grids: two real
    transforms of N points at 2.5 N log2 N each (heFFTe's count; the scale
    is not counted), and f read once in the storage dtype and u written
    once in float32."""
    n = math.prod(grid_shape(config))
    return (work.c2c_flops(n, rows),
            (work.STORAGE_BYTES[config["precision"]] + 4) * n * rows)
