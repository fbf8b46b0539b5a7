"""The one traffic generator: it reads a traffic file's parameters and makes
the input pools of a run on the device from the seed.

A traffic file (``portbench/traffic/<name>.json``) holds:

* ``step``: the directions of the calls that make one step, in order; the
  step ends with a synchronize (a closed loop with one caller);
* ``rows_per_call``: the call's batch, transforms of the configuration's
  length N;
* ``pool_bytes``: bytes of distinct inputs per direction, in the storage
  dtype, used round robin (at least one batch).

Inputs are standard-normal real and imaginary planes, drawn in float32 by one
``torch.Generator`` on the device in one call per direction and cast to the
configuration's storage dtype.  Every seed gives the same sizes; only the
values differ.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Tuple

import torch

from portbench import work

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32,
          "float32_x6": torch.float32}


@dataclasses.dataclass(frozen=True)
class Layout:
    rows: int          # batch of one call
    n: int
    pool: int          # distinct batches per direction
    step: Tuple[str, ...]

    @property
    def directions(self) -> Tuple[str, ...]:
        return tuple(dict.fromkeys(self.step))


def layout(traffic: dict, config: dict) -> Layout:
    n = int(config["n"])
    rows = int(traffic["rows_per_call"])
    if rows < 1:
        raise ValueError(f"rows_per_call {rows} is not a batch")
    batch_bytes = rows * n * 2 * work.STORAGE_BYTES[config["precision"]]
    pool = max(1, int(traffic["pool_bytes"]) // batch_bytes)
    return Layout(rows=rows, n=n, pool=pool, step=tuple(traffic["step"]))


def make_pools(lay: Layout, precision: str, seed: int,
               device: torch.device) -> Dict[str, List[Tuple[torch.Tensor, torch.Tensor]]]:
    """direction -> ``pool`` batches of (re, im) planes, each (rows, n)."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    pools = {}
    for direction in lay.directions:
        planes = torch.randn((2, lay.pool, lay.rows, lay.n), generator=gen,
                             device=device, dtype=torch.float32)
        planes = planes.to(DTYPES[precision])
        pools[direction] = [(planes[0, p], planes[1, p]) for p in range(lay.pool)]
    return pools
