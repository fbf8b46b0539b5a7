"""The work of a transform, counted from its shapes alone.

Whatever implements the transform (which kernels, passes, tables or plan),
the count is the same, so a later change to the program cannot move it:

* operations: 5 N log2 N per length-N complex transform;
* bytes: each input plane read once and each output plane written once, in
  the storage dtype (a complex element of bf16 planes is 4 bytes in and 4
  out). No table, intermediate or extra pass is counted.
"""
from __future__ import annotations

import math

from portbench import peaks

STORAGE_BYTES = {"bfloat16": 2, "float32": 4, "float32_x6": 4}


def c2c_flops(n: int, rows: int) -> float:
    """Operations of ``rows`` complex transforms of length ``n``."""
    return 5.0 * n * math.log2(n) * rows


def c2c_bytes(n: int, rows: int, precision: str) -> int:
    """Compulsory bytes: both planes read once and written once."""
    return 2 * 2 * STORAGE_BYTES[precision] * n * rows


def bound_seconds(flops: float, nbytes: float, peak_flops: str) -> float:
    """Least time the card could take: the larger of operations over the
    named operation peak and bytes over the HBM bandwidth."""
    return max(flops / peaks.FLOPS[peak_flops], nbytes / peaks.HBM_BYTES_PER_S)
