"""Compulsory bytes of the image convolution's spectral product on one
frame, counted from its shape alone (``work.py`` counts whole transforms;
this counts the kernel the ``spectral_product_roofline`` metric reads).

For a frame of N points in the storage dtype of s bytes, the product reads
both spectra's two planes once (4 N s) and writes its two float32 planes
once (8 N): 24 N bytes at float32, 402,653,184 at 4096 x 4096 (0.1202 ms
at 3.35 TB/s).  The metric sees a trace, never the cell's configuration;
it finds the frame through ``r2c_work.metric_config`` (the cells that list
it), which refuses cells of different frames or dtypes.
"""
from __future__ import annotations

import math

from portbench import work


def product_bytes(shape, precision: str) -> int:
    """Bytes of one launch of the spectral product on one frame of
    ``shape``."""
    return (4 * work.STORAGE_BYTES[precision] + 2 * 4) * math.prod(int(s) for s in shape)
