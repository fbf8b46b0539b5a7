"""Compulsory bytes of the real-to-complex kernels and of the spectral
scale on one real grid, counted from its shape alone (``work.py`` counts
whole transforms; this counts the kernels the per-layer metrics of the
Poisson cell read).

For a real (..., nz) grid of R = size / nz rows, M = nz / 2, in the storage
dtype of s bytes, each kernel reads its inputs once and writes its outputs
once:

* pack (K7): the real rows in (R nz s), both half-length planes out
  (2 R M s);
* untangle (K9): both (R, M) planes in, both (R, M + 1) planes out;
* retangle (K10): both (R, M + 1) planes in, both (R, M) planes out;
* interleave (K8): both (R, M) planes in, the real rows out;
* the spectral scale: both half-spectrum planes (size / nz * (M + 1)) in
  and out.

The readers of these counts see a trace, and the Poisson reference sees
planes, never the cell's configuration; ``metric_config`` and
``entry_config`` find it in ``BENCHMARK.json`` (the cells a metric lists,
or the cells that run an entry) and refuse cells whose configurations
differ in what the reader needs, rather than read one file for all.
"""
from __future__ import annotations

import json
import math

from portbench import spec, work


def _one_config(cells, keys, what: str) -> dict:
    """The configuration of the named ``cells``; they must agree on
    ``keys``."""
    configs = {}
    for name in cells:
        config = spec.load_cell(name).config
        configs.setdefault(json.dumps([config[k] for k in keys]), []).append(name)
    if len(configs) != 1:
        raise ValueError(f"{what}: the cells {dict(zip(configs, configs.values()))} "
                         f"differ in {keys}, which this reader cannot tell apart; "
                         f"give it the cell's configuration")
    return spec.load_cell(next(iter(configs.values()))[0]).config


def metric_config(metric: str) -> dict:
    """The configuration of the cells ``BENCHMARK.json`` lists for the
    per-layer ``metric``, which must share one grid and storage dtype."""
    bench = spec._json(spec.ROOT / "BENCHMARK.json")
    (entry,) = [m for m in bench["per_layer"] if m["name"] == metric]
    return _one_config(entry["workloads"], ("shape", "precision"), metric)


def entry_config(entry: str, keys) -> dict:
    """The configuration of the cells of ``BENCHMARK.json`` that run
    ``entries/<entry>.py``, which must agree on ``keys``."""
    bench = spec._json(spec.ROOT / "BENCHMARK.json")
    cells = [w["name"] for w in bench["workloads"]
             if spec._json(spec.HERE / "cells" / f"{w['name']}.json")["entry"] == entry]
    return _one_config(cells, keys, f"references/{entry}.py")


def epilogue_bytes(shape, precision: str) -> dict:
    """Bytes of one launch of each R2C kernel on a real grid of ``shape``."""
    *rest, nz = (int(s) for s in shape)
    rows, m, s = math.prod(rest), nz // 2, work.STORAGE_BYTES[precision]
    half, half_plus, real = 2 * rows * m * s, 2 * rows * (m + 1) * s, rows * nz * s
    return {"pack": real + half, "untangle": half + half_plus,
            "retangle": half_plus + half, "interleave": half + real}


def scale_bytes(shape, precision: str) -> int:
    """Bytes of one launch of the spectral scale on the half spectrum of a
    real grid of ``shape``."""
    *rest, nz = (int(s) for s in shape)
    return 2 * 2 * work.STORAGE_BYTES[precision] * math.prod(rest) * (nz // 2 + 1)
