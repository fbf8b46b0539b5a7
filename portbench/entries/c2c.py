"""Batched 1D C2C through the port's public API: ``fft_split`` forward and
``ifft_split`` inverse on split (B, N) planes, with one plan made in set-up
by ``create_plan(n, precision=...)`` and the library's defaults for the rest.
"""
from __future__ import annotations

import tensorfft_tpu_torch as tfft

from portbench import work

SPANS = {"forward": "fft_split", "inverse": "ifft_split"}


def make(config: dict) -> dict:
    """direction -> callable(re, im) -> (re, im)."""
    plan = tfft.create_plan(int(config["n"]), precision=config["precision"])
    return {"forward": lambda re, im: tfft.fft_split(re, im, plan),
            "inverse": lambda re, im: tfft.ifft_split(re, im, plan)}


def work_of_call(config: dict, rows: int):
    """(operations, compulsory bytes) of one call on ``rows`` rows."""
    n = int(config["n"])
    return work.c2c_flops(n, rows), work.c2c_bytes(n, rows, config["precision"])
