"""How ``correct`` is decided: the outputs the timed path produced, sampled
from the seed, against the plain reference on the same inputs.

A reservoir keeps a uniform sample of each direction's outputs over the
whole window (``random.Random(seed)``).  Once the window has closed, each
kept batch is compared with the reference, in blocks of rows, on two
numbers per direction:

* ``<dir>_rel_rms``: the norm of (output - reference) over the norm of the
  reference, over the batch;
* ``<dir>_max_err``: the largest |output - reference| of any element, over
  the rms magnitude of the reference's elements in its own row (so one wrong
  element of one row shows).

Each number's worst over the sampled batches is held to the cell's limit
(``limits`` in the cell file).
"""
from __future__ import annotations

import math
import random
from typing import Dict, List, Tuple

import torch

SAMPLE_BYTES = 512 << 20     # outputs kept per direction
MAX_SAMPLES = 16
BLOCK_ELEMENTS = 1 << 22     # rows per reference block: this many elements
SHORT = {"forward": "fwd", "inverse": "inv"}  # a direction's name in its numbers


class Reservoir:
    """A uniform sample of at most ``k`` of the items offered."""

    def __init__(self, k: int, rng: random.Random):
        self.k, self.rng, self.seen, self.items = k, rng, 0, []

    def offer(self, item) -> None:
        if self.seen < self.k:
            self.items.append(item)
        else:
            j = self.rng.randrange(self.seen + 1)
            if j < self.k:
                self.items[j] = item
        self.seen += 1


def sample_size(batch_bytes: int) -> int:
    return max(1, min(MAX_SAMPLES, SAMPLE_BYTES // batch_bytes))


def compare(samples: Dict[str, List], pools, reference, scaling: str,
            limits: Dict[str, float]) -> Tuple[Dict[str, float], int]:
    """Each direction's worst numbers over its sampled (pool index, out_re,
    out_im), infinity for a non-finite output, and the count of sampled
    batches with a number over its limit."""
    numbers, failed = {}, 0
    for direction, items in samples.items():
        short = SHORT.get(direction, direction)
        names = (f"{short}_rel_rms", f"{short}_max_err")
        worst = [0.0, 0.0]
        for p, o_re, o_im in items:
            got = _numbers(*pools[direction][p], o_re, o_im, direction,
                           reference, scaling)
            failed += any(v > limits[name] for v, name in zip(got, names))
            worst = [max(w, v) for w, v in zip(worst, got)]
        numbers.update(zip(names, worst))
    return numbers, failed


def _numbers(re, im, o_re, o_im, direction, reference, scaling):
    """(rel_rms, max_err) of one batch, in blocks of rows."""
    rows = max(1, BLOCK_ELEMENTS // re.shape[-1])
    err2 = ref2 = mx = 0.0
    for r in range(0, re.shape[0], rows):
        sl = slice(r, r + rows)
        want = reference.transform(re[sl], im[sl], direction, scaling)
        got = torch.complex(o_re[sl].to(torch.float64), o_im[sl].to(torch.float64))
        diff = (got - want).abs()
        row_rms = want.abs().square().mean(-1, keepdim=True).sqrt()
        err2 += float(diff.square().sum())
        ref2 += float(want.abs().square().sum())
        mx = max(mx, _finite(float((diff / row_rms).max())))
    return _finite(math.sqrt(err2 / ref2)), mx


def _finite(x: float) -> float:
    return x if math.isfinite(x) else math.inf
