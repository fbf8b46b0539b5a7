"""Mixed-radix digit reversal as reshapes and transposes.

The Stockham stage engines never reorder their data; this module is the
testable reference for an explicit digit-reversal reorder (and for
algorithms that want one): on an axis viewed as (r_s, ..., r_1) the
reversal is a multi-axis transpose.  ``digit_reversal_permutation`` and
``digit_reverse`` are numpy, bit-identical to the JAX package's;
``digit_reverse_torch`` is the same reshape/permute on a tensor, on its
device.
"""
from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

__all__ = ["digit_reversal_permutation", "digit_reverse", "digit_reverse_torch"]


def digit_reversal_permutation(n: int, radices: Sequence[int]) -> np.ndarray:
    """perm[j] = source index feeding output slot j.

    Digits of j are taken in combine order (first radix = least significant)
    and re-assembled most-significant-first.
    """
    if int(np.prod(radices)) != n:
        raise ValueError(f"radices {radices} do not factor {n}")
    rem = np.arange(n, dtype=np.int64)
    perm = np.zeros(n, dtype=np.int64)
    for r in radices:
        perm = perm * r + rem % r
        rem //= r
    return perm


def _reverse_axes(shape, radices, axis):
    """(view shape, permutation, output shape) of the reversal along
    ``axis``: view the axis as the reversed radices, reverse the sub-axes,
    flatten."""
    ndim = len(shape)
    axis = axis % ndim
    n = shape[axis]
    if int(np.prod(radices)) != n:
        raise ValueError(f"radices {radices} do not factor {n}")
    lead = tuple(shape[:axis])
    tail = tuple(shape[axis + 1:])
    k = len(radices)
    view = (*lead, *reversed(radices), *tail)
    perm = (
        tuple(range(len(lead)))
        + tuple(len(lead) + k - 1 - i for i in range(k))
        + tuple(len(lead) + k + i for i in range(len(tail)))
    )
    return view, perm, (*lead, n, *tail)


def digit_reverse(x: np.ndarray, radices: Sequence[int], axis: int = -1):
    """Apply the digit reversal along ``axis`` via reshape + transpose.

    This gathers by the inverse of :func:`digit_reversal_permutation`,
    ``x[argsort(perm)]``; that is ``x[perm]`` when the radices read the
    same reversed (every radix equal, say), the permutation then being its
    own inverse.  Reversing with ``reversed(radices)`` undoes it.
    """
    x = np.asarray(x)
    view, perm, out = _reverse_axes(x.shape, tuple(radices), axis)
    return x.reshape(view).transpose(perm).reshape(out)


def digit_reverse_torch(x: torch.Tensor, radices: Sequence[int],
                        axis: int = -1) -> torch.Tensor:
    """:func:`digit_reverse` on a tensor, on its device."""
    view, perm, out = _reverse_axes(tuple(x.shape), tuple(radices), axis)
    return x.reshape(view).permute(perm).reshape(out)
