"""Deviation metrics between a result and the fp64 oracle.

Mirror of the reference AccuracyCalculator.h: GetLargestDeviation (:86-100),
ComputeAverageDeviation (:103-124, pairwise-cascade summation), and
ComputeSigmaOfDeviation (:126-148).  Deviations are computed elementwise over
the concatenated RE and IM planes (the reference iterates the 2N-element split
buffer), on the 1/N-scaled values.

The conformance thresholds are the reference unit-test gate
(UnitTest.cu:14-16): avg <= 1e-3, sigma <= 1e-2, max <= 0.5.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch

__all__ = [
    "Agreement",
    "agreement",
    "Deviation",
    "deviation",
    "REFERENCE_AVG_THRESHOLD",
    "REFERENCE_SIGMA_THRESHOLD",
    "REFERENCE_MAX_THRESHOLD",
]

REFERENCE_AVG_THRESHOLD = 1e-3
REFERENCE_SIGMA_THRESHOLD = 1e-2
REFERENCE_MAX_THRESHOLD = 0.5


@dataclasses.dataclass(frozen=True)
class Deviation:
    average: float
    sigma: float
    maximum: float

    def passes_reference_gate(
        self,
        avg_threshold: float = REFERENCE_AVG_THRESHOLD,
        sigma_threshold: float = REFERENCE_SIGMA_THRESHOLD,
        max_threshold: float = REFERENCE_MAX_THRESHOLD,
    ) -> bool:
        return (
            self.average <= avg_threshold
            and self.sigma <= sigma_threshold
            and self.maximum <= max_threshold
        )

    def __str__(self):
        return (
            f"Deviation(avg={self.average:.3e}, sigma={self.sigma:.3e}, "
            f"max={self.maximum:.3e})"
        )


def deviation(
    got: Tuple[np.ndarray, np.ndarray],
    want: Tuple[np.ndarray, np.ndarray],
) -> Deviation:
    """Average/sigma/max absolute deviation over the split RE+IM planes.

    Host arrays (and CPU tensors) are compared in numpy.  When any plane is
    a tensor on a CUDA device, every plane is compared there in float64,
    so a 2^28-point result never leaves the card.
    """
    on_card = [x.device for x in (*got, *want)
               if isinstance(x, torch.Tensor) and x.device.type != "cpu"]
    if on_card:
        return _deviation_on_device(got, want, on_card[0])
    g = np.concatenate(
        [np.asarray(got[0], np.float64).ravel(), np.asarray(got[1], np.float64).ravel()]
    )
    w = np.concatenate(
        [np.asarray(want[0], np.float64).ravel(), np.asarray(want[1], np.float64).ravel()]
    )
    if g.shape != w.shape:
        raise ValueError(f"shape mismatch {g.shape} vs {w.shape}")
    dev = np.abs(g - w)
    avg = float(dev.mean())
    sigma = float(np.sqrt(np.mean((dev - avg) ** 2)))
    return Deviation(average=avg, sigma=sigma, maximum=float(dev.max()))


def _deviation_on_device(got, want, device) -> Deviation:
    """:func:`deviation` in float64 torch on ``device``, the numpy branch's
    mirror (at N = 2^28 its temporaries are a few 4 GiB planes)."""
    g = torch.cat([torch.as_tensor(x).to(device, torch.float64).reshape(-1) for x in got])
    w = torch.cat([torch.as_tensor(x).to(device, torch.float64).reshape(-1) for x in want])
    if g.shape != w.shape:
        raise ValueError(f"shape mismatch {tuple(g.shape)} vs {tuple(w.shape)}")
    dev = (g - w).abs_()
    del g, w
    avg = dev.mean()
    sigma = (dev - avg).square_().mean().sqrt()
    return Deviation(average=float(avg), sigma=float(sigma), maximum=float(dev.max()))


# Tolerances of one implementation against another on the same inputs (the
# port against the JAX package, a CUDA kernel against its plain version).
# Products of bf16 operands are exact in fp32, so the two differ only in the
# order their fp32 sums are taken (and, against XLA on the CPU, in its FMA
# contraction of the twiddle products).  Under bf16 storage that moves an
# output by one bf16 ulp on a small fraction of elements; more of them in
# the four-step, where one changed bf16 ``mid`` element spreads along its
# row.  Rarely it flips the bf16 rounding of an intermediate stage operand,
# which moves the outputs of that butterfly by ~2^-14 of the output scale:
# several ulps of an output near zero, far below one ulp at the scale.  So
# the bound is one bf16 ulp of the largest output magnitude, for every
# element.  Under fp32 storage the difference is ~1e-7 relative.
# A fused transform past N = 16384 (on a thread-block cluster) sums stages
# of radix up to 256 in another order than cuBLAS does, and flips an output
# rounding on ~0.1 % of elements (0.11 % at (256, 128) on the H100): it is
# held to FOUR_STEP_MAX_FRAC, the bound every port test applies past 16384.
BF16_MAX_SCALE_ULPS = 1.0
FUSED_MAX_FRAC = 1e-3
FOUR_STEP_MAX_FRAC = 1e-2
F32_REL_TOL = 1e-5
# Under a bf16 state every stage rounds its outputs to bf16, so one flipped
# rounding of a stage output moves the next stage's products by a whole
# bf16 step: the bound is two bf16 ulps of the output scale on at most 2 %
# of elements, and the transform must pass the reference gate as well.
BF16_STATE_MAX_SCALE_ULPS = 2.0
BF16_STATE_MAX_FRAC = 2e-2


def bf16_ulp(x: float) -> float:
    """Spacing of bf16 values at magnitude ``x`` (8 significant bits)."""
    return float(np.ldexp(1.0, int(np.floor(np.log2(x))) - 7)) if x > 0 else 0.0


@dataclasses.dataclass(frozen=True)
class Agreement:
    max_abs_err: float
    max_rel_err: float   # max |got - want| / max |want|
    scale_ulps: float    # max |got - want| in bf16 ulps of max |want|
    frac_differ: float   # fraction of elements not bit-identical
    bf16: bool

    def within(self, max_frac: float = FUSED_MAX_FRAC,
               max_ulps: float = BF16_MAX_SCALE_ULPS) -> bool:
        if self.bf16:
            return (self.scale_ulps <= max_ulps
                    and self.frac_differ <= max_frac)
        return self.max_rel_err <= F32_REL_TOL

    def __str__(self):
        return (f"Agreement(max_abs={self.max_abs_err:.3e}, "
                f"max_rel={self.max_rel_err:.3e}, "
                f"scale_ulps={self.scale_ulps:.3f}, "
                f"frac={self.frac_differ:.2e})")


def agreement(got, want, bf16: bool) -> Agreement:
    """How far the (re, im) planes ``got`` are from ``want``; ``bf16`` says
    both hold bf16 values (in any float dtype that holds them exactly)."""
    g = np.concatenate([np.asarray(a, np.float64).ravel() for a in got])
    w = np.concatenate([np.asarray(a, np.float64).ravel() for a in want])
    if g.shape != w.shape or not g.size:
        raise ValueError(f"bad shapes {g.shape} vs {w.shape}")
    err = float(np.abs(g - w).max())
    scale = float(np.abs(w).max())
    ulp = bf16_ulp(scale)
    return Agreement(
        max_abs_err=err,
        max_rel_err=err / scale if scale > 0 else err,
        scale_ulps=err / ulp if ulp > 0 else err,
        frac_differ=float((g != w).mean()),
        bf16=bf16,
    )
