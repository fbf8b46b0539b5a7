"""Synthetic input generators for conformance testing and benchmarking.

Mirror of the reference TestingDataCreation.h: seeded random weights
(GetRandomWeights, TestingDataCreation.h:15-27, uniform on [-1, 1]) and
sine-superposition signals with either linear harmonics 0..cutoff-1
(CreateSineSuperpostionKernel, TestingDataCreation.h:90-117 — the generator
the unit tests use) or power-of-two harmonics
(CreateSineSquareSuperpostionKernel, :29-56).  The reference materializes the
same waveform in __half/float2/double2 so its FFT and cuFFT consume identical
signals; here one float64 NumPy array feeds both our FFT (rounded to the plan's
storage dtype at the boundary) and the fp64 oracle.  ``sine_superposition_torch``
builds the same signal in float64 on a device (the card's conformance sweep,
where numpy's would cost seconds per plane at N = 2^28).
"""
from __future__ import annotations

import math
from typing import Tuple

import numpy as np
import torch

__all__ = ["get_random_weights", "sine_superposition",
           "sine_superposition_torch", "make_test_signal"]

# Past this many sine evaluations (cutoff * N) the linear-harmonic signal is
# built from its exact spectrum with one inverse FFT instead.
DIRECT_SUM_LIMIT = 1 << 28


def get_random_weights(max_frequencies: int, seed: int) -> np.ndarray:
    """Seeded uniform weights on [-1, 1] (reference TestingDataCreation.h:15-27).

    Determinism contract: same (max_frequencies, seed) always produces the same
    weights (PCG64 stream; we do not chase bit-parity with libstdc++'s
    default_random_engine, only the distribution and seeding discipline).
    """
    rng = np.random.Generator(np.random.PCG64(seed))
    return rng.uniform(-1.0, 1.0, size=max_frequencies)


def _weights_and_freqs(weights, harmonics: str):
    """The weights as float64 and the frequency f(h) of each."""
    weights = np.asarray(weights, dtype=np.float64)
    if harmonics not in ("linear", "pow2"):
        raise ValueError(f"bad harmonics {harmonics!r}")
    h = np.arange(len(weights), dtype=np.float64)
    return weights, (h if harmonics == "linear" else 2.0 ** h)


def sine_superposition(
    fft_length: int,
    weights: np.ndarray,
    harmonics: str = "linear",
    dtype=np.float64,
) -> np.ndarray:
    """x[j] = sum_h w[h] * sin(2*pi*f(h)*j / fft_length) for j in [0, N).

    harmonics='linear': f(h) = h (reference CreateSineSuperpostionKernel,
    TestingDataCreation.h:100-104).
    harmonics='pow2':   f(h) = 2^h (CreateSineSquareSuperpostionKernel, :40-43).
    """
    weights, freqs = _weights_and_freqs(weights, harmonics)
    if harmonics == "linear" and len(weights) * fft_length > DIRECT_SUM_LIMIT:
        # Spectral construction: sum_h w_h sin(2 pi h j / N) has the exact
        # spectrum X[h] = -i w_h/2, X[N-h] = +i w_h/2 (h >= 1, h < N), so one
        # N log N inverse FFT replaces O(N * cutoff) sine evaluations (the
        # bandwidth sweep would otherwise need ~1e12 of them).  Harmonics
        # alias mod N exactly as in the direct sum.
        spec = np.zeros(fft_length, dtype=np.complex128)
        h = (freqs.astype(np.int64)) % fft_length
        np.add.at(spec, h, -0.5j * weights)
        np.add.at(spec, (-h) % fft_length, 0.5j * weights)
        return np.fft.ifft(spec).real.astype(dtype) * fft_length
    n = np.arange(fft_length, dtype=np.float64)
    out = np.zeros(fft_length, dtype=np.float64)
    # Chunk the outer product to bound memory at large N.
    chunk = max(1, (1 << 22) // max(len(weights), 1))
    for lo in range(0, fft_length, chunk):
        hi = min(lo + chunk, fft_length)
        phase = (2.0 * np.pi / fft_length) * np.outer(freqs, n[lo:hi])
        out[lo:hi] = weights @ np.sin(phase)
    return out.astype(dtype)


def sine_superposition_torch(
    fft_length: int,
    weights: np.ndarray,
    device,
    harmonics: str = "linear",
) -> torch.Tensor:
    """:func:`sine_superposition` as a float64 tensor built on ``device``,
    with the same direct-sum / spectral threshold (DIRECT_SUM_LIMIT).  It
    differs from the numpy signal by the last bits of the device's ``sin``
    and FFT, ~1e-15 of the signal's scale."""
    weights, freqs = _weights_and_freqs(weights, harmonics)
    if harmonics == "linear" and len(weights) * fft_length > DIRECT_SUM_LIMIT:
        # The spectral construction of sine_superposition; its few nonzero
        # bins are summed on the host (aliased harmonics share a bin).
        h = freqs.astype(np.int64) % fft_length
        bins, where = np.unique(np.concatenate([h, (-h) % fft_length]),
                                return_inverse=True)
        vals = np.zeros(len(bins), np.complex128)
        np.add.at(vals, where, np.concatenate([-0.5j * weights, 0.5j * weights]))
        spec = torch.zeros(fft_length, dtype=torch.complex128, device=device)
        spec[torch.from_numpy(bins).to(device)] = torch.from_numpy(vals).to(device)
        return torch.fft.ifft(spec).real * fft_length
    f = torch.from_numpy(freqs).to(device)
    w = torch.from_numpy(weights).to(device)
    n = torch.arange(fft_length, dtype=torch.float64, device=device)
    out = torch.empty(fft_length, dtype=torch.float64, device=device)
    chunk = max(1, (1 << 26) // max(len(weights), 1))
    for lo in range(0, fft_length, chunk):
        hi = min(lo + chunk, fft_length)
        phase = (2.0 * math.pi / fft_length) * torch.outer(f, n[lo:hi])
        out[lo:hi] = w @ torch.sin(phase)
    return out


def make_test_signal(
    fft_length: int,
    seed_re: int,
    seed_im: int,
    cutoff: int = 20,
    harmonics: str = "linear",
) -> Tuple[np.ndarray, np.ndarray]:
    """Split-complex fp64 test signal (re, im) exactly as the reference unit
    test constructs it (UnitTest.cu:21-24 with highest_harmonic=20; weights
    seeded 42*i and 42*42*i by the caller)."""
    w_re = get_random_weights(cutoff, seed_re)
    w_im = get_random_weights(cutoff, seed_im)
    return (
        sine_superposition(fft_length, w_re, harmonics),
        sine_superposition(fft_length, w_im, harmonics),
    )
