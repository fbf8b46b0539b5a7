"""End-to-end conformance pipelines: the accuracy gate of the library.

Mirror of the reference FFTTest.cu: FullSingleFFTComputation (the canonical
plan -> execute -> compare pipeline, FFTTest.cu:24-88), TestFullFFT (runs the
library and the fp64 oracle on the same seeded signal and checks the three
deviation thresholds, :240-295), and the UnitTest.cu sweep parameters
(N = 256..16^5, 10 seeded runs, thresholds avg 1e-3 / sigma 1e-2 / max 0.5,
UnitTest.cu:8-16).

Every function takes ``device=`` (the card by default).  On the CPU the
signal and the oracle are the numpy ones, bit-identical to the JAX
package's; on the card both are made in float64 there
(``datagen.sine_superposition_torch``, ``oracle.fft_oracle`` in complex128)
and the deviation is taken there, so a 2^28-point run never leaves it.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from tensorfft_tpu_torch.testing import datagen, metrics, oracle

__all__ = [
    "full_single_fft_computation",
    "test_full_fft",
    "run_unit_sweep",
    "REFERENCE_SWEEP",
]

# UnitTest.cu:8-12 parameters.
REFERENCE_SWEEP = dict(
    start_fft_length=256,
    end_fft_length=16 ** 5,
    runs_per_fft_length=10,
    highest_harmonic=20,
)


def _signal(fft_length: int, weights, device: torch.device):
    """The sine-superposition plane: numpy on the CPU, a float64 tensor
    made on any other device."""
    if device.type == "cpu":
        return datagen.sine_superposition(fft_length, weights)
    return datagen.sine_superposition_torch(fft_length, weights, device)


def full_single_fft_computation(
    fft_length: int,
    weights_re: np.ndarray,
    weights_im: np.ndarray,
    plan=None,
    device="cuda",
    **plan_kwargs,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The canonical end-to-end pipeline (FFTTest.cu:24-88 analog):
    generate signal -> plan -> execute on ``device`` -> the result as
    float64 (re, im) tensors on ``device``."""
    import tensorfft_tpu_torch as tt

    device = torch.device(device)
    re = torch.as_tensor(_signal(fft_length, weights_re, device), device=device)
    im = torch.as_tensor(_signal(fft_length, weights_im, device), device=device)
    if plan is None:
        plan = tt.create_plan(fft_length, **plan_kwargs)
    o_re, o_im = tt.fft_split(re, im, plan)
    return o_re.to(torch.float64), o_im.to(torch.float64)


def test_full_fft(
    fft_length: int,
    average_deviation_threshold: float = metrics.REFERENCE_AVG_THRESHOLD,
    sigma_deviation_threshold: float = metrics.REFERENCE_SIGMA_THRESHOLD,
    max_deviation_threshold: float = metrics.REFERENCE_MAX_THRESHOLD,
    weights_re: Optional[np.ndarray] = None,
    weights_im: Optional[np.ndarray] = None,
    plan=None,
    device="cuda",
    **plan_kwargs,
) -> Tuple[bool, metrics.Deviation]:
    """TestFullFFT analog (FFTTest.cu:240-295): run library + oracle on the
    same signal, compare at the thresholds.  Returns (passed, deviation)."""
    if weights_re is None:
        weights_re = datagen.get_random_weights(20, 42)
    if weights_im is None:
        weights_im = datagen.get_random_weights(20, 42 * 42)
    device = torch.device(device)
    got = full_single_fft_computation(
        fft_length, weights_re, weights_im, plan=plan, device=device,
        **plan_kwargs
    )
    re = _signal(fft_length, weights_re, device)
    im = _signal(fft_length, weights_im, device)
    want = oracle.fft_oracle(re, im)
    d = metrics.deviation(got, want)
    ok = d.passes_reference_gate(
        average_deviation_threshold,
        sigma_deviation_threshold,
        max_deviation_threshold,
    )
    return ok, d


def run_unit_sweep(
    start_fft_length: int = REFERENCE_SWEEP["start_fft_length"],
    end_fft_length: int = REFERENCE_SWEEP["end_fft_length"],
    runs_per_fft_length: int = REFERENCE_SWEEP["runs_per_fft_length"],
    highest_harmonic: int = REFERENCE_SWEEP["highest_harmonic"],
    precision: str = "bfloat16",
    verbose: bool = True,
    tuning=None,
    run_offset: int = 0,
    device="cuda",
    record: Optional[list] = None,
) -> bool:
    """UnitTest.cu main() analog: full sweep, abort on first failure.

    Seeds 42*i / 42*42*i per run exactly as UnitTest.cu:21-24.

    ``tuning="auto"`` runs every length under its tuner-cache entry, so the
    gate certifies the configurations production plans actually use.

    ``run_offset`` starts the seed index at ``i = run_offset``, so a long
    sweep can be split over several processes, one seed range each.
    ``record``, when given, receives one ``(fft_length, seed index,
    Deviation)`` per run, the failing one included.
    """
    weights = [
        (
            datagen.get_random_weights(highest_harmonic, 42 * i),
            datagen.get_random_weights(highest_harmonic, 42 * 42 * i),
        )
        for i in range(run_offset, run_offset + runs_per_fft_length)
    ]
    n = start_fft_length
    while n <= end_fft_length:
        if verbose:
            print(f"Testing fft_length: {n}")
        for j in range(runs_per_fft_length):
            ok, d = test_full_fft(
                n, weights_re=weights[j][0], weights_im=weights[j][1],
                precision=precision, tuning=tuning, device=device,
            )
            if record is not None:
                record.append((n, run_offset + j, d))
            if not ok:
                print(f"Error! Test at fft_length: {n} failed! {d}")
                return False
        n *= 2
    if verbose:
        print("All tests passed!")
    return True
