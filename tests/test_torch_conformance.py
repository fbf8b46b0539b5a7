"""The port's conformance harness (``testing.conformance``), oracle,
datagen on a device, on-device deviation and digit reversal, against the
JAX package on the CPU.

Tolerances: the datagen signal, REFERENCE_SWEEP, the numpy oracles and the
digit-reversal permutations are bit-identical.  The bf16 transforms of a
sine superposition hold at two levels: every element within one bf16 ulp of
the output scale, and the bins that carry the signal (|X| >= 2^-8 of the
largest, the 2 x 19 harmonics) within ``agreement``'s fraction
(FUSED_MAX_FRAC, FOUR_STEP_MAX_FRAC past 16384).  The other bins are the
rounding noise of zero bins, and their last bits follow the summation
order, so more of them differ from the JAX package's than that fraction
allows: they are held to NOISE_MAX_FRAC of differing elements, each within
NOISE_MAX_SCALE_ULPS of a bf16 ulp of the scale.  Measured here over the
nine (N, seed) cases of ``test_full_fft_matches_jax``: no signal bin
differs; 0.9-1.8 % of the noise bins differ at N = 256, 0.3-1.5 % at 4096
and 4.5-6.0 % at 2^16, by at most 0.0011 ulp of the scale.  A device-made
signal and spectrum are held within 1e-12 of their scale.

The JAX package computes the signal and the permutation in its native host
library when that is built (``tensorfft_tpu/native``, not ported) and in
numpy otherwise; the port keeps the numpy code.  These tests hold the port
against the JAX package's numpy code, with the native library hidden.
"""
import numpy as np
import pytest
import torch

from tensorfft_tpu.ops import transpose as jax_transpose
from tensorfft_tpu.testing import conformance as jax_conformance
from tensorfft_tpu.testing import datagen as jax_datagen
from tensorfft_tpu.testing import oracle as jax_oracle
from tensorfft_tpu_torch.ops import transpose
from tensorfft_tpu_torch.testing import datagen, metrics, oracle
from tensorfft_tpu_torch.testing.conformance import (
    REFERENCE_SWEEP,
    full_single_fft_computation,
    run_unit_sweep,
    test_full_fft as check_full_fft,
)
from tensorfft_tpu_torch.testing.metrics import (
    BF16_MAX_SCALE_ULPS,
    FOUR_STEP_MAX_FRAC,
    FUSED_MAX_FRAC,
    agreement,
    bf16_ulp,
    deviation,
)

torch.set_num_threads(1)

CPU = torch.device("cpu")
# Bins at or above this fraction of the largest |X| carry the signal.
SIGNAL_BINS = 2.0 ** -8
# The noise bins against the JAX package's (measured: at most 6.0 % differ,
# by at most 0.0011 bf16 ulp of the scale).
NOISE_MAX_FRAC = 0.1
NOISE_MAX_SCALE_ULPS = 2.0 ** -6


@pytest.fixture(autouse=True)
def jax_numpy_host(monkeypatch):
    import tensorfft_tpu.native

    monkeypatch.setattr(tensorfft_tpu.native, "lib", None)


def _weights(i):
    return (jax_datagen.get_random_weights(20, 42 * i),
            jax_datagen.get_random_weights(20, 42 * 42 * i))


def test_reduced_sweep_bfloat16():
    # The JAX package's reduced sweep (tests/test_conformance.py): every
    # power of two 256 ... 2^16, 3 seeds, the reference thresholds.
    record = []
    assert run_unit_sweep(start_fft_length=256, end_fft_length=1 << 16,
                          runs_per_fft_length=3, precision="bfloat16",
                          verbose=False, device="cpu", record=record)
    assert [(n, i) for n, i, _ in record] == [
        (1 << k, i) for k in range(8, 17) for i in range(3)]


def test_reference_sweep_equals_jax():
    assert REFERENCE_SWEEP == jax_conformance.REFERENCE_SWEEP


def test_reference_thresholds_are_defaults():
    ok, d = check_full_fft(256, precision="bfloat16", device="cpu")
    assert ok, str(d)


@pytest.mark.parametrize("i", [0, 1, 2])
@pytest.mark.parametrize("n", [256, 4096, 1 << 16])
def test_full_fft_matches_jax(n, i):
    w_re, w_im = _weights(i)
    for w in (w_re, w_im):
        assert np.array_equal(datagen.sine_superposition(n, w),
                              jax_datagen.sine_superposition(n, w))
    got = full_single_fft_computation(n, w_re, w_im, device="cpu",
                                      precision="bfloat16")
    want = jax_conformance.full_single_fft_computation(n, w_re, w_im,
                                                       precision="bfloat16")
    g = np.concatenate([x.numpy().ravel() for x in got])
    w = np.concatenate([np.asarray(x).ravel() for x in want])
    a = agreement([g], [w], bf16=True)
    assert a.scale_ulps <= BF16_MAX_SCALE_ULPS, a
    signal = np.abs(w) >= SIGNAL_BINS * np.abs(w).max()
    assert signal.sum() == 2 * 2 * 19
    frac = FOUR_STEP_MAX_FRAC if n > 16384 else FUSED_MAX_FRAC
    a_sig = agreement([g[signal]], [w[signal]], bf16=True)
    assert a_sig.within(frac), a_sig
    noise = g[~signal] - w[~signal]
    assert (noise != 0).mean() <= NOISE_MAX_FRAC, (noise != 0).mean()
    assert np.abs(noise).max() <= NOISE_MAX_SCALE_ULPS * bf16_ulp(np.abs(w).max())

    ok, d = check_full_fft(n, weights_re=w_re, weights_im=w_im,
                           precision="bfloat16", device="cpu")
    ok_j, d_j = jax_conformance.test_full_fft(
        n, weights_re=w_re, weights_im=w_im, precision="bfloat16")
    assert ok and ok_j, (d, d_j)
    assert d == deviation((got[0].numpy(), got[1].numpy()),
                          jax_oracle.fft_oracle(
                              jax_datagen.sine_superposition(n, w_re),
                              jax_datagen.sine_superposition(n, w_im)))


@pytest.mark.parametrize("n,radices", [(4096, (16, 16, 16)), (2048, (32, 64)),
                                       (512, (8, 4, 16))])
def test_digit_reversal_matches_jax(n, radices):
    perm = transpose.digit_reversal_permutation(n, radices)
    want = jax_transpose.digit_reversal_permutation(n, radices)
    assert perm.dtype == want.dtype and np.array_equal(perm, want)
    x = np.random.default_rng(n).standard_normal((3, n, 2))
    for axis in (1, -2):
        got = transpose.digit_reverse(x, radices, axis=axis)
        assert np.array_equal(got, jax_transpose.digit_reverse(x, radices, axis=axis))
        # The reshape/transpose gathers by the inverse permutation (the
        # JAX docstring's "equivalent to gathering with the permutation"
        # holds when the radices read the same reversed, as (16, 16, 16)).
        assert np.array_equal(got, x[:, np.argsort(perm), :])
        if tuple(radices) == tuple(reversed(radices)):
            assert np.array_equal(got, x[:, perm, :])
        t = transpose.digit_reverse_torch(torch.from_numpy(x), radices, axis=axis)
        assert np.array_equal(t.numpy(), got)
    back = transpose.digit_reverse(got, tuple(reversed(radices)), axis=1)
    assert np.array_equal(back, x)
    with pytest.raises(ValueError, match="do not factor"):
        transpose.digit_reversal_permutation(n, radices[:-1])


@pytest.mark.parametrize("scaling", ["forward", "none", "ortho"])
def test_oracles_match_jax(scaling):
    rng = np.random.default_rng(3)
    re, im = rng.standard_normal((2, 4, 8, 16))
    for axis in (-1, 1):
        got = oracle.fft_oracle(re, im, scaling, axis)
        want = jax_oracle.fft_oracle(re, im, scaling, axis)
        assert all(np.array_equal(g, w) for g, w in zip(got, want))
    # A CPU tensor takes the numpy path too.
    got = oracle.fft_oracle(torch.from_numpy(re), torch.from_numpy(im), scaling)
    assert all(isinstance(g, np.ndarray) for g in got)
    assert all(np.array_equal(g, w) for g, w in
               zip(got, jax_oracle.fft_oracle(re, im, scaling)))
    for axes in (None, (0, 2), (-1,)):
        got = oracle.fftn_oracle(re, im, axes, scaling)
        want = jax_oracle.fftn_oracle(re, im, axes, scaling)
        assert all(np.array_equal(g, w) for g, w in zip(got, want))


@pytest.mark.parametrize("scaling", ["forward", "none", "ortho"])
def test_torch_oracle_and_baseline(scaling):
    # The card oracle's code (complex128 torch.fft) run on CPU tensors,
    # and the complex64 baseline, against numpy.
    rng = np.random.default_rng(4)
    re, im = rng.standard_normal((2, 3, 1024))
    want = jax_oracle.fft_oracle(re, im, scaling)
    scale = max(np.abs(w).max() for w in want)
    got = oracle._oracle_torch(torch.from_numpy(re), torch.from_numpy(im),
                               scaling, -1, CPU)
    assert all(g.dtype == torch.float64 for g in got)
    assert max(np.abs(g.numpy() - w).max() for g, w in zip(got, want)) <= 1e-12 * scale
    base = oracle.torch_baseline(re, im, scaling)
    assert all(b.dtype == torch.float32 for b in base)
    assert max(np.abs(b.numpy() - w).max() for b, w in zip(base, want)) <= 1e-5 * scale
    with pytest.raises(ValueError, match="bad scaling"):
        oracle.fft_oracle(re, im, "bogus")


@pytest.mark.parametrize("n", [256, 4096, 1 << 16])
def test_sine_superposition_torch(n, monkeypatch):
    w = datagen.get_random_weights(20, 42)
    want = jax_datagen.sine_superposition(n, w)
    scale = np.abs(want).max()
    got = datagen.sine_superposition_torch(n, w, CPU)
    assert got.dtype == torch.float64
    assert np.abs(got.numpy() - want).max() <= 1e-12 * scale
    pow2 = datagen.sine_superposition_torch(n, w[:8], CPU, harmonics="pow2")
    assert np.abs(pow2.numpy() - datagen.sine_superposition(n, w[:8], "pow2")).max() \
        <= 1e-12 * scale
    # The spectral construction (past DIRECT_SUM_LIMIT sine evaluations),
    # against numpy's direct sum and its own spectral form.
    monkeypatch.setattr(datagen, "DIRECT_SUM_LIMIT", 0)
    got = datagen.sine_superposition_torch(n, w, CPU)
    assert np.abs(got.numpy() - want).max() <= 1e-12 * scale
    assert np.abs(got.numpy() - datagen.sine_superposition(n, w)).max() <= 1e-12 * scale


def test_sine_superposition_torch_aliased_spectral(monkeypatch):
    # 20 harmonics on 16 points: harmonics alias mod N into shared bins.
    monkeypatch.setattr(datagen, "DIRECT_SUM_LIMIT", 0)
    w = datagen.get_random_weights(20, 7)
    got = datagen.sine_superposition_torch(16, w, CPU).numpy()
    want = jax_datagen.sine_superposition(16, w)  # the direct sum
    assert np.abs(got - want).max() <= 1e-12 * np.abs(want).max()


def test_deviation_on_device_path():
    # The float64 torch deviation (the card's) on CPU tensors, against the
    # numpy one.
    rng = np.random.default_rng(5)
    got = rng.standard_normal((2, 3, 100)).astype(np.float32)
    want = rng.standard_normal((2, 3, 100))
    d = metrics._deviation_on_device(
        [torch.from_numpy(g).to(torch.bfloat16) for g in got],
        [torch.from_numpy(w) for w in want], CPU)
    d_np = deviation([torch.from_numpy(g).to(torch.bfloat16).double().numpy()
                      for g in got], list(want))
    assert d.maximum == d_np.maximum
    assert d.average == pytest.approx(d_np.average, rel=1e-12)
    assert d.sigma == pytest.approx(d_np.sigma, rel=1e-12)
    with pytest.raises(ValueError, match="shape mismatch"):
        metrics._deviation_on_device([torch.zeros(3)], [torch.zeros(4)], CPU)
