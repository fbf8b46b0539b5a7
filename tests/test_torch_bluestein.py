"""The port's arbitrary-length FFT (Bluestein, ``bluestein.py``) against the
JAX package and the fp64 oracle on the CPU.

Tolerances: the chirp tables are bit-identical.  Under float32 the outputs
agree within 1e-5 of the largest |X| (F32_REL_TOL: bf16x3 M-point
transforms, summed in another order than XLA's).  Under bf16 every element
agrees within one bf16 ulp of the output scale (BF16_MAX_SCALE_ULPS), and
at most BF16_MAX_FRAC of the elements differ.  The fraction bound of a
single transform does not apply: the M-point forward transform's outputs
are rounded to bf16, multiplied by the kernel spectrum and rounded again
before the inverse, so one flipped rounding in the forward transform
spreads over every output of the inverse.  Measured here over the cases of
``test_split_any_matches_jax``: at N = 1000 4.6-4.9 % of the elements
differ in a forward call and 0.03-0.05 % in an inverse one, by at most
0.5 ulp of the scale; at every other N none differ.
"""
import numpy as np
import pytest
import torch

from tensorfft_tpu import bluestein as jax_bluestein
from tensorfft_tpu_torch import bluestein
from tensorfft_tpu_torch.bluestein import (
    fft_any,
    fft_split_any,
    ifft_any,
    ifft_split_any,
)
from tensorfft_tpu_torch.testing import deviation
from tensorfft_tpu_torch.testing.metrics import (
    BF16_MAX_SCALE_ULPS,
    F32_REL_TOL,
    agreement,
)

torch.set_num_threads(1)

CPU = torch.device("cpu")
# Elements of a bf16 call that may differ from the JAX package's (measured:
# at most 4.9 %, at N = 1000).
BF16_MAX_FRAC = 0.1


def _rel(got, want):
    scale = max(np.abs(want).max(), 1e-30)
    return np.abs(got - want).max() / scale


def _planes(n, batch=2):
    rng = np.random.default_rng(n)
    return rng.standard_normal((2, batch, n)).astype(np.float32)


def _hold(got, want, precision):
    a = agreement([g.float().numpy() for g in got],
                  [np.asarray(w, np.float32) for w in want],
                  bf16=precision == "bfloat16")
    if precision == "bfloat16":
        assert a.scale_ulps <= BF16_MAX_SCALE_ULPS, a
        assert a.frac_differ <= BF16_MAX_FRAC, a
    else:
        assert a.max_rel_err <= F32_REL_TOL, a


@pytest.mark.parametrize("scaling", ["forward", "none", "ortho"])
@pytest.mark.parametrize("precision", ["float32", "bfloat16"])
@pytest.mark.parametrize("n", [1, 3, 12, 16, 100, 257, 1000, 1536])
def test_split_any_matches_jax(n, precision, scaling):
    re, im = _planes(n)
    storage = torch.bfloat16 if precision == "bfloat16" else torch.float32
    for forward in (True, False):
        got = fft_split_any(torch.from_numpy(re), torch.from_numpy(im),
                            forward=forward, scaling=scaling,
                            precision=precision)
        want = jax_bluestein.fft_split_any(re, im, forward=forward,
                                           scaling=scaling, precision=precision)
        assert all(g.dtype == storage and g.shape == (2, n) for g in got)
        _hold(got, want, precision)
    back = ifft_split_any(*fft_split_any(torch.from_numpy(re),
                                         torch.from_numpy(im),
                                         scaling=scaling, precision=precision),
                          scaling=scaling, precision=precision)
    x = re + 1j * im
    tol = 2e-2 if precision == "bfloat16" else 1e-3
    assert _rel(back[0].double().numpy() + 1j * back[1].double().numpy(), x) < tol


@pytest.mark.parametrize("n", [3, 5, 7, 12, 100, 257, 1000, 1536])
def test_fft_any_matches_numpy(n):
    # The JAX package's test_bluestein bounds, through the host wrappers.
    rng = np.random.default_rng(n)
    x = rng.standard_normal(n) + 1j * rng.standard_normal(n)
    got = fft_any(x[None, :], device="cpu")[0]
    assert got.dtype == np.complex64
    assert _rel(got, np.fft.fft(x) / n) < 2e-4, n
    back = ifft_any(got[None, :], device="cpu")[0]
    assert _rel(back, x) < 1e-3, n
    for scaling, want in (("none", np.fft.fft(x)),
                          ("ortho", np.fft.fft(x, norm="ortho"))):
        assert _rel(fft_any(x[None, :], scaling=scaling, device="cpu")[0],
                    want) < 2e-4


def test_bf16_passes_reference_gate():
    # bf16 storage through the 2N-point convolution: the reference gate on
    # the 1/N-scaled output of a non-power-of-two length.
    re, im = _planes(1000, batch=4)
    got = fft_split_any(torch.from_numpy(re), torch.from_numpy(im),
                        precision="bfloat16")
    want = np.fft.fft(re.astype(np.float64) + 1j * im, axis=-1) / 1000
    d = deviation([g.double().numpy() for g in got], (want.real, want.imag))
    assert d.passes_reference_gate(), d


@pytest.mark.parametrize("n", [3, 100, 1000, 1536])
def test_tables_match_jax(n):
    got = bluestein._tables(n, CPU)
    want = jax_bluestein._tables(n)
    assert got[4] == want[4]
    for g, w in zip(got[:4], want[:4]):
        assert g.dtype == torch.float32
        assert np.array_equal(g.numpy(), np.asarray(w))
    assert bluestein._tables(n, CPU) is got  # cached per (n, device)


def test_bad_input_raises():
    with pytest.raises(ValueError, match="bad scaling"):
        fft_any(np.ones(10)[None, :], scaling="bogus", device="cpu")
    with pytest.raises(ValueError, match="bad scaling"):
        fft_any(np.ones(1)[None, :], scaling="bogus", device="cpu")
    with pytest.raises(ValueError, match="bad split input"):
        fft_split_any(torch.zeros(2, 5), torch.zeros(2, 6))


def test_tuning_kwarg_and_n1():
    y = fft_any(np.ones(12, np.float32)[None, :], tuning="auto", device="cpu")
    assert y.shape == (1, 12)
    z = fft_any((np.ones(1, np.float32) * 3)[None, :], device="cpu")
    assert z[0, 0] == 3.0


def test_pow2_delegates_to_fft_split():
    import tensorfft_tpu_torch as tt

    re, im = (torch.from_numpy(p) for p in _planes(4096))
    got = fft_split_any(re, im, precision="bfloat16")
    want = tt.fft_split(re, im, precision="bfloat16")
    assert all(torch.equal(g, w) for g, w in zip(got, want))


def test_defaults_run_on_the_card():
    import inspect

    for fn in (fft_any, ifft_any):
        assert inspect.signature(fn).parameters["device"].default == "cuda"
