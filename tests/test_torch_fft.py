"""The port's public 1D path (fft_split / ifft_split) against the JAX package
and the fp64 oracle, at fused and four-step lengths."""
import inspect

import numpy as np
import pytest
import torch

import tensorfft_tpu as tfft
import tensorfft_tpu_torch as tt
from tensorfft_tpu_torch.testing import (
    agreement,
    deviation,
    fft_oracle,
    make_test_signal,
)
from tensorfft_tpu_torch.testing.metrics import FOUR_STEP_MAX_FRAC

torch.set_num_threads(1)


def _signal_rows(n, seeds):
    rows = [make_test_signal(n, 42 * (s + 1), 42 * 42 * (s + 1)) for s in seeds]
    return np.stack([r for r, _ in rows]), np.stack([i for _, i in rows])


def _np(x):
    return np.asarray(x.float().numpy() if isinstance(x, torch.Tensor) else x,
                      np.float64)


@pytest.mark.parametrize("precision", ["bfloat16", "float32"])
@pytest.mark.parametrize("n", [256, 1024, 4096, 32768])
def test_reference_gate(n, precision):
    re, im = _signal_rows(n, range(2))
    plan = tt.create_plan(n, precision=precision)
    o_re, o_im = tt.fft_split(torch.from_numpy(re), torch.from_numpy(im), plan)
    assert o_re.dtype is plan.precision.storage_dtype
    want = fft_oracle(re, im)
    d = deviation((_np(o_re), _np(o_im)), want)
    assert d.passes_reference_gate(), d


@pytest.mark.parametrize("scaling", ["forward", "none", "ortho"])
@pytest.mark.parametrize("precision", ["bfloat16", "float32"])
@pytest.mark.parametrize("n,forward", [(1024, True), (1024, False),
                                       (32768, True), (32768, False)])
def test_fft_split_matches_jax(n, forward, precision, scaling):
    rng = np.random.default_rng(n)
    re = rng.standard_normal((3, n)).astype(np.float32)
    im = rng.standard_normal((3, n)).astype(np.float32)
    t_fn = tt.fft_split if forward else tt.ifft_split
    j_fn = tfft.fft_split if forward else tfft.ifft_split
    got = t_fn(torch.from_numpy(re), torch.from_numpy(im), precision=precision,
               scaling=scaling)
    want = j_fn(re, im, precision=precision, scaling=scaling)
    frac = FOUR_STEP_MAX_FRAC if n > 16384 else 1e-3
    a = agreement([_np(g) for g in got], [_np(w) for w in want],
                  bf16=precision == "bfloat16")
    assert a.within(frac), a


# float32: bf16x3 keeps 16 mantissa bits per operand (~1.5e-5 relative per
# stage); the JAX package's own round trip at N=32768 reaches 2.1e-4.
@pytest.mark.parametrize("precision,atol", [("float32", 5e-4), ("bfloat16", 1e-1)])
@pytest.mark.parametrize("n", [4096, 32768])
def test_roundtrip(n, precision, atol):
    rng = np.random.default_rng(5)
    re = torch.from_numpy(rng.standard_normal((2, n)).astype(np.float32))
    im = torch.from_numpy(rng.standard_normal((2, n)).astype(np.float32))
    plan = tt.create_plan(n, precision=precision)
    r_re, r_im = tt.ifft_split(*tt.fft_split(re, im, plan), plan)
    np.testing.assert_allclose(_np(r_re), re.numpy(), atol=atol)
    np.testing.assert_allclose(_np(r_im), im.numpy(), atol=atol)


@pytest.mark.parametrize("strategy", ["staged", "torch"])
def test_comparison_strategies_match_jax(strategy):
    n = 512
    rng = np.random.default_rng(9)
    re = rng.standard_normal((2, n)).astype(np.float32)
    im = rng.standard_normal((2, n)).astype(np.float32)
    jax_strategy = "xla" if strategy == "torch" else strategy
    for forward in (True, False):
        t_fn = tt.fft_split if forward else tt.ifft_split
        j_fn = tfft.fft_split if forward else tfft.ifft_split
        got = t_fn(torch.from_numpy(re), torch.from_numpy(im),
                   precision="float32", strategy=strategy)
        want = j_fn(re, im, precision="float32", strategy=jax_strategy)
        a = agreement([_np(g) for g in got], [_np(w) for w in want], bf16=False)
        assert a.within(), (forward, a)


def test_batch_shapes_and_scaling():
    n = 256
    rng = np.random.default_rng(3)
    x = (rng.standard_normal((2, 3, n)) + 1j * rng.standard_normal((2, 3, n)))
    plan = tt.create_plan(n, precision="float32", scaling="none")
    o_re, o_im = tt.fft_split(torch.from_numpy(x.real.copy()),
                              torch.from_numpy(x.imag.copy()), plan)
    assert o_re.shape == (2, 3, n)
    want = np.fft.fft(x.astype(np.complex64).astype(np.complex128), axis=-1)
    np.testing.assert_allclose(_np(o_re) + 1j * _np(o_im), want,
                               atol=1e-4 * np.abs(want).max())


def test_complex_wrappers_take_device():
    n = 1024
    rng = np.random.default_rng(4)
    x = (rng.standard_normal((2, n)) + 1j * rng.standard_normal((2, n))).astype(np.complex64)
    # They run on the card unless the caller asks for the CPU.
    for fn in (tt.fft, tt.ifft):
        assert inspect.signature(fn).parameters["device"].default == "cuda"
    got = tt.fft(x, device="cpu", precision="float32")
    assert got.dtype == np.complex64
    want = tfft.fft(x, precision="float32")
    np.testing.assert_allclose(got, want, atol=1e-6)
    back = tt.ifft(got, device="cpu", precision="float32")
    np.testing.assert_allclose(back, x, atol=5e-4)


def test_plan_length_mismatch():
    with pytest.raises(ValueError, match="fft_length"):
        tt.fft_split(torch.zeros(2, 256), torch.zeros(2, 256), tt.create_plan(512))
