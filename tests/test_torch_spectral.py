"""The port's spectral utilities (``spectral.py``) against the JAX package on
the CPU: shifts, frequency grids and windows, all bit-identical."""
import inspect

import numpy as np
import pytest
import torch

import tensorfft_tpu as tfft
import tensorfft_tpu_torch as tt

torch.set_num_threads(1)


@pytest.mark.parametrize("shape,axes", [
    ((8,), None), ((7,), None), ((4, 6), None), ((4, 6), (1,)),
    ((3, 5, 8), (0, 2)), ((5, 8), -1), ((5, 7), (-2, -1)),
])
def test_shifts_match_jax(shape, axes):
    x = np.random.default_rng(0).standard_normal(shape).astype(np.float32)
    t = torch.from_numpy(x)
    for ours, theirs, ref in ((tt.fftshift, tfft.fftshift, np.fft.fftshift),
                              (tt.ifftshift, tfft.ifftshift, np.fft.ifftshift)):
        got = ours(t, axes)
        assert isinstance(got, torch.Tensor) and got.dtype == torch.float32
        assert np.array_equal(got.numpy(), np.asarray(theirs(x, axes)))
        assert np.array_equal(got.numpy(), ref(x, axes))
        assert np.array_equal(ours(x, axes).numpy(), got.numpy())  # host input
    assert torch.equal(tt.ifftshift(tt.fftshift(t, axes), axes), t)


def test_split_shifts_match_jax():
    rng = np.random.default_rng(1)
    re, im = rng.standard_normal((2, 3, 9)).astype(np.float32)
    for ours, theirs in ((tt.fftshift_split, tfft.fftshift_split),
                         (tt.ifftshift_split, tfft.ifftshift_split)):
        got = ours(torch.from_numpy(re), torch.from_numpy(im), axes=-1)
        want = theirs(re, im, axes=-1)
        assert all(np.array_equal(g.numpy(), np.asarray(w))
                   for g, w in zip(got, want))
    # The DC bin of an 8-point spectrum lands at index 4.
    dc = torch.zeros(2, 8)
    dc[:, 0] = 1.0
    s_re, _ = tt.fftshift_split(dc, dc, axes=-1)
    assert s_re[0, 4] == 1.0 and s_re[0, 0] == 0.0


@pytest.mark.parametrize("dtype,jdtype", [(torch.float32, np.float32),
                                          (torch.float64, np.float64)])
@pytest.mark.parametrize("n,d", [(8, 1.0), (9, 0.25), (1024, 2.0), (1, 0.1)])
def test_freq_grids_match_jax(n, d, dtype, jdtype):
    for ours, theirs in ((tt.fftfreq, tfft.fftfreq), (tt.rfftfreq, tfft.rfftfreq)):
        got = ours(n, d, dtype=dtype, device="cpu")
        assert got.dtype == dtype and got.device.type == "cpu"
        assert np.array_equal(got.numpy(), np.asarray(theirs(n, d, jdtype)))


@pytest.mark.parametrize("periodic", [False, True])
@pytest.mark.parametrize("kind", ["rect", "hann", "hamming", "blackman",
                                  "bartlett", "kaiser14"])
def test_windows_match_jax(kind, periodic):
    for n in (1, 7, 256):
        for dtype, jdtype in ((torch.float32, np.float32),
                              (torch.float64, np.float64)):
            got = tt.window(kind, n, dtype=dtype, periodic=periodic, device="cpu")
            want = tfft.window(kind, n, dtype=jdtype, periodic=periodic)
            assert got.dtype == dtype
            assert np.array_equal(got.numpy(), np.asarray(want)), (kind, n)


def test_unknown_window_raises():
    with pytest.raises(ValueError, match="unknown window"):
        tt.window("flattop", 16, device="cpu")


def test_defaults_run_on_the_card():
    for fn in (tt.fftfreq, tt.rfftfreq, tt.window):
        params = inspect.signature(fn).parameters
        assert params["device"].default == "cuda"
        assert params["dtype"].default is torch.float32
