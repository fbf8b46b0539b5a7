"""The R2C/C2R path of the port (rfft.py, ops/rfft_cuda.py, models/fft_conv.py)
against the JAX package: the Pallas epilogue kernels in interpret mode and
the XLA formulations of tensorfft_tpu/rfft.py.  On the CPU the port runs the
plain-torch versions of its kernels."""
import importlib
import inspect

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tensorfft_tpu as tfft
from tensorfft_tpu.models import fft_conv as j_conv
from tensorfft_tpu.ops import rfft_pallas
import tensorfft_tpu_torch as tt
from tensorfft_tpu_torch.ops import rfft_cuda
from tensorfft_tpu_torch.testing import agreement
from tensorfft_tpu_torch.testing.metrics import FOUR_STEP_MAX_FRAC, FUSED_MAX_FRAC

# The packages export functions named rfft, which shadow the modules.
j_rfft = importlib.import_module("tensorfft_tpu.rfft")
t_rfft = importlib.import_module("tensorfft_tpu_torch.rfft")

torch.set_num_threads(1)

STORAGE = {"bfloat16": (torch.bfloat16, jnp.bfloat16),
           "float32": (torch.float32, jnp.float32)}
# Half lengths of the epilogue tests; JAX's Pallas epilogue takes M >= 128.
HALF_LENGTHS = [1, 2, 64, 512, 2048]
SCALINGS = ["forward", "none", "ortho"]


def _planes(shape, precision, seed, count=2):
    """``count`` seeded planes as (torch, jax) pairs holding equal values."""
    rng = np.random.default_rng(seed)
    tdt, jdt = STORAGE[precision]
    out = []
    for _ in range(count):
        t = torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(tdt)
        out.append((t, jnp.asarray(t.float().numpy(), jdt)))
    return out


def _np(x):
    return np.asarray(x.float().numpy() if isinstance(x, torch.Tensor) else x,
                      np.float64)


def _assert_bitwise(got, want):
    for g, w in zip(got, want):
        np.testing.assert_array_equal(_np(g), _np(w))


def _assert_epilogue_close(got, want, precision, inputs, scale):
    """fp32: each element within 1 fp32 ulp of the largest value the chain
    holds (|U + V| and |w (U - V)| reach 4 max|input|), times the scale: the
    port's products are unfused, XLA on the CPU contracts them into FMAs;
    bf16: ``agreement`` at the output scale."""
    g = [_np(x) for x in got]
    w = [_np(x) for x in want]
    if precision == "float32":
        top = 4 * max(np.abs(_np(x)).max() for x in inputs) * scale
        ulp = np.spacing(np.float32(top))
        for a, b in zip(g, w):
            assert np.abs(a - b).max() <= ulp, (np.abs(a - b).max(), ulp)
    else:
        a = agreement(g, w, bf16=True)
        assert a.within(FUSED_MAX_FRAC), a


def _scale(scaling, forward):
    plan = tt.create_plan(2, scaling=scaling)
    return (float(t_rfft._output_scale(plan, True)) if forward
            else float(t_rfft._inverse_pre_scale(plan)))


@pytest.mark.parametrize("m", HALF_LENGTHS + [1 << 19])
@pytest.mark.parametrize("sign", [-1, 1])
def test_phase_tables_match_jax(m, sign):
    n = 2 * m
    cos, sin = rfft_cuda.phase_tables(n, sign, m)
    assert cos.dtype == np.float32 and cos.shape == (m,)
    j_cos, j_sin = j_rfft._pack_tables(n, sign, bins=m)
    np.testing.assert_array_equal(cos, np.asarray(j_cos))
    np.testing.assert_array_equal(sin, np.asarray(j_sin))
    # The Pallas kernels' table, padded to lane blocks: same leading bins.
    p_cos, p_sin = rfft_pallas._pack_phase_tables(n, sign, 128, -(-m // 128) + 1)
    np.testing.assert_array_equal(cos, np.asarray(p_cos)[0, :m])
    np.testing.assert_array_equal(sin, np.asarray(p_sin)[0, :m])
    # rfft._pack_tables' default length M + 1 (bins 0..M).
    full = rfft_cuda.phase_tables(n, sign, m + 1)
    np.testing.assert_array_equal(full[0], np.asarray(j_rfft._pack_tables(n, sign)[0]))


@pytest.mark.parametrize("precision", ["bfloat16", "float32"])
@pytest.mark.parametrize("m", HALF_LENGTHS)
@pytest.mark.parametrize("b", [1, 3])
def test_pack_and_interleave_match_jax(b, m, precision):
    (x, jx), = _planes((b, 2 * m), precision, seed=m + b, count=1)
    got = rfft_cuda.pack_split(x)
    assert got[0].dtype is x.dtype and got[0].shape == (b, m)
    _assert_bitwise(got, j_rfft._deinterleave(jx))
    if m >= 128:
        _assert_bitwise(got, rfft_pallas.pack_split(jx, interpret=True))
    (re, jre), (im, jim) = _planes((b, m), precision, seed=m + b + 1)
    got = rfft_cuda.interleave_split(re, im)
    assert got.dtype is re.dtype and got.shape == (b, 2 * m)
    _assert_bitwise([got], [j_rfft._interleave(jre, jim)])
    if m >= 128:
        _assert_bitwise([got], [rfft_pallas.interleave_split(jre, jim,
                                                             interpret=True)])


@pytest.mark.parametrize("precision", ["bfloat16", "float32"])
@pytest.mark.parametrize("m", HALF_LENGTHS)
@pytest.mark.parametrize("b,scaling", [(3, "forward"), (2, "none"), (1, "ortho")])
def test_untangle_matches_jax(b, scaling, m, precision):
    scale = _scale(scaling, forward=True)
    (z_re, jz_re), (z_im, jz_im) = _planes((b, m), precision, seed=3 * m + b)
    got = rfft_cuda.untangle_fwd(z_re, z_im, n=2 * m, scale=scale)
    assert got[0].dtype is z_re.dtype and got[0].shape == (b, m + 1)
    assert not got[1][:, -1].any()  # Im X[M] is exactly 0
    close = dict(precision=precision, inputs=(z_re, z_im), scale=scale)
    _assert_epilogue_close(got, j_rfft._untangle_fwd(
        jz_re, jz_im, 2 * m, scale, STORAGE[precision][1]), **close)
    if m >= 128:
        _assert_epilogue_close(got, rfft_pallas.untangle_fwd(
            jz_re, jz_im, n=2 * m, scale=scale, interpret=True), **close)


@pytest.mark.parametrize("precision,out", [("bfloat16", "bfloat16"),
                                           ("float32", "float32"),
                                           ("float32", "bfloat16")])
@pytest.mark.parametrize("m", HALF_LENGTHS)
@pytest.mark.parametrize("b,scaling", [(3, "forward"), (2, "none"), (1, "ortho")])
def test_retangle_matches_jax(b, scaling, m, precision, out):
    scale = _scale(scaling, forward=False)
    t_out, j_out = STORAGE[out]
    (x_re, jx_re), (x_im, jx_im) = _planes((b, m + 1), precision,
                                           seed=5 * m + b)
    got = rfft_cuda.retangle_inv(x_re, x_im, n=2 * m, scale=scale,
                                 out_dtype=t_out)
    assert got[0].dtype is t_out and got[0].shape == (b, m)
    want = j_rfft._retangle_inv(jx_re.astype(jnp.float32),
                                jx_im.astype(jnp.float32), 2 * m, scale)
    close = dict(precision=out, inputs=(x_re, x_im), scale=scale)
    _assert_epilogue_close(got, [w.astype(j_out) for w in want], **close)
    if m >= 128:
        _assert_epilogue_close(got, rfft_pallas.retangle_inv(
            jx_re, jx_im, n=2 * m, scale=scale, out_dtype=j_out,
            interpret=True), **close)


# (half length M, batch, max_fused_length): the fused route, and the
# four-step route with split (64, 64).
ROUTES = [(1024, 3, 16384), (4096, 2, 64)]


@pytest.mark.parametrize("scaling", SCALINGS)
@pytest.mark.parametrize("precision", ["bfloat16", "float32"])
@pytest.mark.parametrize("m,b,max_fused", ROUTES)
def test_rfft_split_matches_jax(m, b, max_fused, precision, scaling):
    kw = dict(precision=precision, scaling=scaling, max_fused_length=max_fused)
    tplan, jplan = tt.create_plan(m, **kw), tfft.create_plan(m, **kw)
    four_step = tplan.resolve_strategy() is tt.Strategy.FOUR_STEP
    assert t_rfft._fused_pack_ok(tplan) == j_rfft._fused_pack_ok(jplan) == four_step
    (x, jx), = _planes((b, 2 * m), precision, seed=m + len(scaling), count=1)
    frac = FOUR_STEP_MAX_FRAC if four_step else FUSED_MAX_FRAC
    bf16 = precision == "bfloat16"

    got = tt.rfft_split(x, tplan)
    want = j_rfft.rfft_split(jx, jplan, epilogue="pallas")
    assert got[0].dtype is tplan.precision.storage_dtype
    assert got[0].shape == (b, m + 1)
    a = agreement([_np(g) for g in got], [_np(w) for w in want], bf16=bf16)
    assert a.within(frac), a

    # Both inverses take the same spectrum (the port's, as float32 planes).
    spec = [g.float() for g in got]
    back = tt.irfft_split(*spec, tplan)
    j_back = j_rfft.irfft_split(*[jnp.asarray(s.numpy()) for s in spec], jplan,
                                epilogue="pallas")
    assert back.dtype is tplan.precision.storage_dtype and back.shape == (b, 2 * m)
    a = agreement([_np(back)], [_np(j_back)], bf16=bf16)
    assert a.within(frac), a


@pytest.mark.parametrize("precision", ["bfloat16", "float32"])
def test_rfft_matches_numpy_and_round_trips(precision):
    n = 4096
    rng = np.random.default_rng(11)
    x64 = rng.standard_normal((2, 3, n))
    x = torch.from_numpy(x64.astype(np.float32))
    o_re, o_im = tt.rfft_split(x, precision=precision)
    assert o_re.shape == (2, 3, n // 2 + 1)
    want = np.fft.rfft(x64, axis=-1) / n
    got = _np(o_re) + 1j * _np(o_im)
    np.testing.assert_allclose(got, want, atol=3e-3 if precision == "bfloat16" else 1e-5)
    back = tt.irfft_split(o_re, o_im, precision=precision)
    assert back.shape == (2, 3, n)
    # float32: bf16x3 keeps 16 mantissa bits per operand (as test_torch_fft).
    np.testing.assert_allclose(_np(back), x64, atol=5e-2 if precision == "bfloat16" else 5e-4)


@pytest.mark.parametrize("precision", ["bfloat16", "float32"])
def test_fft_convolve_real_matches_jax(precision):
    n = 2048
    rng = np.random.default_rng(12)
    a, b = rng.standard_normal((2, 2, n)).astype(np.float32)
    got = tt.fft_convolve_real(torch.from_numpy(a), torch.from_numpy(b),
                               precision=precision)
    want = j_conv.fft_convolve_real(a, b, precision=precision)
    assert got.dtype is torch.float32 and got.shape == (2, n)
    agree = agreement([_np(got)], [_np(want)], bf16=precision == "bfloat16")
    assert agree.within(FUSED_MAX_FRAC), agree
    exact = np.fft.irfft(np.fft.rfft(a.astype(np.float64)) * np.fft.rfft(b), n)
    tol = 0.3 if precision == "bfloat16" else 1e-3
    np.testing.assert_allclose(_np(got), exact, atol=tol * np.abs(exact).max())


def test_host_wrappers_default_to_the_card():
    for fn in (tt.rfft, tt.irfft, tt.fft, tt.ifft):
        assert inspect.signature(fn).parameters["device"].default == "cuda"
    n = 512
    x = np.random.default_rng(13).standard_normal((2, n)).astype(np.float32)
    spec = tt.rfft(x, device="cpu", precision="float32")
    assert spec.dtype == np.complex64 and spec.shape == (2, n // 2 + 1)
    np.testing.assert_allclose(spec, tfft.rfft(x, precision="float32"), atol=1e-6)
    back = tt.irfft(spec, device="cpu", precision="float32")
    assert back.dtype == np.float32
    np.testing.assert_allclose(back, x, atol=5e-4)


def test_bad_lengths_raise():
    with pytest.raises(ValueError, match="even"):
        tt.rfft_split(torch.zeros(2, 63))
    with pytest.raises(ValueError, match="fft_length"):
        tt.rfft_split(torch.zeros(2, 64), tt.create_plan(64))
    with pytest.raises(ValueError, match="irfft expects"):
        tt.irfft_split(torch.zeros(2, 33), torch.zeros(2, 33), n=66)
    with pytest.raises(ValueError, match="2\\*M"):
        rfft_cuda.untangle_fwd(torch.zeros(1, 8), torch.zeros(1, 8), n=8,
                               scale=0.25)
