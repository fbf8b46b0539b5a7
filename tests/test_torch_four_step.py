"""Kernels B and C's module (ops/four_step_cuda.py) against the JAX four-step
Pallas kernels (interpret mode).  On the CPU the port runs the plain-torch
versions of both passes."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tensorfft_tpu as tfft
from tensorfft_tpu import dft as jdft
from tensorfft_tpu.fft import four_step_call_kwargs as j_kwargs
from tensorfft_tpu.ops import four_step_pallas
import tensorfft_tpu_torch as tt
from tensorfft_tpu_torch.fft import four_step_call_kwargs as t_kwargs
from tensorfft_tpu_torch.ops import four_step_cuda
from tensorfft_tpu_torch.testing import agreement
from tensorfft_tpu_torch.testing.metrics import FOUR_STEP_MAX_FRAC

torch.set_num_threads(1)

STORAGE = {"bfloat16": (torch.bfloat16, jnp.bfloat16),
           "float32": (torch.float32, jnp.float32)}
# (n, batch, max_fused_length): splits (64, 64) and (128, 256).
CASES = [(4096, 2, 64), (32768, 2, 16384)]


def _inputs(b, n, precision, seed=0):
    rng = np.random.default_rng(seed)
    tdt, jdt = STORAGE[precision]
    re = torch.from_numpy(rng.standard_normal((b, n)).astype(np.float32)).to(tdt)
    im = torch.from_numpy(rng.standard_normal((b, n)).astype(np.float32)).to(tdt)
    return (re, im), (jnp.asarray(re.float().numpy(), jdt),
                      jnp.asarray(im.float().numpy(), jdt))


def _numpy(planes):
    return [np.asarray(p.float() if isinstance(p, torch.Tensor) else p,
                       np.float32) for p in planes]


@pytest.mark.parametrize("precision", ["bfloat16", "float32"])
@pytest.mark.parametrize("forward", [True, False])
@pytest.mark.parametrize("n,b,max_fused", CASES)
def test_four_step_matches_jax(n, b, max_fused, forward, precision):
    tplan = tt.create_plan(n, precision=precision, max_fused_length=max_fused)
    jplan = tfft.create_plan(n, precision=precision, max_fused_length=max_fused)
    (re, im), (jre, jim) = _inputs(b, n, precision)
    got = four_step_cuda.four_step_fft(re, im, **t_kwargs(tplan, forward))
    want = four_step_pallas.four_step_fft(jre, jim, **j_kwargs(jplan, forward),
                                          interpret=True)
    assert got[0].dtype is re.dtype and got[0].shape == (b, n)
    a = agreement(_numpy(got), _numpy(want), bf16=precision == "bfloat16")
    assert a.within(FOUR_STEP_MAX_FRAC), a


# K5/K6 cases (n, batch, max_fused_length): split (64, 64), odd batch.
REAL_CASES = [(4096, 3, 64)]


@pytest.mark.parametrize("precision", ["bfloat16", "float32"])
@pytest.mark.parametrize("n,b,max_fused", REAL_CASES)
def test_packed_real_matches_jax(n, b, max_fused, precision):
    # K5: the four-step of the half-length packed view of real (B, 2N) rows.
    tplan = tt.create_plan(n, precision=precision, max_fused_length=max_fused)
    jplan = tfft.create_plan(n, precision=precision, max_fused_length=max_fused)
    (x, _), (jx, _) = _inputs(b, 2 * n, precision, seed=3)
    got = four_step_cuda.four_step_fft_packed_real(x, **t_kwargs(tplan, True))
    want = four_step_pallas.four_step_fft_packed_real(
        jx, **j_kwargs(jplan, True), interpret=True)
    assert got[0].dtype is x.dtype and got[0].shape == (b, n)
    a = agreement(_numpy(got), _numpy(want), bf16=precision == "bfloat16")
    assert a.within(FOUR_STEP_MAX_FRAC), a
    # The plain K5 is the plain pack composed with the plain four-step.
    plain = four_step_cuda.four_step_fft(x[:, 0::2].contiguous(),
                                         x[:, 1::2].contiguous(),
                                         **t_kwargs(tplan, True))
    for g, w in zip(got, plain):
        assert torch.equal(g, w)


@pytest.mark.parametrize("precision", ["bfloat16", "float32"])
@pytest.mark.parametrize("n,b,max_fused", REAL_CASES)
def test_to_real_matches_jax(n, b, max_fused, precision):
    # K6: the four-step with its output interleaved into real (B, 2N) rows.
    tplan = tt.create_plan(n, precision=precision, max_fused_length=max_fused)
    jplan = tfft.create_plan(n, precision=precision, max_fused_length=max_fused)
    (re, im), (jre, jim) = _inputs(b, n, precision, seed=4)
    got = four_step_cuda.four_step_fft_to_real(re, im, **t_kwargs(tplan, False))
    want = four_step_pallas.four_step_fft_to_real(
        jre, jim, **j_kwargs(jplan, False), interpret=True)
    assert got.dtype is re.dtype and got.shape == (b, 2 * n)
    a = agreement(_numpy([got]), _numpy([want]), bf16=precision == "bfloat16")
    assert a.within(FOUR_STEP_MAX_FRAC), a
    o_re, o_im = four_step_cuda.four_step_fft(re, im, **t_kwargs(tplan, False))
    assert torch.equal(got[:, 0::2], o_re) and torch.equal(got[:, 1::2], o_im)


def _pass_kwargs(plan, forward):
    kw = t_kwargs(plan, forward)
    return kw, dict(n1=kw["n1"], n2=kw["n2"], sign=kw["sign"],
                    algorithm=kw["algorithm"], first_dot=kw["first_dot"])


def test_column_pass_matches_jax():
    # The JAX entry point's measurement knob passes="k1" returns `mid`.
    n, b = 4096, 2
    tplan = tt.create_plan(n, max_fused_length=64)
    (re, im), (jre, jim) = _inputs(b, n, "bfloat16", seed=1)
    kw, common = _pass_kwargs(tplan, True)
    got = four_step_cuda.column_pass(
        re, im, radices1=kw["radices1"], scales1=kw["scales1"],
        lane_tile=kw["lane_tile"], **common)
    want = four_step_pallas.four_step_fft(
        jre, jim, **j_kwargs(tfft.create_plan(n, max_fused_length=64), True),
        passes="k1", interpret=True)
    a = agreement(_numpy(got), _numpy(want), bf16=True)
    assert a.within(), a


def test_row_pass_matches_jax():
    # passes="k2" runs the row pass on the raw input as `mid`.
    n, b = 4096, 2
    tplan = tt.create_plan(n, max_fused_length=64)
    (re, im), (jre, jim) = _inputs(b, n, "bfloat16", seed=2)
    kw, common = _pass_kwargs(tplan, False)
    got = four_step_cuda.row_pass(
        re, im, radices2=kw["radices2"], scales2=kw["scales2"], **common)
    want = four_step_pallas.four_step_fft(
        jre, jim, **j_kwargs(tfft.create_plan(n, max_fused_length=64), False),
        passes="k2", interpret=True)
    a = agreement(_numpy(got), _numpy(want), bf16=True)
    assert a.within(), a


@pytest.mark.parametrize("n1,n2,lane_tile", [(64, 64, 128), (128, 256, 128),
                                             (256, 4096, 128)])
def test_pq_tables_match_jax_layout(n1, n2, lane_tile):
    # four_step_pallas.py:359-377: P as (n2/t, 2, n1), Q as (2, n1, t).
    for sign in (-1, 1):
        pq, qq, t = four_step_cuda.four_step_tables(n1, n2, lane_tile, sign)
        assert t == min(lane_tile, n2)
        p_re, p_im, q_re, q_im = jdft.four_step_twiddle_factors(
            n1, n2, t, dtype=np.float32, sign=sign)
        assert np.array_equal(pq, np.stack([p_re, p_im]).transpose(2, 0, 1))
        assert np.array_equal(qq, np.stack([q_re, q_im]))


def test_pass_lanes():
    assert four_step_cuda.pass_lanes(256, 4096) == 64
    assert four_step_cuda.pass_lanes(4096, 256) == 4
    assert four_step_cuda.pass_lanes(16384, 16384) == 1
    assert four_step_cuda.pass_lanes(64, 8) == 8


def test_unported_knobs_raise():
    # A grouped plan runs and matches the JAX package; a knob value FFTPlan
    # rejects raises ValueError.
    tuning = {"grouped": True}
    tplan = tt.create_plan(4096, max_fused_length=64, tuning=tuning)
    jplan = tfft.create_plan(4096, max_fused_length=64, tuning=tuning)
    (re, im), (jre, jim) = _inputs(1, 4096, "bfloat16", seed=5)
    got = four_step_cuda.four_step_fft(re, im, **t_kwargs(tplan, True))
    want = four_step_pallas.four_step_fft(jre, jim, **j_kwargs(jplan, True),
                                          interpret=True)
    a = agreement(_numpy(got), _numpy(want), bf16=True)
    assert a.within(FOUR_STEP_MAX_FRAC), a
    with pytest.raises(ValueError, match="engine"):
        four_step_cuda.four_step_fft(re, im, **dict(t_kwargs(tplan, True),
                                                    engine="bogus"))
