"""The four-step pairs (C2C, K5, K6) and K4 of the port under the numeric
knobs and the gridslice engines, against the JAX package's four-step and
2D kernels in Pallas interpret mode (at most 2 rows).

Tolerances (``testing.metrics``): fp32 state, the four-step bounds (bf16
storage: one bf16 ulp of the output scale on at most 1 % of elements;
fp32 storage: 1e-5 relative); bf16 state, two bf16 ulps on at most 2 %,
and the port's transform passes the reference gate.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tensorfft_tpu as tfft
from tensorfft_tpu.fft import four_step_call_kwargs as j_kwargs
from tensorfft_tpu.fft import stage_scales
from tensorfft_tpu.ops import four_step_pallas
import tensorfft_tpu_torch as tt
from tensorfft_tpu_torch.fft import four_step_call_kwargs as t_kwargs
from tensorfft_tpu_torch.ops import four_step_cuda
from tensorfft_tpu_torch.plan import effective_state_dtype
from tensorfft_tpu_torch.testing import (agreement, deviation, fft_oracle,
                                         make_test_signal)
from tensorfft_tpu_torch.testing.metrics import (BF16_STATE_MAX_FRAC,
                                                 BF16_STATE_MAX_SCALE_ULPS,
                                                 FOUR_STEP_MAX_FRAC)

import _strict_jax

torch.set_num_threads(1)

STORAGE = {"bfloat16": (torch.bfloat16, jnp.bfloat16),
           "float32": (torch.float32, jnp.float32)}


def _planes(shape, precision, seed, count=2):
    rng = np.random.default_rng(seed)
    tdt, jdt = STORAGE[precision]
    ts = [torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(tdt)
          for _ in range(count)]
    return ts, [jnp.asarray(t.float().numpy(), jdt) for t in ts]


def _np(x):
    return np.asarray(x.float().numpy() if isinstance(x, torch.Tensor) else x,
                      np.float32)


def _assert_agrees(got, want, precision, state_dtype):
    bf16 = precision == "bfloat16" or state_dtype == "bfloat16"
    a = agreement([_np(g) for g in got], [_np(w) for w in want], bf16=bf16)
    if state_dtype == "bfloat16":
        assert a.within(BF16_STATE_MAX_FRAC, BF16_STATE_MAX_SCALE_ULPS), a
    else:
        assert a.within(FOUR_STEP_MAX_FRAC), a


def _strict(tuning, sd):
    """mult3 under a bf16 state: the JAX side runs in _strict_jax."""
    return tuning.get("complex_mult") == "mult3" and sd == "bfloat16"


def _jax(fn, args, precision, kwargs, strict):
    """The JAX kernel's outputs, as a list of planes."""
    if not strict:
        out = getattr(four_step_pallas, fn)(*args, **kwargs, interpret=True)
        return list(out) if isinstance(out, tuple) else [out]
    (out,) = _strict_jax.run([_strict_jax.call(
        f"tensorfft_tpu.ops.four_step_pallas.{fn}",
        [np.asarray(a, np.float32) for a in args], precision, interpret=True,
        **kwargs)])
    return out


def _plans(n, precision, tuning):
    return (tt.create_plan(n, precision=precision, tuning=tuning),
            tfft.create_plan(n, precision=precision, tuning=tuning))


# (n, precision, tuning): the state dtype in effect after the narrow-panel
# rule is the tuning's unless a panel is narrower than 128.
C2C_CASES = [
    (16384, "bfloat16", dict(strategy="four_step", four_step_split=(128, 128),
                             complex_mult="mult3", state_dtype="bfloat16")),
    (1 << 16, "bfloat16", dict(strategy="four_step", four_step_split=(64, 1024),
                               state_dtype="bfloat16")),      # narrow: fp32
    (16384, "float32", dict(strategy="four_step", four_step_split=(128, 128),
                            grouped=True, complex_mult="mult3")),
    (16384, "bfloat16", dict(strategy="four_step", four_step_split=(128, 128),
                             col_radices=(16, 8), row_radices=(8, 16),
                             grouped=True, state_dtype="bfloat16",
                             engine="pretwiddle")),
]


@pytest.mark.parametrize("n,precision,tuning", C2C_CASES)
def test_four_step_knobs_match_jax(n, precision, tuning):
    tplan, jplan = _plans(n, precision, tuning)
    sd = effective_state_dtype(tplan.state_dtype, *tplan.four_step_split,
                               tplan.lane_tile, tplan.k1_tile)
    if tplan.four_step_split == (64, 1024):
        assert sd == "float32"
    (re, im), (jre, jim) = _planes((1, n), precision, seed=n)
    got = four_step_cuda.four_step_fft(re, im, **t_kwargs(tplan, True))
    want = _jax("four_step_fft", (jre, jim), precision, j_kwargs(jplan, True),
                _strict(tuning, sd))
    _assert_agrees(got, want, precision, sd)
    if sd == "bfloat16":
        sig = make_test_signal(n, 42, 42 * 42)
        tdt = STORAGE[precision][0]
        out = tt.fft_split(*[torch.from_numpy(p[None]).to(tdt) for p in sig],
                           tplan)
        d = deviation([_np(o).astype(np.float64) for o in out],
                      fft_oracle(*[p[None] for p in sig]))
        assert d.passes_reference_gate(), d


# K5 and K6 (the R2C pair's four-step legs) under each knob and both planar
# engines, at half length 16384, split (128, 128): panels of 128, so a bf16
# state stays in effect.
REAL_KNOBS = [dict(grouped=True), dict(state_dtype="bfloat16"),
              dict(grouped=True, complex_mult="mult3", state_dtype="bfloat16"),
              dict(engine="planar"), dict(engine="planar_vpu"),
              dict(engine="gridslice")]


@pytest.mark.parametrize("knobs", REAL_KNOBS)
def test_real_pair_knobs_match_jax(knobs):
    n = 16384
    tuning = dict(strategy="four_step", four_step_split=(128, 128), **knobs)
    tplan, jplan = _plans(n, "bfloat16", tuning)
    sd = tplan.state_dtype
    (x, re, im), (jx, jre, jim) = _planes((1, 2 * n), "bfloat16", seed=7,
                                          count=3)
    strict = _strict(tuning, sd)
    got = four_step_cuda.four_step_fft_packed_real(x, **t_kwargs(tplan, True))
    want = _jax("four_step_fft_packed_real", (jx,), "bfloat16",
                j_kwargs(jplan, True), strict)
    _assert_agrees(got, want, "bfloat16", sd)
    re, im, jre, jim = re[:, :n], im[:, :n], jre[:, :n], jim[:, :n]
    got = four_step_cuda.four_step_fft_to_real(re, im, **t_kwargs(tplan, False))
    want = _jax("four_step_fft_to_real", (jre, jim), "bfloat16",
                j_kwargs(jplan, False), strict)
    _assert_agrees([got], want, "bfloat16", sd)


@pytest.mark.parametrize("precision", ["bfloat16", "float32"])
@pytest.mark.parametrize("grouped,state_dtype", [((True, True), "float32"),
                                                 ((False, True), "bfloat16")])
def test_fft2_knobs_match_jax(grouped, state_dtype, precision):
    # K4 has no narrow-panel fallback (four_step_pallas.py:641): its bf16
    # state holds at any width.
    h, w = 64, 128
    r1, r2 = (8, 8), (16, 8)
    (re, im), (jre, jim) = _planes((1, h, w), precision, seed=h + w)
    kw = dict(radices1=r1, radices2=r2,
              scales1=stage_scales(r1, "forward", True),
              scales2=stage_scales(r2, "forward", True),
              algorithm="bf16" if precision == "bfloat16" else "bf16x3",
              grouped=grouped, state_dtype=state_dtype)
    got = four_step_cuda.fft2_fused(re, im, **kw)
    want = four_step_pallas.fft2_fused(jre, jim, interpret=True, **kw)
    _assert_agrees(got, want, precision, state_dtype)


@pytest.mark.parametrize("engine,split,radices,want", [
    ("gridslice", (64, 64), ((8, 8), (8, 8)), ("gridslice", "gridslice")),
    ("gridslice16", (64, 64), ((8, 8), (4, 16)), ("stacked", "stacked")),
    ("gridslice16", (256, 64), ((16, 16), (8, 8)), ("gridslice16", "stacked")),
    ("gridslice", (64, 64), ((16, 4), (8, 8)), ("stacked", "gridslice")),
])
def test_gridslice_passes_are_stacked(engine, split, radices, want):
    # The JAX gate decides where K2cg and K2rg run (four_step_pallas.py
    # :366-372, :490-496); either way the port computes the stacked passes
    # bit for bit, and agrees with the JAX gridslice engine.
    n = split[0] * split[1]
    tuning = dict(strategy="four_step", four_step_split=split,
                  col_radices=radices[0], row_radices=radices[1],
                  engine=engine)
    tplan, jplan = _plans(n, "bfloat16", tuning)
    assert (four_step_cuda.pass_engine(engine, radices[0], False),
            four_step_cuda.pass_engine(engine, radices[1], False)) == want
    (re, im), (jre, jim) = _planes((2, n), "bfloat16", seed=n)
    got = four_step_cuda.four_step_fft(re, im, **t_kwargs(tplan, True))
    stacked = four_step_cuda.four_step_fft(
        re, im, **dict(t_kwargs(tplan, True), engine="stacked"))
    for g, s in zip(got, stacked):
        assert torch.equal(g, s)
    want_j = four_step_pallas.four_step_fft(jre, jim, **j_kwargs(jplan, True),
                                            interpret=True)
    _assert_agrees(got, want_j, "bfloat16", "float32")
    # K6's column pass takes the gridslice gate too (:1102-1107).
    x = four_step_cuda.four_step_fft_to_real(re, im, **t_kwargs(tplan, False))
    jx = four_step_pallas.four_step_fft_to_real(jre, jim, **j_kwargs(jplan, False),
                                                interpret=True)
    _assert_agrees([x], [jx], "bfloat16", "float32")
