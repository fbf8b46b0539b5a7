"""The planar engines (K1b) of the port against the JAX package's
(``fused_pallas.stage_loop_planar``, Pallas interpret mode on the CPU).

On the CPU the port's wrappers run their plain versions
(``fused_cuda.run_stages_planar``)."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tensorfft_tpu as tfft
from tensorfft_tpu.fft import four_step_call_kwargs as j_kwargs
from tensorfft_tpu.fft import stage_scales
from tensorfft_tpu.ops import four_step_pallas, fused_pallas
import tensorfft_tpu_torch as tt
from tensorfft_tpu_torch.fft import four_step_call_kwargs as t_kwargs
from tensorfft_tpu_torch.ops import four_step_cuda, fused_cuda
from tensorfft_tpu_torch.testing import agreement
from tensorfft_tpu_torch.testing.metrics import (
    BF16_STATE_MAX_FRAC,
    BF16_STATE_MAX_SCALE_ULPS,
    FOUR_STEP_MAX_FRAC,
)

torch.set_num_threads(1)

ALGORITHM = {"bfloat16": "bf16", "float32": "bf16x3"}
STORAGE = {"bfloat16": (torch.bfloat16, jnp.bfloat16),
           "float32": (torch.float32, jnp.float32)}
ENGINES = ["planar", "planar_vpu"]


def _planes(shape, precision, seed, count=2):
    rng = np.random.default_rng(seed)
    tdt, jdt = STORAGE[precision]
    out = []
    for _ in range(count):
        t = torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(tdt)
        out.append((t, jnp.asarray(t.float().numpy(), jdt)))
    return out


def _np(x):
    return np.asarray(x.float().numpy() if isinstance(x, torch.Tensor) else x,
                      np.float32)


@pytest.mark.parametrize("first_dot", ["default", "bf16ax2"])
@pytest.mark.parametrize("fold", [True, False])
@pytest.mark.parametrize("algorithm", ["bf16", "bf16x3"])
@pytest.mark.parametrize("radices", [(16, 16, 4), (64, 128), (4, 64, 256)])
def test_planar_stage_tables_identical(radices, algorithm, fold, first_dot):
    scales = stage_scales(radices, "forward", True)
    for sign in (-1, 1):
        got = fused_cuda.planar_stage_tables(radices, scales, sign, algorithm,
                                             fold, first_dot)
        want = fused_pallas.planar_stage_tables(radices, scales, sign,
                                                algorithm, fold, first_dot)
        assert len(got) == len(want)
        for g, w in zip(got, want):
            assert str(g.dtype).split(".")[-1] == str(w.dtype)
            assert np.array_equal(g.float().numpy(), np.asarray(w, np.float32))


@pytest.mark.parametrize("precision", ["bfloat16", "float32"])
@pytest.mark.parametrize("engine", ENGINES)
@pytest.mark.parametrize("radices", [(256,), (64, 64), (16, 16, 4)])
def test_planar_fused_matches_jax(radices, engine, precision):
    # (16, 16, 4): a folded stage at K = 16 and a K = 256 stage past the
    # fold limit, which takes the twiddle and the shared table.
    n, b = int(np.prod(radices)), 3
    scales = stage_scales(radices, "forward", True)
    (re, jre), (im, jim) = _planes((b, n), precision, seed=n + len(radices))
    kw = dict(radices=radices, scales=scales, algorithm=ALGORITHM[precision],
              engine=engine)
    got = fused_cuda.fused_fft(re, im, **kw)
    want = fused_pallas.fused_fft(jre.T, jim.T, **kw, interpret=True)
    assert got[0].dtype is re.dtype and got[0].shape == (b, n)
    a = agreement([_np(g) for g in got], [_np(w.T) for w in want],
                  bf16=precision == "bfloat16")
    assert a.within(), a
    for g, p in zip(got, fused_cuda.fused_fft_reference(re, im, **kw)):
        assert torch.equal(g, p)


@pytest.mark.parametrize("precision", ["bfloat16", "float32"])
def test_planar_four_step_matches_jax(precision):
    n, split = 1 << 15, (128, 256)
    kw = dict(precision=precision,
              tuning={"engine": "planar", "four_step_split": split})
    plan = tt.create_plan(n, **kw)
    assert plan.four_step_split == split and plan.engine == "planar"
    (re, jre), (im, jim) = _planes((2, n), precision, seed=15)
    got = tt.fft_split(re, im, plan)
    want = tfft.fft_split(jre, jim, tfft.create_plan(n, **kw))
    a = agreement([_np(g) for g in got], [_np(w) for w in want],
                  bf16=precision == "bfloat16")
    assert a.within(FOUR_STEP_MAX_FRAC), a


@pytest.mark.parametrize("precision", ["bfloat16", "float32"])
def test_planar_vpu_fft2_matches_jax(precision):
    h, w = 64, 128
    ph, pw = tt.create_plan(h, precision=precision), tt.create_plan(w, precision=precision)
    (re, jre), (im, jim) = _planes((2, h, w), precision, seed=64)
    kw = dict(radices1=ph.radices, radices2=pw.radices,
              scales1=stage_scales(ph.radices, "forward", True),
              scales2=stage_scales(pw.radices, "forward", True),
              algorithm=ALGORITHM[precision], engine="planar_vpu")
    got = four_step_cuda.fft2_fused(re, im, **kw)
    want = four_step_pallas.fft2_fused(jre, jim, **kw, interpret=True)
    a = agreement([_np(g) for g in got], [_np(x) for x in want],
                  bf16=precision == "bfloat16")
    assert a.within(FOUR_STEP_MAX_FRAC), a


@pytest.mark.parametrize("engine", ENGINES)
def test_planar_output_differs_from_stacked(engine):
    # A planar plan that ran the stacked engine would fail here, though it
    # would pass every accuracy check.
    radices = (64, 64)
    (re, _), (im, _) = _planes((4, 4096), "bfloat16", seed=7)
    kw = dict(radices=radices, scales=stage_scales(radices, "forward", True))
    planar = fused_cuda.fused_fft(re, im, engine=engine, **kw)
    stacked = fused_cuda.fused_fft(re, im, **kw)
    assert not all(torch.equal(p, s) for p, s in zip(planar, stacked))


def test_planar_ignores_grouped_and_mult3():
    n = 4096
    (re, jre), (im, jim) = _planes((2, n), "bfloat16", seed=9)
    outs = {"port": [], "jax": []}
    for extra in ({}, {"grouped": True}, {"complex_mult": "mult3"}):
        tuning = dict(engine="planar", radices=(64, 64), **extra)
        t_plan, j_plan = tt.create_plan(n, tuning=tuning), tfft.create_plan(n, tuning=tuning)
        d = dataclasses.asdict(t_plan)
        assert all(d[k] == v for k, v in extra.items())
        outs["port"].append([_np(x) for x in tt.fft_split(re, im, t_plan)])
        outs["jax"].append([_np(x) for x in tfft.fft_split(jre, jim, j_plan)])
    for pkg, runs in outs.items():
        for run in runs[1:]:
            for a, b in zip(run, runs[0]):
                assert np.array_equal(a, b), pkg


def test_planar_knobs_raise_where_not_ported():
    # Nothing raises any more under the planar engines: bf16 state in
    # kernel A, and the R2C four-step pair (K5, K6), each against the JAX
    # package.  bf16 state: <= 2 bf16 ulps of the output scale on <= 2 % of
    # elements; K5, K6 (fp32 state): the four-step bound.
    n = 4096
    (re, jre), (im, jim) = _planes((2, n), "bfloat16", seed=21)
    (x, jx), = _planes((1, 2 * n), "bfloat16", seed=22, count=1)
    for engine in ENGINES:
        kw = dict(radices=(64, 64), scales=stage_scales((64, 64), "forward", True),
                  engine=engine, state_dtype="bfloat16")
        got = fused_cuda.fused_fft(re, im, **kw)
        want = fused_pallas.fused_fft(jre.T, jim.T, interpret=True, **kw)
        a = agreement([_np(g) for g in got], [_np(w.T) for w in want], bf16=True)
        assert a.within(BF16_STATE_MAX_FRAC, BF16_STATE_MAX_SCALE_ULPS), (engine, a)
        plan = tt.create_plan(n, max_fused_length=64, tuning={"engine": engine})
        jplan = tfft.create_plan(n, max_fused_length=64, tuning={"engine": engine})
        got = four_step_cuda.four_step_fft_packed_real(x, **t_kwargs(plan, True))
        want = four_step_pallas.four_step_fft_packed_real(
            jx, **j_kwargs(jplan, True), interpret=True)
        a = agreement([_np(g) for g in got], [_np(w) for w in want], bf16=True)
        assert a.within(FOUR_STEP_MAX_FRAC), (engine, a)
        got = four_step_cuda.four_step_fft_to_real(re[:1], im[:1],
                                                   **t_kwargs(plan, False))
        want = four_step_pallas.four_step_fft_to_real(
            jre[:1], jim[:1], **j_kwargs(jplan, False), interpret=True)
        a = agreement([_np(got)], [_np(want)], bf16=True)
        assert a.within(FOUR_STEP_MAX_FRAC), (engine, a)


@pytest.mark.parametrize("algorithm,terms", [("bf16", 1), ("bf16x3", 2)])
def test_planar_kernel_tables_layout(algorithm, terms):
    # Per stage the split [term][slice][re, im][R][R] matrix, a twiddle only
    # after an unfolded stage, and the stage modes after the per-stage
    # fields: (16, 16, 4) folds its K = 16 stage, not its K = 256 one.
    radices = (16, 16, 4)
    scales = stage_scales(radices, "forward", True)
    tables, meta = fused_cuda.kernel_tables(radices, scales, -1, algorithm,
                                            "default", torch.device("cpu"),
                                            "planar")
    arrays = fused_cuda.planar_stage_tables(radices, scales, -1, algorithm)
    assert list(meta[1 + 4 * 3:1 + 5 * 3]) == [1, 2, 1]
    slices = (1, 16, 1)
    mats = [arrays[0], arrays[1], arrays[2]]
    for s, r in enumerate(radices):
        radix, n_terms, d_off, w_off = meta[1 + 4 * s: 5 + 4 * s]
        assert radix == r and n_terms == terms
        d = tables[d_off:d_off + n_terms * slices[s] * 2 * r * r]
        a = mats[s].float().reshape(slices[s], 2, r, r)
        want = [a] if algorithm == "bf16" else fused_cuda.dots.split_bf16(a, terms)
        assert torch.equal(d, torch.cat([w.float().reshape(-1) for w in want]))
        assert (w_off == 0) == (s != 2)
    w = tables[meta[1 + 4 * 2 + 3]:].reshape(2, 4, 256)
    assert torch.equal(w[0], arrays[3]) and torch.equal(w[1], arrays[4])
    _, stacked_meta = fused_cuda.kernel_tables(radices, scales, -1, algorithm,
                                               "default", torch.device("cpu"))
    assert list(stacked_meta[1 + 4 * 3:1 + 5 * 3]) == [0, 0, 0]
