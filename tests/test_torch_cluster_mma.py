"""The column-block ownership map of the tensor-core engine's cluster mode
(``csrc/fft_mma_cluster.cuh``), mirrored in ``fused_cuda.cluster_owner`` and
``fused_cuda.cluster_slice_base``.

A stage of radix R reads operand index r * nt + g (nt = n / R); on a
cluster of C CTAs, rank g // ntl (ntl = nt / C) holds it at local index
r * ntl + g % ntl, so each CTA's buffer is the [R][ntl] operand of its own
columns.  These tests check the map on every stage of the plans the port
runs past one CTA (``chip_smoke.py``'s bign path, ``tests/test_torch_cluster.py``'s
cluster table) and on a sweep of C = 2, 4, 8 at N = 1024-16384: a bijection
onto C x [0, n / C), each rank's buffer equal to its columns row by row, a
folded stage's slice offset giving each column its own slice, and a numpy
model of the engine's data movement (local stage products, one write per
output to the rank the map names) equal to ``np.fft.fft``.
"""
import numpy as np
import pytest
import torch

import tensorfft_tpu_torch as tt
from tensorfft_tpu_torch.ops import fused_cuda
from tensorfft_tpu_torch.plan import optimal_radices

torch.set_num_threads(1)

# (label, N, precision, tuning, the pass's radices attribute): the bign
# path's plans past one CTA, as chip_smoke.py's BIGN_CALLS builds them.
_FUSED_32K = {"strategy": "fused", "radices": (256, 128), "max_fused_length": 32768}
BIGN_PLANS = [
    ("K1 32768", 32768, "bfloat16", _FUSED_32K, "radices"),
    ("K1 32768 float32 bf16 state", 32768, "float32",
     {"strategy": "fused", "radices": (32, 32, 32), "max_fused_length": 32768,
      "state_dtype": "bfloat16"}, "radices"),
    ("K1 65536 bf16 state", 65536, "bfloat16",
     {"strategy": "fused", "radices": (256, 256), "max_fused_length": 65536,
      "state_dtype": "bfloat16"}, "radices"),
    ("K1 65536 mult3 float32", 65536, "float32",
     {"strategy": "fused", "radices": (128, 4, 128), "max_fused_length": 65536,
      "complex_mult": "mult3"}, "radices"),
    ("K2r 2^27 (4096, 32768)", 1 << 27, "bfloat16",
     {"strategy": "four_step", "four_step_split": (4096, 32768)}, "row_radices"),
    ("K1 bf16x6 grouped mult3 16384", 16384, "float32_x6",
     {"strategy": "fused", "radices": (64, 256), "grouped": True,
      "complex_mult": "mult3"}, "radices"),
    ("R2C half-length 32768", 32768, "bfloat16", {"max_fused_length": 32768},
     "radices"),
]
# The cluster table's lengths that a cluster holds, as fused plans.
CLUSTER_TABLE_PLANS = [
    (f"fused {n} {alg}", n, prec, {"max_fused_length": n}, "radices")
    for n, alg, prec in ((32768, "bf16", "bfloat16"), (65536, "bf16x3", "float32"),
                         (131072, "bf16", "bfloat16"))
]


def _pass(label, n, precision, tuning, attr):
    """(pass length, radices, stages, CTAs per transform) of a plan's pass
    past one CTA, with the cluster ``fused_cuda.fit_cta`` picks."""
    plan = tt.create_plan(n, precision=precision, tuning=tuning)
    radices = tuple(getattr(plan, attr))
    length = int(np.prod(radices))
    stages = fused_cuda.pass_stages(radices, plan.engine, plan.grouped,
                                    plan.complex_mult, plan.state_dtype)
    _, cluster = fused_cuda.fit_cta(length, 1, plan.precision.dot_algorithm,
                                    stages, label)
    return length, radices, stages, cluster


PLAN_PASSES = [pytest.param(*_pass(*p), id=p[0])
               for p in BIGN_PLANS + CLUSTER_TABLE_PLANS]
# N = 1024 ... 16384 on 2, 4 and 8 CTAs, the radices optimal_radices picks
# and a radix-4 middle stage.
SWEEP = [pytest.param(n, radices, c, id=f"{n}-{'x'.join(map(str, radices))}-c{c}")
         for n in (1024, 2048, 4096, 8192, 16384)
         for radices in (optimal_radices(n), (16, 4, n // 64))
         for c in (2, 4, 8)]


def _stage_maps(n, radices, cluster):
    """Per stage: (R, ntl, rank, local) of every operand index."""
    out = []
    for r in radices:
        rank, local = fused_cuda.cluster_owner(n, r, cluster, np.arange(n))
        out.append((r, n // r // cluster, rank, local))
    return out


def _check_bijection(n, radices, cluster):
    e = n // cluster
    for r, ntl, rank, local in _stage_maps(n, radices, cluster):
        assert ntl >= 1 and r * ntl == e
        assert rank.min() == 0 and rank.max() == cluster - 1
        assert local.min() == 0 and local.max() == e - 1
        slots = rank * e + local
        assert np.array_equal(np.sort(slots), np.arange(n))


def _check_buffers(n, radices, cluster, seed):
    x = np.random.default_rng(seed).standard_normal(n)
    e = n // cluster
    for r, ntl, rank, local in _stage_maps(n, radices, cluster):
        buf = np.empty((cluster, e))
        buf[rank, local] = x
        cols = x.reshape(r, n // r)  # operand index r * nt + g
        for c in range(cluster):
            assert np.array_equal(buf[c].reshape(r, ntl),
                                  cols[:, c * ntl:(c + 1) * ntl])


@pytest.mark.parametrize("n,radices,stages,cluster", PLAN_PASSES)
def test_plan_stages_map_is_a_bijection(n, radices, stages, cluster):
    assert cluster > 1
    _check_bijection(n, radices, cluster)


@pytest.mark.parametrize("n,radices,cluster", SWEEP)
def test_sweep_map_is_a_bijection(n, radices, cluster):
    _check_bijection(n, radices, cluster)


@pytest.mark.parametrize("n,radices,stages,cluster", PLAN_PASSES)
def test_plan_rank_buffers_are_its_columns(n, radices, stages, cluster):
    _check_buffers(n, radices, cluster, seed=n)


@pytest.mark.parametrize("n,radices,cluster", SWEEP)
def test_sweep_rank_buffers_are_its_columns(n, radices, cluster):
    _check_buffers(n, radices, cluster, seed=n + cluster)


def _check_slices(n, radices, cluster):
    """Column g of a stage with M columns per slice reads slice g // M: on
    rank c, local column gl, the slice base plus gl // M."""
    k = 1
    for r in radices:
        m = n // (k * r)
        ntl = n // r // cluster
        for c in range(cluster):
            gl = np.arange(ntl)
            got = fused_cuda.cluster_slice_base(c, ntl, m) + gl // m
            assert np.array_equal(got, (c * ntl + gl) // m)
            assert got.max() < k
        k *= r


@pytest.mark.parametrize("n,radices,stages,cluster", PLAN_PASSES)
def test_plan_slice_offsets(n, radices, stages, cluster):
    _check_slices(n, radices, cluster)


@pytest.mark.parametrize("n,radices,cluster", SWEEP)
def test_sweep_slice_offsets(n, radices, cluster):
    _check_slices(n, radices, cluster)


def test_folded_plan_slices_cover_both_cases():
    # The bf16x6 headline plan folds its radix-256 stage (M = 1 <= ntl);
    # the planar engine folds the middle stage of (4, 64, 64) at n = 16384
    # (K = 4), where ntl = 32 < M = 64 on 8 CTAs: both sides of the rule.
    n, radices, stages, cluster = _pass(*BIGN_PLANS[5])
    assert any(st.fold for st in stages) and cluster == 2
    _check_slices(n, radices, cluster)
    stages = fused_cuda.pass_stages((4, 64, 64), "planar")
    assert stages[1].fold
    m, ntl = 16384 // (4 * 64), 16384 // 64 // 8
    assert ntl < m
    _check_slices(16384, (4, 64, 64), 8)


def _simulate(x, radices, cluster):
    """The cluster engine's data movement on complex128 values: each rank
    multiplies its own [R][ntl] buffer by the stage's DFT matrix, then
    writes each output, twiddled, to the rank and local index that
    cluster_owner names for the next stage; the last stage's output
    (r_out, rank * ntl + gl) is bin r_out * K + rank * ntl + gl."""
    n = x.size
    e = n // cluster
    rank, local = fused_cuda.cluster_owner(n, radices[0], cluster, np.arange(n))
    bufs = np.full((cluster, e), np.nan, dtype=complex)
    bufs[rank, local] = x
    k, m = 1, n
    for s, r in enumerate(radices):
        m //= r
        ntl = e // r
        d = np.exp(-2j * np.pi * np.outer(np.arange(r), np.arange(r)) / r)
        outs = np.einsum("or,crg->cog", d, bufs.reshape(cluster, r, ntl))
        c, r_out, gl = np.meshgrid(np.arange(cluster), np.arange(r),
                                   np.arange(ntl), indexing="ij")
        g = c * ntl + gl
        if s + 1 == len(radices):
            y = np.full(n, np.nan, dtype=complex)
            y[r_out * k + g] = outs
            return y
        r2 = radices[s + 1]
        k2, m2 = k * r, m // r2
        kk, mm = np.divmod(g, m)
        kk2 = r_out * k + kk
        rr2, mm2 = np.divmod(mm, m2)
        w = np.exp(-2j * np.pi * rr2 * kk2 / (k2 * r2))
        rank2, local2 = fused_cuda.cluster_owner(n, r2, cluster,
                                                 (rr2 * k2 + kk2) * m2 + mm2)
        bufs = np.full((cluster, e), np.nan, dtype=complex)
        bufs[rank2, local2] = outs * w
        k *= r
    raise AssertionError("no stages")


def _check_model(n, radices, cluster, seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(n) + 1j * rng.standard_normal(n)
    y = _simulate(x, radices, cluster)
    want = np.fft.fft(x)
    assert np.all(np.isfinite(y))
    assert np.max(np.abs(y - want)) <= 1e-9 * np.max(np.abs(want))


@pytest.mark.parametrize("n,radices,stages,cluster", PLAN_PASSES)
def test_plan_cluster_model_is_the_fft(n, radices, stages, cluster):
    _check_model(n, radices, cluster, seed=n + 7)


@pytest.mark.parametrize("n,radices,cluster", SWEEP)
def test_sweep_cluster_model_is_the_fft(n, radices, cluster):
    _check_model(n, radices, cluster, seed=n + 3 * cluster)
