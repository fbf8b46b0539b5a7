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
output to the rank the map names) equal to ``np.fft.fft``.  The same checks
run on the column-tile mode of kernel B's twin (T adjacent columns per
cluster, the lanes innermost: ``cluster_owner(..., lanes=T)``), whose model
adds the column tile's load at a pitch of n2 (K5: packed pairs), the lanes
and the four-step P.Q epilogue, and equals ``np.fft.fft`` down the columns
times the four-step twiddle (K4c: without it).
"""
import numpy as np
import pytest
import torch

import tensorfft_tpu_torch as tt
from tensorfft_tpu_torch.ops import four_step_cuda, fused_cuda
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


# -- column tiles: kernel B's twin, T adjacent columns per cluster ----------
#
# Element i of column lane sits at operand index i * T + lane, so a stage's
# column is g = gm * T + lane and each rank owns ntl = n * T / R / C
# consecutive ones (``cluster_owner(..., lanes=T)``).  The 2^27 split
# (32768, 4096) puts a 32768-point column pass (radices (32, 32, 32)) on a
# cluster; the column-cluster rule's candidates there are (T, C) = (1, 2),
# (2, 4) and (4, 8).
K2C_RADICES = (32, 32, 32)
COL_PLANS = [pytest.param(32768, K2C_RADICES, t, c, id=f"K2c-2^27-T{t}-c{c}")
             for t, c in ((1, 2), (2, 4), (4, 8))]
# n1 = 1024 ... 16384 with T = 1, 2, 4 on 2, 4 and 8 CTAs, wherever each
# stage's columns split into the cluster's blocks.
COL_SWEEP = [pytest.param(n, optimal_radices(n), t, c, id=f"{n}-T{t}-c{c}")
             for n in (1024, 2048, 4096, 8192, 16384)
             for t in (1, 2, 4) for c in (2, 4, 8)
             if max(optimal_radices(n)) * c <= n * t]


def _check_tile_bijection(n, radices, lanes, cluster):
    e = n * lanes // cluster
    for r in radices:
        rank, local = fused_cuda.cluster_owner(n, r, cluster,
                                               np.arange(n * lanes), lanes)
        assert rank.min() == 0 and rank.max() == cluster - 1
        assert local.min() == 0 and local.max() == e - 1
        assert np.array_equal(np.sort(rank * e + local), np.arange(n * lanes))


def _check_tile_buffers(n, radices, lanes, cluster, seed):
    # Element (i, lane) of the tile at operand index i * lanes + lane: rank
    # c's buffer, row by row, is the stage's columns c * ntl ... of the
    # operand (R rows of n * lanes / R columns).
    x = np.random.default_rng(seed).standard_normal((n, lanes))
    e = n * lanes // cluster
    for r in radices:
        ntl = e // r
        rank, local = fused_cuda.cluster_owner(n, r, cluster,
                                               np.arange(n * lanes), lanes)
        buf = np.empty((cluster, e))
        buf[rank, local] = x.reshape(-1)
        cols = x.reshape(r, n * lanes // r)
        for c in range(cluster):
            assert np.array_equal(buf[c].reshape(r, ntl),
                                  cols[:, c * ntl:(c + 1) * ntl])


def _check_tile_slices(n, radices, lanes, cluster):
    # Column g = gm * lanes + lane of a stage with M columns per slice reads
    # slice gm // M: on rank c, local column gl, the base plus
    # gl // (M * lanes).
    k = 1
    for r in radices:
        m = n // (k * r)
        ntl = n * lanes // r // cluster
        for c in range(cluster):
            gl = np.arange(ntl)
            got = fused_cuda.cluster_slice_base(c, ntl, m, lanes) + gl // (m * lanes)
            assert np.array_equal(got, ((c * ntl + gl) // lanes) // m)
            assert got.max() < k
        k *= r


@pytest.mark.parametrize("n,radices,lanes,cluster", COL_PLANS)
def test_col_plan_map_is_a_bijection(n, radices, lanes, cluster):
    _check_tile_bijection(n, radices, lanes, cluster)


@pytest.mark.parametrize("n,radices,lanes,cluster", COL_SWEEP)
def test_col_sweep_map_is_a_bijection(n, radices, lanes, cluster):
    _check_tile_bijection(n, radices, lanes, cluster)


@pytest.mark.parametrize("n,radices,lanes,cluster", COL_PLANS)
def test_col_plan_rank_buffers_are_its_columns(n, radices, lanes, cluster):
    _check_tile_buffers(n, radices, lanes, cluster, seed=n + lanes)


@pytest.mark.parametrize("n,radices,lanes,cluster", COL_SWEEP)
def test_col_sweep_rank_buffers_are_its_columns(n, radices, lanes, cluster):
    _check_tile_buffers(n, radices, lanes, cluster, seed=n + 7 * lanes + cluster)


@pytest.mark.parametrize("n,radices,lanes,cluster", COL_PLANS)
def test_col_plan_slice_offsets(n, radices, lanes, cluster):
    _check_tile_slices(n, radices, lanes, cluster)


@pytest.mark.parametrize("n,radices,lanes,cluster", COL_SWEEP)
def test_col_sweep_slice_offsets(n, radices, lanes, cluster):
    _check_tile_slices(n, radices, lanes, cluster)


def _simulate_tile(x, radices, cluster, lanes, c0, pairs=False, epilogue=None):
    """The engine's column-tile mode on complex128 values: columns c0 ...
    c0 + lanes - 1 of the (n, pitch) block ``x`` (``pairs``: the (n, 2 *
    pitch) real block, element (i, j) the pair x[i, 2j], x[i, 2j + 1]).
    Stage 0 loads each rank's block by the kernel's map (local q = r * ntl
    + gl holds element (r * n / R0 + g // lanes, g % lanes), g = rank * ntl +
    gl), which must be the one ``cluster_owner`` gives; each stage
    multiplies a rank's [R][ntl] buffer by the DFT matrix and writes each
    output, twiddled by column gm = g // lanes, to the rank and local index
    cluster_owner names; the last stage's output (r_out, g) is bin k = r_out
    * K + g // lanes of column g % lanes, passed through ``epilogue(k,
    lane, value)`` and stored at (k, c0 + lane)."""
    n = x.shape[0]
    pitch = x.shape[1] // (2 if pairs else 1)
    e = n * lanes // cluster
    ntl = e // radices[0]
    bufs = np.full((cluster, e), np.nan, dtype=complex)
    q = np.arange(e)
    for c in range(cluster):
        g = c * ntl + q % ntl
        i, col = (q // ntl) * (n // radices[0]) + g // lanes, c0 + g % lanes
        bufs[c] = x[i, 2 * col] + 1j * x[i, 2 * col + 1] if pairs else x[i, col]
        rank, local = fused_cuda.cluster_owner(n, radices[0], cluster,
                                               i * lanes + g % lanes, lanes)
        assert np.all(rank == c) and np.array_equal(local, q)
    k, m = 1, n
    for s, r in enumerate(radices):
        m //= r
        ntl = e // r
        d = np.exp(-2j * np.pi * np.outer(np.arange(r), np.arange(r)) / r)
        outs = np.einsum("or,crg->cog", d, bufs.reshape(cluster, r, ntl))
        c, r_out, gl = np.meshgrid(np.arange(cluster), np.arange(r),
                                   np.arange(ntl), indexing="ij")
        gm, lane = np.divmod(c * ntl + gl, lanes)
        if s + 1 == len(radices):
            y = np.full((n, pitch), np.nan, dtype=complex)
            kb = r_out * k + gm
            y[kb, c0 + lane] = outs if epilogue is None else epilogue(kb, lane, outs)
            return y
        r2 = radices[s + 1]
        k2, m2 = k * r, m // r2
        kk, mm = np.divmod(gm, m)
        kk2 = r_out * k + kk
        rr2, mm2 = np.divmod(mm, m2)
        w = np.exp(-2j * np.pi * rr2 * kk2 / (k2 * r2))
        rank2, local2 = fused_cuda.cluster_owner(
            n, r2, cluster, ((rr2 * k2 + kk2) * m2 + mm2) * lanes + lane, lanes)
        bufs = np.full((cluster, e), np.nan, dtype=complex)
        bufs[rank2, local2] = outs * w
        k *= r
    raise AssertionError("no stages")


def _check_tile_model(n, radices, lanes, cluster, kind, seed, n2=16):
    """K2c (the four-step P.Q twiddle in the epilogue, from the same
    fp32 tables), K4c (no twiddle) or K5 (packed pairs, twiddle) on the
    columns c0 = lanes ... 2 * lanes - 1 of an (n, n2) block: the model
    equals np.fft.fft down those columns, times the twiddle."""
    rng = np.random.default_rng(seed)
    pairs = kind == "K5"
    x = rng.standard_normal((n, 2 * n2 if pairs else n2))
    z = x[:, 0::2] + 1j * x[:, 1::2] if pairs else x + 1j * rng.standard_normal((n, n2))
    c0 = lanes
    epilogue = None
    if kind != "K4c":
        p, qq, t = four_step_cuda.four_step_tables(n, n2, 128, -1)
        p = p.astype(np.float64)
        qq = qq.astype(np.float64)

        def epilogue(k1, lane, v):
            j2 = c0 + lane
            w_p = p[j2 // t, 0, k1] + 1j * p[j2 // t, 1, k1]
            w_q = qq[0, k1, j2 % t] + 1j * qq[1, k1, j2 % t]
            return v * w_p * w_q
    y = _simulate_tile(z if not pairs else x, radices, cluster, lanes, c0,
                       pairs=pairs, epilogue=epilogue)
    cols = slice(c0, c0 + lanes)
    want = np.fft.fft(z[:, cols], axis=0)
    if kind != "K4c":
        k1, j2 = np.meshgrid(np.arange(n), np.arange(c0, c0 + lanes), indexing="ij")
        want = want * np.exp(-2j * np.pi * k1 * j2 / (n * n2))
    got = y[:, cols]
    assert np.all(np.isfinite(got)) and np.all(np.isnan(np.delete(y, cols, axis=1)))
    assert np.max(np.abs(got - want)) <= 1e-6 * np.max(np.abs(want))


@pytest.mark.parametrize("kind", ["K2c", "K4c", "K5"])
@pytest.mark.parametrize("n,radices,lanes,cluster", COL_PLANS)
def test_col_plan_model_is_the_column_pass(n, radices, lanes, cluster, kind):
    _check_tile_model(n, radices, lanes, cluster, kind, seed=lanes + cluster)


@pytest.mark.parametrize("n,radices,lanes,cluster", COL_SWEEP)
def test_col_sweep_model_is_the_column_pass(n, radices, lanes, cluster):
    kind = ("K2c", "K4c", "K5")[(n.bit_length() + lanes + cluster) % 3]
    _check_tile_model(n, radices, lanes, cluster, kind, seed=n + lanes + cluster)
