"""Kernel A's module (ops/fused_cuda.py) against the JAX fused Pallas kernel.

On the CPU ``fused_cuda.fused_fft`` runs its plain-torch version; the JAX
kernel runs in Pallas interpret mode.  The port is batch-major, so the
comparison is ``fused_fft(x)`` against ``fused_pallas.fused_fft(x.T).T``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tensorfft_tpu as tfft
from tensorfft_tpu.fft import stage_scales
from tensorfft_tpu.ops import fused_pallas
from tensorfft_tpu_torch.ops import dots, fused_cuda
from tensorfft_tpu_torch.testing import agreement

torch.set_num_threads(1)

ALGORITHM = {"bfloat16": "bf16", "float32": "bf16x3"}
STORAGE = {"bfloat16": (torch.bfloat16, jnp.bfloat16),
           "float32": (torch.float32, jnp.float32)}


def _inputs(b, n, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, n)).astype(np.float32),
            rng.standard_normal((b, n)).astype(np.float32))


def _run_both(n, b, precision, forward, radices=None, seed=0):
    plan = tfft.create_plan(n, precision=precision, radices=radices)
    algorithm = ALGORITHM[precision]
    sign = -1 if forward else 1
    scales = stage_scales(plan.radices, "forward", forward)
    tdt, jdt = STORAGE[precision]
    re, im = _inputs(b, n, seed)
    re_t = torch.from_numpy(re).to(tdt)
    im_t = torch.from_numpy(im).to(tdt)
    got = fused_cuda.fused_fft(
        re_t, im_t, radices=plan.radices, scales=scales, sign=sign,
        algorithm=algorithm, first_dot=plan.first_dot)
    # The JAX kernel sees exactly the port's storage-rounded inputs.
    j_re = jnp.asarray(re_t.float().numpy(), jdt).T
    j_im = jnp.asarray(im_t.float().numpy(), jdt).T
    want = fused_pallas.fused_fft(
        j_re, j_im, radices=plan.radices, scales=scales, sign=sign,
        algorithm=algorithm, first_dot=plan.first_dot, interpret=True)
    assert got[0].dtype is tdt and got[0].shape == (b, n)
    return ([g.float().numpy() for g in got],
            [np.asarray(w.T, np.float32) for w in want])


@pytest.mark.parametrize("precision", ["bfloat16", "float32"])
@pytest.mark.parametrize("forward", [True, False])
@pytest.mark.parametrize("n", [256, 1024, 4096])
def test_fused_matches_jax(n, forward, precision):
    got, want = _run_both(n, 4, precision, forward)
    a = agreement(got, want, bf16=precision == "bfloat16")
    assert a.within(), a


def test_fused_radix_mix_matches_jax():
    # Three stages: a first stage and two twiddled stages.
    got, want = _run_both(512, 3, "bfloat16", True, radices=(4, 8, 16), seed=3)
    a = agreement(got, want, bf16=True)
    assert a.within(), a


def test_block_dft_tables_identical():
    radices, scales = (16, 64), (1 / 16, 1 / 64)
    for sign in (-1, 1):
        got = fused_cuda.block_dft_tables(radices, scales, sign)
        want = fused_pallas.block_dft_tables(radices, scales, sign)
        for g_stage, w_stage in zip(got, want):
            for g, w in zip(g_stage, w_stage):
                assert (g is None and w is None) or np.array_equal(g, w)


@pytest.mark.parametrize("algorithm,first_dot", [
    ("bf16", "default"), ("bf16", "bf16ax2"), ("bf16x3", "default"),
])
def test_stage_table_arrays_identical(algorithm, first_dot):
    # The stacked engine's tables (stage_matrices) hold the JAX tables'
    # values bit for bit: D_re and D_im as the blocks of its BD, in its
    # dtype, and every stage's twiddle after the first.
    radices, scales = (32, 64, 8), (1 / 32, 1 / 64, 1 / 8)
    got = fused_cuda.stage_matrices(radices, scales, -1, algorithm, first_dot)
    want = iter(fused_pallas.stage_table_arrays(radices, scales, -1, algorithm,
                                                False, first_dot=first_dot))
    for j, ((mat, w), r) in enumerate(zip(got, radices)):
        bd = next(want)
        assert mat.shape == (1, 2, r, r)
        assert str(mat.dtype).split(".")[-1] == str(bd.dtype)
        bd = np.asarray(bd, np.float32)
        assert np.array_equal(mat[0, 0].float().numpy(), bd[:r, :r])
        assert np.array_equal(mat[0, 1].float().numpy(), bd[r:, :r])
        assert np.array_equal(-bd[r:, :r], bd[:r, r:])
        if j == 0:
            assert w is None
        else:
            assert np.array_equal(w[0].numpy(), np.asarray(next(want)))
            assert np.array_equal(w[1].numpy(), np.asarray(next(want)))
    assert next(want, None) is None


@pytest.mark.parametrize("algorithm,first_dot,terms", [
    ("bf16", "default", (1, 1)), ("bf16", "bf16ax2", (2, 1)),
    ("bf16x3", "default", (2, 2)), ("bf16x6", "default", (3, 3)),
])
def test_kernel_tables_layout(algorithm, first_dot, terms):
    # The flat kernel table holds, per stage, the split terms of D_re and
    # D_im and the (2, R, K) twiddle, at meta's offsets.
    radices, scales = (8, 32), (1 / 8, 1 / 32)
    tables, meta = fused_cuda.kernel_tables(radices, scales, -1, algorithm,
                                            first_dot, torch.device("cpu"))
    mats = fused_cuda.stage_matrices(radices, scales, -1, algorithm, first_dot)
    assert meta[0] == len(radices)
    for s, r in enumerate(radices):
        radix, n_terms, d_off, w_off = meta[1 + 4 * s: 5 + 4 * s]
        assert radix == r and n_terms == terms[s]
        d = tables[d_off:d_off + n_terms * 2 * r * r].reshape(n_terms, 2, r, r)
        m = mats[s][0][0].float()
        want = ([m] if n_terms == 1 and algorithm == "bf16"
                else dots.split_bf16(m, n_terms))
        for t in range(n_terms):
            assert torch.equal(d[t], want[t].float())
        if s > 0:
            k = radices[0]
            w = tables[w_off:w_off + 2 * r * k].reshape(2, r, k)
            assert torch.equal(w, mats[s][1])


@pytest.mark.parametrize("knob", [
    dict(state_dtype="float16"), dict(complex_mult="gauss"),
    dict(engine="bogus"), dict(engine="gridslice"),
])
def test_unported_knobs_raise(knob):
    # Every knob value FFTPlan accepts runs (tests/test_torch_knobs.py); a
    # value it rejects raises ValueError, as does a gridslice engine whose
    # last stage emits no whole slices (fused_pallas.py:895-905).
    x = torch.zeros(2, 64, dtype=torch.bfloat16)
    with pytest.raises(ValueError):
        fused_cuda.fused_fft(x, x, radices=(64,), scales=(1 / 64,), **knob)


def test_non_cpu_non_cuda_tensor_raises():
    # No silent fallback: only CPU tensors take the plain version.
    x = torch.empty(2, 64, dtype=torch.bfloat16, device="meta")
    with pytest.raises(ValueError, match="CUDA tensors"):
        fused_cuda.fused_fft(x, x, radices=(64,), scales=(1 / 64,))
    assert fused_cuda.fused_fft.launches == 0


def test_smem_budget():
    assert fused_cuda.cta_smem_bytes(16384, 1, "bf16") == 65536
    assert fused_cuda.cta_smem_bytes(16384, 1, "bf16x3") == 131072
    assert fused_cuda.cta_smem_bytes(16384, 1, "bf16x6") == 196608
    assert fused_cuda.cta_smem_bytes(32768, 1, "bf16") is None
    assert fused_cuda.cta_smem_bytes(256, 64, "bf16") == 65536
