"""The stacked engine's numeric knobs in the port (``grouped``,
``complex_mult='mult3'``, ``state_dtype='bfloat16'``, the ``pretwiddle`` and
``gridslice`` engines) against the JAX package: the stage dispatch and the
tables bit for bit, kernel A's and K3's plain versions against
``fused_pallas.fused_fft`` and ``four_step_pallas.fused_fft_batch_major`` in
Pallas interpret mode.

Tolerances (``testing.metrics``): fp32 state, the agreement bounds of the
existing tests (bf16 storage: one bf16 ulp of the output scale on at most
0.1 % of elements; fp32 storage: 1e-5 relative); bf16 state, two bf16 ulps
on at most 2 % of elements, and the port's transform passes the reference
gate against the fp64 oracle.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tensorfft_tpu.fft import stage_scales
from tensorfft_tpu.ops import four_step_pallas, fused_pallas
from tensorfft_tpu_torch import plan as tplan
from tensorfft_tpu_torch.ops import dots, four_step_cuda, fused_cuda
from tensorfft_tpu_torch.testing import (agreement, deviation, fft_oracle,
                                         make_test_signal)
from tensorfft_tpu_torch.testing.metrics import (BF16_STATE_MAX_FRAC,
                                                 BF16_STATE_MAX_SCALE_ULPS)

import _strict_jax

torch.set_num_threads(1)

ALGORITHM = {"bfloat16": "bf16", "float32": "bf16x3"}
STORAGE = {"bfloat16": (torch.bfloat16, jnp.bfloat16),
           "float32": (torch.float32, jnp.float32)}
RADICES = [(2,), (256,), (16, 16), (32, 16), (2, 16), (8, 8, 8), (4, 4, 4, 4),
           (64, 64), (64, 128), (64, 256), (128, 256), (16, 256), (32, 128),
           (128, 8), (8, 128, 16), (4, 4, 4, 4, 4, 4), (2, 2, 2, 2, 2, 2, 2, 2),
           (16, 16, 16), (2, 256, 32), (256, 64), (4, 64, 64), (256, 256)]


def _signal(b, n, precision, seed=0):
    """Seeded normal rows in the storage dtype, for both packages."""
    tdt, jdt = STORAGE[precision]
    rng = np.random.default_rng(seed)
    planes = [torch.from_numpy(rng.standard_normal((b, n)).astype(np.float32))
              .to(tdt) for _ in range(2)]
    return planes, [jnp.asarray(p.float().numpy(), jdt) for p in planes]


def _np(x):
    return np.asarray(x.float().numpy() if isinstance(x, torch.Tensor) else x,
                      np.float32)


def _assert_agrees(got, want, precision, state_dtype, four_step=False):
    bf16 = precision == "bfloat16" or state_dtype == "bfloat16"
    a = agreement([_np(g) for g in got], [_np(w) for w in want], bf16=bf16)
    if state_dtype == "bfloat16":
        assert a.within(BF16_STATE_MAX_FRAC, BF16_STATE_MAX_SCALE_ULPS), a
    else:
        assert a.within(1e-2 if four_step else 1e-3), a


def _assert_gate(transform, n, precision, rows=2):
    """The reference gate on ``transform``'s output for make_test_signal
    rows (the JAX package's unit-test signal) against the fp64 oracle."""
    sig = [make_test_signal(n, 42 * s, 42 * 42 * s) for s in range(1, rows + 1)]
    planes = [np.stack([p[i] for p in sig]) for i in range(2)]
    tdt = STORAGE[precision][0]
    got = transform(*[torch.from_numpy(p).to(tdt) for p in planes])
    d = deviation([_np(g).astype(np.float64) for g in got], fft_oracle(*planes))
    assert d.passes_reference_gate(), d


@pytest.mark.parametrize("grouped", [False, True])
def test_stage_kinds_match_jax(grouped):
    # Kinds, p, the 2^24 table gate and the p clamp, the gridslice layout
    # and the mult3 fold: every one the JAX package's.
    for radices in RADICES:
        got = list(tplan.stage_kinds(radices, grouped))
        assert got == list(fused_pallas._stage_kinds(radices, grouped)), radices
        assert (tplan.gridslice_layout(radices, grouped)
                == fused_pallas.gridslice_layout(radices, grouped)), radices
        for kind, r, _, p in got:
            for cm in ("block", "mult3"):
                assert (tplan.grouped_mult3(kind, r, p, cm)
                        == fused_pallas._grouped_mult3(kind, r, p, cm))
    kinds = [k for k, *_ in tplan.stage_kinds((64, 256), grouped)]
    assert kinds == (["first", "grouped"] if grouped else ["first", "kloop"])
    # 4 * 128 * 256^2 > 2^24: (128, 256) keeps its last stage a kloop.
    assert [k for k, *_ in tplan.stage_kinds((128, 256), True)][1] == "kloop"


@pytest.mark.parametrize("algorithm", ["bf16", "bf16x3"])
@pytest.mark.parametrize("radices", [(32, 16), (8, 8, 8), (64, 256),
                                     (16, 256), (128, 256)])
def test_stage_tables_match_jax(radices, algorithm):
    # Folded (grouped) slices against the nonzero blocks of the JAX
    # block-diagonal table, the g3 table and mult3's sum of the rounded BD,
    # and the twiddle planes against the pretwiddle epilogue tables.
    scales = stage_scales(radices, "forward", True)
    for sign in (-1, 1):
        stages = fused_cuda.pass_stages(radices, "stacked", True, "mult3")
        got = fused_cuda.stage_matrices(radices, scales, sign, algorithm,
                                        stages=stages)
        want = fused_pallas.stage_table_arrays(
            radices, scales, sign, algorithm, True, complex_mult="mult3")
        kinds = list(fused_pallas._stage_kinds(radices, True))
        wi = 0
        for (kind, r, k, p), st, (mat, w) in zip(kinds, stages, got):
            table = np.asarray(want[wi], np.float32)
            wi += 1
            m = mat.float().numpy()
            if kind == "grouped" and st.mult3:
                assert np.array_equal(m.reshape(k, 3 * r, r), table)
            elif kind == "grouped":
                rows = np.arange(r) * p
                for kk in range(k):
                    blk = table[kk // p]
                    o, c = rows + kk % p, (kk % p) * r + np.arange(r)
                    pr = p * r
                    assert np.array_equal(m[kk, 0], blk[np.ix_(o, c)])
                    assert np.array_equal(m[kk, 1], blk[np.ix_(pr + o, c)])
                    assert np.array_equal(-m[kk, 1], blk[np.ix_(o, pr + c)])
                    # Off the diagonal blocks the JAX table holds zeros.
                    assert np.count_nonzero(blk) <= p * 4 * r * r
            else:
                assert np.array_equal(m[0, 0], table[:r, :r])
                assert np.array_equal(m[0, 1], table[r:, :r])
                if st.mult3:
                    s = (table[:r, :r].astype(np.float32)
                         + table[r:, :r].astype(np.float32))
                    s = np.asarray(jnp.asarray(s, want[wi - 1].dtype), np.float32)
                    assert np.array_equal(m[0, 2], s)
                if kind != "first":
                    assert np.array_equal(w[0].numpy(), np.asarray(want[wi]))
                    assert np.array_equal(w[1].numpy(), np.asarray(want[wi + 1]))
                    wi += 2
        # The pretwiddle epilogue tables hold the same W, transposed.
        epi = fused_pallas.epilogue_twiddle_tables(radices, sign)
        plain = fused_cuda.stage_matrices(radices, scales, sign, algorithm,
                                          stages=fused_cuda.pass_stages(
                                              radices, "pretwiddle"))
        for j in range(len(radices) - 1):
            w = plain[j + 1][1].numpy()
            assert np.array_equal(w[0].T, epi[j][0])
            assert np.array_equal(w[1].T, epi[j][1])


@pytest.mark.parametrize("algorithm", ["bf16", "bf16x3"])
def test_kernel_tables_layout_under_knobs(algorithm):
    # Per stage the split [term][slice][matrix][R][R] matrices, its mode,
    # flags and the pass flags after them.
    radices = (8, 128, 16)
    scales = stage_scales(radices, "forward", True)
    tables, meta = fused_cuda.kernel_tables(
        radices, scales, -1, algorithm, "default", torch.device("cpu"),
        "stacked", True, "mult3", "bfloat16")
    stages = fused_cuda.pass_stages(radices, "stacked", True, "mult3",
                                    "bfloat16")
    assert [st.kind for st in stages] == ["first", "grouped", "big"]
    n = len(radices)
    assert list(meta[1 + 4 * n:1 + 5 * n]) == [0, 3, 0]  # modes
    assert list(meta[1 + 5 * n:1 + 6 * n]) == [0, 1 + 4, 0]  # flags
    assert meta[1 + 6 * n] == 1 + 2  # bf16 state, round the input
    mats = fused_cuda.stage_matrices(radices, scales, -1, algorithm,
                                     stages=stages)
    terms = 1 if algorithm == "bf16" else 2
    for s, (mat, w) in enumerate(mats):
        _, n_terms, d_off, w_off = meta[1 + 4 * s:5 + 4 * s]
        want = [mat] if algorithm == "bf16" else dots.split_bf16(mat, terms)
        d = tables[d_off:d_off + n_terms * mat.numel()]
        assert torch.equal(d, torch.cat([t.float().reshape(-1) for t in want]))
        assert (w is None) == (w_off == 0)
    assert mats[1][0].shape == (8, 3, 128, 128)


# Kernel A's plain version under each knob against fused_pallas.fused_fft.
FUSED_CASES = [
    ((32, 16), "bfloat16", "default", dict(grouped=True)),          # p = 4
    ((32, 128), "bfloat16", "default", dict(grouped=True)),
    ((128, 8), "bfloat16", "bf16ax2", dict(complex_mult="mult3")),
    ((64, 64), "bfloat16", "default", dict(state_dtype="bfloat16")),
    ((16, 16, 16), "bfloat16", "default",
     dict(grouped=True, state_dtype="bfloat16")),
    ((8, 128, 16), "bfloat16", "default",
     dict(grouped=True, complex_mult="mult3", state_dtype="bfloat16")),
    ((16, 256), "float32", "default", dict(grouped=True, complex_mult="mult3")),
    ((4, 4, 4, 4, 4, 4), "float32", "default", dict(grouped=True)),
    ((64, 64), "float32", "default", dict(state_dtype="bfloat16")),
    ((8, 8, 8), "bfloat16", "default",
     dict(engine="pretwiddle", state_dtype="bfloat16")),
]


@pytest.mark.parametrize("radices,precision,first_dot,knobs", FUSED_CASES)
def test_fused_knobs_match_jax(radices, precision, first_dot, knobs):
    n = int(np.prod(radices))
    (re, im), (jre, jim) = _signal(2, n, precision)
    kw = dict(radices=radices, scales=stage_scales(radices, "forward", True),
              algorithm=ALGORITHM[precision], first_dot=first_dot, **knobs)
    got = fused_cuda.fused_fft(re, im, **kw)
    want = fused_pallas.fused_fft(jre.T, jim.T, interpret=True, **kw)
    sd = knobs.get("state_dtype", "float32")
    _assert_agrees(got, [w.T for w in want], precision, sd)
    if sd == "bfloat16":
        _assert_gate(lambda r, i: fused_cuda.fused_fft(r, i, **kw), n, precision)


@pytest.mark.parametrize("engine,radices,grouped", [
    ("pretwiddle", (16, 16, 16), False),
    ("pretwiddle", (4, 64, 64), True),          # a 'big' stage at K = 256
    ("gridslice", (32, 128), True),
    ("gridslice8", (8, 8, 8), False),
    ("gridslice16", (2, 64, 8), False),
])
def test_layout_engines_are_stacked(engine, radices, grouped):
    # pretwiddle (fp32 state) and every gridslice engine compute the
    # stacked function bit for bit in the port, and agree with the JAX
    # engine of the same name within the stacked bounds.
    n = int(np.prod(radices))
    (re, im), (jre, jim) = _signal(2, n, "bfloat16")
    kw = dict(radices=radices, scales=stage_scales(radices, "forward", True),
              grouped=grouped)
    got = fused_cuda.fused_fft(re, im, engine=engine, **kw)
    # pretwiddle runs with grouping off (fused_pallas.py:520).
    stacked = fused_cuda.fused_fft(
        re, im, **dict(kw, grouped=grouped and engine != "pretwiddle"))
    for g, s in zip(got, stacked):
        assert torch.equal(g, s)
    want = fused_pallas.fused_fft(jre.T, jim.T, engine=engine, interpret=True,
                                  **kw)
    _assert_agrees(got, [w.T for w in want], "bfloat16", "float32")


@pytest.mark.parametrize("engine,radices,grouped", [
    ("gridslice", (64,), False),        # one stage: no slices to emit
    ("gridslice16", (8, 8, 8), False),  # S = 64
    ("gridslice16", (16, 8), False),    # S = 16
    ("gridslice", (4, 4), False),       # S = 4 is not a multiple of 8
    ("gridslice", (32, 16), True),      # last stage grouped with p = 4
    ("gridslice", (2, 256, 256), False),  # last stage 'big'
])
def test_gridslice_gate_is_the_jax_gate(engine, radices, grouped):
    n = int(np.prod(radices))
    x = torch.zeros(1, n, dtype=torch.bfloat16)
    kw = dict(radices=radices, scales=(1.0,) * len(radices), engine=engine,
              grouped=grouped)
    try:
        fused_pallas.fused_fft(jnp.zeros((n, 1), jnp.bfloat16),
                               jnp.zeros((n, 1), jnp.bfloat16), interpret=True,
                               **kw)
        jax_raises = False
    except ValueError:
        jax_raises = True
    if jax_raises:
        with pytest.raises(ValueError, match="unsupported"):
            fused_cuda.fused_fft(x, x, **kw)
    else:
        fused_cuda.fused_fft(x, x, **kw)


@pytest.mark.parametrize("knobs", [dict(grouped=True),
                                   dict(state_dtype="bfloat16"),
                                   dict(grouped=True, complex_mult="mult3")])
def test_batch_major_knobs_match_jax(knobs):
    radices = (32, 128) if "complex_mult" in knobs else (16, 32)
    n = int(np.prod(radices))
    (re, im), (jre, jim) = _signal(8, n, "bfloat16")
    kw = dict(radices=radices, scales=stage_scales(radices, "forward", True),
              algorithm="bf16", **knobs)
    got = four_step_cuda.fused_fft_batch_major(re, im, **kw)
    want = four_step_pallas.fused_fft_batch_major(jre, jim, interpret=True, **kw)
    sd = knobs.get("state_dtype", "float32")
    _assert_agrees(got, want, "bfloat16", sd)
    if sd == "bfloat16":
        _assert_gate(lambda r, i: four_step_cuda.fused_fft_batch_major(
            r, i, **kw), n, "bfloat16", rows=8)


def test_float32_mult3_bf16_state_matches_jax():
    # Under a split algorithm mult3's z_re + z_im is rounded to the bf16
    # state (fused_pallas._mult3 sums two bf16 arrays); XLA on the CPU keeps
    # such sums in fp32 unless told otherwise (_strict_jax).
    calls, ports = [], []
    for radices in [(16, 256), (2, 256, 32)]:
        n = int(np.prod(radices))
        (re, im), _ = _signal(2, n, "float32")
        kw = dict(radices=radices, scales=stage_scales(radices, "forward", True),
                  algorithm="bf16x3", complex_mult="mult3",
                  state_dtype="bfloat16")
        ports.append(fused_cuda.fused_fft(re, im, **kw))
        _assert_gate(lambda r, i: fused_cuda.fused_fft(r, i, **kw), n, "float32")
        calls.append(_strict_jax.call("tensorfft_tpu.ops.fused_pallas.fused_fft",
                                      (re.numpy().T, im.numpy().T), "float32",
                                      interpret=True, **kw))
    for got, want in zip(ports, _strict_jax.run(calls)):
        _assert_agrees(got, [w.T for w in want], "float32", "bfloat16")
