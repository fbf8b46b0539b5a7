"""Kernels B and C on the tensor-core engine, on the CPU: their operands,
their summation order and their launchers.

Every one-CTA four-step pass (kernels B and C, K4's column pass, K5, K6)
reads its matrices as bf16 in each stage's route layout
(``fused_cuda.mma_tables``).  These tests hold that buffer entry for entry
against the fp32 ``kernel_tables`` at the four-step passes' radices and
knobs; model the tensor-core summation order of a column pass (k-chunks of
8 rows, the fp32 P.Q twiddle applied before the one rounding to the
storage dtype) followed by a transposed row pass, and hold the model
against the JAX package's ``four_step_fft`` (Pallas interpret mode); and,
with ``launch`` replaced by a recorder, check that the launchers pass the
bf16 matrices on one CTA and to the cluster twins, with as many arguments
as the entry points' ``_SIGNATURES`` declare.

Tolerance of the order model against JAX: the four-step bound of
``tests/test_torch_four_step.py``, one bf16 ulp of the output scale on at
most 1 % of elements (fp32 storage: 1e-5 relative on as many).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tensorfft_tpu as tfft
from tensorfft_tpu.fft import four_step_call_kwargs as j_kwargs
from tensorfft_tpu.ops import four_step_pallas
import tensorfft_tpu_torch as tt
from tensorfft_tpu_torch.fft import four_step_call_kwargs as t_kwargs
from tensorfft_tpu_torch.ops import _build, four_step_cuda, fused_cuda
from tensorfft_tpu_torch.testing import agreement
from tensorfft_tpu_torch.testing.metrics import FOUR_STEP_MAX_FRAC
from test_torch_mma_tables import ALGORITHM, KNOBS, _check_buffer, _order_model

torch.set_num_threads(1)

# The passes' radices under the default plans (2^20: (256,) and (64, 64);
# 32768: (128,) and (256,); 4096^2's K4: (64, 64)) and the PERF.md knob
# plans ((32, 64), (32, 32): the grouped four-step and planar splits).
PASS_RADICES = [(256,), (64, 64), (32, 64), (128,), (32, 32)]


@pytest.mark.parametrize("radices", PASS_RADICES, ids=str)
@pytest.mark.parametrize("precision", ["bfloat16", "float32", "float32_x6"])
def test_pass_tables_equal_fp32(precision, radices):
    _check_buffer(radices, ALGORITHM[precision])


@pytest.mark.parametrize("knobs", KNOBS, ids=lambda k: ",".join(
    f"{a}={b}" for a, b in k.items()))
@pytest.mark.parametrize("precision", ["bfloat16", "float32"])
def test_pass_tables_equal_fp32_knobs(precision, knobs):
    for radices in PASS_RADICES:
        _check_buffer(radices, ALGORITHM[precision], **knobs)


@pytest.mark.parametrize("n", [1 << 15, 1 << 20, 1 << 23])
def test_default_pass_plans_tables_equal_fp32(n):
    # The default four-step plans' column and row radices, both policies.
    for precision in ("bfloat16", "float32"):
        plan = tt.create_plan(n, precision=precision)
        for radices in (plan.col_radices, plan.row_radices):
            _check_buffer(radices, ALGORITHM[precision], first_dot=plan.first_dot)


# -- the summation order of the two passes, modelled in plain torch ----------

def _four_step_model(re, im, kw):
    """Kernel B then kernel C with every stage product in the tensor-core
    order (``_order_model``): the column pass's fp32 stage output times
    the fp32 P.Q twiddle, rounded once to the storage dtype as ``mid``; the
    row pass's output stored transposed, rounded once."""
    b = re.shape[0]
    n1, n2 = kw["n1"], kw["n2"]
    cols = lambda x: x.reshape(b, n1, n2).transpose(1, 2).reshape(b * n2, n1)
    s_re, s_im = _order_model(cols(re), cols(im), kw["radices1"], kw["scales1"],
                              kw["sign"], kw["algorithm"], kw["first_dot"])
    s_re = s_re.reshape(b, n2, n1).transpose(1, 2)
    s_im = s_im.reshape(b, n2, n1).transpose(1, 2)
    w_re, w_im = four_step_cuda._twiddle(n1, n2, kw["lane_tile"], kw["sign"],
                                         re.device)
    mid_re = (s_re * w_re - s_im * w_im).to(re.dtype).reshape(b * n1, n2)
    mid_im = (s_re * w_im + s_im * w_re).to(re.dtype).reshape(b * n1, n2)
    o_re, o_im = _order_model(mid_re, mid_im, kw["radices2"], kw["scales2"],
                              kw["sign"], kw["algorithm"], kw["first_dot"])
    out = lambda s: s.reshape(b, n1, n2).transpose(1, 2).reshape(b, n1 * n2)
    return out(o_re).to(re.dtype), out(o_im).to(re.dtype)


STORAGE = {"bfloat16": (torch.bfloat16, jnp.bfloat16),
           "float32": (torch.float32, jnp.float32)}


@pytest.mark.parametrize("precision", ["bfloat16", "float32"])
@pytest.mark.parametrize("n,max_fused", [(4096, 64), (32768, 16384)])
def test_mma_order_four_step_matches_jax(n, max_fused, precision):
    # Splits (64, 64) and (128, 256): every stage on the mma route.
    tplan = tt.create_plan(n, precision=precision, max_fused_length=max_fused)
    jplan = tfft.create_plan(n, precision=precision, max_fused_length=max_fused)
    kw = t_kwargs(tplan, True)
    assert min(kw["radices1"] + kw["radices2"]) >= 8
    tdt, jdt = STORAGE[precision]
    rng = np.random.default_rng(n)
    re, im = (torch.from_numpy(rng.standard_normal((2, n)).astype(np.float32)).to(tdt)
              for _ in range(2))
    got = _four_step_model(re, im, kw)
    want = four_step_pallas.four_step_fft(
        jnp.asarray(re.float().numpy(), jdt), jnp.asarray(im.float().numpy(), jdt),
        **j_kwargs(jplan, True), interpret=True)
    a = agreement([g.float().numpy() for g in got],
                  [np.asarray(w, np.float32) for w in want],
                  bf16=precision == "bfloat16")
    assert a.within(FOUR_STEP_MAX_FRAC), a


# -- the launchers: bf16 matrices but on kernel B's cluster twin -------------

@pytest.fixture
def recorded(monkeypatch):
    """Replace the C launch with a recorder of (symbol, tensors, codes,
    args); CPU tensors then reach the launchers' operand code."""
    calls = []
    monkeypatch.setattr(four_step_cuda, "launch",
                        lambda symbol, tensors, codes, *args:
                        calls.append((symbol, tensors, codes, args)))
    monkeypatch.setattr(four_step_cuda, "check_kernel_operands",
                        lambda *a, **k: None)
    return calls


def _pass_case(symbol, n1, n2):
    """(launcher, its arguments, the pass's stages' radices) of one pass
    over (1, n1, n2) bf16 planes with the default plans' radices."""
    r1 = tt.create_plan(n1, max_fused_length=max(n1, 16384)).radices
    r2 = tt.create_plan(n2, max_fused_length=max(n2, 16384)).radices
    re = torch.zeros(1, n1 * n2, dtype=torch.bfloat16)
    planes = (re, re.clone())
    knobs = four_step_cuda._knobs("stacked", False, "block", "float32")
    scales = lambda r: tuple(1.0 / x for x in r)
    col = symbol in ("tfft_four_step_col", "tfft_four_step_col_packed",
                     "tfft_fft2_col")
    if col:
        src = (torch.zeros(1, 2 * n1 * n2, dtype=torch.bfloat16),) if \
            symbol.endswith("packed") else planes
        lane_tile = None if symbol == "tfft_fft2_col" else 128
        args = (symbol, src, planes, "bf16", n1, n2, r1, scales(r1), -1,
                lane_tile, "default", knobs)
        return four_step_cuda._col_launch, args, r1
    dst = (torch.zeros(1, 2 * n1 * n2, dtype=torch.bfloat16),) if \
        symbol.endswith("interleave") else planes
    args = (symbol, planes, dst, "bf16", n1, n2, r2, scales(r2), -1,
            "default", knobs)
    return four_step_cuda._row_launch, args, r2


PASS_SYMBOLS = ["tfft_four_step_col", "tfft_four_step_col_packed",
                "tfft_fft2_col", "tfft_four_step_row",
                "tfft_four_step_row_interleave", "tfft_fft2_row"]


@pytest.mark.parametrize("cluster", [False, True], ids=["one_cta", "cluster"])
@pytest.mark.parametrize("symbol", PASS_SYMBOLS)
def test_launch_passes_mats_on_one_cta(recorded, symbol, cluster):
    # One CTA: a 64-point pass; a cluster: a 32768-point pass (2 CTAs per
    # row; a column pass a tile of adjacent columns per cluster,
    # fused_cuda.column_cluster).  Every launch, one CTA or a cluster, takes
    # the bf16 matrices of the tensor-core engine.
    col = "col" in symbol
    long, short = 32768 if cluster else 64, 64
    n1, n2 = (long, short) if col else (short, long)
    fn, args, radices = _pass_case(symbol, n1, n2)
    variant = fn(*args)
    (name, tensors, codes, rest), = recorded
    assert name == symbol
    assert len(tensors) + len(codes) + len(rest) + 1 == len(_build._SIGNATURES[symbol])
    batch, p1, p2, lanes, n_cluster, tables, mats, meta = rest[:8]
    assert (batch, p1, p2) == (1, n1, n2)
    assert len(rest) == (11 if symbol in ("tfft_four_step_col",
                                          "tfft_four_step_col_packed") else 8)
    knobs = ("stacked", False, "block", "float32", True)
    key = (tuple(radices), tuple(1.0 / r for r in radices), -1, "bf16",
           "default", torch.device("cpu"))
    if cluster and col:
        want_lanes, want_cluster = fused_cuda.column_cluster(
            n1, 1, n2, "bf16", fused_cuda.pass_stages(tuple(radices)), "test")
        assert want_cluster > 1
        assert (n_cluster, lanes, variant) == (want_cluster, want_lanes,
                                               f"cluster{want_cluster}")
        want_tables, want_meta, want_mats = fused_cuda.mma_tables(*key, *knobs)
        assert mats is not None and mats == want_mats.data_ptr()
    elif cluster:
        assert (n_cluster, lanes, variant) == (2, 1, "cluster2")
        want_tables, want_meta, want_mats = fused_cuda.mma_tables(*key, *knobs)
        assert mats == want_mats.data_ptr()
    else:
        assert n_cluster == 1 and variant == "mma"
        want_tables, want_meta, want_mats = fused_cuda.mma_tables(*key, *knobs)
        assert mats == want_mats.data_ptr()
    assert tables == want_tables.data_ptr()
    assert meta == want_meta.ctypes.data
