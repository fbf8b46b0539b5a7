"""The N-D path of the port (fft.fftn_split and its wrappers, K4's module
ops/four_step_cuda.fft2_*, rfft.rfftn_split, models/fft_conv.fft_convolve_2d)
against the JAX package, whose Pallas kernels run in interpret mode.  On the
CPU the port runs the plain-torch versions of its kernels."""
import dataclasses
import importlib
import inspect

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tensorfft_tpu as tfft
from tensorfft_tpu.models import fft_conv as j_conv
from tensorfft_tpu.ops import four_step_pallas
import tensorfft_tpu_torch as tt
from tensorfft_tpu_torch.fft import stage_scales
from tensorfft_tpu_torch.ops import four_step_cuda, fused_cuda
from tensorfft_tpu_torch.testing import agreement
from tensorfft_tpu_torch.testing.metrics import F32_REL_TOL, FOUR_STEP_MAX_FRAC

# The packages export functions named rfft, which shadow the modules.
j_rfft = importlib.import_module("tensorfft_tpu.rfft")

torch.set_num_threads(1)

STORAGE = {"bfloat16": (torch.bfloat16, jnp.bfloat16),
           "float32": (torch.float32, jnp.float32)}
PRECISIONS = ["bfloat16", "float32"]
SCALINGS = ["forward", "none", "ortho"]
# (B, H, W) planes of K4: the h = 8 edge, wide and tall, an odd batch.
K4_SHAPES = [(1, 8, 16), (2, 64, 128), (3, 128, 256), (1, 512, 8)]
# (shape, axes) of the N-D entry points: the 2D branch (K4) for the last two
# axes, the 3-D/4-D peel, and the per-axis loop for other axes.
ND_CASES = [
    ((64, 128), (-2, -1)),
    ((8, 512), (-2, -1)),
    ((512, 8), (-2, -1)),
    ((3, 64, 256), (-2, -1)),
    ((2, 2, 32, 64), None),
    ((16, 32, 64), None),
    ((16, 32, 64), (0,)),
    ((16, 32, 64), (0, 2)),
    ((16, 32, 64), (-2, -1)),
]
# Every transform length the tests of this file plan (rfftn's half length 8
# included), for the tuning="auto" check.
LENGTHS = [2, 4, 8, 16, 32, 64, 128, 256, 512]


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


def _agree(got, want, precision, passes=1):
    """``agreement`` at the four-step fraction.  Under float32 the bound is
    F32_REL_TOL per transform pass: bf16x3 splits each operand into two bf16
    terms, and a one-ulp fp32 difference (summation order; XLA's FMA
    contraction on the CPU) can flip the rounding of the low term, ~2^-17 of
    the element, once per pass."""
    a = agreement([_np(g) for g in got], [_np(w) for w in want],
                  bf16=precision == "bfloat16")
    if precision == "bfloat16":
        assert a.within(FOUR_STEP_MAX_FRAC), a
    else:
        assert a.max_rel_err <= F32_REL_TOL * passes, a


def _fields(plan):
    d = dataclasses.asdict(plan)
    d["precision"] = plan.precision.value
    d["strategy"] = plan.strategy.value
    return d


@pytest.mark.parametrize("scaling", SCALINGS)
@pytest.mark.parametrize("forward", [True, False])
@pytest.mark.parametrize("precision", PRECISIONS)
@pytest.mark.parametrize("shape", K4_SHAPES)
def test_fft2_fused_matches_jax(shape, precision, forward, scaling):
    b, h, w = shape
    kw = dict(precision=precision, scaling=scaling)
    ph, pw = tt.create_plan(h, **kw), tt.create_plan(w, **kw)
    (re, jre), (im, jim) = _planes(shape, precision, seed=b + h + w)
    args = dict(radices1=ph.radices, radices2=pw.radices,
                scales1=stage_scales(ph.radices, scaling, forward),
                scales2=stage_scales(pw.radices, scaling, forward),
                sign=-1 if forward else 1,
                algorithm=ph.precision.dot_algorithm)
    got = four_step_cuda.fft2_fused(re, im, **args)
    assert got[0].dtype is re.dtype and got[0].shape == shape
    _agree(got, four_step_pallas.fft2_fused(jre, jim, **args, interpret=True),
           precision)
    # The wrapper on CPU tensors is the two plain passes composed.
    for g, p in zip(got, four_step_cuda.fft2_fused_reference(re, im, **args)):
        assert torch.equal(g, p)


def test_fft2_passes_are_the_1d_transforms():
    # The column pass is kernel A's plain version down each column (no
    # twiddle), the row pass the same along each row, stored in place.
    b, h, w = 2, 16, 32
    (re, _), (im, _) = _planes((b, h, w), "float32", seed=5)
    ph, pw = tt.create_plan(h), tt.create_plan(w)
    col = dict(radices1=ph.radices, scales1=stage_scales(ph.radices, "forward", True))
    row = dict(radices2=pw.radices, scales2=stage_scales(pw.radices, "forward", True))
    m_re, m_im = four_step_cuda.fft2_column_pass(re, im, **col)
    cols = lambda x: x.transpose(1, 2).reshape(b * w, h)
    c_re, c_im = fused_cuda.fused_fft_reference(
        cols(re), cols(im), radices=col["radices1"], scales=col["scales1"])
    torch.testing.assert_close(m_re, c_re.reshape(b, w, h).transpose(1, 2))
    torch.testing.assert_close(m_im, c_im.reshape(b, w, h).transpose(1, 2))
    o_re, o_im = four_step_cuda.fft2_row_pass(m_re, m_im, **row)
    r_re, r_im = fused_cuda.fused_fft_reference(
        m_re.reshape(b * h, w), m_im.reshape(b * h, w),
        radices=row["radices2"], scales=row["scales2"])
    torch.testing.assert_close(o_re, r_re.reshape(b, h, w))
    torch.testing.assert_close(o_im, r_im.reshape(b, h, w))


def test_fft2_wrappers_check_their_operands():
    x = torch.zeros(1, 8, 16)
    kw = dict(radices1=(8,), scales1=(1 / 8,))
    with pytest.raises(ValueError, match="radices"):
        four_step_cuda.fft2_column_pass(x, x, radices1=(4,), scales1=(0.25,))
    with pytest.raises(ValueError, match="radices"):
        four_step_cuda.fft2_row_pass(x, x, radices2=(8,), scales2=(1 / 8,))
    with pytest.raises(ValueError, match="B, H, W"):
        four_step_cuda.fft2_column_pass(x[0], x[0], **kw)
    with pytest.raises(ValueError, match="dtype"):
        four_step_cuda.fft2_column_pass(x, x.double(), **kw)
    with pytest.raises(ValueError, match="engine"):
        four_step_cuda.fft2_fused(x, x, radices1=(8,), radices2=(16,),
                                  scales1=(1.0,), scales2=(1.0,),
                                  grouped=(False, True), engine="bogus")


@pytest.mark.parametrize("precision", PRECISIONS)
@pytest.mark.parametrize("shape,axes", ND_CASES)
def test_fftn_split_matches_jax(shape, axes, precision):
    (re, jre), (im, jim) = _planes(shape, precision, seed=sum(shape))
    got = tt.fftn_split(re, im, axes=axes, precision=precision)
    want = tfft.fftn_split(jre, jim, axes=axes, precision=precision)
    assert got[0].shape == shape
    assert got[0].dtype is STORAGE[precision][0]
    passes = len(shape if axes is None else axes)
    _agree(got, want, precision, passes)
    # Both inverses take the port's spectrum.
    back = tt.ifftn_split(*got, axes=axes, precision=precision)
    spec = [jnp.asarray(g.float().numpy(), STORAGE[precision][1]) for g in got]
    _agree(back, tfft.ifftn_split(*spec, axes=axes, precision=precision),
           precision, passes)


@pytest.mark.parametrize("shape,axes", ND_CASES)
def test_fft2_dispatch_matches_jax(shape, axes, monkeypatch):
    calls = {"jax": 0, "port": 0}

    def spy(module, key):
        original = module.fft2_fused

        def counted(*args, **kwargs):
            calls[key] += 1
            return original(*args, **kwargs)
        monkeypatch.setattr(module, "fft2_fused", counted)

    spy(four_step_pallas, "jax")
    spy(four_step_cuda, "port")
    (re, jre), (im, jim) = _planes(shape, "float32", seed=1)
    tt.fftn_split(re, im, axes=axes, precision="float32")
    tfft.fftn_split(jre, jim, axes=axes, precision="float32")
    assert calls["port"] == calls["jax"]
    # Exactly the cases that include both trailing axes run K4.
    nd = len(shape)
    trailing = axes is None or {nd - 2, nd - 1} <= {a % nd for a in axes}
    assert calls["port"] == int(trailing)


@pytest.mark.parametrize("precision", PRECISIONS)
@pytest.mark.parametrize("n", LENGTHS)
def test_auto_tuning_plans_untuned_on_cpu(n, precision):
    # The JAX N-D paths plan with tuning="auto"; its cache holds no entry for
    # the CPU platform, so it plans exactly what the port's untuned
    # create_plan plans.
    auto = tfft.create_plan(n, precision=precision, tuning="auto")
    assert _fields(auto) == _fields(tfft.create_plan(n, precision=precision))
    assert _fields(auto) == _fields(tt.create_plan(n, precision=precision))


@pytest.mark.parametrize("precision", PRECISIONS)
@pytest.mark.parametrize("shape", [(64, 64), (16, 64, 64)])
def test_fftn_split_reads_the_tuner_cache(shape, precision, tmp_path, monkeypatch):
    # A cache entry for length 64 (cpu platform) sends both K4 passes through
    # planar_vpu with radices (8, 8); the JAX package reads the same file.
    from tensorfft_tpu_torch.tuning import TunerCache

    path = tmp_path / "cache.json"
    cache = TunerCache(path)
    cache.put(64, precision, "cpu", {"strategy": "fused", "radices": [8, 8],
                                     "engine": "planar_vpu"})
    cache.save()
    monkeypatch.setenv("TENSORFFT_TUNER_CACHE", str(path))
    engines = []
    original = four_step_cuda.fft2_fused

    def spy(*args, **kwargs):
        engines.append((kwargs["engine"], kwargs["radices1"], kwargs["radices2"]))
        return original(*args, **kwargs)
    monkeypatch.setattr(four_step_cuda, "fft2_fused", spy)
    (re, jre), (im, jim) = _planes(shape, precision, seed=64)
    got = tt.fftn_split(re, im, precision=precision)
    assert engines == [("planar_vpu", (8, 8), (8, 8))]
    _agree(got, tfft.fftn_split(jre, jim, precision=precision), precision,
           len(shape))
    # An explicit tuning= overrides the cache.
    tt.fftn_split(re, im, precision=precision, tuning={})
    assert engines[-1] == ("stacked", (64,), (64,))


@pytest.mark.parametrize("precision", PRECISIONS)
def test_fftn_split_with_plans_dict(precision):
    # A plans= dict skips the 2D branch: the per-axis loop runs the given
    # plans (the bf16 ones at these lengths with the bf16ax2 first stage).
    kw = dict(precision=precision, scaling="ortho")
    t_plans = {n: tt.create_plan(n, **kw) for n in (64, 128)}
    j_plans = {n: tfft.create_plan(n, **kw) for n in (64, 128)}
    for n in t_plans:
        assert _fields(t_plans[n]) == _fields(j_plans[n])
    (re, jre), (im, jim) = _planes((64, 128), precision, seed=9)
    got = tt.fftn_split(re, im, axes=(-2, -1), plans=t_plans)
    _agree(got, tfft.fftn_split(jre, jim, axes=(-2, -1), plans=j_plans),
           precision)
    back = tt.ifftn_split(*got, axes=(-2, -1), plans=t_plans)
    x = np.stack([_np(re), _np(im)])
    tol = 2e-2 if precision == "bfloat16" else 3e-4
    assert np.abs(np.stack([_np(b) for b in back]) - x).max() <= tol * np.abs(x).max()


def test_fftn_non_power_of_two_raises():
    x = torch.ones(48, 64)
    with pytest.raises(ValueError):
        tt.fftn_split(x, x, axes=(-2, -1))
    with pytest.raises(ValueError):
        tt.fftn_split(torch.ones(64, 48), torch.ones(64, 48), axes=(-2, -1))
    with pytest.raises(ValueError, match="shape mismatch"):
        tt.fftn_split(torch.ones(8, 8), torch.ones(8, 16))


@pytest.mark.parametrize("precision", PRECISIONS)
def test_host_wrappers_match_numpy(precision):
    rng = np.random.default_rng(10)
    x = rng.standard_normal((4, 32, 64)) + 1j * rng.standard_normal((4, 32, 64))
    tol = 1e-2 if precision == "bfloat16" else 1e-4
    for fn, want in ((tt.fftn, np.fft.fftn(x) / x.size),
                     (tt.fft2, np.fft.fft2(x) / (32 * 64))):
        got = fn(x, device="cpu", precision=precision)
        assert got.dtype == np.complex64 and got.shape == x.shape
        assert np.abs(got - want).max() <= tol * np.abs(want).max()
    back = tt.ifft2(tt.fft2(x, device="cpu", precision=precision),
                    device="cpu", precision=precision)
    assert np.abs(back - x).max() <= 5 * tol * np.abs(x).max()
    back = tt.ifftn(tt.fftn(x, device="cpu", precision=precision),
                    device="cpu", precision=precision)
    assert np.abs(back - x).max() <= 5 * tol * np.abs(x).max()


def test_nd_host_wrappers_default_to_the_card():
    for fn in (tt.fftn, tt.ifftn, tt.fft2, tt.ifft2, tt.rfftn, tt.irfftn):
        assert inspect.signature(fn).parameters["device"].default == "cuda"


@pytest.mark.parametrize("precision", PRECISIONS)
@pytest.mark.parametrize("axes", [None, (0, 2), (-1,)])
def test_rfftn_split_matches_jax(axes, precision):
    shape = (4, 8, 16)
    (x, jx), = _planes(shape, precision, seed=21, count=1)
    got = tt.rfftn_split(x, axes=axes, precision=precision)
    want = j_rfft.rfftn_split(jx, axes=axes, precision=precision)
    assert got[0].shape == (4, 8, 9)
    _agree(got, want, precision)
    back = tt.irfftn_split(*got, axes=axes, precision=precision)
    spec = [jnp.asarray(g.float().numpy()) for g in got]
    _agree([back], [j_rfft.irfftn_split(*spec, axes=axes, precision=precision)],
           precision)
    # Against numpy: rfftn over the same axes, scaled by their sizes.
    ax = (0, 1, 2) if axes is None else tuple(a % 3 for a in axes)
    x64 = _np(x)
    ref = np.fft.rfftn(x64, axes=ax) / np.prod([shape[a] for a in ax])
    tol = 1e-2 if precision == "bfloat16" else 1e-5
    got_c = _np(got[0]) + 1j * _np(got[1])
    assert np.abs(got_c - ref).max() <= tol * np.abs(ref).max()
    rt = 2e-2 if precision == "bfloat16" else 3e-4
    assert np.abs(_np(back) - x64).max() <= rt * np.abs(x64).max()


def test_rfftn_host_wrappers_round_trip():
    x = np.random.default_rng(22).standard_normal((8, 32)).astype(np.float32)
    spec = tt.rfftn(x, device="cpu", precision="float32")
    assert spec.dtype == np.complex64 and spec.shape == (8, 17)
    np.testing.assert_allclose(spec, np.fft.rfftn(x) / x.size,
                               atol=1e-5 * np.abs(spec).max())
    back = tt.irfftn(spec, device="cpu", precision="float32")
    assert back.dtype == np.float32 and back.shape == x.shape
    np.testing.assert_allclose(back, x, atol=3e-4 * np.abs(x).max())


def test_rfftn_requires_the_last_axis():
    x = torch.zeros(4, 8, 16)
    with pytest.raises(ValueError, match="last axis"):
        tt.rfftn_split(x, axes=(0, 1))
    with pytest.raises(ValueError, match="last axis"):
        tt.irfftn_split(x, x, axes=(0,))


@pytest.mark.parametrize("precision", PRECISIONS)
def test_fft_convolve_2d_matches_jax(precision):
    rng = np.random.default_rng(30)
    image, kernel = rng.standard_normal((2, 64, 128)).astype(np.float32)
    got = tt.fft_convolve_2d(torch.from_numpy(image), torch.from_numpy(kernel),
                             precision=precision)
    assert got.dtype is torch.float32 and got.shape == (64, 128)
    want = j_conv.fft_convolve_2d(image, kernel, precision=precision)
    _agree([got], [want], precision)
    exact = np.fft.ifft2(np.fft.fft2(image.astype(np.float64))
                         * np.fft.fft2(kernel)).real
    tol = 5e-2 if precision == "bfloat16" else 1e-3
    assert np.abs(_np(got) - exact).max() <= tol * np.abs(exact).max()


def test_fft_convolve_2d_identity_kernel():
    image = np.random.default_rng(31).standard_normal((32, 32)).astype(np.float32)
    delta = np.zeros_like(image)
    delta[0, 0] = 1.0
    got = tt.fft_convolve_2d(torch.from_numpy(image), torch.from_numpy(delta))
    np.testing.assert_allclose(_np(got), image, atol=1e-4 * np.abs(image).max())
    with pytest.raises(ValueError, match="shape mismatch"):
        tt.fft_convolve_2d(torch.zeros(32, 32), torch.zeros(32, 16))
