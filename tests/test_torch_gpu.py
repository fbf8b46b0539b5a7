"""The port's CUDA kernels against their plain-torch versions on the card:
kernels A, B and C, the packed/interleaving four-step variants (K5, K6),
the R2C epilogue kernels (K7-K10), the 2D row-column passes (K4), K3,
every engine and numeric knob of the shared stage engine, the Poisson
solve's spectral scale and the solve itself, and the image convolution's
spectral product and the convolution itself.

Run on a machine with a CUDA device:

    python -m pytest -m gpu tests/test_torch_gpu.py

Without one every test skips (decided in the ``cuda`` fixture, never at
import or collection time).
"""
import collections

import numpy as np
import pytest
import torch

import tensorfft_tpu_torch as tt
from tensorfft_tpu_torch.fft import four_step_call_kwargs, stage_scales
from tensorfft_tpu_torch.ops import four_step_cuda, fused_cuda, rfft_cuda
from tensorfft_tpu_torch.rfft import _inverse_pre_scale, _output_scale
from tensorfft_tpu_torch.testing import (
    agreement,
    deviation,
    fft_oracle,
    make_test_signal,
)
from tensorfft_tpu_torch.testing.metrics import FOUR_STEP_MAX_FRAC

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", 0)


def _planes(b, n, dtype, device, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((2, b, n), dtype=np.float32)
    return (torch.from_numpy(x[0]).to(device, dtype),
            torch.from_numpy(x[1]).to(device, dtype))


def _hold(got, want, bf16, max_frac=1e-3, max_ulps=1.0):
    a = agreement([g.float().cpu() for g in got],
                  [w.float().cpu() for w in want], bf16=bf16)
    assert a.within(max_frac, max_ulps), a


def _bound(state_dtype, max_frac):
    """The agreement bound: a bf16 state allows 2 bf16 ulps on 2 %."""
    if state_dtype == "bfloat16":
        return dict(max_frac=2e-2, max_ulps=2.0)
    return dict(max_frac=max_frac)


@pytest.mark.parametrize("precision", ["bfloat16", "float32", "float32_x6"])
@pytest.mark.parametrize("forward", [True, False])
@pytest.mark.parametrize("n", [256, 1024, 4096, 16384])
def test_fused_kernel_matches_plain(cuda, n, forward, precision):
    plan = tt.create_plan(n, precision=precision)
    dtype = plan.precision.storage_dtype
    re, im = _planes(8, n, dtype, cuda, seed=n)
    kwargs = dict(radices=plan.radices, sign=-1 if forward else 1,
                  scales=stage_scales(plan.radices, "forward", forward),
                  algorithm=plan.precision.dot_algorithm,
                  first_dot=plan.first_dot)
    before = fused_cuda.fused_fft.launches
    got = fused_cuda.fused_fft(re, im, **kwargs)
    torch.cuda.synchronize()
    assert fused_cuda.fused_fft.launches == before + 1
    assert got[0].dtype is dtype and got[0].is_cuda
    _hold(got, fused_cuda.fused_fft_reference(re, im, **kwargs),
          bf16=dtype is torch.bfloat16)


def test_fused_kernel_three_stages(cuda):
    re, im = _planes(5, 2048, torch.bfloat16, cuda, seed=7)
    kwargs = dict(radices=(4, 8, 64), scales=(1 / 4, 1 / 8, 1 / 64))
    _hold(fused_cuda.fused_fft(re, im, **kwargs),
          fused_cuda.fused_fft_reference(re, im, **kwargs), bf16=True)


@pytest.mark.parametrize("precision", ["bfloat16", "float32"])
@pytest.mark.parametrize("forward", [True, False])
@pytest.mark.parametrize("n", [1 << 15, 1 << 20])
def test_four_step_kernels_match_plain(cuda, n, forward, precision):
    plan = tt.create_plan(n, precision=precision)
    kw = four_step_call_kwargs(plan, forward)
    common = dict(n1=kw["n1"], n2=kw["n2"], sign=kw["sign"],
                  algorithm=kw["algorithm"], first_dot=kw["first_dot"])
    col = dict(radices1=kw["radices1"], scales1=kw["scales1"],
               lane_tile=kw["lane_tile"], **common)
    row = dict(radices2=kw["radices2"], scales2=kw["scales2"], **common)
    bf16 = precision == "bfloat16"
    re, im = _planes(3, n, plan.precision.storage_dtype, cuda, seed=n + forward)
    mid = four_step_cuda.column_pass_reference(re, im, **col)
    _hold(four_step_cuda.column_pass(re, im, **col), mid, bf16,
          FOUR_STEP_MAX_FRAC)
    _hold(four_step_cuda.row_pass(*mid, **row),
          four_step_cuda.row_pass_reference(*mid, **row), bf16,
          FOUR_STEP_MAX_FRAC)


@pytest.mark.parametrize("n", [256, 4096, 16384, 1 << 17])
def test_fft_split_on_card_passes_gate(cuda, n):
    sig = [make_test_signal(n, 42 * s, 42 * 42 * s) for s in (1, 2)]
    re = np.stack([s[0] for s in sig])
    im = np.stack([s[1] for s in sig])
    o_re, o_im = tt.fft_split(torch.from_numpy(re).to(cuda),
                              torch.from_numpy(im).to(cuda))
    assert o_re.is_cuda
    d = deviation((o_re.double().cpu().numpy(), o_im.double().cpu().numpy()),
                  fft_oracle(re, im))
    assert d.passes_reference_gate(), d


def test_kernel_rejects_bad_operands(cuda):
    re, im = _planes(4, 512, torch.bfloat16, cuda)
    kwargs = dict(radices=(8, 64), scales=(1 / 8, 1 / 64))
    with pytest.raises(ValueError, match="contiguous"):
        fused_cuda.fused_fft(re.T.contiguous().T, im, **kwargs)
    with pytest.raises(TypeError):
        fused_cuda.fused_fft(re.half(), im.half(), **kwargs)
    with pytest.raises(NotImplementedError):
        fused_cuda.fused_fft(re.double(), im.double(), algorithm="exact",
                             **kwargs)
    with pytest.raises(NotImplementedError, match="pairs"):
        fused_cuda.fused_fft(re.float(), im.float(), algorithm="bf16",
                             **kwargs)


def _bitwise(got, want):
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and torch.equal(g, w)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("m", [1, 2, 64, 16384, 1 << 19])
def test_pack_interleave_kernels_match_plain(cuda, m, dtype):
    (x,) = _planes(3, 2 * m, dtype, cuda, seed=m)[:1]
    before = (rfft_cuda.pack_split.launches, rfft_cuda.interleave_split.launches)
    planes = rfft_cuda.pack_split(x)
    _bitwise(planes, rfft_cuda.pack_split_reference(x))
    _bitwise([rfft_cuda.interleave_split(*planes)], [x])
    torch.cuda.synchronize()
    assert (rfft_cuda.pack_split.launches, rfft_cuda.interleave_split.launches) == (
        before[0] + 1, before[1] + 1)


def _untangle_pair_bitwise(z, x, m, scaling, out):
    """K9 on planes z (B, M), K10 on planes x (B, M+1) to ``out``: one launch
    each, equal to the plain versions bit for bit."""
    plan = tt.create_plan(2, scaling=scaling)
    scale = float(_output_scale(plan, True))
    before = (rfft_cuda.untangle_fwd.launches, rfft_cuda.retangle_inv.launches)
    got = rfft_cuda.untangle_fwd(*z, n=2 * m, scale=scale)
    assert not got[1][:, -1].any()
    _bitwise(got, rfft_cuda.untangle_fwd_reference(*z, n=2 * m, scale=scale))
    kw = dict(n=2 * m, scale=float(_inverse_pre_scale(plan)), out_dtype=out)
    got = rfft_cuda.retangle_inv(*x, **kw)
    assert got[0].dtype is out
    _bitwise(got, rfft_cuda.retangle_inv_reference(*x, **kw))
    torch.cuda.synchronize()
    assert (rfft_cuda.untangle_fwd.launches, rfft_cuda.retangle_inv.launches) == (
        before[0] + 1, before[1] + 1)


@pytest.mark.parametrize("scaling", ["forward", "none", "ortho"])
@pytest.mark.parametrize("dtype,out", [(torch.bfloat16, torch.bfloat16),
                                       (torch.bfloat16, torch.float32),
                                       (torch.float32, torch.float32),
                                       (torch.float32, torch.bfloat16)])
@pytest.mark.parametrize("m", [1, 2, 3, 8, 12, 64, 16384, 1 << 19])
def test_untangle_retangle_kernels_match_plain(cuda, m, dtype, out, scaling):
    # B = 9: rows start at every misalignment of the pitch-(M+1) planes.
    z = _planes(9, m, dtype, cuda, seed=m + 1)
    x = _planes(9, m + 1, dtype, cuda, seed=m + 2)
    _untangle_pair_bitwise(z, x, m, scaling, out)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_untangle_retangle_kernels_past_grid_y(cuda, dtype):
    """B = 70,000 rows of M = 256, past the 65535 limit of a grid's y."""
    z = _planes(70000, 256, dtype, cuda, seed=3)
    x = _planes(70000, 257, dtype, cuda, seed=4)
    _untangle_pair_bitwise(z, x, 256, "forward", dtype)


def _offset_planes(b, n, dtype, device, offset, seed):
    """Planes (b, n) that start ``offset`` elements into their buffers."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((2, b * n + offset), dtype=np.float32)
    return [torch.from_numpy(p).to(device, dtype)[offset:].view(b, n) for p in x]


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("m", [8, 64, 1024])
def test_untangle_retangle_kernels_on_offset_rows(cuda, m, dtype):
    """Planes off a 16-byte boundary: Z one element in takes the
    element-wise branch, X three elements in shifts its pointer's phase into
    every row's."""
    z = _offset_planes(9, m, dtype, cuda, 1, seed=m + 5)
    x = _offset_planes(9, m + 1, dtype, cuda, 3, seed=m + 6)
    assert z[0].data_ptr() % 16 and x[0].data_ptr() % 16
    _untangle_pair_bitwise(z, x, m, "forward", dtype)


@pytest.mark.parametrize("precision", ["bfloat16", "float32"])
@pytest.mark.parametrize("n", [1 << 15, 1 << 19])
def test_packed_and_interleaving_passes_match_plain(cuda, n, precision):
    plan = tt.create_plan(n, precision=precision)
    bf16 = precision == "bfloat16"
    dtype = plan.precision.storage_dtype
    fwd, inv = four_step_call_kwargs(plan, True), four_step_call_kwargs(plan, False)
    col = {k: fwd[k] for k in ("n1", "n2", "radices1", "scales1", "sign",
                               "lane_tile", "algorithm", "first_dot")}
    row = {k: inv[k] for k in ("n1", "n2", "radices2", "scales2", "sign",
                               "algorithm", "first_dot")}
    (x,) = _planes(3, 2 * n, dtype, cuda, seed=n)[:1]
    _hold(four_step_cuda.column_pass_packed(x, **col),
          four_step_cuda.column_pass_packed_reference(x, **col), bf16,
          FOUR_STEP_MAX_FRAC)
    mid = _planes(3, n, dtype, cuda, seed=n + 1)
    _hold([four_step_cuda.row_pass_interleave(*mid, **row)],
          [four_step_cuda.row_pass_interleave_reference(*mid, **row)], bf16,
          FOUR_STEP_MAX_FRAC)
    # The fused maps agree bit for bit with the unfused kernels.
    _bitwise(four_step_cuda.column_pass_packed(x, **col),
             four_step_cuda.column_pass(*rfft_cuda.pack_split(x), **col))
    _bitwise([four_step_cuda.row_pass_interleave(*mid, **row)],
             [rfft_cuda.interleave_split(*four_step_cuda.row_pass(*mid, **row))])


@pytest.mark.parametrize("precision", ["bfloat16", "float32"])
@pytest.mark.parametrize("n", [512, 32768, 1 << 18])
def test_rfft_split_on_card_passes_gate(cuda, n, precision):
    sig = [make_test_signal(n, 42 * s, 42 * 42 * s) for s in (1, 2)]
    x64 = np.stack([s[0] for s in sig] + [s[1] for s in sig])
    plan = tt.create_plan(n // 2, precision=precision)
    o_re, o_im = tt.rfft_split(torch.from_numpy(x64).to(cuda), plan)
    assert o_re.is_cuda and o_re.shape == (4, n // 2 + 1)
    want = np.fft.rfft(x64, axis=-1) / n
    d = deviation((o_re.double().cpu().numpy(), o_im.double().cpu().numpy()),
                  (want.real, want.imag))
    assert d.passes_reference_gate(), d
    back = tt.irfft_split(o_re, o_im, plan).double().cpu().numpy()
    tol = 2e-2 if precision == "bfloat16" else 3e-4
    assert np.abs(back - x64).max() <= tol * np.abs(x64).max()


def test_fft_convolve_real_on_card(cuda):
    """Within 1e-3 of the float64 convolution, with one launch of the
    spectral product's kernel (on the odd-length half spectra: one element
    a thread)."""
    from tensorfft_tpu_torch.ops import spectral_cuda

    n = 1 << 12
    rng = np.random.default_rng(8)
    a, b = rng.standard_normal((2, 3, n))
    before = spectral_cuda.spectral_product.launches
    got = tt.fft_convolve_real(torch.from_numpy(a).to(cuda),
                               torch.from_numpy(b).to(cuda))
    torch.cuda.synchronize()
    assert spectral_cuda.spectral_product.launches == before + 1
    want = np.fft.irfft(np.fft.rfft(a) * np.fft.rfft(b), n)
    assert np.abs(got.double().cpu().numpy() - want).max() <= 1e-3 * np.abs(want).max()


def test_epilogue_kernels_reject_bad_operands(cuda):
    x = torch.zeros(2, 64, device=cuda)
    with pytest.raises(TypeError):
        rfft_cuda.pack_split(x.double())
    with pytest.raises(ValueError, match="contiguous"):
        rfft_cuda.untangle_fwd(x[:, ::2], x[:, ::2], n=64, scale=0.25)
    with pytest.raises(TypeError):
        spec = x[:, :33].contiguous()
        rfft_cuda.retangle_inv(spec, spec, n=64, scale=1.0,
                               out_dtype=torch.float16)


# (H, W) of the K4 passes: the h = 8 edge, one-lane passes (16384), the
# config-3 square.
FFT2_SHAPES = [(8, 64), (64, 8), (8, 16384), (16384, 8), (64, 4096),
               (4096, 4096)]


@pytest.mark.parametrize("precision", ["bfloat16", "float32"])
@pytest.mark.parametrize("b", [0, 1, 3])
@pytest.mark.parametrize("h,w", FFT2_SHAPES)
def test_fft2_kernels_match_plain(cuda, h, w, b, precision):
    ph = tt.create_plan(h, precision=precision)
    pw = tt.create_plan(w, precision=precision)
    dtype = ph.precision.storage_dtype
    common = dict(sign=-1, algorithm=ph.precision.dot_algorithm)
    col = dict(radices1=ph.radices,
               scales1=stage_scales(ph.radices, "forward", True), **common)
    row = dict(radices2=pw.radices,
               scales2=stage_scales(pw.radices, "forward", True), **common)
    re, im = (p.reshape(b, h, w) for p in _planes(b, h * w, dtype, cuda, seed=h + w + b))
    before = (four_step_cuda.fft2_column_pass.launches,
              four_step_cuda.fft2_row_pass.launches)
    mid = four_step_cuda.fft2_column_pass(re, im, **col)
    mid_plain = four_step_cuda.fft2_column_pass_reference(re, im, **col)
    out = four_step_cuda.fft2_row_pass(*mid_plain, **row)
    torch.cuda.synchronize()
    assert (four_step_cuda.fft2_column_pass.launches,
            four_step_cuda.fft2_row_pass.launches) == (before[0] + (b > 0),
                                                       before[1] + (b > 0))
    for t in (*mid, *out):
        assert t.is_cuda and t.dtype is dtype and t.shape == (b, h, w)
    if b:
        bf16 = dtype is torch.bfloat16
        _hold(mid, mid_plain, bf16, FOUR_STEP_MAX_FRAC)
        _hold(out, four_step_cuda.fft2_row_pass_reference(*mid_plain, **row),
              bf16, FOUR_STEP_MAX_FRAC)


@pytest.mark.parametrize("precision", ["bfloat16", "float32"])
def test_fftn_split_on_card_matches_torch_fft(cuda, precision):
    shape = (16, 64, 128)
    rng = np.random.default_rng(9)
    x = rng.standard_normal((2, *shape), dtype=np.float32)
    re, im = (torch.from_numpy(p).to(cuda) for p in x)
    before = (four_step_cuda.fft2_column_pass.launches,
              four_step_cuda.fft2_row_pass.launches, fused_cuda.fused_fft.launches)
    o_re, o_im = tt.fftn_split(re, im, precision=precision)
    torch.cuda.synchronize()
    # K4 on the trailing two axes, then kernel A along axis 0.
    assert (four_step_cuda.fft2_column_pass.launches,
            four_step_cuda.fft2_row_pass.launches,
            fused_cuda.fused_fft.launches) == tuple(c + 1 for c in before)
    want = torch.fft.fftn(torch.complex(re, im)) / re.numel()
    got = torch.complex(o_re.float(), o_im.float())
    tol = 1e-2 if precision == "bfloat16" else 1e-4
    assert float((got - want).abs().max() / want.abs().max()) <= tol
    b_re, b_im = tt.ifftn_split(o_re, o_im, precision=precision)
    back = torch.stack([b_re, b_im]).double()
    ref = torch.stack([re, im]).to(o_re.dtype).double()
    rt = 2e-2 if precision == "bfloat16" else 3e-4
    assert float((back - ref).abs().max() / ref.abs().max()) <= rt


# -- the planar engines (K1b) in kernels A, B, C and K4, and K3 --------------

PLANAR = ["planar", "planar_vpu"]


def _engine_count(wrapper, engine):
    return wrapper.variant_launches[engine]


def _mma(variant):
    """The counter name of a variant on the tensor-core engine (every
    kernel's pass on one CTA): ``mma`` for the knob-free stacked engine,
    else the variant with ``,mma``."""
    return "mma" if variant == "stacked" else f"{variant},mma"


def _launched(wrapper, call):
    """(call's output, the variants of ``wrapper`` it launched, with their
    counts)."""
    before = collections.Counter(wrapper.variant_launches)
    out = call()
    torch.cuda.synchronize()
    return out, dict(collections.Counter(wrapper.variant_launches) - before)


def _hold_mma(wrapper, call, want, bf16, max_frac=1e-3, max_ulps=1.0):
    """Hold ``call`` (one launch of ``wrapper``) against ``want`` and check
    that it ran the tensor-core engine (a ``mma`` variant)."""
    got, launched = _launched(wrapper, call)
    assert len(launched) == 1 and list(launched.values()) == [1], launched
    assert next(iter(launched)).split(",")[-1] == "mma", launched
    _hold(got if isinstance(got, (tuple, list)) else [got], want, bf16,
          max_frac, max_ulps)


@pytest.mark.parametrize("precision", ["bfloat16", "float32"])
@pytest.mark.parametrize("engine", PLANAR)
@pytest.mark.parametrize("radices", [(16, 16), (16, 16, 4), (64, 64),
                                     (128, 128), (4, 8, 8, 64)])
def test_planar_fused_kernel_matches_plain(cuda, radices, engine, precision):
    # (16, 16, 4): folded stage at K = 16, then a K = 256 stage past the
    # fold limit; at N = 1024 the bf16 plan splits the first stage (bf16ax2).
    n = int(np.prod(radices))
    plan = tt.create_plan(n, precision=precision)
    dtype = plan.precision.storage_dtype
    re, im = _planes(5, n, dtype, cuda, seed=n + len(radices))
    kwargs = dict(radices=radices, scales=stage_scales(radices, "forward", True),
                  algorithm=plan.precision.dot_algorithm,
                  first_dot=plan.first_dot, engine=engine)
    before = _engine_count(fused_cuda.fused_fft, _mma(engine))
    got = fused_cuda.fused_fft(re, im, **kwargs)
    torch.cuda.synchronize()
    assert _engine_count(fused_cuda.fused_fft, _mma(engine)) == before + 1
    _hold(got, fused_cuda.fused_fft_reference(re, im, **kwargs),
          bf16=dtype is torch.bfloat16)


@pytest.mark.parametrize("precision", ["bfloat16", "float32"])
@pytest.mark.parametrize("engine", PLANAR)
@pytest.mark.parametrize("n,split", [(1 << 15, (128, 256)),
                                     (1 << 17, (128, 1024))])
def test_planar_four_step_kernels_match_plain(cuda, n, split, engine, precision):
    plan = tt.create_plan(n, precision=precision,
                          tuning={"engine": engine, "four_step_split": split})
    kw = four_step_call_kwargs(plan, True)
    common = dict(n1=kw["n1"], n2=kw["n2"], sign=kw["sign"],
                  algorithm=kw["algorithm"], first_dot=kw["first_dot"],
                  engine=engine)
    col = dict(radices1=kw["radices1"], scales1=kw["scales1"],
               lane_tile=kw["lane_tile"], **common)
    row = dict(radices2=kw["radices2"], scales2=kw["scales2"], **common)
    bf16 = precision == "bfloat16"
    re, im = _planes(3, n, plan.precision.storage_dtype, cuda, seed=n)
    before = (_engine_count(four_step_cuda.column_pass, _mma(engine)),
              _engine_count(four_step_cuda.row_pass, _mma(engine)))
    mid = four_step_cuda.column_pass_reference(re, im, **col)
    _hold(four_step_cuda.column_pass(re, im, **col), mid, bf16,
          FOUR_STEP_MAX_FRAC)
    _hold(four_step_cuda.row_pass(*mid, **row),
          four_step_cuda.row_pass_reference(*mid, **row), bf16,
          FOUR_STEP_MAX_FRAC)
    torch.cuda.synchronize()
    assert (_engine_count(four_step_cuda.column_pass, _mma(engine)),
            _engine_count(four_step_cuda.row_pass, _mma(engine))) == (
                before[0] + 1, before[1] + 1)


@pytest.mark.parametrize("precision", ["bfloat16", "float32"])
@pytest.mark.parametrize("engine", PLANAR)
@pytest.mark.parametrize("h,w", [(8, 64), (64, 128), (512, 512), (4096, 4096)])
def test_planar_fft2_kernels_match_plain(cuda, h, w, engine, precision):
    ph = tt.create_plan(h, precision=precision)
    pw = tt.create_plan(w, precision=precision)
    dtype = ph.precision.storage_dtype
    common = dict(sign=-1, algorithm=ph.precision.dot_algorithm, engine=engine)
    col = dict(radices1=ph.radices,
               scales1=stage_scales(ph.radices, "forward", True), **common)
    row = dict(radices2=pw.radices,
               scales2=stage_scales(pw.radices, "forward", True), **common)
    re, im = (p.reshape(2, h, w) for p in _planes(2, h * w, dtype, cuda, seed=h + w))
    bf16 = dtype is torch.bfloat16
    mid = four_step_cuda.fft2_column_pass_reference(re, im, **col)
    _hold(four_step_cuda.fft2_column_pass(re, im, **col), mid, bf16,
          FOUR_STEP_MAX_FRAC)
    _hold(four_step_cuda.fft2_row_pass(*mid, **row),
          four_step_cuda.fft2_row_pass_reference(*mid, **row), bf16,
          FOUR_STEP_MAX_FRAC)


@pytest.mark.parametrize("precision", ["bfloat16", "float32"])
@pytest.mark.parametrize("engine", ["stacked"] + PLANAR)
@pytest.mark.parametrize("n,b", [(256, 128), (512, 64), (1024, 24),
                                 (4096, 16), (16384, 8)])
def test_batch_major_kernel_matches_plain_and_kernel_a(cuda, n, b, engine,
                                                       precision):
    plan = tt.create_plan(n, precision=precision)
    dtype = plan.precision.storage_dtype
    re, im = _planes(b, n, dtype, cuda, seed=n + b)
    kwargs = dict(radices=plan.radices,
                  scales=stage_scales(plan.radices, "forward", True),
                  algorithm=plan.precision.dot_algorithm,
                  first_dot=plan.first_dot, engine=engine)
    k3 = four_step_cuda.fused_fft_batch_major
    before = _engine_count(k3, _mma(engine))
    got = k3(re, im, **kwargs)
    torch.cuda.synchronize()
    assert _engine_count(k3, _mma(engine)) == before + 1
    _hold(got, fused_cuda.fused_fft_reference(re, im, **kwargs),
          bf16=dtype is torch.bfloat16)
    # The same rows and plan through kernel A: each output's sums run in
    # the same order whatever the rows per CTA.
    _bitwise(got, fused_cuda.fused_fft(re, im, **kwargs))


def test_fft_split_dispatches_batch_major_on_card(cuda):
    re, im = _planes(64, 4096, torch.bfloat16, cuda, seed=11)
    k3, a = (four_step_cuda.fused_fft_batch_major.launches,
             fused_cuda.fused_fft.launches)
    got = tt.fft_split(re, im, fused_layout="batch_major")
    torch.cuda.synchronize()
    assert (four_step_cuda.fused_fft_batch_major.launches,
            fused_cuda.fused_fft.launches) == (k3 + 1, a)
    _bitwise(got, tt.fft_split(re, im))


# -- the numeric knobs and the pretwiddle / gridslice engines ---------------

@pytest.mark.parametrize("precision,radices,knobs,variant", [
    ("bfloat16", (64, 256), dict(grouped=True), "grouped"),
    ("bfloat16", (64, 256), dict(grouped=True, complex_mult="mult3"),
     "grouped,mult3"),
    ("bfloat16", (32, 128), dict(grouped=True), "grouped"),
    ("bfloat16", (32, 16), dict(grouped=True), "grouped"),
    ("bfloat16", (128, 8), dict(complex_mult="mult3"), "mult3"),
    ("bfloat16", (64, 64), dict(state_dtype="bfloat16"), "bf16_state"),
    ("bfloat16", (16, 16, 16), dict(grouped=True, state_dtype="bfloat16"),
     "grouped,bf16_state"),
    ("bfloat16", (8, 128, 16), dict(grouped=True, complex_mult="mult3",
                                    state_dtype="bfloat16"),
     "grouped,mult3,bf16_state"),
    ("float32", (64, 256), dict(grouped=True, complex_mult="mult3"),
     "grouped,mult3"),
    ("float32", (64, 64), dict(state_dtype="bfloat16"), "bf16_state"),
    ("float32", (128, 128), dict(engine="pretwiddle", state_dtype="bfloat16"),
     "pretwiddle,bf16_state"),
    ("float32_x6", (32, 256), dict(complex_mult="mult3"), "mult3"),
    ("float32", (64, 64), dict(engine="planar", state_dtype="bfloat16"),
     "planar,bf16_state"),
])
def test_knob_fused_kernel_matches_plain(cuda, precision, radices, knobs,
                                         variant):
    n = int(np.prod(radices))
    plan = tt.create_plan(n, precision=precision)
    dtype = plan.precision.storage_dtype
    re, im = _planes(6, n, dtype, cuda, seed=n + 3)
    kw = dict(radices=radices, scales=stage_scales(radices, "forward", True),
              algorithm=plan.precision.dot_algorithm,
              first_dot=plan.first_dot, **knobs)
    before = fused_cuda.fused_fft.variant_launches[_mma(variant)]
    got = fused_cuda.fused_fft(re, im, **kw)
    torch.cuda.synchronize()
    assert fused_cuda.fused_fft.variant_launches[_mma(variant)] == before + 1
    bf16 = dtype is torch.bfloat16 or knobs.get("state_dtype") == "bfloat16"
    _hold(got, fused_cuda.fused_fft_reference(re, im, **kw), bf16,
          **_bound(knobs.get("state_dtype"), 1e-3))


@pytest.mark.parametrize("engine,radices,grouped", [
    ("pretwiddle", (64, 256), True), ("gridslice", (128, 128), False),
    ("gridslice8", (64, 256), True), ("gridslice16", (32, 128), True)])
def test_layout_engines_bitwise_stacked_on_card(cuda, engine, radices, grouped):
    n = int(np.prod(radices))
    re, im = _planes(8, n, torch.bfloat16, cuda, seed=n)
    kw = dict(radices=radices, scales=stage_scales(radices, "forward", True))
    got = fused_cuda.fused_fft(re, im, engine=engine, grouped=grouped, **kw)
    _bitwise(got, fused_cuda.fused_fft(
        re, im, grouped=grouped and engine != "pretwiddle", **kw))


def test_bf16x6_mult3_does_not_fit_one_cta(cuda):
    # One CTA cannot hold it (288 KiB of operand): it runs on a cluster of
    # two CTAs.  Past a cluster of 8 the plan is refused, with no launch.
    plan = tt.create_plan(16384, precision="float32_x6",
                          tuning={"radices": (128, 128), "complex_mult": "mult3"})
    assert tt.plan_works_on_device(plan, cuda) == (True, "ok")
    re, im = _planes(2, 16384, torch.float32, cuda)
    before = fused_cuda.fused_fft.variant_launches["mult3,cluster2"]
    got = tt.fft_split(re, im, plan)
    torch.cuda.synchronize()
    assert fused_cuda.fused_fft.variant_launches["mult3,cluster2"] == before + 1
    kw = dict(radices=plan.radices, scales=stage_scales(plan.radices, "forward", True),
              algorithm="bf16x6", complex_mult="mult3")
    _hold(got, fused_cuda.fused_fft_reference(re, im, **kw), bf16=False)
    big = tt.create_plan(1 << 17, precision="float32_x6",
                         tuning={"radices": (128, 32, 32), "complex_mult": "mult3",
                                 "max_fused_length": 1 << 17})
    assert not tt.plan_works_on_device(big, cuda)[0]
    re, im = _planes(1, 1 << 17, torch.float32, cuda)
    before = fused_cuda.fused_fft.launches
    with pytest.raises(ValueError, match="cluster of 8 CTAs"):
        tt.fft_split(re, im, big)
    assert fused_cuda.fused_fft.launches == before


@pytest.mark.parametrize("n,precision,tuning", [
    (1 << 20, "bfloat16", dict(strategy="four_step", four_step_split=(512, 2048),
                               col_radices=(32, 16), row_radices=(64, 32),
                               grouped=True, state_dtype="bfloat16",
                               lane_tile=256, k1_tile=512)),
    (32768, "bfloat16", dict(strategy="four_step", four_step_split=(128, 256),
                             complex_mult="mult3", state_dtype="bfloat16")),
    (1 << 17, "float32_x6", dict(strategy="four_step",
                                 four_step_split=(256, 512),
                                 col_radices=(256,), complex_mult="mult3")),
    (1 << 20, "bfloat16", dict(strategy="four_step",
                               four_step_split=(1024, 1024),
                               engine="gridslice16")),
])
def test_knob_four_step_kernels_match_plain(cuda, n, precision, tuning):
    plan = tt.create_plan(n, precision=precision, tuning=tuning)
    kw = four_step_call_kwargs(plan, True)
    col_kw, row_kw = four_step_cuda._pair_kwargs(**kw)
    bf16 = precision == "bfloat16" or col_kw["state_dtype"] == "bfloat16"
    frac = _bound(col_kw["state_dtype"], FOUR_STEP_MAX_FRAC)
    re, im = _planes(2, n, plan.precision.storage_dtype, cuda, seed=n)
    mid = four_step_cuda.column_pass_reference(re, im, **col_kw)
    _hold_mma(four_step_cuda.column_pass,
              lambda: four_step_cuda.column_pass(re, im, **col_kw), mid, bf16,
              **frac)
    _hold_mma(four_step_cuda.row_pass,
              lambda: four_step_cuda.row_pass(*mid, **row_kw),
              four_step_cuda.row_pass_reference(*mid, **row_kw), bf16, **frac)
    if plan.engine.startswith("gridslice"):
        _bitwise(tt.fft_split(re, im, plan), tt.fft_split(
            re, im, tt.create_plan(n, precision=precision,
                                   tuning=dict(tuning, engine="stacked"))))


@pytest.mark.parametrize("knobs", [
    dict(grouped=True, state_dtype="bfloat16"), dict(engine="planar"),
    dict(engine="planar_vpu"), dict(complex_mult="mult3", grouped=True)])
def test_knob_real_pair_kernels_match_plain(cuda, knobs):
    n = 1 << 20
    plan = tt.create_plan(n, tuning=dict(strategy="four_step",
                                         four_step_split=(512, 2048),
                                         col_radices=(32, 16),
                                         row_radices=(128, 16), lane_tile=256,
                                         k1_tile=512, **knobs))
    kw = four_step_call_kwargs(plan, True)
    col_kw, row_kw = four_step_cuda._pair_kwargs(**kw)
    frac = _bound(col_kw["state_dtype"], FOUR_STEP_MAX_FRAC)
    (x,) = _planes(2, 2 * n, torch.bfloat16, cuda, seed=5)[:1]
    _hold_mma(four_step_cuda.column_pass_packed,
              lambda: four_step_cuda.column_pass_packed(x, **col_kw),
              four_step_cuda.column_pass_packed_reference(x, **col_kw), True,
              **frac)
    re, im = _planes(2, n, torch.bfloat16, cuda, seed=6)
    _hold_mma(four_step_cuda.row_pass_interleave,
              lambda: four_step_cuda.row_pass_interleave(re, im, **row_kw),
              [four_step_cuda.row_pass_interleave_reference(re, im, **row_kw)],
              True, **frac)


@pytest.mark.parametrize("knobs", [dict(grouped=True),
                                   dict(grouped=True, complex_mult="mult3"),
                                   dict(state_dtype="bfloat16")])
def test_knob_fft2_and_batch_major_match_plain(cuda, knobs):
    h = w = 4096
    r = (32, 128)
    common = dict(sign=-1, algorithm="bf16", **knobs)
    col = dict(radices1=r, scales1=stage_scales(r, "forward", True), **common)
    row = dict(radices2=r, scales2=stage_scales(r, "forward", True), **common)
    re, im = (p.reshape(1, h, w) for p in _planes(1, h * w, torch.bfloat16,
                                                   cuda, seed=9))
    frac = _bound(knobs.get("state_dtype"), FOUR_STEP_MAX_FRAC)
    mid = four_step_cuda.fft2_column_pass_reference(re, im, **col)
    _hold_mma(four_step_cuda.fft2_column_pass,
              lambda: four_step_cuda.fft2_column_pass(re, im, **col), mid, True,
              **frac)
    _hold(four_step_cuda.fft2_row_pass(*mid, **row),
          four_step_cuda.fft2_row_pass_reference(*mid, **row), True, **frac)
    rows = (re.reshape(h, w)[:256], im.reshape(h, w)[:256])
    kw = dict(radices=r, scales=col["scales1"], **common)
    got = four_step_cuda.fused_fft_batch_major(*rows, **kw)
    _hold(got, fused_cuda.fused_fft_reference(*rows, round_input=True, **kw),
          True, **_bound(knobs.get("state_dtype"), 1e-3))


# (n1, n2) of (B, n1, n2) planes whose column and row passes take tiles of
# T = 1 ... 64 columns and rows, so the column tiles' loads and stores run
# every access width (2 to 16 bytes), and a radix-2 pass the vector route.
TILE_SPLITS = [(16384, 2), (8192, 4), (4096, 8), (2048, 16), (1024, 32),
               (256, 64), (64, 256), (2, 8192)]


@pytest.mark.parametrize("precision", ["bfloat16", "float32"])
@pytest.mark.parametrize("n1,n2", TILE_SPLITS)
def test_four_step_tc_every_tile_width(cuda, n1, n2, precision):
    # Kernels B and C, K5, K6 and K4's column pass on the tensor-core engine
    # at each tile width, against their plain versions.
    plan1 = tt.create_plan(n1, precision=precision)
    plan2 = tt.create_plan(n2, precision=precision)
    dtype = plan1.precision.storage_dtype
    bf16 = dtype is torch.bfloat16
    common = dict(n1=n1, n2=n2, sign=-1, algorithm=plan1.precision.dot_algorithm)
    col = dict(radices1=plan1.radices, scales1=stage_scales(plan1.radices, "forward", True),
               lane_tile=128, **common)
    row = dict(radices2=plan2.radices, scales2=stage_scales(plan2.radices, "forward", True),
               **common)
    re, im = _planes(2, n1 * n2, dtype, cuda, seed=n1)
    mid = four_step_cuda.column_pass_reference(re, im, **col)
    _hold_mma(four_step_cuda.column_pass,
              lambda: four_step_cuda.column_pass(re, im, **col), mid, bf16,
              FOUR_STEP_MAX_FRAC)
    _hold_mma(four_step_cuda.row_pass, lambda: four_step_cuda.row_pass(*mid, **row),
              four_step_cuda.row_pass_reference(*mid, **row), bf16, FOUR_STEP_MAX_FRAC)
    x = torch.stack([re, im], -1).reshape(2, 2 * n1 * n2)
    _hold_mma(four_step_cuda.column_pass_packed,
              lambda: four_step_cuda.column_pass_packed(x, **col),
              four_step_cuda.column_pass_packed_reference(x, **col), bf16,
              FOUR_STEP_MAX_FRAC)
    _hold_mma(four_step_cuda.row_pass_interleave,
              lambda: four_step_cuda.row_pass_interleave(*mid, **row),
              [four_step_cuda.row_pass_interleave_reference(*mid, **row)], bf16,
              FOUR_STEP_MAX_FRAC)
    k4 = dict(radices1=col["radices1"], scales1=col["scales1"], sign=-1,
              algorithm=common["algorithm"])
    x3 = (re.reshape(2, n1, n2), im.reshape(2, n1, n2))
    _hold_mma(four_step_cuda.fft2_column_pass,
              lambda: four_step_cuda.fft2_column_pass(*x3, **k4),
              four_step_cuda.fft2_column_pass_reference(*x3, **k4), bf16,
              FOUR_STEP_MAX_FRAC)


# -- plans past one CTA: thread-block clusters ---------------------------------

# (N, precision, tuning, the kernel A variant it launches): the JAX
# package's single-pass plans past 16384 and bf16x6 with mult3 at 16384.
CLUSTER_FUSED = [
    (32768, "bfloat16", dict(strategy="fused", radices=(256, 128),
                             max_fused_length=32768), "cluster2"),
    (32768, "float32", dict(strategy="fused", radices=(32, 32, 32),
                            max_fused_length=32768, state_dtype="bfloat16"),
     "bf16_state,cluster2"),
    (65536, "bfloat16", dict(strategy="fused", radices=(256, 256),
                             max_fused_length=65536, state_dtype="bfloat16"),
     "bf16_state,cluster4"),
    (65536, "float32", dict(strategy="fused", radices=(128, 4, 128),
                            max_fused_length=65536, complex_mult="mult3"),
     "mult3,cluster4"),
    (16384, "float32_x6", dict(strategy="fused", radices=(64, 256), grouped=True,
                               complex_mult="mult3"), "grouped,mult3,cluster2"),
    (131072, "bfloat16", dict(strategy="fused", max_fused_length=131072),
     "cluster8"),
]


def _fused_kwargs(plan, forward):
    return dict(radices=plan.radices, sign=-1 if forward else 1,
                scales=stage_scales(plan.radices, "forward", forward),
                algorithm=plan.precision.dot_algorithm, first_dot=plan.first_dot,
                grouped=plan.grouped, complex_mult=plan.complex_mult,
                state_dtype=plan.state_dtype)


@pytest.mark.parametrize("forward", [True, False])
@pytest.mark.parametrize("n,precision,tuning,variant", CLUSTER_FUSED)
def test_cluster_fused_kernel_matches_plain(cuda, n, precision, tuning, variant,
                                            forward):
    plan = tt.create_plan(n, precision=precision, tuning=tuning)
    dtype = plan.precision.storage_dtype
    re, im = _planes(4, n, dtype, cuda, seed=n + forward)
    kw = _fused_kwargs(plan, forward)
    before = fused_cuda.fused_fft.variant_launches[variant]
    got = fused_cuda.fused_fft(re, im, **kw)
    torch.cuda.synchronize()
    assert fused_cuda.fused_fft.variant_launches[variant] == before + 1
    bf16 = dtype is torch.bfloat16 or plan.state_dtype == "bfloat16"
    # Past N = 16384 the bound every port test applies there (metrics.py).
    _hold(got, fused_cuda.fused_fft_reference(re, im, **kw), bf16,
          **_bound(plan.state_dtype, FOUR_STEP_MAX_FRAC if n > 16384 else 1e-3))


@pytest.mark.parametrize("n,precision,tuning,variant", CLUSTER_FUSED)
def test_cluster_plans_pass_gate(cuda, n, precision, tuning, variant):
    plan = tt.create_plan(n, precision=precision, tuning=tuning)
    sig = [make_test_signal(n, 42 * s, 42 * 42 * s) for s in (1, 2)]
    planes = [np.stack([s[i] for s in sig]) for i in range(2)]
    x = [torch.from_numpy(p).to(cuda, plan.precision.storage_dtype) for p in planes]
    o_re, o_im = tt.fft_split(*x, plan)
    d = deviation((o_re.double().cpu().numpy(), o_im.double().cpu().numpy()),
                  fft_oracle(*planes))
    assert d.passes_reference_gate(), d


@pytest.mark.parametrize("precision,radices,knobs", [
    ("bfloat16", (128, 128), {}),
    ("float32", (64, 64), dict(state_dtype="bfloat16")),
    ("bfloat16", (64, 256), dict(engine="planar")),
])
def test_cluster_kernel_a_bitwise_one_cta(cuda, precision, radices, knobs):
    # A row that one CTA holds, split over 2 and 4 CTAs through the private
    # launcher: each CTA owns a block of every stage's columns and runs the
    # one-CTA tensor-core products on it, so the output is one-CTA kernel
    # A's bit for bit.  Each is held against the plain-torch kernel A (the
    # same plan in another summation order) at the fused bound, and one-CTA
    # K4c (tensor cores, columns over the rows viewed as (B, N, 1)) against
    # it at the four-step bound.
    n = int(np.prod(radices))
    plan = tt.create_plan(n, precision=precision)
    dtype = plan.precision.storage_dtype
    re, im = _planes(8, n, dtype, cuda, seed=n)
    kw = dict(radices=radices, scales=stage_scales(radices, "forward", True),
              sign=-1, algorithm=plan.precision.dot_algorithm,
              first_dot="default", engine="stacked", grouped=False,
              complex_mult="block", state_dtype="float32")
    kw.update(knobs)
    one = fused_cuda._launch_fused(re, im, cluster=1, **kw)
    _bitwise(fused_cuda.fused_fft(re, im, **kw), one)
    bf16 = dtype is torch.bfloat16 or kw["state_dtype"] == "bfloat16"
    col = {k: v for k, v in kw.items() if k not in ("radices", "scales", "first_dot")}
    cols = (re.reshape(8, n, 1), im.reshape(8, n, 1))
    plain = fused_cuda.fused_fft_reference(re, im, **kw)
    for cluster in (2, 4):
        got = fused_cuda._launch_fused(re, im, cluster=cluster, **kw)
        _bitwise(got, one)
        _hold(got, plain, bf16, **_bound(kw["state_dtype"], 1e-3))
    k4c = four_step_cuda.fft2_column_pass(*cols, radices1=radices,
                                          scales1=kw["scales"], **col)
    _hold([t.reshape(8, n) for t in k4c], plain, bf16,
          **_bound(kw["state_dtype"], FOUR_STEP_MAX_FRAC))


@pytest.mark.parametrize("precision,radices,knobs", [
    ("bfloat16", (128, 128), {}),
    ("float32", (64, 256), dict(grouped=True, state_dtype="bfloat16")),
    ("bfloat16", (64, 256), dict(engine="planar")),
])
def test_cluster_row_passes_bitwise_one_cta(cuda, precision, radices, knobs):
    # K3, kernel C, K6 and K4's row pass at 16384 points, forced onto 2
    # CTAs through their private launchers, equal their one-CTA kernels bit
    # for bit (the twin's in-place, transposed and interleaved stores).
    n = int(np.prod(radices))
    plan = tt.create_plan(n, precision=precision)
    dtype, alg = plan.precision.storage_dtype, plan.precision.dot_algorithm
    knobs = four_step_cuda._knobs(knobs.get("engine", "stacked"),
                                  knobs.get("grouped", False), "block",
                                  knobs.get("state_dtype", "float32"))
    scales = stage_scales(radices, "forward", True)
    re, im = _planes(16, n, dtype, cuda, seed=n + 1)
    k3 = dict(radices=radices, scales=scales, sign=-1, algorithm=alg,
              first_dot="default", knobs=knobs)
    counts = four_step_cuda.fused_fft_batch_major.variant_launches
    one_var = fused_cuda.variant(knobs["engine"], fused_cuda.pass_stages(
        radices, knobs["engine"], knobs["grouped"], "block",
        knobs["state_dtype"]), knobs["state_dtype"])
    two_var = one_var.replace("mma", "cluster2")
    before = (counts[one_var], counts[two_var])
    _bitwise(four_step_cuda._launch_batch_major(re, im, cluster=2, **k3),
             four_step_cuda._launch_batch_major(re, im, **k3))
    torch.cuda.synchronize()
    assert (counts[one_var], counts[two_var]) == (before[0] + 1, before[1] + 1)
    n1 = 8
    mid = (re.reshape(2, n1 * n), im.reshape(2, n1 * n))
    row = dict(n1=n1, n2=n, radices2=radices, scales2=scales, sign=-1,
               algorithm=alg, first_dot="default", knobs=knobs)
    counts = four_step_cuda.row_pass.variant_launches
    before = (counts[one_var], counts[two_var])
    _bitwise(four_step_cuda._launch_row_pass(*mid, cluster=2, **row),
             four_step_cuda._launch_row_pass(*mid, **row))
    torch.cuda.synchronize()
    assert (counts[one_var], counts[two_var]) == (before[0] + 1, before[1] + 1)
    vol = tuple(t.reshape(2, n1, n) for t in mid)
    for symbol, src, out in (
            ("tfft_four_step_row_interleave", mid,
             lambda: (torch.empty((2, 2 * n1 * n), dtype=dtype, device=cuda),)),
            ("tfft_fft2_row", vol,
             lambda: tuple(torch.empty_like(t) for t in vol))):
        got = []
        for cluster, var in ((2, two_var), (None, one_var)):
            got.append(out())
            assert four_step_cuda._row_launch(
                symbol, src, got[-1], alg, n1, n, radices, scales, -1,
                "default", knobs, cluster=cluster) == var
        _bitwise(*got)


def test_cluster_k3_and_kernel_a_bitwise(cuda):
    # K3 and kernel A on 2 CTAs at N = 32768 x 2048 compute every output
    # alike: bit for bit.
    tuning = dict(strategy="fused", radices=(256, 128), max_fused_length=32768)
    re, im = _planes(2048, 32768, torch.bfloat16, cuda, seed=11)
    k1 = fused_cuda.fused_fft.variant_launches["cluster2"]
    k3 = four_step_cuda.fused_fft_batch_major.variant_launches["cluster2"]
    a = tt.fft_split(re, im, tt.create_plan(32768, tuning=tuning))
    b = tt.fft_split(re, im, tt.create_plan(32768, tuning=tuning,
                                            fused_layout="batch_major"))
    torch.cuda.synchronize()
    assert fused_cuda.fused_fft.variant_launches["cluster2"] == k1 + 1
    assert four_step_cuda.fused_fft_batch_major.variant_launches["cluster2"] == k3 + 1
    _bitwise(b, a)


@pytest.mark.parametrize("precision", ["bfloat16", "float32"])
@pytest.mark.parametrize("split", [(32, 32768), (32768, 32)])
def test_cluster_four_step_passes_match_plain(cuda, split, precision):
    n = split[0] * split[1]
    plan = tt.create_plan(n, precision=precision,
                          tuning=dict(strategy="four_step", four_step_split=split))
    assert tt.plan_works_on_device(plan, cuda) == (True, "ok")
    kw = four_step_call_kwargs(plan, True)
    common = dict(n1=kw["n1"], n2=kw["n2"], sign=kw["sign"],
                  algorithm=kw["algorithm"], first_dot=kw["first_dot"])
    col = dict(radices1=kw["radices1"], scales1=kw["scales1"],
               lane_tile=kw["lane_tile"], **common)
    row = dict(radices2=kw["radices2"], scales2=kw["scales2"], **common)
    bf16 = precision == "bfloat16"
    re, im = _planes(2, n, plan.precision.storage_dtype, cuda, seed=split[0])
    # The column pass past one CTA takes the column-cluster rule's cluster.
    stages = fused_cuda.pass_stages(tuple(kw["radices1"]))
    _, c_cluster = fused_cuda.column_cluster(split[0], 1, split[1],
                                             kw["algorithm"], stages, "test")
    c_var, r_var = (("mma", "cluster2") if split[1] == 32768
                    else (f"cluster{c_cluster}", "mma"))
    c0 = four_step_cuda.column_pass.variant_launches[c_var]
    r0 = four_step_cuda.row_pass.variant_launches[r_var]
    mid = four_step_cuda.column_pass_reference(re, im, **col)
    _hold(four_step_cuda.column_pass(re, im, **col), mid, bf16, FOUR_STEP_MAX_FRAC)
    _hold(four_step_cuda.row_pass(*mid, **row),
          four_step_cuda.row_pass_reference(*mid, **row), bf16, FOUR_STEP_MAX_FRAC)
    torch.cuda.synchronize()
    assert four_step_cuda.column_pass.variant_launches[c_var] == c0 + 1
    assert four_step_cuda.row_pass.variant_launches[r_var] == r0 + 1
    sig = make_test_signal(n, 42, 42 * 42)
    x = [torch.from_numpy(s[None]).to(cuda, plan.precision.storage_dtype) for s in sig]
    o_re, o_im = tt.fft_split(*x, plan)
    d = deviation((o_re.double().cpu().numpy(), o_im.double().cpu().numpy()),
                  fft_oracle(sig[0][None], sig[1][None]))
    assert d.passes_reference_gate(), d


def _col_cases(n1, n2):
    """Every (lanes, cluster) a column pass of n1 over n2 columns may be
    forced onto past one CTA: a power-of-two tile of columns dividing n2 on
    2, 4 or 8 CTAs of at most 16384 elements each."""
    return [(t, c) for c in (2, 4, 8) for t in (1, 2, 4, 8)
            if n2 % t == 0 and n1 * t // c <= fused_cuda.MAX_CTA_ELEMS]


@pytest.mark.parametrize("engine", ["stacked", "planar"])
@pytest.mark.parametrize("precision", ["bfloat16", "float32"])
@pytest.mark.parametrize("n1", [8192, 16384])
def test_cluster_col_pass_bitwise_one_cta(cuda, n1, precision, engine):
    # Kernel B, K4's column pass and K5 forced onto every (lanes, cluster)
    # through the private launcher: each CTA owns a block of every stage's
    # columns, the lanes innermost, so each output is the one-CTA kernel's
    # bit for bit (twiddle epilogue, pair loads and column-tile stores
    # included).
    n2 = 8
    plan = tt.create_plan(n1, precision=precision)
    dtype, alg = plan.precision.storage_dtype, plan.precision.dot_algorithm
    radices = plan.radices
    knobs = four_step_cuda._knobs(engine, False, "block", "float32")
    stages = fused_cuda.pass_stages(radices, engine)
    one_var = fused_cuda.variant(engine, stages, "float32")
    re, im = _planes(2, n1 * n2, dtype, cuda, seed=n1 + len(engine))
    kw = dict(n1=n1, n2=n2, radices1=radices,
              scales1=stage_scales(radices, "forward", True), sign=-1,
              algorithm=alg, first_dot="default", knobs=knobs)
    for wrapper, src, lane_tile in (
            (four_step_cuda.column_pass, (re, im), 128),
            (four_step_cuda.fft2_column_pass,
             (re.reshape(2, n1, n2), im.reshape(2, n1, n2)), None),
            (four_step_cuda.column_pass_packed,
             (torch.stack([re, im], -1).reshape(2, 2 * n1 * n2),), 128)):
        counts = wrapper.variant_launches
        before = counts[one_var]
        one = four_step_cuda._launch_col_pass(src, lane_tile=lane_tile, **kw)
        torch.cuda.synchronize()
        assert counts[one_var] == before + 1
        for lanes, cluster in _col_cases(n1, n2):
            var = one_var.replace("mma", f"cluster{cluster}")
            before = counts[var]
            got = four_step_cuda._launch_col_pass(src, lane_tile=lane_tile,
                                                  cluster=cluster, lanes=lanes,
                                                  **kw)
            torch.cuda.synchronize()
            assert counts[var] == before + 1, (lanes, cluster)
            _bitwise(got, one)


def test_cluster_column_twin_k4c_and_k5_pass_gate(cuda):
    # The column twin on the entry points: a 2D transform with H = 32768
    # (K4's column pass past one CTA) and a real four-step transform whose
    # 32768-point column pass is K5's, each launching the twin once and
    # passing the gate against numpy.
    h, w = 32768, 16
    stages = fused_cuda.pass_stages(tt.create_plan(h, max_fused_length=h).radices)
    _, cluster = fused_cuda.column_cluster(h, 1, w, "bf16", stages, "test")
    sig = make_test_signal(h * w, 42, 42 * 42)
    x = [torch.from_numpy(s.reshape(h, w)).to(cuda, torch.bfloat16) for s in sig]
    counts = four_step_cuda.fft2_column_pass.variant_launches
    before = counts[f"cluster{cluster}"]
    o_re, o_im = tt.fftn_split(*x, axes=(-2, -1), max_fused_length=h)
    torch.cuda.synchronize()
    assert counts[f"cluster{cluster}"] == before + 1
    want = np.fft.fft2(sig[0].reshape(h, w) + 1j * sig[1].reshape(h, w)) / (h * w)
    d = deviation((o_re.double().cpu().numpy(), o_im.double().cpu().numpy()),
                  (want.real, want.imag))
    assert d.passes_reference_gate(), d
    m = 1 << 20
    plan = tt.create_plan(m, tuning=dict(strategy="four_step",
                                         four_step_split=(32768, 32)))
    radices1 = tuple(four_step_call_kwargs(plan, True)["radices1"])
    _, cluster = fused_cuda.column_cluster(32768, 1, 32, "bf16",
                                           fused_cuda.pass_stages(radices1), "test")
    x64 = np.stack(make_test_signal(2 * m, 42, 42 * 42))
    counts = four_step_cuda.column_pass_packed.variant_launches
    before = counts[f"cluster{cluster}"]
    spec = tt.rfft_split(torch.from_numpy(x64).to(cuda, torch.bfloat16), plan)
    torch.cuda.synchronize()
    assert counts[f"cluster{cluster}"] == before + 1
    want = np.fft.rfft(x64, axis=-1) / (2 * m)
    d = deviation((spec[0].double().cpu().numpy(), spec[1].double().cpu().numpy()),
                  (want.real, want.imag))
    assert d.passes_reference_gate(), d


def test_cluster_batch_major_and_r2c(cuda):
    # K3 at N = 32768 on clusters of two, bit for bit kernel A's; the R2C
    # fused route at real N = 65536 through kernel A on a cluster.
    tuning = dict(strategy="fused", radices=(256, 128), max_fused_length=32768)
    plan = tt.create_plan(32768, tuning=tuning, fused_layout="batch_major")
    re, im = _planes(16, 32768, torch.bfloat16, cuda, seed=3)
    k3 = four_step_cuda.fused_fft_batch_major.variant_launches["cluster2"]
    got = tt.fft_split(re, im, plan)
    torch.cuda.synchronize()
    assert four_step_cuda.fused_fft_batch_major.variant_launches["cluster2"] == k3 + 1
    _bitwise(got, tt.fft_split(re, im, tt.create_plan(32768, tuning=tuning)))
    n = 65536
    plan = tt.create_plan(n // 2, max_fused_length=n // 2)
    x64 = np.stack(make_test_signal(n, 42, 42 * 42))
    before = fused_cuda.fused_fft.variant_launches["cluster2"]
    spec = tt.rfft_split(torch.from_numpy(x64).to(cuda, torch.bfloat16), plan)
    torch.cuda.synchronize()
    assert fused_cuda.fused_fft.variant_launches["cluster2"] == before + 1
    want = np.fft.rfft(x64, axis=-1) / n
    d = deviation((spec[0].double().cpu().numpy(), spec[1].double().cpu().numpy()),
                  (want.real, want.imag))
    assert d.passes_reference_gate(), d


# -- the tensor-core engine: kernel A, K3 and K4's row pass on one CTA ------

# (precision, radices, knobs, variant): one plan per engine and knob the
# tensor-core engine carries, with the stage routes each exercises.
MMA_ENGINES = [
    ("bfloat16", (16, 32), dict(first_dot="bf16ax2"), "stacked"),  # bf16ax2 first stage
    ("float32", (64, 64), {}, "stacked"),
    ("float32_x6", (32, 32), {}, "stacked"),
    ("bfloat16", (4, 8, 64), {}, "stacked"),                # radix 4: vector route
    ("bfloat16", (64, 256), dict(grouped=True), "grouped"),  # folded: vector route
    ("float32", (64, 256), dict(grouped=True, complex_mult="mult3"), "grouped,mult3"),
    ("bfloat16", (128, 8), dict(complex_mult="mult3"), "mult3"),  # mult3 on mma
    ("bfloat16", (64, 64), dict(state_dtype="bfloat16"), "bf16_state"),
    ("bfloat16", (128, 128), dict(engine="planar"), "planar"),
    ("float32", (4, 8, 8, 64), dict(engine="planar"), "planar"),
    ("bfloat16", (32, 128), dict(engine="planar_vpu"), "planar_vpu"),
]


@pytest.mark.parametrize("precision,radices,knobs,variant", MMA_ENGINES)
def test_mma_engines_launch_and_match_plain(cuda, precision, radices, knobs,
                                            variant):
    n = int(np.prod(radices))
    plan = tt.create_plan(n, precision=precision)
    dtype = plan.precision.storage_dtype
    re, im = _planes(8, n, dtype, cuda, seed=n + len(radices))
    kw = dict(radices=radices, scales=stage_scales(radices, "forward", True),
              algorithm=plan.precision.dot_algorithm, **knobs)
    state = knobs.get("state_dtype")
    bf16 = dtype is torch.bfloat16 or state == "bfloat16"
    k3 = four_step_cuda.fused_fft_batch_major
    for wrapper in (fused_cuda.fused_fft, k3):
        before = wrapper.variant_launches[_mma(variant)]
        got = wrapper(re, im, **kw)
        torch.cuda.synchronize()
        assert wrapper.variant_launches[_mma(variant)] == before + 1
        # K3 rounds its input to a bf16 state under every engine.
        want = fused_cuda.fused_fft_reference(
            re, im, round_input=True if wrapper is k3 else None, **kw)
        _hold(got, want, bf16, **_bound(state, 1e-3))
    if "first_dot" in knobs:
        return  # K4's passes run the plain first stage
    x = (re.reshape(1, 8, n), im.reshape(1, 8, n))
    row = dict(radices2=radices, scales2=kw["scales"], sign=-1,
               algorithm=kw["algorithm"], **knobs)
    before = four_step_cuda.fft2_row_pass.variant_launches[_mma(variant)]
    got = four_step_cuda.fft2_row_pass(*x, **row)
    torch.cuda.synchronize()
    assert four_step_cuda.fft2_row_pass.variant_launches[_mma(variant)] == before + 1
    _hold(got, four_step_cuda.fft2_row_pass_reference(*x, **row), bf16,
          **_bound(state, FOUR_STEP_MAX_FRAC))


@pytest.mark.parametrize("n", [512, 4096])
@pytest.mark.parametrize("precision", ["bfloat16", "float32"])
def test_batch_major_bitwise_kernel_a_every_tile(cuda, n, precision):
    # Every rows-per-CTA count the planner picks at n: K3 equals kernel A
    # bit for bit, each output summed in the same k-chunk order.
    plan = tt.create_plan(n, precision=precision)
    kw = dict(radices=plan.radices, scales=stage_scales(plan.radices, "forward", True),
              algorithm=plan.precision.dot_algorithm, first_dot=plan.first_dot)
    tiles = set()
    for b in (1, 2, 4, 8, 16, 32, 64, 96):
        re, im = _planes(b, n, plan.precision.storage_dtype, cuda, seed=b)
        tiles.add(four_step_cuda.batch_major_lanes(n, b))
        _bitwise(four_step_cuda.fused_fft_batch_major(re, im, **kw),
                 fused_cuda.fused_fft(re, im, **kw))
    assert tiles == ({1, 2, 4, 8, 16, 32} if n == 512 else {1, 2, 4})


@pytest.mark.parametrize("n", [1000, 10_000])
def test_bluestein_card_vs_cpu(cuda, n):
    # The M-point transforms run kernel A (M = 2048) or kernels B and C
    # (M = 32768) on the card and their plain versions on the CPU; the
    # chirp products are the same elementwise torch ops.  float32: within
    # 1e-5 of the largest |X|.
    rng = np.random.default_rng(n)
    re, im = (torch.from_numpy(p) for p in
              rng.standard_normal((2, 4, n), dtype=np.float32))
    for forward in (True, False):
        kw = dict(forward=forward, precision="float32", tuning=None)
        got = tt.fft_split_any(re.to(cuda), im.to(cuda), **kw)
        want = tt.fft_split_any(re, im, **kw)
        assert all(g.device.type == "cuda" for g in got)
        a = agreement([g.cpu() for g in got], list(want), bf16=False)
        assert a.within(), a


def test_unit_sweep_card_vs_cpu(cuda):
    # The ported harness on the card (signal, oracle and deviation made
    # there) and on the CPU (numpy signal and oracle, the kernels' plain
    # versions): both pass the reference gate at every (N, seed), and the
    # average deviations agree within 5 % (they differ by the kernels'
    # summation order only).
    from tensorfft_tpu_torch.testing.conformance import run_unit_sweep

    card, cpu = [], []
    assert run_unit_sweep(256, 1 << 17, 2, verbose=False, device="cuda", record=card)
    assert run_unit_sweep(256, 1 << 17, 2, verbose=False, device="cpu", record=cpu)
    assert [(n, i) for n, i, _ in card] == [(n, i) for n, i, _ in cpu]
    for (n, i, d_card), (_, _, d_cpu) in zip(card, cpu):
        assert d_card.average == pytest.approx(d_cpu.average, rel=5e-2), (n, i)


def test_card_oracle_and_datagen_vs_numpy(cuda):
    # N = 2^20: the card's signal within 1e-12 of its scale, the card's
    # complex128 oracle within 1e-12 of the largest |X|, and the card's
    # deviation equal to numpy's on the same planes.
    from tensorfft_tpu_torch.testing import (get_random_weights, sine_superposition,
                                             sine_superposition_torch)

    n = 1 << 20
    sig, sig_card = [], []
    for seed in (42, 42 * 42):
        w = get_random_weights(20, seed)
        sig.append(sine_superposition(n, w))
        sig_card.append(sine_superposition_torch(n, w, cuda))
        scale = np.abs(sig[-1]).max()
        assert np.abs(sig_card[-1].cpu().numpy() - sig[-1]).max() <= 1e-12 * scale
    want = fft_oracle(*sig)
    got = fft_oracle(*(torch.from_numpy(s).to(cuda) for s in sig))
    assert all(g.device.type == "cuda" and g.dtype == torch.float64 for g in got)
    scale = max(np.abs(w).max() for w in want)
    assert max(np.abs(g.cpu().numpy() - w).max() for g, w in zip(got, want)) <= 1e-12 * scale
    noisy = [g + 1e-3 * torch.sin(g * 7.0) for g in got]
    d_card = deviation(noisy, got)
    d_host = deviation([x.cpu().numpy() for x in noisy], [g.cpu().numpy() for g in got])
    assert d_card.maximum == d_host.maximum
    assert d_card.average == pytest.approx(d_host.average, rel=1e-12)
    assert d_card.sigma == pytest.approx(d_host.sigma, rel=1e-9)


# -- the Poisson solve ---------------------------------------------------------

# (shape of the half spectrum, memory order of its axes, outermost first):
# dense (the kernel's mode 0); y innermost, as the forward pass leaves it
# (the 512^3 solve's layout at a smaller grid, and at full size; mode 2,
# pairs along y); x innermost (mode 2); y innermost with an odd extent
# (mode 1, one element a lane); x and y swapped (mode 0); tiles cut at every
# edge.
SCALE_CASES = [((64, 96, 33), (0, 1, 2)), ((64, 64, 33), (0, 2, 1)),
               ((512, 512, 257), (0, 2, 1)), ((40, 72, 17), (2, 1, 0)),
               ((66, 33, 9), (0, 2, 1)), ((33, 65, 9), (1, 0, 2))]


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
@pytest.mark.parametrize("shape,order", SCALE_CASES)
def test_poisson_scale_kernel_matches_plain(cuda, shape, order, dtype):
    """The kernel on planes of any strides equals its plain version bit for
    bit, in dense C-order planes."""
    from tensorfft_tpu_torch.models import poisson
    from tensorfft_tpu_torch.ops import spectral_cuda

    gen = torch.Generator(device=cuda).manual_seed(sum(shape))
    stored = [shape[a] for a in order]
    re, im = (torch.randn(stored, generator=gen, device=cuda).to(dtype)
              .permute(*np.argsort(order)) for _ in range(2))
    grid = (shape[0], shape[1], 2 * (shape[2] - 1))
    tables = poisson.device_tables(grid, (1.0, 1.0, 1.0), True, cuda)
    before = spectral_cuda.poisson_scale.launches
    got = spectral_cuda.poisson_scale(re, im, *tables)
    torch.cuda.synchronize()
    assert spectral_cuda.poisson_scale.launches == before + 1
    want = spectral_cuda.poisson_scale_reference(
        re.cpu(), im.cpu(), *(t.cpu() for t in tables))
    for g, w in zip(got, want):
        assert g.is_cuda and g.dtype is dtype and g.is_contiguous()
        assert torch.equal(g.cpu(), w)


def _cell_limits():
    import json
    from pathlib import Path

    path = Path(__file__).resolve().parents[1] / "portbench/cells/poisson512.solve.json"
    return json.loads(path.read_text())["limits"]


@pytest.mark.parametrize("side", [64, 512])
def test_poisson_solve_within_the_cell_limits(cuda, side):
    """The solve of a bf16 grid on the card against the float64 reference,
    on the numbers and within the limits of the benchmark's cell: the
    relative rms error of u, and the largest error of an element over its
    line's rms; one launch of the scale a solve."""
    import reference_poisson
    from tensorfft_tpu_torch.models import poisson_solve_3d
    from tensorfft_tpu_torch.ops import spectral_cuda

    gen = torch.Generator(device=cuda).manual_seed(side)
    f = torch.randn((side,) * 3, generator=gen, device=cuda).to(torch.bfloat16)
    before = spectral_cuda.poisson_scale.launches
    u = poisson_solve_3d(f, precision="bfloat16")
    torch.cuda.synchronize()
    assert spectral_cuda.poisson_scale.launches == before + 1
    assert u.is_cuda and u.dtype is torch.float32 and u.shape == f.shape
    want = reference_poisson.solve(f)
    diff = (u.double() - want).abs()
    rms = float(diff.norm() / want.norm())
    worst = float((diff / want.square().mean(-1, keepdim=True).sqrt()).max())
    limits = _cell_limits()
    assert rms <= limits["fwd_rel_rms"] and worst <= limits["fwd_max_err"], (rms, worst)


def test_poisson_solve_sends_an_array_to_the_card(cuda):
    """A NumPy f goes to the card by default (``device="cuda"``) and comes
    back as a CUDA u, through the scale's kernel, equal to the solve of the
    same grid handed over as a CUDA tensor."""
    from tensorfft_tpu_torch.models import poisson_solve_3d
    from tensorfft_tpu_torch.ops import spectral_cuda

    f = np.random.default_rng(7).standard_normal((32, 32, 32), dtype=np.float32)
    before = spectral_cuda.poisson_scale.launches
    u = poisson_solve_3d(f)
    torch.cuda.synchronize()
    assert spectral_cuda.poisson_scale.launches == before + 1
    assert u.is_cuda and u.dtype is torch.float32 and u.shape == f.shape
    assert torch.equal(u, poisson_solve_3d(torch.from_numpy(f).to(cuda)))


# -- the image convolution ------------------------------------------------------

# (A's shape, B's shape, A's storage offset in elements): the cell's frame
# (one plane, 16-byte vectors); a kernel broadcast over a batch of images
# (B's batch stride 0), and an image broadcast over kernels (A's); half
# spectra of odd length (one element a thread); planes off their vector
# alignment by one element (one element a thread); a broadcast the kernel
# cannot stride (expanded first).
PRODUCT_CASES = [((4096, 4096), (4096, 4096), 0), ((3, 64, 64), (64, 64), 0),
                 ((64, 64), (2, 64, 64), 0), ((3, 2049), (3, 2049), 0),
                 ((8, 256), (8, 256), 1), ((2, 1, 32, 32), (1, 3, 32, 32), 0)]


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
@pytest.mark.parametrize("a_shape,b_shape,offset", PRODUCT_CASES)
def test_spectral_product_kernel_matches_plain(cuda, a_shape, b_shape, offset, dtype):
    """The kernel equals its plain version bit for bit: dense fp32 planes of
    the broadcast shape, one launch."""
    from tensorfft_tpu_torch.ops import spectral_cuda

    gen = torch.Generator(device=cuda).manual_seed(len(a_shape) + offset)

    def planes(shape):
        n = int(np.prod(shape))
        return tuple(torch.randn(n + offset, generator=gen, device=cuda).to(dtype)[offset:]
                     .view(shape) for _ in range(2))

    a, b = planes(a_shape), planes(b_shape)
    before = spectral_cuda.spectral_product.launches
    got = spectral_cuda.spectral_product(*a, *b)
    torch.cuda.synchronize()
    assert spectral_cuda.spectral_product.launches == before + 1
    want = spectral_cuda.spectral_product_reference(*(x.cpu() for x in (*a, *b)))
    for g, w in zip(got, want):
        assert g.is_cuda and g.dtype is torch.float32 and g.is_contiguous()
        assert torch.equal(g.cpu(), w)


def _conv_cell_limits():
    import json
    from pathlib import Path

    path = Path(__file__).resolve().parents[1] / "portbench/cells/conv4096.image.json"
    return json.loads(path.read_text())["limits"]


@pytest.mark.parametrize("side", [256, 4096])
def test_fft_convolve_2d_within_the_cell_limits(cuda, side):
    """The float32 convolution of a frame on the card against the float64
    reference (``tests/reference_conv2d.py``), on the numbers and within the
    limits of the benchmark's cell: the relative rms error of the output,
    and the largest error of an element over its line's rms; K4 three times
    and one launch of the product a call."""
    import reference_conv2d
    from tensorfft_tpu_torch.fft import nd_counts
    from tensorfft_tpu_torch.models import fft_convolve_2d
    from tensorfft_tpu_torch.ops import spectral_cuda

    gen = torch.Generator(device=cuda).manual_seed(side)
    image, kernel = (torch.randn((side, side), generator=gen, device=cuda) for _ in range(2))
    before = (spectral_cuda.spectral_product.launches, nd_counts["fft2_branch"])
    out = fft_convolve_2d(image, kernel)
    torch.cuda.synchronize()
    assert (spectral_cuda.spectral_product.launches, nd_counts["fft2_branch"]) == (
        before[0] + 1, before[1] + 3)
    assert out.is_cuda and out.dtype is torch.float32 and out.shape == image.shape
    want = reference_conv2d.convolve(image, kernel)
    diff = (out.double() - want).abs()
    rms = float(diff.norm() / want.norm())
    worst = float((diff / want.square().mean(-1, keepdim=True).sqrt()).max())
    limits = _conv_cell_limits()
    assert rms <= limits["fwd_rel_rms"] and worst <= limits["fwd_max_err"], (rms, worst)
