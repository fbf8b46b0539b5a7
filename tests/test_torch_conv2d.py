"""The port's FFT image convolution (``tensorfft_tpu_torch.models.
fft_convolve_2d``) against the plain reference (``tests/reference_conv2d.py``:
``torch.fft`` in float64), and its spectral product
(``ops/spectral_cuda.py:spectral_product``), spans and counters.

Tolerances, per precision, on the same float32 image and kernel (their own
rounding is not counted), as (relative rms error of the output, largest
error of an element over its line's rms), the numbers of the benchmark's
``correct``:

* bfloat16: both forward transforms, the inverse and K4's intermediate
  store bf16 (unit roundoff 2^-9), so the output reads 4.9-6.2e-3 rms over
  six seeds at these sizes and an element at most 1.2-3.3e-2 of its line;
  1.2e-2 and 0.07.
* float32 (bf16x3 compensated products, float32 storage): 1.4-4.9e-5 and
  4.1e-5-2.3e-4; 1e-4 and 5e-4.

A planted fault (the conjugate product, which correlates where it should
convolve) reads a relative rms error near 1.4, far outside both.
"""
import json

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import reference_conv2d
from tensorfft_tpu_torch import tracing
from tensorfft_tpu_torch.models import fft_convolve_2d, fft_convolve_real
from tensorfft_tpu_torch.ops import spectral_cuda

# (image shape, kernel shape): square, oblong, and a batch of three images
# convolved with one kernel broadcast over them.
SHAPES = [((64, 64), (64, 64)), ((128, 256), (128, 256)), ((3, 64, 64), (64, 64))]
IDS = ["64x64", "128x256", "3x64x64_broadcast"]
TOL = {"bfloat16": (1.2e-2, 0.07), "float32": (1e-4, 5e-4)}


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _frames(image_shape, kernel_shape, seed):
    gen = torch.Generator().manual_seed(seed)
    return torch.randn(image_shape, generator=gen), torch.randn(kernel_shape, generator=gen)


def _errors(out, want):
    diff = (out.to(torch.float64) - want).abs()
    line_rms = want.square().mean(-1, keepdim=True).sqrt()
    return float(diff.norm() / want.norm()), float((diff / line_rms).max())


@pytest.mark.parametrize("precision", ["bfloat16", "float32"])
@pytest.mark.parametrize("image_shape,kernel_shape", SHAPES, ids=IDS)
def test_convolution_matches_reference(image_shape, kernel_shape, precision):
    image, kernel = _frames(image_shape, kernel_shape, seed=sum(image_shape))
    out = fft_convolve_2d(image, kernel, precision=precision)
    assert out.shape == image.shape and out.dtype is torch.float32
    rms, worst = _errors(out, reference_conv2d.convolve(image, kernel))
    assert rms <= TOL[precision][0] and worst <= TOL[precision][1], (rms, worst)


def test_reference_is_the_circular_convolution():
    """The reference against the convolution's sum at a small size: out[i, j]
    = sum_{p, q} image[p, q] kernel[(i - p) mod H, (j - q) mod W]."""
    image, kernel = (x.double() for x in _frames((4, 6), (4, 6), seed=1))
    want = torch.zeros(4, 6, dtype=torch.float64)
    for i in range(4):
        for j in range(6):
            rolled = torch.roll(torch.flip(kernel, (0, 1)), (i + 1, j + 1), (0, 1))
            want[i, j] = (image * rolled).sum()
    assert torch.allclose(reference_conv2d.convolve(image, kernel), want, rtol=0,
                          atol=1e-12)


def test_broadcast_kernel_convolves_every_image():
    """A (64, 64) kernel over a (3, 64, 64) batch: each image's output is its
    own convolution with the kernel, within the float32 tolerance."""
    images, kernel = _frames((3, 64, 64), (64, 64), seed=4)
    out = fft_convolve_2d(images, kernel)
    for b in range(3):
        rms, worst = _errors(out[b], reference_conv2d.convolve(images[b], kernel))
        assert rms <= TOL["float32"][0] and worst <= TOL["float32"][1], (b, rms, worst)


def _conjugate_product(a_re, a_im, b_re, b_im):
    """A times conj(B): circular correlation, not convolution."""
    return spectral_cuda.spectral_product_reference(a_re, a_im, b_re, -b_im)


@pytest.mark.parametrize("precision", ["bfloat16", "float32"])
def test_planted_fault_fails(monkeypatch, precision):
    image, kernel = _frames((64, 64), (64, 64), seed=2)
    monkeypatch.setattr(spectral_cuda, "spectral_product", _conjugate_product)
    rms, _ = _errors(fft_convolve_2d(image, kernel, precision=precision),
                     reference_conv2d.convolve(image, kernel))
    assert rms > 50 * TOL[precision][0], rms


# -- the spectral product ------------------------------------------------------


def _spectra(shape, dtype, seed):
    gen = torch.Generator().manual_seed(seed)
    return tuple(torch.randn(shape, generator=gen).to(dtype) for _ in range(2))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
def test_product_reference_against_float64(dtype):
    """The plain product in fp32: each output within one rounding of each of
    its two products and of their sum or difference of the float64 product
    of the same inputs, and the product itself on CPU tensors."""
    a, b = _spectra((8, 16), dtype, 3), _spectra((8, 16), dtype, 4)
    got = spectral_cuda.spectral_product_reference(*a, *b)
    ar, ai, br, bi = (x.to(torch.float64) for x in (*a, *b))
    for g, want, size in ((got[0], ar * br - ai * bi, (ar * br).abs() + (ai * bi).abs()),
                          (got[1], ar * bi + ai * br, (ar * bi).abs() + (ai * br).abs())):
        assert g.dtype is torch.float32 and g.shape == (8, 16) and g.is_contiguous()
        # |fl(fl(x) -+ fl(y)) - (x -+ y)| <= u (|x| + |y|) (1 + u) + u |x -+ y|.
        assert torch.all((g.to(torch.float64) - want).abs() <= 2.0 ** -23 * 1.0001 * size)
    # A planted fault (the conjugate product) fails the same bound.
    fault = _conjugate_product(*a, *b)
    assert not torch.all((fault[1].to(torch.float64) - (ar * bi + ai * br)).abs()
                         <= 2.0 ** -23 * 1.0001 * ((ar * bi).abs() + (ai * br).abs()))
    before = spectral_cuda.spectral_product.launches
    assert all(torch.equal(x, y) for x, y in
               zip(spectral_cuda.spectral_product(*a, *b), got))
    assert spectral_cuda.spectral_product.launches == before


# (A's shape, B's shape): equal shapes (one plane), a kernel broadcast over
# images (stride 0 for B, and for A), and broadcasts the kernel cannot
# stride, expanded first.
PRODUCT_SHAPES = [((8, 16), (8, 16)), ((3, 8, 16), (8, 16)), ((8, 16), (2, 3, 8, 16)),
                  ((3, 1, 8, 16), (3, 8, 16)), ((2, 1, 8, 16), (1, 3, 8, 16)),
                  ((4, 6), (4, 1)), ((5,), (5,))]


@pytest.mark.parametrize("a_shape,b_shape", PRODUCT_SHAPES)
def test_batch_planes_give_the_product(a_shape, b_shape):
    """The kernel's indexing emulated on the planes ``_batch_planes`` hands
    it (plane b of A at b * sa, of B at b * sb, of P at b * M) gives the
    plain product bit for bit."""
    a, b = _spectra(a_shape, torch.float32, 5), _spectra(b_shape, torch.float32, 6)
    shape = torch.broadcast_shapes(a_shape, b_shape)
    m, batch, ((ar, ai, sa), (br, bi, sb)) = spectral_cuda._batch_planes(shape, a, b)
    assert m * batch == torch.Size(shape).numel() and sa in (0, m) and sb in (0, m)
    assert all(x.is_contiguous() for x in (ar, ai, br, bi))
    i = torch.arange(m)
    rows = [spectral_cuda.spectral_product_reference(
        ar.reshape(-1)[p * sa + i], ai.reshape(-1)[p * sa + i],
        br.reshape(-1)[p * sb + i], bi.reshape(-1)[p * sb + i]) for p in range(batch)]
    want = spectral_cuda.spectral_product_reference(*a, *b)
    for k in range(2):
        assert torch.equal(torch.cat([r[k] for r in rows]).reshape(shape), want[k])
    if a_shape == (3, 8, 16) and b_shape == (8, 16):
        assert (m, batch, sa, sb) == (128, 3, 128, 0) and br.data_ptr() == b[0].data_ptr()


def test_product_refuses_bad_planes():
    x = torch.zeros(4, 4)
    with pytest.raises(ValueError, match="differ in shape"):
        spectral_cuda.spectral_product(x, torch.zeros(4, 3), x, x)
    with pytest.raises(ValueError, match="dtype or device"):
        spectral_cuda.spectral_product(x, x, x, x.double())
    with pytest.raises(RuntimeError):
        spectral_cuda.spectral_product(x, x, torch.zeros(3, 4), torch.zeros(3, 4))


# -- spans and counters ---------------------------------------------------------


@pytest.fixture
def record_function_calls(monkeypatch):
    made = []
    real = torch.profiler.record_function

    def counted(name, *args):
        made.append(name)
        return real(name, *args)

    monkeypatch.setattr(torch.profiler, "record_function", counted)
    return made


def test_no_span_without_a_profiler(record_function_calls):
    fft_convolve_2d(*_frames((64, 64), (64, 64), seed=1))
    fft_convolve_real(*_frames((2, 64), (2, 64), seed=1))
    assert record_function_calls == []


def _holds(outer, inner):
    return outer["ts"] <= inner["ts"] and inner["ts"] + inner["dur"] <= outer["ts"] + outer["dur"]


def _spans(tmp_path, fn):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for _ in range(2):
            fn()
    path = str(tmp_path / "trace.json")
    prof.export_chrome_trace(path)
    with open(path) as fh:
        return sorted((e for e in json.load(fh)["traceEvents"]
                       if e.get("ph") == "X" and e.get("cat") == "user_annotation"),
                      key=lambda e: e["ts"])


@pytest.mark.parametrize("model,inner", [("conv2d", "tfft.nd"), ("conv_real", "tfft.r2c")])
def test_spans_nest(tmp_path, model, inner):
    """One ``tfft.model.conv2d`` a call holding its three ``tfft.nd`` calls
    (two forward, one inverse), and one ``tfft.model.conv_real`` holding its
    three ``tfft.r2c`` calls; every such call lies in a model span."""
    if model == "conv2d":
        spans = _spans(tmp_path, lambda: fft_convolve_2d(*_frames((64, 64), (64, 64), 2)))
    else:
        spans = _spans(tmp_path, lambda: fft_convolve_real(*_frames((2, 64), (2, 64), 2)))
    models = [s for s in spans if s["name"] == f"tfft.model.{model}"]
    assert len(models) == 2
    for outer in models:
        assert len([s for s in spans if s["name"] == inner and _holds(outer, s)]) == 3
    assert all(any(_holds(m, s) for m in models) for s in spans if s["name"] == inner)


def test_counters_at_64():
    """Exact counts of one convolution of each kind on CPU tensors: the 2D
    one runs the 2D branch three times and no axis pass; the real one three
    R2C calls; neither launches the product's kernel (the plain version
    runs)."""
    before = tracing.counters()
    fft_convolve_2d(*_frames((64, 64), (64, 64), seed=3))
    mid = tracing.counters()
    fft_convolve_real(*_frames((2, 64), (2, 64), seed=3))
    after = tracing.counters()

    def moved(a, b, group):
        return {k: b[group][k] - a[group][k] for k in b[group]}

    assert moved(before, mid, "models") == {"poisson_solves": 0, "conv2d_calls": 1,
                                            "conv_real_calls": 0}
    assert moved(before, mid, "nd") == {"fft2_branch": 3, "axis_passes": 0,
                                        "relayout_bytes": 0}
    assert moved(mid, after, "models") == {"poisson_solves": 0, "conv2d_calls": 0,
                                           "conv_real_calls": 1}
    assert moved(mid, after, "r2c")["calls"] == 3
    assert after["launches"]["spectral_product"] == before["launches"]["spectral_product"]
