"""The benchmark's image-convolution cell on the CPU: ``conv4096.image`` and
the files it names (``entries/conv2d.py``, ``references/conv2d.py``,
``conv_work.py``, its per-layer metric and the two N-D metrics it shares
with ``fftn512.grid`` and ``poisson512.solve``), at small frames: the
reference against numpy, the work counted, the metrics on a synthetic
trace, the readers' refusal of cells whose frames they cannot tell apart, a
planted fault that turns ``correct`` false, and the controls above the
program.

The reference and the metric read the frame from the configuration's file
(through ``BENCHMARK.json``), so the tests at small frames change that file
as read (``small_frame``), not the loaded cell alone."""
import copy
import dataclasses
import functools
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from portbench import calibrate, conv_work, harness, r2c_work, spec
from portbench.trace import Trace

ROOT = Path(__file__).resolve().parents[1]
CELL = "conv4096.image"
CONFIG = "fftconv2d_4096_f32.json"
SMALL = (32, 256)


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _patch_frame(monkeypatch, shape):
    """``spec._json`` as if the configuration's frame were ``shape``."""
    real = spec._json

    def read(path):
        data = real(path)
        if Path(path).name == CONFIG:
            data.update(n=shape[0] * shape[1], shape=list(shape))
        return data

    monkeypatch.setattr(spec, "_json", read)


@pytest.fixture
def small_frame(monkeypatch):
    """The cell at a (32, 256) frame, two pairs a call, two calls' pairs in
    the pool."""
    _patch_frame(monkeypatch, SMALL)
    cell = copy.deepcopy(spec.load_cell(CELL))
    n = SMALL[0] * SMALL[1]
    cell.traffic.update(rows_per_call=2, pool_bytes=2 * 2 * n * 4 * 2)
    return cell


def test_cell_resolves():
    cell = spec.load_cell(CELL)
    assert (cell.entry, cell.chips) == ("conv2d", 1)
    assert cell.config["n"] == 4096 ** 2 and cell.config["shape"] == [4096, 4096]
    assert cell.config["precision"] == "float32" and cell.config["reduced"] == []
    assert cell.config["peak_flops"] == "bf16_dense"
    assert set(cell.limits) == {"fwd_rel_rms", "fwd_max_err"}
    assert [m["name"] for m in cell.end_to_end] == ["gflops", "step_p95_ms", "setup_s"]
    shared = {"relayout_pct", "transform_kernels_roofline"}
    assert shared | {"spectral_product_roofline"} <= {m["name"] for m in cell.per_layer}
    assert cell.traffic["rows_per_call"] == 1 and cell.traffic["step"] == ["forward"]
    # Eight pairs of a 64 MiB float32 image (re) and kernel (im).
    assert cell.traffic["pool_bytes"] // (cell.config["n"] * 2 * 4) == 8
    for other in ("n16384.bulk", "n2p20.batch20", "fftn512.grid", "poisson512.solve"):
        assert "spectral_product_roofline" not in {m["name"] for m in
                                                   spec.load_cell(other).per_layer}


def test_reference_matches_numpy(small_frame):
    ref = spec.load_module("references", "conv2d")
    gen = torch.Generator().manual_seed(3)
    re, im = (torch.randn(2, SMALL[0] * SMALL[1], generator=gen, dtype=torch.float64)
              for _ in range(2))
    got = ref.transform(re, im, "forward", "forward")
    assert got.shape == (2, *SMALL) and got.dtype == torch.complex128
    assert torch.equal(got.imag, torch.zeros_like(got.imag))
    a, b = re.numpy().reshape(2, *SMALL), im.numpy().reshape(2, *SMALL)
    want = np.fft.ifft2(np.fft.fft2(a) * np.fft.fft2(b)).real
    np.testing.assert_allclose(got.real.numpy(), want, rtol=1e-10, atol=1e-10)
    # The output does not depend on the FFT scaling convention.
    for scaling in ("none", "ortho"):
        assert torch.equal(ref.transform(re, im, "forward", scaling), got)
    with pytest.raises(ValueError, match="one direction"):
        ref.transform(re, im, "inverse", "forward")


def test_reference_refuses_another_frame(small_frame):
    ref = spec.load_module("references", "conv2d")
    with pytest.raises(ValueError, match="not a frame"):
        ref.transform(torch.zeros(1, 4096), torch.zeros(1, 4096), "forward", "forward")


def test_work_of_call():
    entry = spec.load_module("entries", "conv2d")
    config = spec.load_cell(CELL).config
    n = 2 ** 24
    # Three transforms at 2.5 N log2 N: 3.02 GFLOP; 12 N bytes: 201 MB.
    assert entry.work_of_call(config, 1) == (3 * 2.5 * n * 24, 12 * n)
    assert entry.work_of_call(config, 2) == (2 * 3 * 2.5 * n * 24, 2 * 12 * n)
    assert entry.work_of_call(config, 1)[0] == pytest.approx(3.02e9, rel=1e-3)
    with pytest.raises(ValueError, match="2-D frame"):
        entry.work_of_call(dict(config, shape=[4096, 4096, 1]), 1)


def test_product_bytes():
    """Four spectrum planes in the storage dtype read, two fp32 planes
    written: 24 bytes a point at float32, 16 at bf16."""
    assert conv_work.product_bytes((4096, 4096), "float32") == 24 * 2 ** 24 == 402_653_184
    assert conv_work.product_bytes([64, 32], "bfloat16") == 16 * 64 * 32
    assert 402_653_184 / 3.35e12 == pytest.approx(0.1202e-3, rel=1e-3)


def _run_with(ops):
    spans = [(0, 1000, "step"), (0, 900, "fft_convolve_2d")]
    t = Trace(window=(0, 1000), device_ops=ops, spans=spans,
              call_bounds={"fft_convolve_2d": 60e-6})
    return harness.Run(setup_s=1.0, window_s=1.0, step_times=[1.0], flops=1.0, trace=t,
                       untraced_step_times=[1e-3], untraced_call_times=[1e-4])


OPS = [(0, 100, "void at::native::vectorized_elementwise_kernel<4, ...>(...)"),
       (100, 300, "void tfft::four_step_tc_kernel<float, 3, 0>(...)"),
       (300, 500, "void tfft::row_pass_tc_kernel<float, 3>(...)"),
       (500, 650, "void tfft::spectral_product_kernel<float, true>(float const*, ...)"),
       (650, 900, "void tfft::four_step_tc_kernel<float, 3, 0>(...)")]


def test_metrics_on_a_synthetic_trace():
    product = spec.load_module("metrics", "spectral_product_roofline")
    copies = spec.load_module("metrics", "relayout_pct")
    kernels = spec.load_module("metrics", "transform_kernels_roofline")
    hbm = 3.35e12
    run = _run_with(OPS)
    assert product.read(run) == pytest.approx(100 * 24 * 2 ** 24 / hbm / 150e-6)
    assert copies.read(run) == pytest.approx(100 * 100 / 900)
    assert kernels.read(run) == pytest.approx(100 * 60e-6 / 800e-6)
    # Two launches of the product count two bounds.
    twice = _run_with(OPS + [(900, 1000, OPS[3][2])])
    assert product.read(twice) == pytest.approx(100 * 2 * 24 * 2 ** 24 / hbm / 250e-6)
    # Nothing to read: no trace, or no launch of the product (the parent's
    # six torch launches).
    assert product.read(_run_with(OPS[:3])) is None
    for metric in (product, copies, kernels):
        assert metric.read(dataclasses.replace(run, trace=None)) is None
        assert metric.read(_run_with([])) is None


@pytest.fixture
def second_conv_cell(monkeypatch):
    """``BENCHMARK.json`` as if it held a second convolution cell,
    ``conv2048.image``, running the ``conv2d`` entry and listed by the
    product's metric; both configurations start as the 4096^2 one at a
    (32, 256) frame, and the test changes the second."""
    real = spec._json
    bench = real(ROOT / "BENCHMARK.json")
    bench["configs"].append({"name": "conv_2048", "file": "portbench/configs/conv_2048.json"})
    bench["workloads"].append({"name": "conv2048.image", "config": "conv_2048",
                               "traffic": "image", "chips": 1})
    for m in bench["per_layer"]:
        if m["name"] == "spectral_product_roofline":
            m["workloads"].append("conv2048.image")
    first = dict(real(ROOT / "portbench/configs" / CONFIG), n=SMALL[0] * SMALL[1],
                 shape=list(SMALL))
    config = copy.deepcopy(first)
    files = {"BENCHMARK.json": bench, CONFIG: first, "conv_2048.json": config,
             "conv2048.image.json": dict(real(ROOT / f"portbench/cells/{CELL}.json"),
                                         config="conv_2048")}
    monkeypatch.setattr(spec, "_json", lambda path: copy.deepcopy(files.get(Path(path).name))
                        if Path(path).name in files else real(path))
    return config


@pytest.mark.parametrize("change", [dict(shape=[64, 128]),
                                    dict(precision="bfloat16"), dict(scaling="none")])
def test_readers_refuse_cells_they_cannot_tell_apart(second_conv_cell, change):
    """The metric reads the frame and the storage dtype, the reference the
    frame, of the configuration of their cells: a second cell that differs
    in what a reader needs is refused by it, and one that differs only in
    what it does not need is read as before."""
    product = spec.load_module("metrics", "spectral_product_roofline")
    ref = spec.load_module("references", "conv2d")
    run = _run_with(OPS)
    before = product.read(run)
    x = torch.zeros(1, SMALL[0] * SMALL[1])
    second_conv_cell.update(change)
    if {"shape", "precision"} & set(change):
        with pytest.raises(ValueError, match="cannot tell apart"):
            product.read(run)
    else:
        assert product.read(run) == before
    if "shape" in change:
        with pytest.raises(ValueError, match="cannot tell apart"):
            ref.transform(x, x, "forward", "forward")
    else:
        assert ref.transform(x, x, "forward", "forward").shape == (1, *SMALL)


def test_poisson_readers_do_not_see_the_conv_cell():
    """The Poisson reference and the R2C metrics find the Poisson cell's
    configuration alone."""
    config = r2c_work.entry_config("poisson", ("lengths", "discrete"))
    assert config["name"] == "poisson_512cube_bf16"
    for metric in ("r2c_epilogue_roofline", "spectral_scale_roofline"):
        assert r2c_work.metric_config(metric)["name"] == "poisson_512cube_bf16"
    assert r2c_work.metric_config("spectral_product_roofline")["name"] == "fftconv2d_4096_f32"
    assert r2c_work.entry_config("conv2d", ("shape",))["shape"] == [4096, 4096]


def test_small_frame_is_correct_and_the_outputs_are_the_program_s(small_frame):
    result = harness.run(small_frame, 2 ** 31 + 11, 0.3, False, torch.device("cpu"),
                         time.perf_counter())
    assert result["correct"] is True and result["failed"] == 0
    assert set(result["checks"]) == {"fwd_rel_rms", "fwd_max_err"}
    assert all(c["value"] <= c["limit"] for c in result["checks"].values())
    # The entry hands the pool's re rows to the model as images and its im
    # rows as kernels, viewed, and returns the output as it gives it, with a
    # zero imaginary plane that is a view of one element.
    from tensorfft_tpu_torch.models import fft_convolve_2d

    convolve = spec.load_module("entries", "conv2d").make(small_frame.config)["forward"]
    gen = torch.Generator().manual_seed(1)
    re, im = (torch.randn(2, SMALL[0] * SMALL[1], generator=gen) for _ in range(2))
    out, zeros = convolve(re, im)
    assert out.shape == zeros.shape == (2, *SMALL) and out.dtype is torch.float32
    assert zeros.stride() == (0, 0, 0) and not zeros.any()
    want = fft_convolve_2d(re.view(2, *SMALL), im.view(2, *SMALL), precision="float32")
    assert torch.equal(out, want)


def _faulty(config):
    """The program with the conjugate product: it correlates the image with
    the kernel where it should convolve."""
    from tensorfft_tpu_torch.models import fft_convolve_2d
    from tensorfft_tpu_torch.ops import spectral_cuda

    real = spectral_cuda.spectral_product_reference
    shape = config["shape"]

    def convolve(re, im):
        saved = spectral_cuda.spectral_product
        spectral_cuda.spectral_product = lambda ar, ai, br, bi: real(ar, ai, br, -bi)
        try:
            out = fft_convolve_2d(re.view(-1, *shape), im.view(-1, *shape),
                                  precision=config["precision"])
        finally:
            spectral_cuda.spectral_product = saved
        return out, torch.zeros_like(out)
    return {"forward": convolve}


def test_a_planted_fault_turns_correct_false(small_frame):
    result = harness.run(small_frame, 9, 0.2, False, torch.device("cpu"),
                         time.perf_counter(), make_calls=_faulty)
    assert result["correct"] is False and result["failed"] > 0
    assert all(c["value"] > c["limit"] for c in result["checks"].values())


@pytest.mark.parametrize("control", ["bf16_storage", "bf16_products"])
def test_controls_read_above_the_program(small_frame, control):
    """Each control, the convolution one precision below float32, reads
    every number far above the program's on the same frames and seed, and
    above the cell's limit in at least one of them."""
    program = harness.run(small_frame, 5, 0.0, False, torch.device("cpu"),
                          time.perf_counter())
    fn = spec.load_module("references", "conv2d").CONTROLS[control]
    result = harness.run(small_frame, 5, 0.0, False, torch.device("cpu"),
                         time.perf_counter(),
                         make_calls=functools.partial(calibrate.control_calls, fn,
                                                      dtype=torch.float32))
    for name, c in result["checks"].items():
        assert c["value"] > 10 * program["checks"][name]["value"], name
    assert result["correct"] is False


def test_small_frame_run_loads_no_jax():
    code = ("import sys, time, torch; sys.path.insert(0, %r); "
            "from portbench import harness, spec; from portbench import run as r; "
            "real = spec._json; "
            "spec._json = lambda p: dict(real(p), n=512, shape=[16, 32]) "
            "if str(p).endswith('fftconv2d_4096_f32.json') else real(p); "
            "cell = spec.load_cell('conv4096.image'); "
            "cell.traffic.update(rows_per_call=1, pool_bytes=4096); "
            "harness.run(cell, 1, 0.2, True, torch.device('cpu'), time.perf_counter()); "
            "[spec.load_module('metrics', m['name']) for m in cell.end_to_end + cell.per_layer]; "
            "spec.load_module('references', 'conv2d'); "
            "print('FOUND', r.forbidden_modules())" % str(ROOT))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         check=True, cwd=ROOT).stdout
    assert "FOUND []" in out
