"""The benchmark's Poisson cell on the CPU: ``poisson512.solve`` and the files
it names (``entries/poisson.py``, ``references/poisson.py``, ``r2c_work.py``,
its two per-layer metrics and the two N-D metrics it shares with
``fftn512.grid``), at small cubes: the reference against numpy, the work
counted, the metrics on a synthetic trace, the readers' refusal of cells
whose configurations they cannot tell apart, a planted fault that turns
``correct`` false, and the controls above the program."""
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

from portbench import calibrate, harness, r2c_work, spec
from portbench.trace import Trace

ROOT = Path(__file__).resolve().parents[1]
SIDE = 16
CELL = "poisson512.solve"


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _small_cell(side=SIDE, rows=1):
    """``poisson512.solve`` at a cube of ``side``, two grids in the pool."""
    cell = copy.deepcopy(spec.load_cell(CELL))
    cell.config.update(n=side ** 3, shape=[side] * 3)
    cell.traffic.update(rows_per_call=rows, pool_bytes=2 * rows * side ** 3 * 4)
    return cell


def test_cell_resolves():
    cell = spec.load_cell(CELL)
    assert (cell.entry, cell.chips) == ("poisson", 1)
    assert cell.config["n"] == 512 ** 3 and cell.config["shape"] == [512, 512, 512]
    assert cell.config["precision"] == "bfloat16" and cell.config["discrete"] is True
    assert cell.config["lengths"] == [1, 1, 1]
    assert set(cell.limits) == {"fwd_rel_rms", "fwd_max_err"}
    assert [m["name"] for m in cell.end_to_end] == ["gflops", "step_p95_ms", "setup_s"]
    new = {"r2c_epilogue_roofline", "spectral_scale_roofline"}
    shared = {"relayout_pct", "transform_kernels_roofline"}
    assert new | shared <= {m["name"] for m in cell.per_layer}
    assert shared <= {m["name"] for m in spec.load_cell("fftn512.grid").per_layer}
    assert cell.traffic["rows_per_call"] == 1 and cell.traffic["step"] == ["forward"]
    # Two 512 MiB grids of bf16 re and im planes.
    assert cell.traffic["pool_bytes"] // (cell.config["n"] * 2 * 2) == 2
    for other in ("n16384.bulk", "n2p20.batch20", "fftn512.grid"):
        assert not new & {m["name"] for m in spec.load_cell(other).per_layer}


def _numpy_solve(f):
    """u of laplacian(u) = f - mean(f) on the unit cube, discrete, numpy."""
    n = f.shape[-1]
    k = np.fft.fftfreq(n) * n
    e = -4.0 * n ** 2 * np.sin(np.pi * k / n) ** 2
    lam = e[:, None, None] + e[None, :, None] + e[None, None, : n // 2 + 1]
    lam[0, 0, 0] = 1.0
    spectrum = np.fft.rfftn(f, axes=(-3, -2, -1)) / lam
    spectrum[..., 0, 0, 0] = 0.0
    return np.fft.irfftn(spectrum, s=(n,) * 3, axes=(-3, -2, -1))


def test_reference_matches_numpy():
    ref = spec.load_module("references", "poisson")
    gen = torch.Generator().manual_seed(3)
    re, im = (torch.randn(2, SIDE ** 3, generator=gen, dtype=torch.float64) for _ in range(2))
    got = ref.transform(re, im, "forward", "forward")
    assert got.shape == (2, SIDE, SIDE, SIDE) and got.dtype == torch.complex128
    assert torch.equal(got.imag, torch.zeros_like(got.imag))
    np.testing.assert_allclose(got.real.numpy(), _numpy_solve(re.numpy().reshape(got.shape)),
                               rtol=1e-10, atol=1e-14)
    # u does not depend on the FFT scaling convention or on im.
    for scaling in ("none", "ortho"):
        assert torch.allclose(ref.transform(re, 2 * im, "forward", scaling), got,
                              rtol=1e-12, atol=1e-15)
    with pytest.raises(ValueError, match="one direction"):
        ref.transform(re, im, "inverse", "forward")


@pytest.mark.parametrize("n", [2 ** 10, 4095, 2 * 512 ** 3])
def test_reference_refuses_a_non_cube(n):
    ref = spec.load_module("references", "poisson")
    with pytest.raises(ValueError, match="not a cube"):
        ref.transform(torch.zeros(1, n), torch.zeros(1, n), "forward", "forward")


def test_work_of_call():
    entry = spec.load_module("entries", "poisson")
    config = spec.load_cell(CELL).config
    n = 2 ** 27
    assert entry.work_of_call(config, 1) == (5.0 * n * 27, 6 * n)
    assert entry.work_of_call(config, 2) == (2 * 5.0 * n * 27, 2 * 6 * n)
    with pytest.raises(ValueError, match="3-D grid"):
        entry.work_of_call(dict(config, shape=[512, 512]), 1)


def test_r2c_work():
    """About 16 bytes a grid point a solve over the four R2C kernels, and 8
    a half-spectrum point for the scale (both planes in and out, bf16)."""
    shape = (512, 512, 512)
    per = r2c_work.epilogue_bytes(shape, "bfloat16")
    rows = 512 * 512
    assert per == {"pack": rows * 2048, "untangle": rows * 2052,
                   "retangle": rows * 2052, "interleave": rows * 2048}
    assert sum(per.values()) / 512 ** 3 == pytest.approx(16.02, abs=0.01)
    assert r2c_work.scale_bytes(shape, "bfloat16") == 8 * 512 * 512 * 257
    assert r2c_work.scale_bytes(shape, "float32") == 16 * 512 * 512 * 257


def _run_with(ops):
    spans = [(0, 1000, "step"), (0, 900, "poisson_solve_3d")]
    t = Trace(window=(0, 1000), device_ops=ops, spans=spans,
              call_bounds={"poisson_solve_3d": 240e-6})
    return harness.Run(setup_s=1.0, window_s=1.0, step_times=[1.0], flops=1.0, trace=t,
                       untraced_step_times=[1e-3], untraced_call_times=[1e-4])


OPS = [(0, 100, "void tfft::pack_kernel<__nv_bfloat16>(__nv_bfloat16 const*, ...)"),
       (100, 300, "void tfft::fused_fft_pipe_kernel<false>(...)"),
       (300, 400, "void tfft::untangle_pairs_kernel<__nv_bfloat16, true>(...)"),
       (400, 500, "void at::native::elementwise_kernel<128, 4, ...>(...)"),
       (500, 700, "void tfft::poisson_scale_kernel<__nv_bfloat16>(...)"),
       (700, 800, "void tfft::retangle_pairs_kernel<__nv_bfloat16, __nv_bfloat16, true>(...)"),
       (800, 900, "void tfft::interleave_kernel<__nv_bfloat16>(...)")]


def test_metrics_on_a_synthetic_trace():
    epilogue = spec.load_module("metrics", "r2c_epilogue_roofline")
    scale = spec.load_module("metrics", "spectral_scale_roofline")
    copies = spec.load_module("metrics", "relayout_pct")
    kernels = spec.load_module("metrics", "transform_kernels_roofline")
    hbm = 3.35e12
    nbytes = r2c_work.epilogue_bytes((512, 512, 512), "bfloat16")
    run = _run_with(OPS)
    assert epilogue.read(run) == pytest.approx(100 * sum(nbytes.values()) / hbm / 400e-6)
    assert scale.read(run) == pytest.approx(100 * 8 * 512 * 512 * 257 / hbm / 200e-6)
    assert copies.read(run) == pytest.approx(100 * 100 / 900)
    # The call's bound over the device time of the port's kernels alone.
    assert kernels.read(run) == pytest.approx(100 * 240e-6 / 800e-6)
    # Two launches of the scale count two bounds.
    twice = _run_with(OPS + [(900, 1000, OPS[4][2])])
    assert scale.read(twice) == pytest.approx(100 * 2 * 8 * 512 * 512 * 257 / hbm / 300e-6)
    # Nothing to read: no trace, or none of the kernels.
    only_a = _run_with([OPS[1]])
    assert epilogue.read(only_a) is None and scale.read(only_a) is None
    assert copies.read(only_a) == 0.0
    for metric in (epilogue, scale, copies, kernels):
        assert metric.read(dataclasses.replace(run, trace=None)) is None
        assert metric.read(_run_with([])) is None


@pytest.fixture
def second_poisson_cell(monkeypatch):
    """``BENCHMARK.json`` as if it held a second Poisson cell,
    ``poisson256.solve``, listed by both R2C metrics; its configuration
    starts as the 512^3 one and the test changes it."""
    real = spec._json
    bench = real(ROOT / "BENCHMARK.json")
    bench["configs"].append({"name": "poisson_256", "file": "portbench/configs/poisson_256.json"})
    bench["workloads"].append({"name": "poisson256.solve", "config": "poisson_256",
                               "traffic": "solve", "chips": 1})
    for m in bench["per_layer"]:
        if m["name"] in ("r2c_epilogue_roofline", "spectral_scale_roofline"):
            m["workloads"].append("poisson256.solve")
    config = real(ROOT / "portbench/configs/poisson_512cube_bf16.json")
    files = {"BENCHMARK.json": bench, "poisson_256.json": config,
             "poisson256.solve.json": dict(real(ROOT / f"portbench/cells/{CELL}.json"),
                                           config="poisson_256")}
    monkeypatch.setattr(spec, "_json", lambda path: copy.deepcopy(files.get(Path(path).name))
                        if Path(path).name in files else real(path))
    return config


@pytest.mark.parametrize("change", [dict(shape=[256] * 3, n=256 ** 3),
                                    dict(precision="float32"), dict(discrete=False),
                                    dict(lengths=[2, 1, 1])])
def test_readers_refuse_cells_they_cannot_tell_apart(second_poisson_cell, change):
    """The metrics read the grid and the storage dtype, the reference the
    lengths and the eigenvalues, of the configuration of their cells: a
    second cell that differs in what a reader needs is refused by it, and
    one that differs only in what it does not need is read as before."""
    epilogue = spec.load_module("metrics", "r2c_epilogue_roofline")
    scale = spec.load_module("metrics", "spectral_scale_roofline")
    ref = spec.load_module("references", "poisson")
    run = _run_with(OPS)
    f = torch.randn(1, SIDE ** 3, generator=torch.Generator().manual_seed(2),
                    dtype=torch.float64)
    want = (epilogue.read(run), scale.read(run), ref.transform(f, f, "forward", "forward"))
    second_poisson_cell.update(change)
    for metric, before in zip((epilogue, scale), want):
        if {"shape", "precision"} & set(change):
            with pytest.raises(ValueError, match="cannot tell apart"):
                metric.read(run)
        else:
            assert metric.read(run) == before
    if {"lengths", "discrete"} & set(change):
        with pytest.raises(ValueError, match="cannot tell apart"):
            ref.transform(f, f, "forward", "forward")
    else:
        assert torch.equal(ref.transform(f, f, "forward", "forward"), want[2])


def test_small_cube_is_correct_and_the_outputs_are_the_program_s():
    result = harness.run(_small_cell(rows=2), 2 ** 31 + 11, 0.3, False, torch.device("cpu"),
                         time.perf_counter())
    assert result["correct"] is True and result["failed"] == 0
    assert set(result["checks"]) == {"fwd_rel_rms", "fwd_max_err"}
    assert all(c["value"] <= c["limit"] for c in result["checks"].values())
    # The entry hands each grid of the pool's re plane to the model as a
    # view and returns u as it gives it, with a zero imaginary plane that is
    # a view of one element.
    from tensorfft_tpu_torch.models import poisson_solve_3d

    cell = _small_cell(rows=2)
    solve = spec.load_module("entries", "poisson").make(cell.config)["forward"]
    gen = torch.Generator().manual_seed(1)
    re, im = (torch.randn(2, SIDE ** 3, generator=gen).to(torch.bfloat16) for _ in range(2))
    u, zeros = solve(re, im)
    assert u.shape == zeros.shape == (2, SIDE, SIDE, SIDE) and u.dtype is torch.float32
    assert zeros.stride() == (0, 0, 0, 0) and not zeros.any()
    for row in range(2):
        want = poisson_solve_3d(re[row].view(SIDE, SIDE, SIDE), precision="bfloat16")
        assert torch.equal(u[row], want)
    one, _ = solve(re[:1], im[:1])
    assert torch.equal(one[0], u[0])


def _faulty(config):
    """The program with the mean mode of the spectrum left in (the scale
    leaves F[0, 0, 0] as it is)."""
    from tensorfft_tpu_torch.models import poisson_solve_3d
    from tensorfft_tpu_torch.ops import spectral_cuda

    real = spectral_cuda.poisson_scale_reference

    def mean_left_in(re, im, k0, k1, k2):
        out = real(re, im, k0, k1, k2)
        for o, x in zip(out, (re, im)):
            o[0, 0, 0] = x[0, 0, 0]
        return out

    shape = config["shape"]

    def solve(re, im):
        saved = spectral_cuda.poisson_scale
        spectral_cuda.poisson_scale = mean_left_in
        try:
            u = poisson_solve_3d(re.view(*shape), precision=config["precision"])
        finally:
            spectral_cuda.poisson_scale = saved
        return u[None], torch.zeros_like(u)[None]
    return {"forward": solve}


def test_a_planted_fault_turns_correct_false():
    result = harness.run(_small_cell(), 9, 0.2, False, torch.device("cpu"),
                         time.perf_counter(), make_calls=_faulty)
    assert result["correct"] is False and result["failed"] > 0
    assert all(c["value"] > c["limit"] for c in result["checks"].values())


@pytest.mark.parametrize("control", ["fp8_storage", "bf16_accumulate"])
def test_controls_read_above_the_program(control):
    """Each control, the solve one precision down, reads every number above
    the program's on the same small cube and seed, and above the cell's
    limit in at least one of them."""
    cell = _small_cell(side=32)
    program = harness.run(cell, 5, 0.0, False, torch.device("cpu"), time.perf_counter())
    fn = spec.load_module("references", "poisson").CONTROLS[control]
    result = harness.run(cell, 5, 0.0, False, torch.device("cpu"), time.perf_counter(),
                         make_calls=functools.partial(calibrate.control_calls, fn,
                                                      dtype=torch.bfloat16))
    for name, c in result["checks"].items():
        assert c["value"] > 2 * program["checks"][name]["value"], name
    assert result["correct"] is False


def test_small_cube_run_loads_no_jax():
    code = ("import sys, time, torch; sys.path.insert(0, %r); "
            "from portbench import harness, spec; from portbench import run as r; "
            "cell = spec.load_cell('poisson512.solve'); "
            "cell.config.update(n=512, shape=[8, 8, 8]); "
            "cell.traffic.update(rows_per_call=1, pool_bytes=4096); "
            "harness.run(cell, 1, 0.2, True, torch.device('cpu'), time.perf_counter()); "
            "[spec.load_module('metrics', m['name']) for m in cell.end_to_end + cell.per_layer]; "
            "spec.load_module('references', 'poisson'); "
            "print('FOUND', r.forbidden_modules())" % str(ROOT))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         check=True, cwd=ROOT).stdout
    assert "FOUND []" in out
