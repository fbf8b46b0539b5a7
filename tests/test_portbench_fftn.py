"""The benchmark's N-D cell on the CPU: ``fftn512.grid`` and the files it
names (``entries/fftn.py``, ``references/fftn.py``, the two per-layer
metrics), at small cubes: the reference against numpy, the work counted,
the metrics on a synthetic trace, and a planted fault that turns
``correct`` false."""
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

from portbench import calibrate, harness, spec
from portbench.trace import Trace

ROOT = Path(__file__).resolve().parents[1]
SIDE = 16


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _small_cell(side=SIDE, rows=1):
    """``fftn512.grid`` at a cube of ``side``, two grids a direction."""
    cell = copy.deepcopy(spec.load_cell("fftn512.grid"))
    cell.config.update(n=side ** 3, shape=[side] * 3)
    cell.traffic.update(rows_per_call=rows, pool_bytes=2 * rows * side ** 3 * 4)
    return cell


def test_cell_resolves():
    cell = spec.load_cell("fftn512.grid")
    assert (cell.entry, cell.chips) == ("fftn", 1)
    assert cell.config["n"] == 512 ** 3 and cell.config["shape"] == [512, 512, 512]
    assert cell.config["precision"] == "bfloat16" and cell.config["scaling"] == "forward"
    assert set(cell.limits) == {"fwd_rel_rms", "fwd_max_err", "inv_rel_rms", "inv_max_err"}
    assert [m["name"] for m in cell.end_to_end] == ["gflops", "step_p95_ms", "setup_s"]
    assert {"relayout_pct", "transform_kernels_roofline"} <= {m["name"] for m in cell.per_layer}
    assert cell.traffic["rows_per_call"] == 1 and cell.traffic["step"] == ["forward", "inverse"]
    # Two 512 MiB grids a direction.
    assert cell.traffic["pool_bytes"] // (cell.config["n"] * 2 * 2) == 2
    # The other cells do not report the N-D metrics.
    assert "relayout_pct" not in {m["name"] for m in spec.load_cell("n16384.bulk").per_layer}


@pytest.mark.parametrize("scaling", ["forward", "none", "ortho"])
@pytest.mark.parametrize("direction", ["forward", "inverse"])
def test_reference_matches_numpy(direction, scaling):
    ref = spec.load_module("references", "fftn")
    gen = torch.Generator().manual_seed(3)
    re, im = (torch.randn(2, 8 ** 3, generator=gen, dtype=torch.float64) for _ in range(2))
    got = ref.transform(re, im, direction, scaling)
    assert got.shape == (2, 8, 8, 8) and got.dtype == torch.complex128
    x = (re.numpy() + 1j * im.numpy()).reshape(2, 8, 8, 8)
    norm = {"forward": "forward", "none": "backward", "ortho": "ortho"}[scaling]
    numpy_fn = np.fft.fftn if direction == "forward" else np.fft.ifftn
    np.testing.assert_allclose(got.numpy(), numpy_fn(x, axes=(1, 2, 3), norm=norm),
                               rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("n", [2 ** 10, 4095, 2 * 512 ** 3])
def test_reference_refuses_a_non_cube(n):
    ref = spec.load_module("references", "fftn")
    assert ref.cube_side(512 ** 3) == 512 and ref.cube_side(1) == 1
    with pytest.raises(ValueError, match="not a cube"):
        ref.cube_side(n)


def test_work_of_call():
    entry = spec.load_module("entries", "fftn")
    config = spec.load_cell("fftn512.grid").config
    n = 2 ** 27
    assert entry.work_of_call(config, 1) == (5.0 * n * 27, 2 * 2 * 2 * n)
    assert entry.work_of_call(config, 3) == (3 * 5.0 * n * 27, 3 * 2 * 2 * 2 * n)
    with pytest.raises(ValueError, match="3-D grid"):
        entry.work_of_call(dict(config, shape=[512, 512]), 1)


def _run_with(ops, calls=(("fftn_split", 0, 500),)):
    spans = [(0, 1000, "step")] + [(a, b, name) for name, a, b in calls]
    t = Trace(window=(0, 1000), device_ops=ops, spans=spans,
              call_bounds={"fftn_split": 30e-6, "ifftn_split": 30e-6})
    return harness.Run(setup_s=1.0, window_s=1.0, step_times=[1.0], flops=1.0, trace=t,
                       untraced_step_times=[1e-3], untraced_call_times=[1e-4])


def test_nd_metrics_on_a_synthetic_trace():
    relayout = spec.load_module("metrics", "relayout_pct")
    kernels = spec.load_module("metrics", "transform_kernels_roofline")
    ops = [(0, 100, "void tfft::four_step_tc_kernel<__nv_bfloat16, 1, 0>(...)"),
           (100, 160, "tfft::fused_fft_pipe_kernel(__nv_bfloat16 const*, ...)"),
           (160, 200, "void at::native::elementwise_kernel<128, 4, ...>(...)")]
    run = _run_with(ops, calls=(("fftn_split", 0, 300), ("ifftn_split", 300, 600)))
    assert relayout.read(run) == pytest.approx(100 * 40 / 200)
    assert kernels.read(run) == pytest.approx(100 * 60e-6 / 160e-6)
    # kernels_roofline divides by every operation; this by the port's alone.
    assert spec.load_module("metrics", "kernels_roofline").read(run) == pytest.approx(30.0)
    only_port = _run_with(ops[:2])
    assert relayout.read(only_port) == 0.0
    assert kernels.read(only_port) == pytest.approx(100 * 30e-6 / 160e-6)
    assert kernels.read(_run_with(ops[2:])) is None
    for metric in (relayout, kernels):
        assert metric.read(dataclasses.replace(run, trace=None)) is None
        assert metric.read(_run_with([])) is None


def test_small_cube_is_correct_and_the_outputs_are_the_program_s():
    result = harness.run(_small_cell(rows=2), 2 ** 31 + 11, 0.3, False, torch.device("cpu"),
                         time.perf_counter())
    assert result["correct"] is True and result["failed"] == 0
    assert all(c["value"] <= c["limit"] for c in result["checks"].values())
    # The entry hands the pool's planes to fftn_split as views and returns
    # what it gives, with no copy on either side.
    import tensorfft_tpu_torch as tt

    cell = _small_cell(rows=2)
    calls = spec.load_module("entries", "fftn").make(cell.config)
    gen = torch.Generator().manual_seed(1)
    re, im = (torch.randn(2, SIDE ** 3, generator=gen).to(torch.bfloat16) for _ in range(2))
    got = calls["inverse"](re, im)
    want = tt.ifftn_split(re.view(2, SIDE, SIDE, SIDE), im.view(2, SIDE, SIDE, SIDE),
                          axes=(1, 2, 3), precision="bfloat16")
    assert all(torch.equal(g, w) and g.stride() == w.stride() for g, w in zip(got, want))


@pytest.mark.parametrize("left_out", [-3, -2, -1])
def test_an_untransformed_axis_turns_correct_false(left_out):
    """A planted fault: the program's call with one axis left untransformed."""
    import tensorfft_tpu_torch as tt

    axes = tuple(a for a in (-3, -2, -1) if a != left_out)

    def make(config):
        shape = config["shape"]

        def call(fn):
            return lambda re, im: fn(re.view(re.shape[0], *shape), im.view(im.shape[0], *shape),
                                     axes=axes, precision=config["precision"])
        return {"forward": call(tt.fftn_split), "inverse": call(tt.ifftn_split)}

    result = harness.run(_small_cell(), 9, 0.2, False, torch.device("cpu"),
                         time.perf_counter(), make_calls=make)
    assert result["correct"] is False and result["failed"] > 0
    assert all(c["value"] > c["limit"] for c in result["checks"].values())


@pytest.mark.parametrize("control", ["fp8_storage", "bf16_accumulate"])
def test_controls_read_above_the_program(control):
    """Each control, the reference one precision down, reads every number
    above the program's on the same small cube and seed."""
    cell = _small_cell(side=32)
    program = harness.run(cell, 5, 0.0, False, torch.device("cpu"), time.perf_counter())
    fn = spec.load_module("references", "fftn").CONTROLS[control]
    result = harness.run(cell, 5, 0.0, False, torch.device("cpu"), time.perf_counter(),
                         make_calls=functools.partial(calibrate.control_calls, fn,
                                                      dtype=torch.bfloat16))
    for name, c in result["checks"].items():
        assert c["value"] > 2 * program["checks"][name]["value"], name


def test_small_cube_run_loads_no_jax():
    code = ("import sys, time, torch; sys.path.insert(0, %r); "
            "from portbench import harness, spec; from portbench import run as r; "
            "cell = spec.load_cell('fftn512.grid'); cell.config.update(n=512, shape=[8, 8, 8]); "
            "cell.traffic.update(rows_per_call=1, pool_bytes=4096); "
            "harness.run(cell, 1, 0.2, True, torch.device('cpu'), time.perf_counter()); "
            "[spec.load_module('metrics', m['name']) for m in cell.end_to_end + cell.per_layer]; "
            "print('FOUND', r.forbidden_modules())" % str(ROOT))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         check=True, cwd=ROOT).stdout
    assert "FOUND []" in out
