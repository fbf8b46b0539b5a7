"""The plain reference against numpy.fft, the controls against the cells'
limits at each cell's own length, and the reference's isolation from the
program."""
import ast
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from portbench import check, spec, traffic
from portbench.references import c2c

HERE = Path(__file__).resolve().parents[1]
CELLS = [w["name"] for w in json.loads((HERE.parent / "BENCHMARK.json").read_text())["workloads"]]


@pytest.mark.parametrize("n", [2, 8, 64, 1024])
@pytest.mark.parametrize("scaling", ["forward", "none", "ortho"])
def test_transform_against_numpy(n, scaling):
    rng = np.random.default_rng(n)
    x = rng.standard_normal((3, n)) + 1j * rng.standard_normal((3, n))
    re, im = torch.from_numpy(x.real.copy()), torch.from_numpy(x.imag.copy())
    np_norm = {"forward": ("forward", "forward"), "none": ("backward", "backward"),
               "ortho": ("ortho", "ortho")}[scaling]
    fwd = c2c.transform(re, im, "forward", scaling).numpy()
    inv = c2c.transform(re, im, "inverse", scaling).numpy()
    np.testing.assert_allclose(fwd, np.fft.fft(x, norm=np_norm[0]), rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(inv, np.fft.ifft(x, norm=np_norm[1]), rtol=1e-12, atol=1e-12)


def test_forward_scaling_round_trip():
    # "forward": 1/N on the forward transform, the inverse unscaled and exact.
    x = torch.randn(2, 256, dtype=torch.float64), torch.randn(2, 256, dtype=torch.float64)
    y = c2c.transform(*x, "forward", "forward")
    z = c2c.transform(y.real, y.imag, "inverse", "forward")
    torch.testing.assert_close(z.real, x[0], rtol=0, atol=1e-12)
    torch.testing.assert_close(z.imag, x[1], rtol=0, atol=1e-12)
    e = torch.zeros(1, 256, dtype=torch.float64)
    e[0, 0] = 1.0
    assert torch.allclose(c2c.transform(e, 0 * e, "forward", "forward").real,
                          torch.full((1, 256), 1 / 256, dtype=torch.float64))


@pytest.mark.parametrize("n", [2, 96, 1024, 16384, 1 << 15])
@pytest.mark.parametrize("direction", ["forward", "inverse"])
def test_staged_dft_without_rounding_is_the_dft(n, direction):
    """The bf16 control's stages (factors of at most 128, the largest first),
    with no rounding, are the transform itself."""
    x = torch.complex(torch.randn(2, n, dtype=torch.float64),
                      torch.randn(2, n, dtype=torch.float64))
    got = c2c.staged_dft(x, -1.0 if direction == "forward" else 1.0)
    want = np.fft.fft(x.numpy()) if direction == "forward" else np.fft.ifft(x.numpy()) * n
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-9 * np.sqrt(n))


def test_bf16_accumulate_rounds_every_sum():
    """Summed term by term in bf16, 256 then 127 ones stay at 256: each 257
    rounds back to it (half a bf16 unit there is 1, and 256 is even).  The
    same stages without rounding sum to 383."""
    x = torch.ones((1, 128), dtype=torch.complex64)
    x[0, 0] = 256
    assert float(c2c.staged_dft(x, -1.0, c2c.bf16)[0, 0].real) == 256.0
    assert float(c2c.staged_dft(x, -1.0)[0, 0].real) == 383.0


def test_fp8_round_is_fp8():
    re, im = torch.randn(4, 512, dtype=torch.float64), torch.randn(4, 512, dtype=torch.float64)
    r8, i8 = c2c.fp8_round(re, im)
    scale = c2c.FP8_MAX / torch.maximum(re.abs().amax(-1, keepdim=True),
                                        im.abs().amax(-1, keepdim=True))
    for p in (r8, i8):  # every value, scaled, is an e4m3 number
        q = (p * scale).to(torch.float32)
        assert torch.equal(q.to(c2c.FP8).to(torch.float32), q)
    assert float((r8 - re).abs().max()) > 0


def _numbers(cell_name, rows, calls_of):
    """Numbers of one batch of ``rows`` rows at the cell's own length."""
    cell = spec.load_cell(cell_name)
    lay = traffic.layout(cell.traffic, cell.config)
    lay = traffic.Layout(rows=rows, n=lay.n, pool=1, step=lay.step)
    pools = traffic.make_pools(lay, cell.config["precision"], 31, torch.device("cpu"))
    calls = calls_of(cell.config)
    samples = {d: [(0, *calls[d](*pools[d][0]))] for d in lay.directions}
    return cell, check.compare(samples, pools, c2c, cell.config["scaling"], cell.limits)


def _rows(cell_name):
    return 4 if "n16384" in cell_name else 1


@pytest.mark.parametrize("control", sorted(c2c.CONTROLS))
@pytest.mark.parametrize("cell_name", CELLS)
def test_control_fails_and_program_passes(cell_name, control):
    """Each control (fp8 storage, the precision below bf16 storage; bf16
    accumulation, the precision below fp32 accumulation) fails the cell's
    limits at its own length, and the program's plain versions pass them."""
    torch.set_num_threads(1)
    fn = c2c.CONTROLS[control]
    controls = lambda config: {d: (lambda re, im, d=d: fn(
        re, im, d, config["scaling"], torch.bfloat16)) for d in ("forward", "inverse")}
    cell, (numbers, failed) = _numbers(cell_name, _rows(cell_name), controls)
    assert failed == 2, numbers
    assert all(numbers[k] > cell.limits[k] for k in numbers if k.endswith("rel_rms")), numbers
    entry = spec.load_module("entries", "c2c")
    cell, (numbers, failed) = _numbers(cell_name, _rows(cell_name), entry.make)
    assert failed == 0, numbers


def _imports(path):
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


@pytest.mark.parametrize("path", sorted((HERE / "references").glob("*.py")), ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_program(path):
    assert _imports(path) <= {"__future__", "math", "numpy", "torch"}
    code = (f"import sys, importlib.util; s = importlib.util.spec_from_file_location('r', {str(path)!r}); "
            "m = importlib.util.module_from_spec(s); s.loader.exec_module(m); "
            "print(sorted({n.split('.')[0] for n in sys.modules}))")
    loaded = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                            check=True).stdout
    for name in ("tensorfft_tpu_torch", "tensorfft_tpu", "jax", "portbench"):
        assert f"'{name}'" not in loaded
