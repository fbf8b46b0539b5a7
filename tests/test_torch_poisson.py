"""The port's spectral Poisson solve (``tensorfft_tpu_torch.models.
poisson_solve_3d``) against the plain reference (``tests/reference_poisson.py``:
``torch.fft.rfftn`` / ``irfftn`` in float64), against the JAX
``poisson_solve_3d``, and its spectral operator, spans and counters.

Tolerances, per precision, on the same f (so f's own rounding is not
counted), as (relative rms error of u, largest error of an element over its
line's rms):

* bfloat16: every pass of both transforms and the scale store bf16 (unit
  roundoff 2^-9), about nine stores a solve, so u reads 4.7-5.5e-3 rms over
  six seeds at these grids, and an element at most 2.6-7.6e-2 of its line
  (the continuous eigenvalues' largest); 1.2e-2 and 0.15.
* float32 (bf16x3 compensated products, float32 storage): 2.3-2.9e-5 and
  1.2-2.0e-4; 6e-5 and 5e-4.

A planted fault (the mean mode left in, one axis's eigenvalues dropped)
reads a relative rms error of 1.09 or more on every grid, far outside both.
"""
import json

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import reference_poisson
from tensorfft_tpu_torch import tracing
from tensorfft_tpu_torch.models import poisson, poisson_solve_3d
from tensorfft_tpu_torch.ops import spectral_cuda

SHAPES = [(16, 16, 16), (8, 16, 32), (32, 16, 8)]
IDS = ["cube16", "box8x16x32", "box32x16x8"]
DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}
TOL = {"bfloat16": (1.2e-2, 0.15), "float32": (6e-5, 5e-4)}


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _field(shape, dtype, seed):
    gen = torch.Generator().manual_seed(seed)
    return torch.randn(shape, generator=gen).to(dtype)


def _errors(u, want):
    diff = (u.to(torch.float64) - want).abs()
    line_rms = want.square().mean(-1, keepdim=True).sqrt()
    return float(diff.norm() / want.norm()), float((diff / line_rms).max())


@pytest.mark.parametrize("precision", ["bfloat16", "float32"])
@pytest.mark.parametrize("discrete", [True, False], ids=["discrete", "continuous"])
@pytest.mark.parametrize("shape", SHAPES, ids=IDS)
def test_solve_matches_reference(shape, discrete, precision):
    f = _field(shape, DTYPES[precision], seed=sum(shape) + discrete)
    u = poisson_solve_3d(f, discrete=discrete, precision=precision)
    assert u.shape == shape and u.dtype is torch.float32
    rms, worst = _errors(u, reference_poisson.solve(f, discrete=discrete))
    assert rms <= TOL[precision][0] and worst <= TOL[precision][1], (rms, worst)


def test_lengths_scale_the_eigenvalues():
    """A box of sides (2, 1, 0.5): each axis's spacing is its own."""
    lengths = (2.0, 1.0, 0.5)
    f = _field((16, 8, 32), torch.float32, seed=8)
    for discrete in (True, False):
        u = poisson_solve_3d(f, lengths=lengths, discrete=discrete)
        rms, worst = _errors(u, reference_poisson.solve(f, lengths, discrete))
        assert rms <= TOL["float32"][0] and worst <= TOL["float32"][1], (rms, worst)


def test_manufactured_solution():
    """The JAX package's check: u = sin(2 pi x) sin(4 pi y) cos(2 pi z) on
    [0, 1)^3 with the continuous Laplacian (exact for a band-limited u)."""
    n = 16
    x, y, z = np.meshgrid(*(np.arange(n) / n,) * 3, indexing="ij")
    u_true = np.sin(2 * np.pi * x) * np.sin(4 * np.pi * y) * np.cos(2 * np.pi * z)
    lap = -((2 * np.pi) ** 2 + (4 * np.pi) ** 2 + (2 * np.pi) ** 2) * u_true
    u = poisson_solve_3d(lap.astype(np.float32), discrete=False, device="cpu")
    np.testing.assert_allclose(u.numpy().astype(np.float64), u_true, atol=1e-4)


def test_discrete_residual():
    """The JAX package's check: the 7-point Laplacian of u is f - mean(f)."""
    n = 16
    f = np.random.default_rng(3).standard_normal((n, n, n)).astype(np.float32)
    f -= f.mean()
    u = poisson_solve_3d(f, discrete=True, device="cpu").numpy().astype(np.float64)
    lap_u = (sum(np.roll(u, s, a) for a in range(3) for s in (1, -1)) - 6 * u) * n ** 2
    np.testing.assert_allclose(lap_u, f - f.mean(), atol=2e-3)


@pytest.mark.parametrize("discrete", [True, False], ids=["discrete", "continuous"])
def test_matches_jax(discrete):
    """The port against the JAX ``poisson_solve_3d`` on the 8-device CPU mesh
    (``conftest.py``), both under the float32 policy: each reads 2-3e-5 from
    the float64 reference, so they differ by under 1e-4."""
    import jax
    from jax.sharding import Mesh

    from tensorfft_tpu.models import poisson_solve_3d as jax_solve

    f = np.random.default_rng(5).standard_normal((16, 16, 16)).astype(np.float32)
    mesh = Mesh(np.asarray(jax.devices()), ("sp",))
    want = np.asarray(jax_solve(f, mesh, discrete=discrete), np.float64)
    got = poisson_solve_3d(torch.from_numpy(f), discrete=discrete).numpy().astype(np.float64)
    assert np.linalg.norm(got - want) / np.linalg.norm(want) < 1e-4


def test_eigenvalue_tables_are_the_jax_formula():
    """Each table is an axis of the JAX package's ``_spectral_laplacian``:
    lambda at (i, j, k) is their sum, and k2 holds the half spectrum's
    nz/2+1 bins."""
    from tensorfft_tpu.models.poisson import _spectral_laplacian

    shape, lengths = (8, 16, 32), (1.0, 2.0, 0.5)
    for discrete in (True, False):
        k0, k1, k2 = poisson.eigenvalue_tables(shape, lengths, discrete)
        lam = _spectral_laplacian(*shape, lengths, discrete)
        lam[0, 0, 0] = 0.0
        np.testing.assert_array_equal(
            k0[:, None, None] + k1[None, :, None] + k2[None, None, :], lam[:, :, :17])


def _scale_inputs(shape, dtype, seed, order):
    """Half-spectrum planes of ``shape`` laid out in memory in axis order
    ``order`` (outermost first), so their strides are permuted."""
    gen = torch.Generator().manual_seed(seed)
    stored = [shape[a] for a in order]
    planes = [torch.randn(stored, generator=gen).to(dtype).permute(*np.argsort(order))
              for _ in range(2)]
    assert tuple(planes[0].shape) == shape
    return planes


ORDERS = [(0, 1, 2), (0, 2, 1), (2, 1, 0), (1, 0, 2)]


@pytest.mark.parametrize("order", ORDERS, ids=["dense", "y_inner", "x_inner", "x_y_swapped"])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
def test_poisson_scale_reference_against_float64(dtype, order):
    """The plain spectral scale on planes of any strides: dense C-order
    output in the input's dtype, equal to the float64 formula rounded once
    (to within fp32's rounding of lambda, the reciprocal and the product),
    the mean mode exactly 0."""
    shape = (8, 16, 9)
    re, im = _scale_inputs(shape, dtype, 3, order)
    tables = poisson.eigenvalue_tables((8, 16, 16), (1.0, 1.0, 1.0), True)
    k0, k1, k2 = (torch.from_numpy(t.astype(np.float32)) for t in tables)
    got = spectral_cuda.poisson_scale_reference(re, im, k0, k1, k2)
    lam = torch.from_numpy(tables[0][:, None, None] + tables[1][None, :, None]
                           + tables[2][None, None, :])
    lam[0, 0, 0] = 1.0
    for g, x in zip(got, (re, im)):
        assert g.dtype is dtype and g.is_contiguous() and g.shape == shape
        assert float(g[0, 0, 0]) == 0.0
        want = x.to(torch.float64) / lam
        want[0, 0, 0] = 0.0
        # The tables' and lambda's fp32 roundings (same-signed terms), the
        # reciprocal's and the product's, then the storage dtype's.
        unit = 2.0 ** -8 if dtype is torch.bfloat16 else 2.0 ** -24
        assert torch.all((g.to(torch.float64) - want).abs()
                         <= (unit + 6 * 2.0 ** -24) * want.abs())
    # The public wrapper takes the plain version on CPU tensors.
    assert all(torch.equal(a, b) for a, b in
               zip(spectral_cuda.poisson_scale(re, im, k0, k1, k2), got))


def test_poisson_scale_checks_its_tables():
    re = torch.zeros(4, 4, 3)
    k = torch.zeros(4)
    with pytest.raises(ValueError, match="table 2"):
        spectral_cuda.poisson_scale_reference(re, re, k, k, k)
    with pytest.raises(ValueError, match="float32"):
        spectral_cuda.poisson_scale_reference(re, re, k, k.double(), torch.zeros(3))


def _without_mean_zeroed(re, im, k0, k1, k2):
    out = spectral_cuda.poisson_scale_reference(re, im, k0, k1, k2)
    for o, x in zip(out, (re, im)):
        o[0, 0, 0] = x[0, 0, 0]     # the mean mode times 1, as with lambda = 1 there
    return out


def _without_axis_0(re, im, k0, k1, k2):
    lam = k1[None, :, None] + k2[None, None, :]
    inv = torch.where(lam == 0, 0.0, 1.0 / lam).expand(re.shape)
    return tuple((x.to(torch.float32) * inv).to(x.dtype).contiguous() for x in (re, im))


@pytest.mark.parametrize("fault", [_without_mean_zeroed, _without_axis_0],
                         ids=["mean_mode_left_in", "axis0_eigenvalues_dropped"])
@pytest.mark.parametrize("precision", ["bfloat16", "float32"])
@pytest.mark.parametrize("shape", SHAPES, ids=IDS)
def test_planted_fault_fails(monkeypatch, shape, precision, fault):
    f = _field(shape, DTYPES[precision], seed=1)
    monkeypatch.setattr(spectral_cuda, "poisson_scale", fault)
    rms, _ = _errors(poisson_solve_3d(f, precision=precision), reference_poisson.solve(f))
    assert rms > 50 * TOL[precision][0], rms


def test_a_mesh_of_two_devices_raises():
    f = _field((8, 8, 8), torch.float32, seed=2)
    with pytest.raises(NotImplementedError, match="ROADMAP Queue 1 item 2"):
        poisson_solve_3d(f, mesh=[torch.device("cpu")] * 2)

    import jax
    from jax.sharding import Mesh

    with pytest.raises(NotImplementedError, match="Queue 1 item 2"):
        poisson_solve_3d(f, mesh=Mesh(np.asarray(jax.devices()[:2]), ("sp",)))
    # One device runs, as None does.
    one = poisson_solve_3d(f, mesh=Mesh(np.asarray(jax.devices()[:1]), ("sp",)))
    assert torch.equal(one, poisson_solve_3d(f))
    assert torch.equal(poisson_solve_3d(f, mesh=[torch.device("cpu")]), one)


def test_input_dtypes():
    """float64 and integer f are cast to float32 first, as JAX's
    ``jnp.asarray(f, float32)``; a bf16 f goes in as it is; an array goes
    to ``device`` (here the CPU) first."""
    f = _field((8, 8, 8), torch.float32, seed=4)
    want = poisson_solve_3d(f)
    assert torch.equal(poisson_solve_3d(f.double()), want)
    assert torch.equal(poisson_solve_3d(f.numpy(), device="cpu"), want)
    assert torch.equal(poisson_solve_3d(f.numpy().tolist(), device="cpu"), want)
    with pytest.raises(ValueError, match="grid"):
        poisson_solve_3d(f[0])


def test_arrays_go_to_the_card_by_default(monkeypatch):
    """``device`` is keyword-only and "cuda" by default, as ``rfftn``'s: an
    array is moved there before the solve; a tensor stays on its device."""
    import inspect

    param = inspect.signature(poisson_solve_3d).parameters["device"]
    assert (param.kind, param.default) == (inspect.Parameter.KEYWORD_ONLY, "cuda")
    moved = []
    real_to = torch.Tensor.to

    def to(self, *args, **kwargs):
        if args and str(args[0]).startswith("cuda"):
            moved.append(str(args[0]))
            args = ("cpu",) + args[1:]
        return real_to(self, *args, **kwargs)

    monkeypatch.setattr(torch.Tensor, "to", to)
    f = _field((8, 8, 8), torch.float32, seed=4)
    poisson_solve_3d(f.numpy())
    assert moved == ["cuda"]
    poisson_solve_3d(f)
    assert moved == ["cuda"]


# -- spans and counters -------------------------------------------------------


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
    poisson_solve_3d(_field((16, 16, 16), torch.bfloat16, seed=1), precision="bfloat16")
    assert record_function_calls == []


def _holds(outer, inner):
    return outer["ts"] <= inner["ts"] and inner["ts"] + inner["dur"] <= outer["ts"] + outer["dur"]


def test_spans_nest(tmp_path):
    """One ``tfft.model.poisson`` a solve, holding two ``tfft.r2c`` spans
    (the forward's rfft_split first, the inverse's irfft_split last) and the
    two ``tfft.nd`` calls between them."""
    f = _field((16, 16, 16), torch.bfloat16, seed=2)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for _ in range(2):
            poisson_solve_3d(f, precision="bfloat16")
    path = str(tmp_path / "trace.json")
    prof.export_chrome_trace(path)
    with open(path) as fh:
        spans = sorted((e for e in json.load(fh)["traceEvents"]
                        if e.get("ph") == "X" and e.get("cat") == "user_annotation"),
                       key=lambda e: e["ts"])
    models = [s for s in spans if s["name"] == "tfft.model.poisson"]
    assert len(models) == 2
    for model in models:
        inside = [s for s in spans if s is not model and _holds(model, s)]
        r2c = [s for s in inside if s["name"] == "tfft.r2c"]
        nd = [s for s in inside if s["name"] == "tfft.nd"]
        assert len(r2c) == 2 and len(nd) == 2
        assert r2c[0]["ts"] < nd[0]["ts"] and nd[1]["ts"] < r2c[1]["ts"]
        assert not any(_holds(a, b) for a in r2c for b in nd)
    assert all(any(_holds(m, s) for m in models)
               for s in spans if s["name"] in ("tfft.r2c", "tfft.nd"))


@pytest.mark.parametrize("dtype,precision", [
    (torch.bfloat16, "bfloat16"), (torch.float32, "bfloat16"), (torch.float32, "float32")])
def test_counters_at_16_cubed(dtype, precision):
    """Exact counts of one solve on a 16^3 grid, from the shapes: two R2C
    calls; the casts and copies of the R2C path are f's cast to the storage
    dtype (if f is not in it) and irfft_split's copy of the permuted half
    spectrum into rows (both planes); under the float32 policy also the
    contiguous copies of the half-length transform's output before the
    untangle and the interleave (the plain kernel A hands back its planes
    as column slices of one buffer), both planes.  On CPU planes every axis
    pass of both 3-D calls takes the relayout (both planes)."""
    itemsize = DTYPES[precision].itemsize
    half = 16 * 16 * 9
    rows = 2 * 2 * 16 * 16 * 8 * itemsize if precision == "float32" else 0
    f = _field((16, 16, 16), dtype, seed=3)
    before = tracing.counters()
    poisson_solve_3d(f, precision=precision)
    after = tracing.counters()

    def moved(group):
        return {k: after[group][k] - before[group][k] for k in after[group]}

    cast = 16 ** 3 * itemsize if dtype is not DTYPES[precision] else 0
    assert moved("r2c") == {"calls": 2, "copy_bytes": cast + 2 * half * itemsize + rows}
    assert moved("models") == {"poisson_solves": 1, "conv2d_calls": 0, "conv_real_calls": 0}
    assert moved("nd") == {"fft2_branch": 0, "axis_passes": 4,
                           "relayout_bytes": 4 * 2 * half * itemsize}
    assert after["launches"]["poisson_scale"] == before["launches"]["poisson_scale"]
