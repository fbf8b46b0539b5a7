"""The port's N-D transform (``fftn_split`` / ``ifftn_split``) against the
plain reference (``tests/reference_fftn.py``: ``torch.fft.fftn`` in
complex128), and the N-D dispatch's spans and counters.

Tolerances, per precision, on the same input planes (so the inputs' own
rounding is not counted):

* bfloat16: every pass stores its result in bf16 (unit roundoff 2^-9), and a
  3-D call stores three or four times (K4's two passes, then each further
  axis), so the relative rms error reads 3.2-3.3e-3 at these sizes; 8e-3
  holds it with room and is under a third of what one dropped rounding
  level would not explain.  The largest error of an element over its line's
  rms reads 1.1-1.5e-2; 4e-2.
* float32 (bf16x3 compensated products, float32 storage): rms 1.5-1.7e-5,
  element 5-8e-5; 5e-5 and 2.5e-4.

A transform with one axis left out reads a relative rms error of 1 or more
in every case, far outside both.
"""
import importlib
import json

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import reference_fftn
import tensorfft_tpu_torch as tt
from tensorfft_tpu_torch import tracing

fft_module = importlib.import_module("tensorfft_tpu_torch.fft")

# (shape, axes): a cube, a batch of cubes over the last three axes, and a
# box of three different lengths.
CASES = [((16, 16, 16), None), ((2, 16, 16, 16), (-3, -2, -1)), ((8, 16, 32), None)]
IDS = ["cube16", "batch2_cube16", "box8x16x32"]
PRECISIONS = ["bfloat16", "float32"]
DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}
TOL = {"bfloat16": (8e-3, 4e-2), "float32": (5e-5, 2.5e-4)}


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _planes(shape, dtype, seed):
    gen = torch.Generator().manual_seed(seed)
    return tuple(torch.randn(shape, generator=gen).to(dtype) for _ in range(2))


def _errors(got, want):
    """(relative rms error, largest element error over its line's rms)."""
    g = torch.complex(got[0].to(torch.float64), got[1].to(torch.float64))
    diff = (g - want).abs()
    line_rms = want.abs().square().mean(-1, keepdim=True).sqrt()
    return float(diff.norm() / want.abs().norm()), float((diff / line_rms).max())


def _transform(forward):
    return tt.fftn_split if forward else tt.ifftn_split


def _axes_of(shape, axes):
    return tuple(range(len(shape))) if axes is None else axes


@pytest.mark.parametrize("forward", [True, False], ids=["fwd", "inv"])
@pytest.mark.parametrize("precision", PRECISIONS)
@pytest.mark.parametrize("shape,axes", CASES, ids=IDS)
def test_fftn_split_matches_reference(shape, axes, precision, forward):
    re, im = _planes(shape, DTYPES[precision], seed=sum(shape) + forward)
    got = _transform(forward)(re, im, axes=axes, precision=precision)
    assert got[0].shape == shape and got[0].dtype is DTYPES[precision]
    rms, worst = _errors(got, reference_fftn.fftn(re, im, axes, forward))
    assert rms <= TOL[precision][0] and worst <= TOL[precision][1], (rms, worst)


@pytest.mark.parametrize("forward", [True, False], ids=["fwd", "inv"])
@pytest.mark.parametrize("precision", PRECISIONS)
@pytest.mark.parametrize("shape,axes", CASES, ids=IDS)
def test_one_axis_left_out_fails(shape, axes, precision, forward):
    """The check sees a transform that skips any one axis."""
    re, im = _planes(shape, DTYPES[precision], seed=3)
    want = reference_fftn.fftn(re, im, axes, forward)
    every = _axes_of(shape, axes)
    for left_out in every:
        rest = tuple(a for a in every if a != left_out)
        got = _transform(forward)(re, im, axes=rest, precision=precision)
        rms, _ = _errors(got, want)
        assert rms > 100 * TOL[precision][0], (left_out, rms)


@pytest.mark.parametrize("scaling", ["forward", "none", "ortho"])
def test_reference_matches_numpy(scaling):
    import numpy as np

    re, im = _planes((4, 8, 6), torch.float64, seed=9)
    x = re.numpy() + 1j * im.numpy()
    norm = {"forward": "forward", "none": "backward", "ortho": "ortho"}[scaling]
    np.testing.assert_allclose(
        reference_fftn.fftn(re, im, None, True, scaling).numpy(),
        np.fft.fftn(x, norm=norm), rtol=1e-12, atol=1e-12)
    # The inverse's sign is +1; numpy's ifftn divides by N under "backward".
    inv = {"forward": "forward", "none": "backward", "ortho": "ortho"}[scaling]
    np.testing.assert_allclose(
        reference_fftn.fftn(re, im, (1, 2), False, scaling).numpy(),
        np.fft.ifftn(x, axes=(1, 2), norm=inv), rtol=1e-12, atol=1e-12)


def _old_per_axis(re, im, axes, forward, precision):
    """The per-axis loop with no relayout of its own: each axis moved last
    and handed to ``fft_split`` as a strided view, which ``_run`` copies."""
    for ax in axes:
        re_m, im_m = torch.movedim(re, ax, -1), torch.movedim(im, ax, -1)
        plan = tt.create_plan(re_m.shape[-1], precision=precision, tuning="auto")
        re_m, im_m = (tt.fft_split if forward else tt.ifft_split)(re_m, im_m, plan)
        re, im = torch.movedim(re_m, -1, ax), torch.movedim(im_m, -1, ax)
    return re, im


# (shape, axes through K4 first, axes through the per-axis loop, input dtype,
# precision, strided): the 3-D peel, a per-axis-only call on a float32 input
# under the bf16 policy (the cast before the copy), and a strided input.
BITWISE = [
    ((16, 16, 16), (-2, -1), (0,), torch.bfloat16, "bfloat16", False),
    ((2, 16, 16, 16), (-2, -1), (1,), torch.float32, "float32", False),
    ((8, 16, 32), (), (0, 1), torch.float32, "bfloat16", False),
    ((16, 16, 8), (), (2, 0), torch.float32, "bfloat16", True),
]


@pytest.mark.parametrize("forward", [True, False], ids=["fwd", "inv"])
@pytest.mark.parametrize("shape,k4_axes,loop_axes,dtype,precision,strided", BITWISE)
def test_relayout_keeps_the_old_bits(shape, k4_axes, loop_axes, dtype, precision,
                                     strided, forward):
    re, im = _planes(shape, dtype, seed=11)
    if strided:   # every other row of a box twice as long along axis 1
        re, im = (torch.cat([p, p], 1)[:, ::2] for p in (re, im))
    axes = tuple(k4_axes) + tuple(loop_axes)
    got = _transform(forward)(re, im, axes=axes, precision=precision)
    want = (re, im)
    if k4_axes:
        want = _transform(forward)(re, im, axes=k4_axes, precision=precision)
    want = _old_per_axis(*want, loop_axes, forward, precision)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    assert all(g.stride() == w.stride() for g, w in zip(got, want))


def test_run_gets_contiguous_planes(monkeypatch):
    """After the relayout, ``_run`` finds contiguous planes in the storage
    dtype and has nothing left to copy."""
    seen = []
    real = fft_module._run

    def spy(re, im, plan, forward, plan_kwargs):
        seen.append((re.is_contiguous(), im.is_contiguous(),
                     re.dtype is plan.precision.storage_dtype))
        return real(re, im, plan, forward, plan_kwargs)

    monkeypatch.setattr(fft_module, "_run", spy)
    re, im = _planes((8, 16, 32), torch.float32, seed=2)
    tt.fftn_split(re, im, axes=(0, 1), precision="bfloat16")
    assert seen == [(True, True, True)] * 2


def _counts():
    return tracing.counters()["nd"]


@pytest.mark.parametrize("precision,itemsize", [("bfloat16", 2), ("float32", 4)])
def test_nd_counters_at_16_cubed(precision, itemsize):
    re, im = _planes((16, 16, 16), DTYPES[precision], seed=4)
    before = _counts()
    tt.ifftn_split(*tt.fftn_split(re, im, precision=precision), precision=precision)
    after = _counts()
    moved = {k: after[k] - before[k] for k in after}
    # Each call: K4 on the trailing two axes, one pass along axis 0 whose
    # relayout copies both 16^3 planes.
    assert moved == {"fft2_branch": 2, "axis_passes": 2,
                     "relayout_bytes": 2 * 2 * 16 ** 3 * itemsize}


def test_nd_counters_count_no_copy_on_the_last_axis():
    re, im = _planes((4, 16), torch.bfloat16, seed=6)
    before = _counts()
    tt.fftn_split(re, im, axes=(-1,), precision="bfloat16")
    after = _counts()
    assert {k: after[k] - before[k] for k in after} == {
        "fft2_branch": 0, "axis_passes": 1, "relayout_bytes": 0}


def test_cpu_planes_keep_the_relayout(monkeypatch):
    """A pass that would land from the strided planes on the card (128
    points along axis 0 of dense bf16 planes, 4096 lines: tiles of 32) runs
    the relayout on CPU planes, with the same bits as before."""
    from tensorfft_tpu_torch.ops import fused_cuda

    monkeypatch.setattr(fused_cuda, "multiprocessors", lambda device: 132)
    re, im = _planes((128, 64, 64), torch.bfloat16, seed=13)
    plan = tt.create_plan(128)
    assert fused_cuda.column_tile(
        re.shape, (re.stride(), im.stride()), 0, re.dtype, (0, 16), 132,
        radices=plan.radices, algorithm=plan.precision.dot_algorithm) == 32
    assert fft_module._column_tile(re, im, 0, plan) == 0
    before, launched = _counts(), fused_cuda.fused_fft_columns.launches
    got = tt.fftn_split(re, im, axes=(0,), plans={128: plan})
    after = _counts()
    assert {k: after[k] - before[k] for k in after} == {
        "fft2_branch": 0, "axis_passes": 1, "relayout_bytes": 2 * 2 * 128 * 64 * 64}
    assert fused_cuda.fused_fft_columns.launches == launched
    want = _old_per_axis(re, im, (0,), True, "bfloat16")
    assert all(torch.equal(g, w) and g.stride() == w.stride()
               for g, w in zip(got, want))


@pytest.fixture
def record_function_calls(monkeypatch):
    made = []
    real = torch.profiler.record_function

    def counted(name, *args):
        made.append(name)
        return real(name, *args)

    monkeypatch.setattr(torch.profiler, "record_function", counted)
    return made


def test_no_nd_span_without_a_profiler(record_function_calls):
    re, im = _planes((16, 16, 16), torch.bfloat16, seed=1)
    tt.ifftn_split(*tt.fftn_split(re, im), axes=(0, 1))
    assert record_function_calls == []


def _spans(prof, tmp_path):
    path = str(tmp_path / "trace.json")
    prof.export_chrome_trace(path)
    with open(path) as f:
        return [e for e in json.load(f)["traceEvents"]
                if e.get("ph") == "X" and e.get("cat") == "user_annotation"]


def _holds(outer, inner):
    return outer["ts"] <= inner["ts"] and inner["ts"] + inner["dur"] <= outer["ts"] + outer["dur"]


def test_nd_spans_nest(tmp_path):
    """One ``tfft.nd`` a call, however deep the dispatch recurses; inside
    it, ``tfft.nd.fft2``, then ``tfft.nd.relayout`` before the pass's
    ``tfft.entry``, which holds its ``tfft.dispatch``."""
    re, im = _planes((2, 16, 16, 16), torch.bfloat16, seed=8)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        tt.fftn_split(re, im, axes=(-3, -2, -1))
        tt.ifftn_split(re, im, axes=(-3, -2, -1))
    spans = _spans(prof, tmp_path)
    named = {n: [e for e in spans if e["name"] == n]
             for n in ("tfft.nd", "tfft.nd.fft2", "tfft.nd.relayout",
                       "tfft.entry", "tfft.dispatch")}
    assert {n: len(v) for n, v in named.items()} == {n: 2 for n in named}
    for call in named["tfft.nd"]:
        inner = {n: [e for e in named[n] if _holds(call, e)] for n in named if n != "tfft.nd"}
        assert all(len(v) == 1 for v in inner.values()), inner
        fft2, relayout, entry = (inner[n][0] for n in
                                 ("tfft.nd.fft2", "tfft.nd.relayout", "tfft.entry"))
        assert fft2["ts"] + fft2["dur"] <= relayout["ts"]
        assert relayout["ts"] + relayout["dur"] <= entry["ts"]
        assert _holds(entry, inner["tfft.dispatch"][0])


def test_nd_plans_are_kept_between_calls(monkeypatch):
    """A second call with the same arguments makes no plan; other arguments
    make their own, and an unhashable ``tuning`` dict is planned afresh."""
    made = []
    real = fft_module.create_plan

    def counted(n, **kw):
        made.append(n)
        return real(n, **kw)

    monkeypatch.setattr(fft_module, "create_plan", counted)
    fft_module._cached_plan.cache_clear()
    re, im = _planes((8, 16, 32), torch.bfloat16, seed=12)
    first = tt.fftn_split(re, im, precision="bfloat16")
    assert sorted(made) == [8, 16, 32]
    again = tt.fftn_split(re, im, precision="bfloat16")
    assert sorted(made) == [8, 16, 32]
    assert all(torch.equal(a, b) for a, b in zip(first, again))
    tt.fftn_split(re, im, precision="float32")
    assert len(made) == 6
    tt.fftn_split(re, im, precision="bfloat16", tuning={"grouped": False})
    tt.fftn_split(re, im, precision="bfloat16", tuning={"grouped": False})
    assert len(made) == 12


def test_nd_plans_follow_the_tuner_cache_file(tmp_path, monkeypatch):
    """Under ``tuning="auto"`` a kept plan is dropped once this process
    saves a tuner cache, and plans are kept per cache file."""
    from tensorfft_tpu_torch.tuning import TunerCache

    path = tmp_path / "cache.json"
    monkeypatch.setenv("TENSORFFT_TUNER_CACHE", str(path))
    kw = {"precision": "bfloat16", "tuning": "auto"}
    assert fft_module._nd_plan(64, kw).radices == tt.create_plan(64).radices
    cache = TunerCache(path)
    cache.put(64, "bfloat16", "cpu", {"radices": [8, 8]})
    cache.save()
    assert fft_module._nd_plan(64, kw).radices == (8, 8)
    cache.put(64, "bfloat16", "cpu", {"radices": [4, 16]})
    cache.save()
    assert fft_module._nd_plan(64, kw).radices == (4, 16)
    monkeypatch.setenv("TENSORFFT_TUNER_CACHE", str(tmp_path / "other.json"))
    assert fft_module._nd_plan(64, kw).radices == tt.create_plan(64).radices
