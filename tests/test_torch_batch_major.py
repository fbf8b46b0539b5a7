"""K3 of the port (``four_step_cuda.fused_fft_batch_major``) and the
``fused_layout="batch_major"`` dispatch against the JAX package's
(``four_step_pallas.fused_fft_batch_major``, Pallas interpret mode)."""
import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tensorfft_tpu as tfft
from tensorfft_tpu.fft import stage_scales
from tensorfft_tpu.ops import four_step_pallas
import tensorfft_tpu_torch as tt
from tensorfft_tpu_torch.ops import four_step_cuda, fused_cuda
from tensorfft_tpu_torch.testing import agreement

# The packages export functions named fft, which shadow the modules.
j_fft = importlib.import_module("tensorfft_tpu.fft")
t_fft = importlib.import_module("tensorfft_tpu_torch.fft")

torch.set_num_threads(1)

STORAGE = {"bfloat16": (torch.bfloat16, jnp.bfloat16),
           "float32": (torch.float32, jnp.float32)}


def _planes(b, n, precision, seed):
    rng = np.random.default_rng(seed)
    tdt, jdt = STORAGE[precision]
    out = []
    for _ in range(2):
        t = torch.from_numpy(rng.standard_normal((b, n)).astype(np.float32)).to(tdt)
        out.append((t, jnp.asarray(t.float().numpy(), jdt)))
    return out


def _np(x):
    return np.asarray(x.float().numpy() if isinstance(x, torch.Tensor) else x,
                      np.float32)


@pytest.mark.parametrize("b,k3", [(64, True), (7, False), (24, True), (2, True)])
def test_batch_major_dispatch_matches_jax(b, k3, monkeypatch):
    # K3 where the JAX dispatch runs fused_fft_batch_major (a row tile of at
    # least 8, or the whole batch), else kernel A.
    calls = {"jax": 0, "port": 0, "kernel_a": 0}

    def spy(module, name, key):
        original = getattr(module, name)

        def counted(*args, **kwargs):
            calls[key] += 1
            return original(*args, **kwargs)
        monkeypatch.setattr(module, name, counted)

    spy(four_step_pallas, "fused_fft_batch_major", "jax")
    spy(four_step_cuda, "fused_fft_batch_major", "port")
    spy(fused_cuda, "fused_fft", "kernel_a")
    n = 256
    (re, jre), (im, jim) = _planes(b, n, "bfloat16", seed=b)
    got = tt.fft_split(re, im, fused_layout="batch_major")
    want = tfft.fft_split(jre, jim, fused_layout="batch_major")
    assert calls == {"jax": int(k3), "port": int(k3), "kernel_a": int(not k3)}
    a = agreement([_np(g) for g in got], [_np(w) for w in want], bf16=True)
    assert a.within(), a
    # The default layout always takes kernel A.
    tt.fft_split(re, im)
    assert calls["port"] == int(k3) and calls["kernel_a"] == int(not k3) + 1


@pytest.mark.parametrize("b", [1, 2, 7, 8, 24, 64, 128, 256])
def test_batch_major_ok_is_the_jax_rule(b):
    for layout in ("auto", "batch_major", "transform_major"):
        t_plan = tt.create_plan(512, fused_layout=layout)
        j_plan = tfft.create_plan(512, fused_layout=layout)
        assert t_fft._batch_major_ok(t_plan, b) == j_fft._batch_major_ok(j_plan, b)


@pytest.mark.parametrize("engine", ["stacked", "planar"])
@pytest.mark.parametrize("precision", ["bfloat16", "float32"])
@pytest.mark.parametrize("b,n", [(7, 512), (64, 1024)])
def test_fused_fft_batch_major_matches_jax(b, n, precision, engine):
    plan = tt.create_plan(n, precision=precision)
    (re, jre), (im, jim) = _planes(b, n, precision, seed=n + b)
    kw = dict(radices=plan.radices, scales=stage_scales(plan.radices, "forward", True),
              algorithm=plan.precision.dot_algorithm, first_dot=plan.first_dot,
              engine=engine)
    got = four_step_cuda.fused_fft_batch_major(re, im, **kw)
    want = four_step_pallas.fused_fft_batch_major(jre, jim, **kw, interpret=True)
    assert got[0].dtype is re.dtype and got[0].shape == (b, n)
    a = agreement([_np(g) for g in got], [_np(w) for w in want],
                  bf16=precision == "bfloat16")
    assert a.within(), a
    # K3 and kernel A compute the same function, one plain version.
    for g, w in zip(got, fused_cuda.fused_fft(re, im, **kw)):
        assert torch.equal(g, w)


@pytest.mark.parametrize("n,b,lanes", [
    (512, 262144, 32), (4096, 256, 4), (16384, 8, 1), (256, 64, 64),
    (256, 24, 8), (1024, 7, 1), (64, 512, 64), (512, 2, 2),
])
def test_batch_major_lanes(n, b, lanes):
    # The largest power of two <= min(row tile, 64) with n * lanes <= 16384.
    assert four_step_cuda.batch_major_lanes(n, b) == lanes


def test_fused_fft_batch_major_checks_its_operands():
    x = torch.zeros(8, 64, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="radices"):
        four_step_cuda.fused_fft_batch_major(x, x, radices=(8,), scales=(1.0,))
    with pytest.raises(ValueError, match="state_dtype"):
        four_step_cuda.fused_fft_batch_major(x, x, radices=(64,), scales=(1.0,),
                                             state_dtype="float16")
    meta = torch.empty(8, 64, dtype=torch.bfloat16, device="meta")
    with pytest.raises(ValueError, match="CUDA tensors"):
        four_step_cuda.fused_fft_batch_major(meta, meta, radices=(64,),
                                             scales=(1.0,))
    assert four_step_cuda.fused_fft_batch_major.launches == 0
