"""The port's ``memory.py`` and ``testing/io.py`` against the JAX package on
the CPU: layout helpers round trip, ``donate_fft`` equals ``fft_split``, and
every file writer produces the JAX package's bytes on the same arrays."""
import inspect

import numpy as np
import pytest
import torch

import tensorfft_tpu as tfft
import tensorfft_tpu_torch as tt
from tensorfft_tpu import memory as jax_memory
from tensorfft_tpu.testing import io as jax_io
from tensorfft_tpu_torch import memory
from tensorfft_tpu_torch.testing import agreement, io

torch.set_num_threads(1)


def test_public_names_cover_jax():
    assert set(tfft.__all__) <= set(tt.__all__)
    for name in tt.__all__:
        assert hasattr(tt, name), name


def test_interleaved_roundtrip():
    buf = np.arange(16.0).reshape(2, 8)
    re, im = memory.interleaved_to_split(buf)
    j_re, j_im = jax_memory.interleaved_to_split(buf)
    assert np.array_equal(re, j_re) and np.array_equal(im, j_im)
    assert np.array_equal(memory.split_to_interleaved(re, im), buf)
    t = torch.from_numpy(buf)
    t_re, t_im = memory.interleaved_to_split(t)
    assert np.array_equal(t_re.numpy(), re) and np.array_equal(t_im.numpy(), im)
    t_re[0, 0] = -1.0  # a copy, not a view of the buffer
    assert buf[0, 0] == 0.0
    assert torch.equal(memory.split_to_interleaved(*memory.interleaved_to_split(t)), t)


@pytest.mark.parametrize("precision,dtype", [("bfloat16", torch.bfloat16),
                                             ("float32", torch.float32)])
def test_device_staging(precision, dtype):
    plan = tt.create_plan(256, precision=precision)
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 256))
    re, im = memory.to_device_split(x[0], x[1], plan, device="cpu")
    assert re.dtype == dtype and im.device.type == "cpu"
    h_re, h_im = memory.from_device_split(re, im)
    j_re, j_im = jax_memory.from_device_split(
        *jax_memory.to_device_split(x[0], x[1], tfft.create_plan(256, precision=precision)))
    assert h_re.dtype == np.float32
    assert np.array_equal(h_re, j_re) and np.array_equal(h_im, j_im)
    assert memory.to_device_split(x[0], x[1], device="cpu")[0].dtype == torch.bfloat16
    assert inspect.signature(memory.to_device_split).parameters["device"].default == "cuda"


@pytest.mark.parametrize("forward", [True, False])
def test_donate_fft_matches(forward):
    # JAX tests/test_memory.py: against fft_split at 1e-6.
    n = 512
    plan = tt.create_plan(n, precision="float32", strategy="staged")
    rng = np.random.default_rng(0)
    re = rng.standard_normal(n).astype(np.float32)
    im = rng.standard_normal(n).astype(np.float32)
    j_fn = tfft.fft_split if forward else tfft.ifft_split
    want = j_fn(re, im, tfft.create_plan(n, precision="float32", strategy="staged"))
    t_re, t_im = memory.to_device_split(re, im, plan, device="cpu")
    ours = (tt.fft_split if forward else tt.ifft_split)(t_re, t_im, plan)
    got = memory.donate_fft(plan, forward)(t_re, t_im)
    assert got[0] is t_re and got[1] is t_im  # written into the inputs
    assert all(torch.equal(g, o) for g, o in zip(got, ours))
    if forward:
        np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), atol=1e-6)
        np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]), atol=1e-6)
    else:
        # The inverse is unscaled (outputs up to ~60): F32_REL_TOL of the
        # largest output.
        a = agreement([g.numpy() for g in got], [np.asarray(w) for w in want],
                      bf16=False)
        assert a.within(), a
    with pytest.raises(ValueError, match="storage dtype"):
        memory.donate_fft(plan)(t_re.double(), t_im.double())


def _planes():
    rng = np.random.default_rng(7)
    return rng.standard_normal((2, 3, 5)).astype(np.float32)


def _same_bytes(a, b):
    with open(a, "rb") as fa, open(b, "rb") as fb:
        return fa.read() == fb.read()


def test_result_files_match_jax(tmp_path):
    re, im = _planes()
    io.write_results_to_file(tmp_path / "t.dat", re[0], im[0])
    jax_io.write_results_to_file(tmp_path / "j.dat", re[0], im[0])
    assert _same_bytes(tmp_path / "t.dat", tmp_path / "j.dat")
    # A tensor (bf16 included) writes the same bytes as its float32 values.
    io.write_results_to_file(tmp_path / "b.dat", torch.from_numpy(re[0]).to(torch.bfloat16),
                             torch.from_numpy(im[0]).to(torch.bfloat16))
    jax_io.write_results_to_file(
        tmp_path / "jb.dat",
        torch.from_numpy(re[0]).to(torch.bfloat16).float().numpy(),
        torch.from_numpy(im[0]).to(torch.bfloat16).float().numpy())
    assert _same_bytes(tmp_path / "b.dat", tmp_path / "jb.dat")
    r, i = io.read_results_from_file(tmp_path / "t.dat")
    assert np.array_equal(r, re[0]) and np.array_equal(i, im[0])

    paths = io.write_result_batch_to_files(str(tmp_path / "tb"), torch.from_numpy(re),
                                           torch.from_numpy(im))
    j_paths = jax_io.write_result_batch_to_files(str(tmp_path / "jb"), re, im)
    assert len(paths) == 3
    assert all(_same_bytes(p, q) for p, q in zip(paths, j_paths))
    r, i = io.read_result_batch_from_files(paths)
    assert np.array_equal(r, re) and np.array_equal(i, im)


def test_compare_result_files_match_jax(tmp_path):
    re, im = _planes()
    paths = io.write_result_batch_to_files(str(tmp_path / "x"), re, im)
    got = io.compare_many_result_files(paths, paths[0])
    want = jax_io.compare_many_result_files(paths, paths[0])
    assert [(d.average, d.sigma, d.maximum) for d in got] == \
        [(d.average, d.sigma, d.maximum) for d in want]
    assert got[0].maximum == 0.0
    io.write_results_to_file(tmp_path / "short.dat", re[0][:3], im[0][:3])
    with pytest.raises(ValueError, match="length mismatch"):
        io.compare_result_files(paths[0], tmp_path / "short.dat")


def test_tables_match_jax(tmp_path):
    acc = [{"fft_length": 256, "avg": 1.5e-4, "sigma": 2e-4, "max": 1.2e-3},
           {"fft_length": 512, "avg": 1e-4, "sigma": 1.1e-4, "max": 9e-4,
            "seed": 3}]
    bench = [{"fft_length": 4096, "batch": 256, "avg_time_us": 12.3456,
              "sigma_us": 0.5, "gflops": 1234.56},
             {"fft_length": 16384, "avg_time_us": 100.0}]
    for name, rows in (("write_accuracy_table", acc), ("write_bench_table", bench)):
        getattr(io, name)(tmp_path / f"t_{name}.dat", rows)
        getattr(jax_io, name)(tmp_path / f"j_{name}.dat", rows)
        for suffix in ("", ".json"):
            assert _same_bytes(tmp_path / f"t_{name}.dat{suffix}",
                               tmp_path / f"j_{name}.dat{suffix}"), name


def test_tuner_data_matches_jax(tmp_path):
    class Config:
        def __init__(self, **kw):
            self.kw = kw

        def as_tuning(self):
            return dict(self.kw)

    audit = [
        ({"radices": (64, 256), "strategy": "fused"}, 123456.0, 789.0, "sweep"),
        (Config(four_step_split=(128, 128), grouped=True), float("inf"), 0.0, "sweep"),
        (Config(radices=(128, 128), state_dtype="bfloat16"), 98765.4, 12.3, "guard"),
    ]
    winner = {"radices": (64, 256), "strategy": "fused"}
    got = io.write_tuner_data(16384, 4096, "bfloat16", audit, winner,
                              tmp_path / "t", tag="_x")
    want = jax_io.write_tuner_data(16384, 4096, "bfloat16", audit, winner,
                                   tmp_path / "j", tag="_x")
    assert got.name == want.name == "tuner_data_16384_x.dat"
    for suffix in ("", ".json"):
        assert _same_bytes(f"{got}{suffix}", f"{want}{suffix}")


def test_log_matches_jax(tmp_path):
    for w, p in ((io.write_log, tmp_path / "t.log"), (jax_io.write_log, tmp_path / "j.log")):
        w(p, ["first\n", "second"])
        w(p, ["third"])
    assert _same_bytes(tmp_path / "t.log", tmp_path / "j.log")
