"""Port planner and DFT tables against the JAX package: bit-identical.

Also checks that the port imports without jax, and its device budget."""
import dataclasses
import subprocess
import sys

import numpy as np
import pytest
import torch

import tensorfft_tpu.dft as jdft
import tensorfft_tpu.plan as jplan
import tensorfft_tpu_torch as tt
import tensorfft_tpu_torch.dft as tdft
import tensorfft_tpu_torch.plan as tplan

torch.set_num_threads(1)


def _fields(plan):
    d = dataclasses.asdict(plan)
    d["precision"] = plan.precision.value
    d["strategy"] = plan.strategy.value
    return d


@pytest.mark.parametrize("precision", ["bfloat16", "float32", "float32_x6", "float64"])
def test_default_plans_identical(precision):
    for p in range(1, 28):
        n = 1 << p
        assert _fields(tt.create_plan(n, precision=precision)) == _fields(
            jplan.create_plan(n, precision=precision)), n


@pytest.mark.parametrize("kwargs", [
    dict(max_fused_length=64),
    dict(strategy="four_step"),
    dict(strategy="staged", scaling="none"),
    dict(radices=(4, 4, 16), lane_tile=256),
    dict(tuning={"four_step_split": (64, 1024), "row_radices": [32, 32],
                 "first_dot": "bf16ax2", "k1_tile": 256}),
])
def test_plans_with_options_identical(kwargs):
    n = 65536 if "tuning" in kwargs else 4096 if "max_fused_length" in kwargs else 256
    assert _fields(tt.create_plan(n, **kwargs)) == _fields(
        jplan.create_plan(n, **kwargs))


def test_radix_helpers_identical():
    for p in range(1, 28):
        n = 1 << p
        assert tplan.optimal_radices(n) == jplan.optimal_radices(n)
        assert tplan.balanced_radices(n) == jplan.balanced_radices(n)
        for mf in (64, 1024, 16384):
            try:
                want = jplan.default_four_step_split(n, mf)
            except ValueError:
                with pytest.raises(ValueError):
                    tplan.default_four_step_split(n, mf)
                continue
            assert tplan.default_four_step_split(n, mf) == want


def test_precision_maps_to_torch_dtypes():
    P = tt.Precision
    assert P.BFLOAT16.storage_dtype is torch.bfloat16
    assert P.FLOAT32.storage_dtype is torch.float32
    assert P.FLOAT64.compute_dtype is torch.float64
    assert [p.dot_algorithm for p in P] == [p.dot_algorithm for p in jplan.Precision]
    assert tt.Strategy("torch") is tt.Strategy.TORCH


def test_tuning_auto_over_an_empty_cache_plans_untuned(tmp_path, monkeypatch):
    monkeypatch.setenv("TENSORFFT_TUNER_CACHE", str(tmp_path / "absent.json"))
    for n in (256, 4096, 1 << 20):
        assert _fields(tt.create_plan(n, tuning="auto")) == _fields(tt.create_plan(n))


@pytest.mark.parametrize("radix", [2, 8, 64, 128, 256])
@pytest.mark.parametrize("sign", [tdft.FORWARD, tdft.INVERSE])
def test_dft_tables_identical(radix, sign):
    for dtype in (np.float32, np.float64):
        for a, b in zip(tdft.dft_matrix(radix, dtype, sign, 1.0 / radix),
                        jdft.dft_matrix(radix, dtype, sign, 1.0 / radix)):
            assert a.dtype == b.dtype and np.array_equal(a, b)
        for a, b in zip(tdft.stage_twiddle(radix, 64, dtype, sign),
                        jdft.stage_twiddle(radix, 64, dtype, sign)):
            assert a.dtype == b.dtype and np.array_equal(a, b)


@pytest.mark.parametrize("n1,n2,t", [(64, 64, 64), (128, 256, 128), (256, 4096, 128)])
def test_four_step_twiddle_tables_identical(n1, n2, t):
    for sign in (tdft.FORWARD, tdft.INVERSE):
        for a, b in zip(tdft.four_step_twiddle_factors(n1, n2, t, sign=sign),
                        jdft.four_step_twiddle_factors(n1, n2, t, sign=sign)):
            assert np.array_equal(a, b)


def test_plan_works_on_device():
    ok, _ = tt.plan_works_on_device(tt.create_plan(16384), "cuda")
    assert ok
    ok, _ = tt.plan_works_on_device(tt.create_plan(1 << 20, precision="float32_x6"), "cuda")
    assert ok
    # A fused transform past one CTA runs on a thread-block cluster of up to
    # 8 CTAs (131072 elements); past that the plan is refused.
    assert tt.plan_works_on_device(tt.create_plan(32768, max_fused_length=32768),
                                   "cuda") == (True, "ok")
    ok, why = tt.plan_works_on_device(tt.create_plan(1 << 18, max_fused_length=1 << 18),
                                      "cuda")
    assert not ok and "cluster of 8 CTAs" in why
    ok, why = tt.plan_works_on_device(tt.create_plan(4096, precision="float64"), "cuda")
    assert not ok and "float64" in why
    # Every engine and knob has a kernel; mult3's third operand plane makes
    # one bf16x6 transform of 16384 too large for a CTA, so it takes a
    # cluster of two, and one of 131072 too large for a cluster of 8.
    for tuning in ({"engine": "gridslice"}, {"state_dtype": "bfloat16"},
                   {"grouped": True, "complex_mult": "mult3"}):
        assert tt.plan_works_on_device(tt.create_plan(4096, tuning=tuning),
                                       "cuda") == (True, "ok")
    assert tt.plan_works_on_device(tt.create_plan(
        16384, precision="float32_x6",
        tuning={"radices": (128, 128), "complex_mult": "mult3"}), "cuda") == (True, "ok")
    ok, why = tt.plan_works_on_device(tt.create_plan(
        1 << 17, precision="float32_x6",
        tuning={"radices": (128, 32, 32), "complex_mult": "mult3",
                "max_fused_length": 1 << 17}), "cuda")
    assert not ok and "mult3" in why and "cluster of 8 CTAs" in why
    # CPU tensors take the plain versions, which run every plan.
    assert tt.plan_works_on_device(tt.create_plan(32768, max_fused_length=32768), "cpu")[0]


def test_port_imports_without_jax():
    code = ("import sys, tensorfft_tpu_torch, tensorfft_tpu_torch.testing, "
            "tensorfft_tpu_torch.ops.four_step_cuda, tensorfft_tpu_torch.ops.stages_torch, "
            "tensorfft_tpu_torch.tuning; "
            "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.') "
            "or m.startswith('tensorfft_tpu.') or m == 'tensorfft_tpu']; "
            "print(bad); sys.exit(1 if bad else 0)")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
