"""The JAX package's TPU tuner-cache entries (``tensorfft_tpu/tuning/
tuner_cache.json``) as plans of the port: each plans field for field as in
the JAX package and is accepted by ``plan_works_on_device(plan, "cuda")``
(budgeted from the H100's shared memory, no card needed); three of them
through ``fft_split`` / ``ifft_split`` / ``rfft_split`` on the CPU at a cut
batch against the JAX package with the same plan.

Tolerance: the fused or four-step agreement bound of ``testing.metrics``
for fp32 state; two bf16 ulps on at most 2 % of elements under a bf16 state.
"""
import dataclasses
import json
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tensorfft_tpu as tfft
import tensorfft_tpu_torch as tt
from tensorfft_tpu_torch.testing import agreement
from tensorfft_tpu_torch.testing.metrics import (BF16_STATE_MAX_FRAC,
                                                 BF16_STATE_MAX_SCALE_ULPS,
                                                 FOUR_STEP_MAX_FRAC,
                                                 FUSED_MAX_FRAC)

import _strict_jax

torch.set_num_threads(1)

_CACHE = (Path(__file__).resolve().parent.parent / "tensorfft_tpu" / "tuning"
          / "tuner_cache.json")
ENTRIES = json.loads(_CACHE.read_text())["entries"]


def _key(key):
    fields = dict(kv.split("=") for kv in key.split(","))
    return int(fields["n"]), fields["precision"]


def _value(v):
    return v.value if hasattr(v, "value") else v


def test_cache_has_the_thirty_entries():
    assert len(ENTRIES) == 30


@pytest.mark.parametrize("key", sorted(ENTRIES))
def test_cache_entry_plans_as_in_jax(key):
    n, precision = _key(key)
    entry = ENTRIES[key]
    tplan = tt.create_plan(n, precision=precision, tuning=entry)
    jplan = tfft.create_plan(n, precision=precision, tuning=entry)
    t_fields, j_fields = dataclasses.asdict(tplan), dataclasses.asdict(jplan)
    common = set(t_fields) & set(j_fields)
    assert len(common) == len(t_fields)
    for name in common:
        assert _value(t_fields[name]) == _value(j_fields[name]), name
    assert tt.plan_works_on_device(tplan, "cuda") == (True, "ok")


def _planes(shape, dtype, seed, count=2):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
            .to(dtype) for _ in range(count)]


def _np(x):
    return np.asarray(x.float().numpy() if isinstance(x, torch.Tensor) else x,
                      np.float32)


# (cache key, rows): the packed grouped fused plan (p = 4 in JAX), a grouped
# fused plan with a radix-128 fold, and the mult3 + bf16-state four-step.
SLICE_CASES = [("n=512,precision=bfloat16,platform=tpu", 4),
               ("n=8192,precision=bfloat16,platform=tpu", 2),
               ("n=32768,precision=bfloat16,platform=tpu", 1)]


@pytest.mark.parametrize("key,rows", SLICE_CASES)
def test_cache_entries_through_the_entry_points(key, rows):
    n, precision = _key(key)
    entry = ENTRIES[key]
    tplan = tt.create_plan(n, precision=precision, tuning=entry)
    jplan = tfft.create_plan(n, precision=precision, tuning=entry)
    four_step = tplan.resolve_strategy() is tt.Strategy.FOUR_STEP
    if tplan.state_dtype == "bfloat16":
        bound = dict(max_frac=BF16_STATE_MAX_FRAC,
                     max_ulps=BF16_STATE_MAX_SCALE_ULPS)
    else:
        bound = dict(max_frac=FOUR_STEP_MAX_FRAC if four_step else FUSED_MAX_FRAC)

    def check(got, want):
        a = agreement([_np(g) for g in got], [_np(w) for w in want], bf16=True)
        assert a.within(**bound), a

    re, im = _planes((rows, n), torch.bfloat16, seed=n)
    (x,) = _planes((rows, 2 * n), torch.bfloat16, seed=n + 1, count=1)
    spec = tt.fft_split(re, im, tplan)
    got = [spec, tt.ifft_split(*spec, tplan), tt.rfft_split(x, tplan)]
    args = [(re, im), spec, (x,)]
    fns = ["fft_split", "ifft_split", "rfft_split"]
    if tplan.complex_mult == "mult3" and tplan.state_dtype == "bfloat16":
        # mult3 under a bf16 state: the JAX side runs in _strict_jax.
        plan = dict(fft_length=n, precision=precision, tuning=entry)
        want = _strict_jax.run([
            _strict_jax.call(f"tensorfft_tpu.{fn}", [_np(a) for a in a_s],
                             "bfloat16", plan=plan)
            for fn, a_s in zip(fns, args)])
    else:
        want = [getattr(tfft, fn)(*(jnp.asarray(_np(a), jnp.bfloat16)
                                    for a in a_s), jplan)
                for fn, a_s in zip(fns, args)]
    for g, w in zip(got, want):
        check(g, w)
