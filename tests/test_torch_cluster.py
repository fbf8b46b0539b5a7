"""Plans past one CTA: the JAX package's single-pass plans at N = 32768 and
65536, four-step passes of 32768, bf16x6 with mult3 at N = 16384, K3 and the
R2C fused route past 16384, which the port runs on thread-block clusters
(``fused_cuda.fit_cta``, and for the column passes
``fused_cuda.column_cluster``; ``csrc/fft_mma_cluster.cuh``).

On the CPU the wrappers run their plain versions, so these tests hold the
port's plans and transforms against the JAX package (Pallas interpret mode)
and check the cluster choice and ``plan_works_on_device``; the kernels
themselves are checked on the card (``tests/test_torch_gpu.py``,
``chip_smoke.py`` path ``bign``).

Tolerances (``testing.metrics.agreement``): the bound of
``tests/test_torch_fft.py``'s port-vs-JAX test, one bf16 ulp of the output
scale on at most 1 % of elements past N = 16384 (fp32 storage: 1e-5
relative on as many); under a bf16 state two bf16 ulps on at most 2 %.
"""
import dataclasses
import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tensorfft_tpu as tfft
from tensorfft_tpu.plan import optimal_radices
from tensorfft_tpu.tuning.tuner import get_run_configs, get_search_space
import tensorfft_tpu_torch as tt
from tensorfft_tpu_torch.ops import four_step_cuda, fused_cuda
from tensorfft_tpu_torch.testing import agreement
from tensorfft_tpu_torch.testing.metrics import (BF16_STATE_MAX_FRAC,
                                                 BF16_STATE_MAX_SCALE_ULPS,
                                                 FOUR_STEP_MAX_FRAC)

torch.set_num_threads(1)

# The module (tensorfft_tpu's package attribute ``rfft`` is the function).
j_rfft = importlib.import_module("tensorfft_tpu.rfft")

# The JAX package's bench headline structure (its TPU tuner cache, key
# n=16384,precision=bfloat16,platform=tpu), with mult3 under bf16x6.
HEADLINE = {"batch": 4096, "grouped": True, "lane_tile": 128,
            "radices": [64, 256], "strategy": "fused"}
# (label, N, precision, tuning): every plan of the path.
PATH_PLANS = [
    ("fused 32768 bf16", 32768, "bfloat16",
     {"strategy": "fused", "radices": (256, 128), "max_fused_length": 32768}),
    ("fused 32768 float32 bf16 state", 32768, "float32",
     {"strategy": "fused", "radices": optimal_radices(32768),
      "max_fused_length": 32768, "state_dtype": "bfloat16"}),
    ("fused 65536 bf16 state", 65536, "bfloat16",
     {"strategy": "fused", "radices": (256, 256), "max_fused_length": 65536,
      "state_dtype": "bfloat16"}),
    ("fused 65536 mult3 float32", 65536, "float32",
     {"strategy": "fused", "radices": (128, 4, 128), "max_fused_length": 65536,
      "complex_mult": "mult3"}),
    ("four-step (4096, 32768)", 1 << 27, "bfloat16",
     {"strategy": "four_step", "four_step_split": (4096, 32768)}),
    ("four-step (32768, 4096)", 1 << 27, "bfloat16",
     {"strategy": "four_step", "four_step_split": (32768, 4096)}),
    ("bf16x6 mult3 16384", 16384, "float32_x6",
     dict(HEADLINE, complex_mult="mult3")),
    ("K3 32768", 32768, "bfloat16",
     {"strategy": "fused", "radices": (256, 128), "max_fused_length": 32768}),
    ("R2C half-length 32768", 32768, "bfloat16", {"max_fused_length": 32768}),
]


def _fields(plan):
    return {k: getattr(v, "value", v)
            for k, v in dataclasses.asdict(plan).items()}


def _np(x):
    return np.asarray(x.float().numpy() if isinstance(x, torch.Tensor) else x,
                      np.float32)


def _rows(b, n, seed, count=2):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((b, n)).astype(np.float32) for _ in range(count)]


def _assert_agrees(got, want, precision, state_dtype="float32"):
    bf16 = precision == "bfloat16" or state_dtype == "bfloat16"
    a = agreement([_np(g) for g in got], [_np(w) for w in want], bf16=bf16)
    if state_dtype == "bfloat16":
        assert a.within(BF16_STATE_MAX_FRAC, BF16_STATE_MAX_SCALE_ULPS), a
    else:
        assert a.within(FOUR_STEP_MAX_FRAC), a


@pytest.mark.parametrize("label,n,precision,tuning", PATH_PLANS,
                         ids=[p[0] for p in PATH_PLANS])
def test_path_plans_equal_jax_and_work_on_cuda(label, n, precision, tuning):
    layout = "batch_major" if label.startswith("K3") else None
    got = tt.create_plan(n, precision=precision, tuning=tuning,
                         fused_layout=layout)
    want = tfft.create_plan(n, precision=precision, tuning=tuning,
                            fused_layout=layout)
    assert _fields(got) == _fields(want)
    assert tt.plan_works_on_device(got, "cuda") == (True, "ok")


@pytest.mark.parametrize("forward", [True, False])
@pytest.mark.parametrize("label", ["fused 32768 bf16",
                                   "fused 32768 float32 bf16 state"])
def test_fft_split_matches_jax_past_one_cta(label, forward):
    # The single-pass plan at N = 32768: kernel A on a cluster of two CTAs
    # on the card, its plain version here.
    _, n, precision, tuning = next(p for p in PATH_PLANS if p[0] == label)
    re, im = _rows(2, n, seed=n)
    plan = tt.create_plan(n, precision=precision, tuning=tuning)
    dtype = plan.precision.storage_dtype
    t_fn = tt.fft_split if forward else tt.ifft_split
    j_fn = tfft.fft_split if forward else tfft.ifft_split
    got = t_fn(torch.from_numpy(re).to(dtype), torch.from_numpy(im).to(dtype),
               plan)
    want = j_fn(re, im, tfft.create_plan(n, precision=precision, tuning=tuning))
    assert got[0].dtype is dtype and got[0].shape == (2, n)
    _assert_agrees(got, want, precision, plan.state_dtype)


@pytest.mark.parametrize("split", [(2, 32768), (32768, 2)])
def test_four_step_pass_of_32768_matches_jax(split):
    # The smallest N whose four-step plan has a 32768-point pass; the pass
    # runs on a cluster of two CTAs on the card (kernel C, then kernel B).
    n = split[0] * split[1]
    tuning = {"strategy": "four_step", "four_step_split": split}
    re, im = _rows(1, n, seed=split[0])
    plan = tt.create_plan(n, tuning=tuning)
    assert tt.plan_works_on_device(plan, "cuda") == (True, "ok")
    got = tt.fft_split(torch.from_numpy(re).to(torch.bfloat16),
                       torch.from_numpy(im).to(torch.bfloat16), plan)
    want = tfft.fft_split(re, im, tfft.create_plan(n, tuning=tuning))
    _assert_agrees(got, want, "bfloat16")


def test_batch_major_past_one_cta_matches_jax():
    _, n, precision, tuning = next(p for p in PATH_PLANS if p[0] == "K3 32768")
    re, im = _rows(16, n, seed=3)
    plan = tt.create_plan(n, tuning=tuning, fused_layout="batch_major")
    before = four_step_cuda.fused_fft_batch_major.launches
    got = tt.fft_split(torch.from_numpy(re).to(torch.bfloat16),
                       torch.from_numpy(im).to(torch.bfloat16), plan)
    assert four_step_cuda.fused_fft_batch_major.launches == before  # CPU
    want = tfft.fft_split(re, im, tfft.create_plan(
        n, tuning=tuning, fused_layout="batch_major"))
    _assert_agrees(got, want, precision)


def test_rfft_fused_route_past_one_cta_matches_jax():
    # Real N = 65536 with max_fused_length = 32768: the fused R2C route,
    # whose half-length transform takes a cluster of two CTAs.  Both
    # packages take the same bf16 rows, and both inverses the port's
    # spectrum (as tests/test_torch_rfft.py holds them).
    (x,) = _rows(1, 65536, seed=5, count=1)
    x = torch.from_numpy(x).to(torch.bfloat16)
    jx = jnp.asarray(x.float().numpy(), jnp.bfloat16)
    plan = tt.create_plan(32768, max_fused_length=32768)
    jplan = tfft.create_plan(32768, max_fused_length=32768)
    assert plan.resolve_strategy() is tt.Strategy.FUSED
    spec = tt.rfft_split(x, plan)
    _assert_agrees(spec, j_rfft.rfft_split(jx, jplan, epilogue="pallas"),
                   "bfloat16")
    spec = [s.float() for s in spec]
    back = tt.irfft_split(*spec, plan)
    j_back = j_rfft.irfft_split(*[jnp.asarray(s.numpy()) for s in spec], jplan,
                                epilogue="pallas")
    _assert_agrees([back], [j_back], "bfloat16")


@pytest.mark.parametrize("n", [32768, 65536])
def test_every_jax_fused_bign_config_works_on_cuda(n):
    configs = get_run_configs(get_search_space(n))
    bign = [c for c in configs if c.strategy == "fused"]
    assert len(bign) == (8 if n == 32768 else 3)
    for cfg in configs:
        got = tt.create_plan(n, tuning=cfg.as_tuning())
        assert _fields(got) == _fields(tfft.create_plan(n, tuning=cfg.as_tuning()))
        assert tt.plan_works_on_device(got, "cuda") == (True, "ok"), cfg


def _fit(n, algorithm, mult3=False, lanes=1):
    radices = (128,) + (n // 128,) if mult3 else (n,)
    stages = fused_cuda.pass_stages(radices, complex_mult="mult3" if mult3
                                    else "block")
    return fused_cuda.fit_cta(n, lanes, algorithm, stages, "test")


# (N, dot algorithm, mult3 stages, CTAs per transform; None: refused).
CLUSTER_TABLE = [
    (16384, "bf16", False, 1),
    (32768, "bf16", False, 2),
    (65536, "bf16x3", False, 4),
    (131072, "bf16", False, 8),
    (16384, "bf16x6", True, 2),
    (262144, "bf16", False, None),
    (131072, "bf16x6", True, None),
]


@pytest.mark.parametrize("n,algorithm,mult3,cluster", CLUSTER_TABLE)
def test_cluster_choice(n, algorithm, mult3, cluster):
    if cluster is None:
        with pytest.raises(ValueError, match="cluster of 8 CTAs"):
            _fit(n, algorithm, mult3)
        return
    assert _fit(n, algorithm, mult3) == (1, cluster)


def test_one_cta_plans_keep_their_kernel():
    # Every pass one CTA held keeps one CTA and its lanes: a cluster only
    # where no CTA can hold the transform.
    for n in (1 << p for p in range(1, 15)):
        for alg in ("bf16", "bf16ax2", "bf16x3", "bf16x6"):
            for other in (1, 8, 4096):
                lanes = four_step_cuda.pass_lanes(n, other)
                assert _fit(n, alg, lanes=lanes) == (lanes, 1)
    # mult3's third plane halves the lanes before any cluster is taken.
    assert _fit(8192, "bf16x6", True, lanes=2) == (1, 1)


# (n1, columns n2, dot algorithm, mult3 stages, (lanes, cluster)) of the
# column-cluster rule: one CTA keeps pass_lanes' tile; past it, each
# doubling of the lanes doubles fit_cta's cluster, while the lanes divide
# n2 and the cluster stays within 8 CTAs.
COLUMN_TABLE = [
    (16384, 4096, "bf16", False, (1, 1)),
    (4096, 4096, "bf16", False, (4, 1)),
    (32768, 4096, "bf16", False, (4, 8)),   # the 2^27 split (32768, 4096)
    (32768, 32, "bf16", False, (4, 8)),
    (32768, 2, "bf16", False, (2, 4)),
    (32768, 1, "bf16", False, (1, 2)),
    (32768, 4096, "bf16x3", False, (4, 8)),
    (65536, 4096, "bf16", False, (2, 8)),
    (131072, 4096, "bf16", False, (1, 8)),
    (16384, 4096, "bf16x6", True, (4, 8)),
    (8192, 4096, "bf16x6", True, (1, 1)),
]


@pytest.mark.parametrize("n,other,algorithm,mult3,want", COLUMN_TABLE)
def test_column_cluster_rule(n, other, algorithm, mult3, want):
    radices = (128,) + (n // 128,) if mult3 else (n,)
    stages = fused_cuda.pass_stages(radices, complex_mult="mult3" if mult3
                                    else "block")
    lanes = four_step_cuda.pass_lanes(n, other)
    assert fused_cuda.column_cluster(n, lanes, other, algorithm, stages,
                                     "test") == want
    # Each CTA of the cluster holds what it held with one lane.
    _, fit = _fit(n, algorithm, mult3)
    assert want[1] == 1 or n * want[0] // want[1] == n // fit


def test_column_cluster_refuses_past_8_ctas():
    stages = fused_cuda.pass_stages((1 << 18,))
    with pytest.raises(ValueError, match="cluster of 8 CTAs"):
        fused_cuda.column_cluster(1 << 18, 1, 4096, "bf16", stages, "test")


def test_cluster_refusal_names_the_limit():
    ok, why = tt.plan_works_on_device(
        tt.create_plan(1 << 18, max_fused_length=1 << 18), "cuda")
    assert not ok and "cluster of 8 CTAs" in why


def test_variant_names_the_cluster():
    stages = fused_cuda.pass_stages((256, 128))
    assert fused_cuda.variant("stacked", stages, "float32") == "mma"
    assert fused_cuda.variant("stacked", stages, "float32", 2) == "cluster2"
    assert (fused_cuda.variant("stacked", stages, "bfloat16", 4)
            == "bf16_state,cluster4")
