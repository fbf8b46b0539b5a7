"""The tensor-core engine's operands (``fused_cuda.mma_tables``) and its
summation order, on the CPU.

Kernel A and the in-place row pass (K3, K4's row pass) read their matrices
as bf16, each stage in its route's layout (``fused_cuda.mma_table_index``):
fragment order on the mma route, slice-major and transposed within a slice
on the vector route.  These tests hold the bf16 buffer entry for entry
against the fp32 one the other kernels read, check that each layout is a
bijection, that the CTA fit and ``plan_works_on_device`` answer as they did
before the engine existed (answers recorded as digests of the sweep), and
that a plain-torch model of the tensor-core order (k-chunks of 8 rows of
each operand plane, a chunk's sum rounded once, chunks added in fp32 in
order, partial products combined by level) agrees with the JAX package's
``fused_fft`` (Pallas interpret mode).

Tolerance of the order model against JAX: ``testing.metrics.agreement``'s
fused bound, one bf16 ulp of the output scale on at most 0.1 % of elements
(fp32 storage: 1e-5 relative on as many), the bound of
``tests/test_torch_fused.py``.
"""
import hashlib
import json
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tensorfft_tpu as tfft
from tensorfft_tpu.fft import stage_scales
from tensorfft_tpu.ops import fused_pallas
from tensorfft_tpu.tuning.tuner import get_run_configs, get_search_space
import tensorfft_tpu_torch as tt
from tensorfft_tpu_torch import dft
from tensorfft_tpu_torch.ops import dots, fused_cuda
from tensorfft_tpu_torch.testing import agreement

torch.set_num_threads(1)

CPU = torch.device("cpu")
ALGORITHM = {"bfloat16": "bf16", "float32": "bf16x3", "float32_x6": "bf16x6"}
KNOBS = [dict(grouped=True), dict(complex_mult="mult3"),
         dict(grouped=True, complex_mult="mult3"), dict(state_dtype="bfloat16"),
         dict(engine="planar"), dict(engine="planar_vpu")]


def _tables(radices, algorithm, first_dot="default", engine="stacked",
            grouped=False, complex_mult="block", state_dtype="float32"):
    scales = tuple(float(s) for s in stage_scales(radices, "forward", True))
    args = (tuple(radices), scales, -1, algorithm, first_dot, CPU, engine,
            grouped, complex_mult, state_dtype, True)
    stages = fused_cuda.pass_stages(tuple(radices), engine, grouped,
                                    complex_mult, state_dtype)
    return stages, fused_cuda.kernel_tables(*args), fused_cuda.mma_tables(*args)


def _check_buffer(radices, algorithm, **knobs):
    stages, (tables, meta), (tw, meta_m, mats) = _tables(radices, algorithm,
                                                          **knobs)
    assert tw is tables
    n = int(meta[0])
    off = np.arange(3, 3 + 4 * n, 4)
    keep = np.ones(meta.size, bool)
    keep[off] = False
    assert np.array_equal(meta[keep], meta_m[keep])  # only the offsets move
    end = 0
    for s, st in enumerate(stages):
        r, terms = int(meta[1 + 4 * s]), int(meta[2 + 4 * s])
        slices = st.k if st.fold else 1
        matrices = 3 if st.mult3 else 2
        size = terms * slices * matrices * r * r
        natural = tables[int(meta[3 + 4 * s]):][:size]
        assert torch.equal(natural.to(torch.bfloat16).float(), natural)
        pos, block = fused_cuda.mma_table_index(r, slices, matrices, terms,
                                                fused_cuda.mma_route(st))
        base = int(meta_m[3 + 4 * s])
        assert base == end and base % 8 == 0  # 16-byte table loads
        got = mats[base + torch.from_numpy(pos)].float()
        assert torch.equal(got, natural), (radices, algorithm, knobs, s)
        pad = torch.ones(block, dtype=torch.bool)
        pad[torch.from_numpy(pos)] = False
        assert not mats[base:base + block][pad].float().any()
        end = base + block
    assert end == mats.numel() and mats.dtype is torch.bfloat16


@pytest.mark.parametrize("precision", ["bfloat16", "float32", "float32_x6"])
def test_bf16_tables_equal_fp32_default_plans(precision):
    for p in range(4, 15):
        plan = tt.create_plan(1 << p, precision=precision)
        _check_buffer(plan.radices, ALGORITHM[precision],
                      first_dot=plan.first_dot)


@pytest.mark.parametrize("knobs", KNOBS, ids=lambda k: ",".join(
    f"{a}={b}" for a, b in k.items()))
@pytest.mark.parametrize("precision", ["bfloat16", "float32"])
def test_bf16_tables_equal_fp32_stage_kinds(precision, knobs):
    # Shared, folded, mult3 (folded and not), bf16 state and planar stages,
    # with radices under 8 (the vector route) in the three-stage plans.
    for radices in [(8, 8), (16, 32), (32, 128), (4, 8, 64), (16, 16, 16),
                    (8, 128, 16), (64, 256)]:
        _check_buffer(radices, ALGORITHM[precision], **knobs)


@pytest.mark.parametrize("args", [
    (8, 1, 2, 1, True), (32, 1, 2, 3, True), (128, 1, 3, 2, True),
    (2, 1, 2, 1, False), (4, 8, 2, 2, False), (16, 4, 3, 1, False),
    (256, 64, 2, 1, False)])
def test_table_layout_is_a_bijection(args):
    radix, slices, matrices, terms, mma = args
    pos, block = fused_cuda.mma_table_index(*args)
    assert pos.size == terms * slices * matrices * radix * radix
    assert np.unique(pos).size == pos.size and pos.min() >= 0 and pos.max() < block
    # Back to [term][slice][matrix][R][R]: the map inverts.
    inv = np.full(block, -1)
    inv[pos] = np.arange(pos.size)
    assert np.array_equal(inv[pos], np.arange(pos.size))
    unused = np.flatnonzero(inv < 0)
    if mma or matrices == 2:
        assert unused.size == 0
    else:  # mult3's (re, im, S) entries padded to 4
        assert np.all(unused % 4 == 3) and unused.size == pos.size // 3


def test_fragment_layout_of_one_block():
    # Lane l of chunk (q, c) holds entries r = 8c + 2(l % 4) + {0, 1} of row
    # r_out = 8q + l // 4: the A-fragment register of mma.m16n8k16.
    pos, _ = fused_cuda.mma_table_index(16, 1, 2, 1, True)
    pos = pos.reshape(1, 1, 2, 16, 16)
    for m, r_out, r in [(0, 0, 0), (0, 3, 5), (1, 9, 14), (1, 15, 15)]:
        q, c, lane = r_out // 8, r // 8, (r_out % 8) * 4 + (r % 8) // 2
        want = ((((m * 2 + q) * 2 + c) * 32 + lane) * 2) + r % 2
        assert pos[0, 0, m, r_out, r] == want


# -- the CTA fit and plan_works_on_device, as recorded before the engine ------

def _digest(x):
    return hashlib.sha256(repr(x).encode()).hexdigest()[:16]


def _fit_answers():
    out = []
    for p in range(1, 18):
        n = 1 << p
        for lanes in (1, 2, 4, 8, 16, 32, 64):
            for alg in ("bf16", "bf16ax2", "bf16x3", "bf16x6"):
                for mult3 in (False, True):
                    radices = (128, n // 128) if (mult3 and n >= 256) else (n,)
                    stages = fused_cuda.pass_stages(
                        radices, complex_mult="mult3" if mult3 else "block")
                    try:
                        got = fused_cuda.fit_cta(n, lanes, alg, stages, "t")
                    except ValueError:
                        got = None
                    out.append((n, lanes, alg, mult3, got,
                                fused_cuda.cta_smem_bytes(n, lanes, alg, mult3)))
    return out


def _plan_answers():
    out = []
    for p in range(4, 15):
        for prec in ("bfloat16", "float32", "float32_x6"):
            for knobs in [{}, {"grouped": True}, {"complex_mult": "mult3"},
                          {"grouped": True, "complex_mult": "mult3"},
                          {"state_dtype": "bfloat16"}, {"engine": "planar"},
                          {"engine": "planar_vpu"}, {"engine": "pretwiddle"}]:
                plan = tt.create_plan(1 << p, precision=prec,
                                      tuning=dict(knobs) or None)
                out.append((1 << p, prec, json.dumps(knobs, sort_keys=True),
                             tt.plan_works_on_device(plan, "cuda")))
    return out


_CACHE = (Path(__file__).resolve().parent.parent / "tensorfft_tpu" / "tuning"
          / "tuner_cache.json")


def _tuned_and_bign_answers():
    out = []
    for key, entry in sorted(json.loads(_CACHE.read_text())["entries"].items()):
        fields = dict(kv.split("=") for kv in key.split(","))
        plan = tt.create_plan(int(fields["n"]), precision=fields["precision"],
                              tuning=entry)
        out.append((key, tt.plan_works_on_device(plan, "cuda")))
    for n in (32768, 65536):
        for cfg in get_run_configs(get_search_space(n)):
            plan = tt.create_plan(n, tuning=cfg.as_tuning())
            out.append((n, repr(cfg.as_tuning()), tt.plan_works_on_device(plan, "cuda")))
    for n, prec, tuning in [
            (16384, "float32_x6", dict(radices=(64, 256), grouped=True,
                                       complex_mult="mult3")),
            (1 << 17, "float32_x6", dict(radices=(128, 32, 32), complex_mult="mult3",
                                         max_fused_length=1 << 17)),
            (1 << 18, "bfloat16", dict(max_fused_length=1 << 18)),
            (1 << 27, "bfloat16", dict(strategy="four_step",
                                       four_step_split=(4096, 32768)))]:
        plan = tt.create_plan(n, precision=prec, tuning=tuning)
        out.append((n, prec, tt.plan_works_on_device(plan, "cuda")))
    return out


# Digests of the three sweeps' answers on the tree before the tensor-core
# engine (fit_cta, cta_smem_bytes and plan_works_on_device are unchanged by
# it: the engine uses no shared memory beyond the operand's).
FIT_DIGEST = "83b525112637fece"
PLAN_DIGEST = "74b2dd5271f71cfa"
TUNED_BIGN_DIGEST = "0189ad48958b360b"


def test_fit_cta_answers_as_before():
    answers = _fit_answers()
    assert len(answers) == 952 and sum(a[4] is None for a in answers) == 7
    assert _digest(answers) == FIT_DIGEST


def test_plan_works_on_device_answers_as_before():
    answers = _plan_answers()
    assert all(a[3] == (True, "ok") for a in answers)
    assert _digest(answers) == PLAN_DIGEST


def test_tuned_and_bign_plans_answer_as_before():
    answers = _tuned_and_bign_answers()
    assert sum(not a[-1][0] for a in answers) == 2  # the two past 8 CTAs
    assert _digest(answers) == TUNED_BIGN_DIGEST


# -- the tensor-core summation order, modelled in plain torch ---------------

def _order_model(re, im, radices, scales, sign, algorithm, first_dot):
    """The stacked engine on (rows, n) fp32 planes with each stage product
    summed as the mma route sums it: per partial product (i, j), k-chunks of
    8 rows of z_re and the same 8 of z_im, each chunk's sum rounded once to
    fp32 and added to the running fp32 sum in chunk order; the partial
    products then combined by level (``ops/dots.py``).  Radices >= 8."""
    rows, n = re.shape
    stages = fused_cuda.pass_stages(tuple(radices))
    mats = fused_cuda.stage_matrices(radices, scales, sign, algorithm,
                                     first_dot, stages)
    data_terms = fused_cuda.DATA_TERMS[algorithm]
    s_re, s_im, m = re.float(), im.float(), n
    for j, (st, (mat, w)) in enumerate(zip(stages, mats)):
        r, k = st.radix, st.k
        m //= r
        z_re = s_re.reshape(rows, k, r, m)
        z_im = s_im.reshape(rows, k, r, m)
        if w is not None:
            w_re = w[0].T.reshape(1, k, r, 1)
            w_im = w[1].T.reshape(1, k, r, 1)
            z_re, z_im = z_re * w_re - z_im * w_im, z_re * w_im + z_im * w_re
        alg = (first_dot if (j == 0 and first_dot != "default" and algorithm == "bf16")
               else algorithm)
        a_terms = ([mat[0].float()] if alg == "bf16"
                   else [t.float() for t in dots.split_bf16(mat[0].float(),
                                                            fused_cuda._MATRIX_TERMS[alg])])
        z = torch.cat([z_re, z_im], 2).permute(2, 0, 1, 3).reshape(2 * r, -1)
        z_terms = ([z.to(torch.bfloat16).float()] if data_terms == 1
                   else [t.float() for t in dots.split_bf16(z, data_terms)])
        levels = max(len(a_terms), len(z_terms))
        acc = {}
        for ai, a in enumerate(a_terms):
            bd = torch.cat([torch.cat([a[0], -a[1]], 1), torch.cat([a[1], a[0]], 1)], 0)
            for zj, zt in enumerate(z_terms):
                if ai + zj >= levels:
                    continue
                run = torch.zeros(2 * r, zt.shape[1])
                for c in range(r // 8):
                    idx = torch.cat([torch.arange(8 * c, 8 * c + 8),
                                     r + torch.arange(8 * c, 8 * c + 8)])
                    run = run + (bd[:, idx].double() @ zt[idx].double()).float()
                acc[ai, zj] = run
        out = acc[0, 0]
        for lvl in range(1, levels):
            parts = [acc[i, lvl - i] for i in range(lvl + 1) if (i, lvl - i) in acc]
            level = parts[0]
            for p in parts[1:]:
                level = level + p
            out = out + level
        out = out.reshape(2, r, rows, k, m)
        # (r_out, rows, kk, mm) -> state index (r_out*k + kk)*m + mm
        s_re = out[0].permute(1, 0, 2, 3).reshape(rows, n)
        s_im = out[1].permute(1, 0, 2, 3).reshape(rows, n)
    return s_re, s_im


@pytest.mark.parametrize("precision,n", [
    ("bfloat16", 64), ("bfloat16", 512), ("bfloat16", 4096),
    ("float32", 256), ("float32", 1024), ("float32_x6", 256)])
def test_mma_order_model_matches_jax(precision, n):
    plan = tfft.create_plan(n, precision=precision)
    algorithm = ALGORITHM[precision]
    assert min(plan.radices) >= 8
    rng = np.random.default_rng(n)
    storage = torch.bfloat16 if precision == "bfloat16" else torch.float32
    re, im = (torch.from_numpy(rng.standard_normal((3, n)).astype(np.float32))
              .to(storage) for _ in range(2))
    scales = stage_scales(plan.radices, "forward", True)
    got = _order_model(re, im, plan.radices, scales, dft.FORWARD, algorithm,
                       plan.first_dot)
    got = [g.to(storage).float().numpy() for g in got]
    jdt = jnp.bfloat16 if storage is torch.bfloat16 else jnp.float32
    want = fused_pallas.fused_fft(
        jnp.asarray(re.float().numpy(), jdt).T, jnp.asarray(im.float().numpy(), jdt).T,
        radices=plan.radices, scales=scales, sign=-1, algorithm=algorithm,
        first_dot=plan.first_dot, interpret=True)
    a = agreement(got, [np.asarray(w.T, np.float32) for w in want],
                  bf16=storage is torch.bfloat16)
    assert a.within(), a
