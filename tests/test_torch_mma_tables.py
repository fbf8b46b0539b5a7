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


# -- the pipelined kernel's roots route (csrc/fused_fft_pipe.cu) --------------

# The default plan at N = 256 under bfloat16 (one radix-256 stage, bf16ax2),
# and a radix-256 stage after a first stage, under one term and two.
ROOTS_CASES = [((256,), "bf16", "bf16ax2"), ((256,), "bf16", "default"),
               ((256,), "bf16ax2", "default"), ((64, 256), "bf16", "default"),
               ((64, 256), "bf16", "bf16ax2"), ((64, 256), "bf16ax2", "default")]


def _signed_tables(radices, algorithm, first_dot, sign):
    scales = tuple(float(s) for s in stage_scales(radices, "forward", sign < 0))
    args = (tuple(radices), scales, sign, algorithm, first_dot, CPU, "stacked",
            False, "block", "float32", True)
    return fused_cuda.kernel_tables(*args), fused_cuda.mma_tables(*args)


def test_the_default_plan_at_256_is_one_two_term_radix_256_stage():
    plan = tt.create_plan(256, precision="bfloat16")
    assert plan.radices == (256,) and plan.first_dot == "bf16ax2"
    assert ROOTS_CASES[0] == (plan.radices, ALGORITHM["bfloat16"], plan.first_dot)


@pytest.mark.parametrize("sign", [-1, 1], ids=["fwd", "inv"])
@pytest.mark.parametrize("radices,algorithm,first_dot", ROOTS_CASES,
                         ids=lambda v: "x".join(map(str, v)) if isinstance(v, tuple) else v)
def test_radix_256_stage_entries_are_its_roots(radices, algorithm, first_dot, sign):
    # Every entry (term, matrix, r_out, r) of a stage of radix 256 on the
    # mma route equals its entry (term, matrix, 1, (r_out * r) mod R), bit for
    # bit: the identity the roots route's gathers rest on.
    (tables, meta), _ = _signed_tables(radices, algorithm, first_dot, sign)
    stages = fused_cuda.pass_stages(tuple(radices))
    seen = 0
    for s, st in enumerate(stages):
        r, terms = int(meta[1 + 4 * s]), int(meta[2 + 4 * s])
        if r != fused_cuda.ROOTS_RADIX or not fused_cuda.mma_route(st):
            continue
        seen += 1
        table = tables[int(meta[3 + 4 * s]):][:terms * 2 * r * r].view(terms, 2, r, r)
        k = (torch.arange(r)[:, None] * torch.arange(r)[None, :]) % r
        assert torch.equal(table, table[:, :, 1, :][:, :, k])
    assert seen == 1


def _gathered_words(mats, d_off, radix):
    """The roots route's A words of a two-term stage, modelled on the kernel:
    row r_out = 1 of the stage's fragment-order table copied into the roots'
    slots (load_roots), then lane l of chunk (q, c) gathering roots r_out (8c
    + 2(l % 4)) and that + r_out (mod R) (stage_mma_roots): [q][lane][c][term]
    words (re pair, im pair)."""
    u16 = mats.view(torch.int16).numpy().view(np.uint16)[d_off:]
    chunks = radix // 8

    def slot(k):
        return k + (k >> 5)

    roots = np.zeros(4 * slot(radix), np.uint16)
    tm, c, e = np.meshgrid(np.arange(4), np.arange(chunks), np.arange(8),
                           indexing="ij")
    roots[(slot(8 * c + e) * 2 + (tm >> 1)) * 2 + (tm & 1)] = \
        u16[(tm * chunks * chunks + c) * 64 + 8 + e]
    words = roots.view(np.uint32).reshape(-1, 2)
    q, lane, c = np.meshgrid(np.arange(chunks), np.arange(32), np.arange(chunks),
                             indexing="ij")
    r_out = 8 * q + lane // 4
    k0 = (r_out * (8 * c + 2 * (lane % 4))) % radix
    w0, w1 = words[slot(k0)], words[slot((k0 + r_out) % radix)]
    return ((w0 & 0xFFFF) | ((w1 & 0xFFFF) << 16)), ((w0 >> 16) | ((w1 >> 16) << 16))


@pytest.mark.parametrize("sign", [-1, 1], ids=["fwd", "inv"])
@pytest.mark.parametrize("radices,algorithm,first_dot", ROOTS_CASES,
                         ids=lambda v: "x".join(map(str, v)) if isinstance(v, tuple) else v)
def test_roots_gathers_give_the_fragment_words(radices, algorithm, first_dot, sign):
    # The words the route builds from the stage's roots are the words
    # stage_mma loads from the fragment table, for every lane, chunk and
    # row tile; a stage takes the route where it has two terms.
    _, (_, meta, mats) = _signed_tables(radices, algorithm, first_dot, sign)
    s = fused_cuda.roots_stage(meta, 32)
    terms = [int(meta[2 + 4 * j]) for j in range(int(meta[0]))]
    two = [j for j, (r, a) in enumerate(zip(radices, terms)) if r == 256 and a == 2]
    assert s == (two[0] if two else None)
    if s is None:
        return
    radix, chunks = radices[s], radices[s] // 8
    m0, m1 = _gathered_words(mats, int(meta[3 + 4 * s]), radix)
    frag = (mats.view(torch.int16).numpy().view(np.uint16)[int(meta[3 + 4 * s]):]
            [:4 * radix * radix].view(np.uint32).reshape(2, 2, chunks, chunks, 32))
    for term in range(2):
        assert np.array_equal(m0[..., term], frag[term, 0].transpose(0, 2, 1))
        assert np.array_equal(m1[..., term], frag[term, 1].transpose(0, 2, 1))
