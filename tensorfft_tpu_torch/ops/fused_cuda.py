"""Fused whole-transform FFT: kernel A (``csrc/fused_fft.cu``) and its plain
torch version, and the stage engines the port's kernels share.

The TPU kernel (``tensorfft_tpu/ops/fused_pallas.py:fused_fft``) holds an
(N, lane_tile) transform-major panel in VMEM; here one CTA holds one
batch-major (B, N) row in shared memory, so no (B, N) <-> (N, B) transpose
exists on either side of the kernel.  Two stage engines:

* ``stacked`` (the default): each stage is the block-complex product
  BD = [[D_re, -D_im], [D_im, D_re]] applied to [z_re; z_im] with the 1/R
  scale folded into D, after an fp32 twiddle multiply by W[r, k] on every
  stage but the first (the ``first`` and ``kloop``/``big`` stages of the
  TPU's ``stage_loop``);
* ``planar`` and ``planar_vpu`` (K1b, ``fused_pallas.stage_loop_planar``):
  each stage applies A = [A_re; A_im] to the real and the imaginary plane
  as two products, u = A @ re and v = A @ im, and combines them as
  out_re = u[:R] - v[R:], out_im = u[R:] + v[:R].  ``planar`` folds the
  twiddle into per-slice matrices A_kk = D diag(W[:, kk]), built in fp64
  and rounded once, on every stage with 1 < K <= 128; the first stage,
  stages with K > 128 and every ``planar_vpu`` stage use the shared
  [D_re; D_im] after the fp32 twiddle.

A CPU tensor takes the plain version; a CUDA tensor launches the kernel, and
anything else raises.  The knobs the kernels do not implement
(``state_dtype='bfloat16'``, the gridslice and pretwiddle engines, and
``grouped`` or ``complex_mult='mult3'`` under the stacked engine) raise
``NotImplementedError`` on every device; under a planar engine ``grouped``
and ``complex_mult`` change nothing, as in the JAX package.
"""
from __future__ import annotations

import functools
import math
from typing import Sequence, Tuple

import numpy as np
import torch

from tensorfft_tpu_torch import dft
from tensorfft_tpu_torch.ops import _build, dots
from tensorfft_tpu_torch.plan import PLANAR_ENGINES, PORTED_ENGINES, unported_knob

__all__ = [
    "block_dft_tables",
    "stage_table_arrays",
    "run_stages",
    "planar_stage_tables",
    "run_stages_planar",
    "plain_pass",
    "fused_fft",
    "fused_fft_reference",
    "kernel_tables",
    "cta_smem_bytes",
    "check_planes",
    "check_kernel_operands",
    "require_ported_knobs",
    "count_launch",
    "reset_launches",
    "launch",
    "policy_codes",
    "KERNEL_DTYPES",
    "MAX_CTA_ELEMS",
]

# Complex elements one CTA holds (csrc/fft_stages.cuh kMaxCtaElems): 512
# threads keeping 32 fp32 outputs each in registers.
MAX_CTA_ELEMS = 16384

# bf16 terms per data operand, and per matrix operand, of each algorithm.
DATA_TERMS = {"bf16": 1, "bf16ax2": 1, "bf16x3": 2, "bf16x6": 3}
_MATRIX_TERMS = {"bf16": 1, "bf16ax2": 2, "bf16x3": 2, "bf16x6": 3}
KERNEL_DTYPES = {torch.bfloat16: 0, torch.float32: 1}
# Stages of the planar engine with 1 < K <= this many sub-transforms fold the
# twiddle into per-slice matrices (fused_pallas._MAX_KLOOP).
MAX_KLOOP = 128


def block_dft_tables(
    radices: Sequence[int],
    scales: Sequence[float],
    sign: int,
    d_dtype=np.float32,
):
    """Per-stage (BD, W_re, W_im) numpy tables (W is None at stage 0).

    BD is the 2R x 2R block-complex DFT matrix with the stage's progressive
    scale folded in; W is the (R, prior_length) twiddle table in fp32.
    """
    tables = []
    k = 1
    for j, (r, s) in enumerate(zip(radices, scales)):
        d_re, d_im = dft.dft_matrix(r, dtype=np.float64, sign=sign, scale=s)
        bd = np.block([[d_re, -d_im], [d_im, d_re]]).astype(d_dtype)
        if j == 0:
            w_re = w_im = None
        else:
            w_re, w_im = dft.stage_twiddle(r, k, dtype=np.float32, sign=sign)
        tables.append((bd, w_re, w_im))
        k *= r
    return tables


def _first_algorithm(algorithm: str, first_dot: str) -> str:
    return first_dot if (first_dot != "default" and algorithm == "bf16") else algorithm


def stage_table_arrays(radices, scales, sign, algorithm,
                       first_dot: str = "default"):
    """Table operands in consumption order: BD per stage, then W_re, W_im for
    every stage after the first (CPU tensors).

    BD is rounded to bf16 under the plain 'bf16' algorithm (f64 -> f32 ->
    bf16, as the JAX package rounds it) and kept fp32 otherwise; a
    compensated ``first_dot`` keeps the first stage's BD fp32 for its split.
    """
    d_dtype = torch.bfloat16 if algorithm == "bf16" else torch.float32
    arrays = []
    plain = block_dft_tables(radices, scales, sign, d_dtype=np.float64)
    for j, (bd, w_re, w_im) in enumerate(plain):
        dt = torch.float32 if (j == 0 and first_dot != "default") else d_dtype
        arrays.append(torch.from_numpy(bd.astype(np.float32)).to(dt))
        if j > 0:
            arrays += [torch.from_numpy(w_re), torch.from_numpy(w_im)]
    return arrays


def run_stages(re: torch.Tensor, im: torch.Tensor, radices, tables,
               algorithm: str, first_dot: str = "default"):
    """Plain-torch stage sequence on batch-major (rows, n) planes.

    The math of the kernels' shared engine (csrc/fft_stages.cuh), stage for
    stage: fp32 state, fp32 twiddle, ``dots.dot`` block-complex products.
    Returns fp32 (re, im) planes in natural order.
    """
    rows, n = re.shape
    s_re = re.to(torch.float32)
    s_im = im.to(torch.float32)
    tables = [t.to(re.device) for t in tables]
    k, m, ti = 1, n, 0
    for j, r in enumerate(radices):
        m //= r
        bd = tables[ti]
        ti += 1
        z_re = s_re.reshape(rows, k, r, m)
        z_im = s_im.reshape(rows, k, r, m)
        if j > 0:
            w_re = tables[ti].T.reshape(1, k, r, 1)
            w_im = tables[ti + 1].T.reshape(1, k, r, 1)
            ti += 2
            z_re, z_im = z_re * w_re - z_im * w_im, z_re * w_im + z_im * w_re
        alg = _first_algorithm(algorithm, first_dot) if j == 0 else algorithm
        out = dots.dot(bd, torch.cat([z_re, z_im], dim=2), alg)
        # (rows, k, [re; im] x r_out, m) -> state index (r_out*k + kk)*m + mm
        out = out.reshape(rows, k, 2, r, m).permute(2, 0, 3, 1, 4)
        s_re = out[0].reshape(rows, n)
        s_im = out[1].reshape(rows, n)
        k *= r
    return s_re, s_im


def _stage_folds(radices, fold: bool):
    """Per stage of the planar engine: whether its twiddle is folded into
    per-slice matrices (1 < K <= MAX_KLOOP under ``fold``)."""
    k = 1
    for r in radices:
        yield fold and 1 < k <= MAX_KLOOP
        k *= r


@functools.lru_cache(maxsize=None)
def _planar_a_table(radix: int, k: int, scale: float, sign: int, fold: bool):
    """(K, 2R, R) fp64 stage matrices of the planar engine: slice kk is
    [Re(M_kk); Im(M_kk)] with M_kk[r_o, r_i] = D[r_o, r_i] * W[r_i, kk]
    (``fused_pallas._planar_a_table``); without the fold, the shared
    (1, 2R, R) [D_re; D_im]."""
    d_re, d_im = dft.dft_matrix(radix, dtype=np.float64, sign=sign, scale=scale)
    if not fold or k == 1:
        return np.concatenate([d_re, d_im], axis=0)[None]
    w_re, w_im = dft.stage_twiddle(radix, k, dtype=np.float64, sign=sign)
    m = (d_re + 1j * d_im)[None] * (w_re + 1j * w_im).T[:, None, :]
    return np.concatenate([m.real, m.imag], axis=1)


def planar_stage_tables(radices, scales, sign, algorithm, fold: bool = True,
                        first_dot: str = "default"):
    """Table operands of the planar engine in consumption order (CPU
    tensors): per stage the (K or 1, 2R, R) A table, then for every unfolded
    stage after the first the fp32 (R, K) twiddle planes W_re, W_im.

    A is rounded f64 -> f32 -> bf16 under the plain 'bf16' algorithm and kept
    fp32 otherwise; a compensated ``first_dot`` keeps the first stage's fp32
    for its split (``fused_pallas.planar_stage_tables``).
    """
    d_dtype = torch.bfloat16 if algorithm == "bf16" else torch.float32
    arrays, k = [], 1
    for radix, scale, stage_fold in zip(radices, scales,
                                        _stage_folds(radices, fold)):
        dt = torch.float32 if (k == 1 and first_dot != "default") else d_dtype
        a = _planar_a_table(radix, k, float(scale), sign, stage_fold)
        arrays.append(torch.from_numpy(a.astype(np.float32)).to(dt))
        if k > 1 and not stage_fold:
            w_re, w_im = dft.stage_twiddle(radix, k, dtype=np.float32, sign=sign)
            arrays += [torch.from_numpy(w_re), torch.from_numpy(w_im)]
        k *= radix
    return arrays


def run_stages_planar(re: torch.Tensor, im: torch.Tensor, radices, tables,
                      algorithm: str, first_dot: str = "default",
                      fold: bool = True):
    """Plain-torch planar stage sequence on batch-major (rows, n) planes.

    The math of ``fused_pallas.stage_loop_planar`` with fp32 state: per stage
    u = A @ z_re and v = A @ z_im as two ``dots.dot`` products, then
    out_re = u[:R] - v[R:] and out_im = u[R:] + v[:R].  Returns fp32 (re, im)
    planes in natural order.
    """
    rows, n = re.shape
    s_re = re.to(torch.float32)
    s_im = im.to(torch.float32)
    tables = [t.to(re.device) for t in tables]
    k, m, ti = 1, n, 0
    for j, (r, stage_fold) in enumerate(zip(radices, _stage_folds(radices, fold))):
        m //= r
        a = tables[ti]
        ti += 1
        # (k, r, rows, m): digit r of sub-transform kk, every row and mm.
        z_re = s_re.reshape(rows, k, r, m).permute(1, 2, 0, 3)
        z_im = s_im.reshape(rows, k, r, m).permute(1, 2, 0, 3)
        if k > 1 and not stage_fold:
            w_re = tables[ti].T.reshape(k, r, 1, 1)
            w_im = tables[ti + 1].T.reshape(k, r, 1, 1)
            ti += 2
            z_re, z_im = z_re * w_re - z_im * w_im, z_re * w_im + z_im * w_re
        alg = _first_algorithm(algorithm, first_dot) if j == 0 else algorithm
        if stage_fold:  # slice kk's own A_kk: (k, 2R, R) @ (k, R, rows*m)
            prod = lambda z: dots.dot(a, z.reshape(k, r, rows * m), alg)
        else:           # the shared A: (2R, R) @ (R, k*rows*m)
            prod = lambda z: dots.dot(a[0], z.transpose(0, 1).reshape(r, -1),
                                      alg).reshape(2 * r, k, -1).transpose(0, 1)
        u, v = prod(z_re), prod(z_im)  # (k, 2R, rows*m)
        o_re = u[:, :r] - v[:, r:]
        o_im = u[:, r:] + v[:, :r]
        # (k, r_out, rows, m) -> state index (r_out*k + kk)*m + mm
        s_re = o_re.reshape(k, r, rows, m).permute(2, 1, 0, 3).reshape(rows, n)
        s_im = o_im.reshape(k, r, rows, m).permute(2, 1, 0, 3).reshape(rows, n)
        k *= r
    return s_re, s_im


def plain_pass(re, im, *, radices, scales, sign, algorithm,
               first_dot="default", engine="stacked"):
    """One pass's stage sequence in plain torch under ``engine``: fp32
    (re, im) planes in natural order from (rows, n) planes."""
    if engine in PLANAR_ENGINES:
        tables = planar_stage_tables(radices, scales, sign, algorithm,
                                     fold=engine == "planar", first_dot=first_dot)
        return run_stages_planar(re, im, radices, tables, algorithm, first_dot,
                                 fold=engine == "planar")
    tables = stage_table_arrays(radices, scales, sign, algorithm, first_dot)
    return run_stages(re, im, radices, tables, algorithm, first_dot)


def require_ported_knobs(grouped, complex_mult, state_dtype, engine,
                         engines=PORTED_ENGINES):
    """Raise ``NotImplementedError`` for a knob the kernels and their plain
    versions do not implement (``plan.unported_knob``)."""
    bad = unported_knob(engine, state_dtype, grouped, complex_mult, engines)
    if bad is not None:
        raise NotImplementedError(
            f"{bad} is not ported: the CUDA kernels and their plain versions "
            f"implement the engines {', '.join(engines)} with fp32 state"
        )


def reset_launches(wrapper) -> None:
    """Set a kernel wrapper's launch count, and its count per engine, to 0."""
    wrapper.launches = 0
    wrapper.engine_launches = dict.fromkeys(PORTED_ENGINES, 0)


def count_launch(wrapper, engine: str) -> None:
    """Count one launch of ``wrapper``'s kernel under ``engine``."""
    wrapper.launches += 1
    wrapper.engine_launches[engine] += 1


_LAYOUTS = {2: "(B, N)", 3: "(B, H, W)"}


def check_planes(re: torch.Tensor, im: torch.Tensor, what: str,
                 ndim: int = 2) -> None:
    """Shape, dtype and device agreement of a pair of ``ndim``-D planes:
    (B, N) rows, or (B, H, W) volumes with ``ndim=3``."""
    if not (isinstance(re, torch.Tensor) and isinstance(im, torch.Tensor)):
        raise TypeError(f"{what} expects torch tensors")
    if re.ndim != ndim or re.shape != im.shape:
        raise ValueError(
            f"{what} expects matching {_LAYOUTS[ndim]} planes, got re {tuple(re.shape)} "
            f"im {tuple(im.shape)}"
        )
    if re.dtype != im.dtype or re.device != im.device:
        raise ValueError(
            f"{what}: re/im differ in dtype or device ({re.dtype} on "
            f"{re.device} vs {im.dtype} on {im.device})"
        )


def check_kernel_operands(re: torch.Tensor, im: torch.Tensor, algorithm: str,
                          what: str) -> None:
    """What the CUDA launchers take: contiguous CUDA planes in the storage
    dtype of a split-precision policy (bf16 storage with 'bf16'/'bf16ax2',
    fp32 storage with 'bf16x3'/'bf16x6')."""
    if re.device.type != "cuda":
        raise ValueError(
            f"{what} runs on CPU tensors (plain torch) or CUDA tensors "
            f"(kernel), got {re.device}"
        )
    if algorithm not in DATA_TERMS:
        raise NotImplementedError(
            f"{what}: algorithm {algorithm!r} has no CUDA kernel "
            f"(the float64 policy runs on CPU tensors)"
        )
    if re.dtype not in KERNEL_DTYPES:
        raise TypeError(f"{what}: kernel takes bfloat16 or float32, got {re.dtype}")
    if (re.dtype is torch.bfloat16) != (DATA_TERMS[algorithm] == 1):
        raise NotImplementedError(
            f"{what}: the kernel pairs bfloat16 storage with 'bf16'/'bf16ax2' "
            f"and float32 storage with 'bf16x3'/'bf16x6', got {re.dtype} with "
            f"{algorithm!r} (CPU tensors run any pairing)"
        )
    if not (re.is_contiguous() and im.is_contiguous()):
        raise ValueError(f"{what}: kernel needs contiguous planes")


def cta_smem_bytes(n: int, lanes: int, algorithm: str):
    """Dynamic shared memory of one CTA holding ``lanes`` transforms of
    length ``n`` (the split operand), or None if they exceed one CTA."""
    if n * lanes > MAX_CTA_ELEMS or algorithm not in DATA_TERMS:
        return None
    return n * lanes * 2 * 2 * DATA_TERMS[algorithm]


def launch(symbol: str, tensors, dtype_codes, *args) -> None:
    """Call C launcher ``symbol`` on the current stream of the tensors'
    device: (*tensor pointers, *dtype_codes, *args, stream)."""
    device = tensors[0].device
    with torch.cuda.device(device):
        err = getattr(_build.library(), symbol)(
            *(t.data_ptr() for t in tensors), *dtype_codes, *args,
            torch.cuda.current_stream(device).cuda_stream,
        )
    _build.check(err, symbol)


def policy_codes(t: torch.Tensor, algorithm: str):
    """The (storage dtype, data terms) codes the stage-engine launchers take."""
    return KERNEL_DTYPES[t.dtype], DATA_TERMS[algorithm]


@functools.lru_cache(maxsize=64)
def kernel_tables(radices: Tuple[int, ...], scales: Tuple[float, ...],
                  sign: int, algorithm: str, first_dot: str, device,
                  engine: str = "stacked"):
    """Kernel operands of one pass: (tables, meta).

    ``tables`` is one fp32 tensor on ``device`` holding, per stage, the
    matrix terms [term][slice][re, im][R][R] split as the stage's dot
    algorithm splits them (the same ``dots.split_bf16`` the plain versions
    apply), then for every stage after the first that is not folded the
    twiddle [re, im][R][K].  The matrix is D = BD[:, :R] (stacked) or the
    planar A table: one slice, or K per-slice A_kk on a folded stage.
    ``meta`` is the int64 host array the C launchers read: n_stages, then
    per stage (radix, matrix terms, matrix offset, twiddle offset), then per
    stage its mode: 0 stacked, 1 planar with the shared table, 2 planar
    folded.
    """
    planar = engine in PLANAR_ENGINES
    if planar:
        arrays = planar_stage_tables(radices, scales, sign, algorithm,
                                     fold=engine == "planar", first_dot=first_dot)
        folds = list(_stage_folds(radices, engine == "planar"))
    else:
        arrays = stage_table_arrays(radices, scales, sign, algorithm, first_dot)
        folds = [False] * len(radices)
    chunks, meta, modes, off, ti = [], [len(radices)], [], 0, 0
    for j, (r, fold) in enumerate(zip(radices, folds)):
        mat = arrays[ti]
        ti += 1
        alg = _first_algorithm(algorithm, first_dot) if j == 0 else algorithm
        terms = _MATRIX_TERMS[alg]
        if planar:
            d = mat.reshape(-1, 2, r, r)  # (slices, 2, R, R): A_re, A_im
        else:
            d = torch.stack([mat[:r, :r], mat[r:, :r]])  # (2, R, R): D_re, D_im
        parts = [d] if alg == "bf16" else dots.split_bf16(d, terms)
        d_off = off
        for p in parts:
            chunks.append(p.to(torch.float32).reshape(-1))
            off += p.numel()
        w_off = 0
        if j > 0 and not fold:
            w_off = off
            w = torch.stack([arrays[ti], arrays[ti + 1]])  # (2, R, K)
            ti += 2
            chunks.append(w.reshape(-1))
            off += w.numel()
        meta += [r, terms, d_off, w_off]
        modes.append(2 if fold else int(planar))
    tables = torch.cat(chunks).to(device)
    return tables, np.asarray(meta + modes, dtype=np.int64)


def fused_fft_reference(re, im, *, radices, scales, sign=dft.FORWARD,
                        algorithm="bf16", first_dot="default", engine="stacked"):
    """Plain-torch kernel A on (B, N) planes; output in the input dtype."""
    o_re, o_im = plain_pass(re, im, radices=radices, scales=scales, sign=sign,
                            algorithm=algorithm, first_dot=first_dot,
                            engine=engine)
    return o_re.to(re.dtype), o_im.to(im.dtype)


def fused_fft(
    re: torch.Tensor,
    im: torch.Tensor,
    *,
    radices: Tuple[int, ...],
    scales: Tuple[float, ...],
    sign: int = dft.FORWARD,
    algorithm: str = "bf16",
    first_dot: str = "default",
    grouped: bool = False,
    state_dtype: str = "float32",
    complex_mult: str = "block",
    engine: str = "stacked",
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Whole-transform FFT along the last axis of batch-major (B, N) planes.

    Output dtype matches the input (storage rounding at the HBM boundary);
    compute is fp32 with ``algorithm`` matmul operands.  CPU tensors run
    :func:`fused_fft_reference`; CUDA tensors launch kernel A, counted in
    ``fused_fft.launches`` and, per engine, ``fused_fft.engine_launches``.
    """
    require_ported_knobs(grouped, complex_mult, state_dtype, engine)
    check_planes(re, im, "fused_fft")
    b, n = re.shape
    radices = tuple(int(r) for r in radices)
    if math.prod(radices) != n:
        raise ValueError(f"radices {radices} do not multiply to N={n}")
    if re.device.type == "cpu":
        return fused_fft_reference(re, im, radices=radices, scales=scales,
                                   sign=sign, algorithm=algorithm,
                                   first_dot=first_dot, engine=engine)
    check_kernel_operands(re, im, algorithm, "fused_fft")
    if n > MAX_CTA_ELEMS:
        raise ValueError(
            f"fused_fft: N={n} exceeds one CTA ({MAX_CTA_ELEMS}); use the "
            f"four-step plan"
        )
    out_re, out_im = torch.empty_like(re), torch.empty_like(im)
    if b == 0:
        return out_re, out_im
    tables, meta = kernel_tables(radices, tuple(float(s) for s in scales),
                                 int(sign), algorithm, first_dot, re.device,
                                 engine)
    launch("tfft_fused_fft", (re, im, out_re, out_im),
           policy_codes(re, algorithm), b, n, tables.data_ptr(),
           meta.ctypes.data)
    count_launch(fused_fft, engine)
    return out_re, out_im


reset_launches(fused_fft)
