"""Fused whole-transform FFT: kernel A (``csrc/fused_fft.cu``) and its plain
torch version, and the stage engines the port's kernels share.

The TPU kernel (``tensorfft_tpu/ops/fused_pallas.py:fused_fft``) holds an
(N, lane_tile) transform-major panel in VMEM; here one CTA holds one
batch-major (B, N) row in shared memory, so no (B, N) <-> (N, B) transpose
exists on either side of the kernel.  A row longer than one CTA holds runs
on a thread-block cluster of 2, 4 or 8 CTAs (:func:`fit_cta`), each holding
a block of every stage's columns (:func:`cluster_owner`), with the same
arithmetic as one CTA.  Two stage engines:

* the stacked engine (``stacked``, ``pretwiddle`` and the ``gridslice``
  engines; ``fused_pallas.stage_loop``): each stage is the block-complex
  product BD = [[D_re, -D_im], [D_im, D_re]] applied to [z_re; z_im] with
  the 1/R scale folded into D, after an fp32 twiddle multiply by W[r, k]
  on every stage but the first.  Its stages follow ``plan.stage_kinds``:
  under ``grouped`` a 'grouped' stage takes no twiddle and applies the
  per-slice M_kk = D diag(W[:, kk]) instead (built in fp64, rounded once);
  under ``complex_mult='mult3'`` every stage of radix >= 128 runs three
  real products, t1 = D_re.z_re, t2 = D_im.z_im, t3 = S.(z_re + z_im),
  out = (t1 - t2, (t3 - t1) - t2), where S is the grouped stage's fp64 sum
  M_re + M_im or, on the other stages, the sum of the already-rounded D_re
  and D_im.  ``pretwiddle`` is the stacked engine with grouping off whose
  twiddled operand is rounded to the state dtype before every stage (the
  port applies each twiddle in the previous stage's epilogue, which is what
  the TPU engine moves); the gridslice engines defer a TPU interleave the
  port does not have (its last stage stores each output to its bin) and
  compute the stacked function bit for bit;
* ``planar`` and ``planar_vpu`` (K1b, ``fused_pallas.stage_loop_planar``):
  each stage applies A = [A_re; A_im] to the real and the imaginary plane
  as two products, u = A @ re and v = A @ im, and combines them as
  out_re = u[:R] - v[R:], out_im = u[R:] + v[:R].  ``planar`` folds the
  twiddle into per-slice matrices A_kk = D diag(W[:, kk]), built in fp64
  and rounded once, on every stage with 1 < K <= 128; the first stage,
  stages with K > 128 and every ``planar_vpu`` stage use the shared
  [D_re; D_im] after the fp32 twiddle.

``state_dtype='bfloat16'`` rounds each stage's outputs to bf16, and, as the
JAX engines do, the input, the twiddled operand of a stacked 'kloop' stage
(of every stage under ``pretwiddle``) and mult3's z_re + z_im on every
stage but a 'big' one.

A CPU tensor takes the plain version; a CUDA tensor launches the kernel, and
anything else raises.
"""
from __future__ import annotations

import collections
import dataclasses
import functools
import math
from typing import Sequence, Tuple

import numpy as np
import torch

from tensorfft_tpu_torch import dft, tracing
from tensorfft_tpu_torch.ops import _build, dots
from tensorfft_tpu_torch.plan import (
    COMPLEX_MULTS,
    ENGINES,
    MAX_KLOOP,
    PLANAR_ENGINES,
    STATE_DTYPES,
    gridslice_fits,
    grouped_mult3,
    stage_kinds,
)
from tensorfft_tpu_torch.utils.device import H100

__all__ = [
    "block_dft_tables",
    "Stage",
    "pass_stages",
    "stage_matrices",
    "run_stages",
    "planar_stage_tables",
    "run_stages_planar",
    "plain_pass",
    "fused_fft",
    "fused_fft_reference",
    "fused_fft_columns",
    "column_tile",
    "kernel_tables",
    "mma_route",
    "roots_route",
    "roots_stage",
    "cluster_owner",
    "cluster_slice_base",
    "mma_table_index",
    "mma_tables",
    "variant",
    "knob_free",
    "takes_pipeline",
    "pipeline_tile",
    "multiprocessors",
    "cta_smem_bytes",
    "fit_cta",
    "column_cluster",
    "check_planes",
    "check_kernel_operands",
    "count_launch",
    "reset_launches",
    "launch",
    "policy_codes",
    "KERNEL_DTYPES",
    "MAX_CTA_ELEMS",
    "MAX_CLUSTER",
]

# Complex elements one CTA holds (csrc/fft_stages.cuh kMaxCtaElems): 512
# threads keeping 32 fp32 outputs each in registers.
MAX_CTA_ELEMS = 16384
# The shortest rows the pipelined kernel takes (pipeline_tile), and the rows
# from which a tile fills the whole CTA rather than half of it: on the H100
# its tiles beat one CTA a row at every batch above the SMs from n = 128 on,
# and tiles of 8192 elements beat 16384 below n = 2048 (PERF.md §6).
TILE_MIN_N = 128
TILE_FULL_N = 2048
# The radix of a stage whose A fragments the pipelined kernel on tiles of
# T > 1 rows gathers from the stage's roots in shared memory (roots_route;
# csrc/fused_fft_pipe.cu kRootsRadix): the one radix measured and tested.
ROOTS_RADIX = 256
# The fewest lines a tile of the strided landing (fused_fft_columns) takes:
# each line's run of T bf16 elements is then whole 16-byte chunks, which a
# tensor copy lands and the operand copy moves.
COLUMN_MIN_TILE = 8
# CTAs of the largest thread-block cluster a pass may take (kMaxCluster).
MAX_CLUSTER = H100.max_cluster

# bf16 terms per data operand, and per matrix operand, of each algorithm.
DATA_TERMS = {"bf16": 1, "bf16ax2": 1, "bf16x3": 2, "bf16x6": 3}
_MATRIX_TERMS = {"bf16": 1, "bf16ax2": 2, "bf16x3": 2, "bf16x6": 3}
KERNEL_DTYPES = {torch.bfloat16: 0, torch.float32: 1}
# Stage modes of the kernels' meta (csrc/fft_stages.cuh StageMode).
_STACKED, _PLANAR_SHARED, _PLANAR_FOLDED, _STACKED_FOLDED = 0, 1, 2, 3
# Per-stage flag bits and pass flag bits of the meta.
_MULT3, _ROUND_TW, _ROUND_SUM = 1, 2, 4
_BF16_STATE, _ROUND_INPUT = 1, 2


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


@dataclasses.dataclass(frozen=True)
class Stage:
    """One stage of a pass as the stage engines run it.

    ``kind`` is 'first', 'grouped', 'kloop' or 'big' (``plan.stage_kinds``;
    the planar engines take no 'grouped'), ``k`` the sub-transforms built
    before it; ``fold``: its twiddle is folded into per-slice matrices
    (a grouped stage, or a planar one at 1 < K <= 128); ``mult3``: three
    real products; ``round_tw`` and ``round_sum``: the twiddled operand and
    mult3's z_re + z_im are rounded to the bf16 state.
    """

    kind: str
    radix: int
    k: int
    fold: bool = False
    mult3: bool = False
    round_tw: bool = False
    round_sum: bool = False


@functools.lru_cache(maxsize=256)
def pass_stages(radices: Tuple[int, ...], engine: str = "stacked",
                grouped: bool = False, complex_mult: str = "block",
                state_dtype: str = "float32") -> Tuple[Stage, ...]:
    """The stages of one pass under ``engine`` and the numeric knobs.

    The stacked engine follows ``stage_kinds(radices, grouped)``, with
    grouping off under ``pretwiddle`` (``fused_pallas.py:520``); its bf16
    state rounds the twiddled operand of a 'kloop' stage, and of every
    stage under ``pretwiddle``, but not of a 'big' one (``:592-593``,
    ``:651-653``, ``:678``), and mult3's z_re + z_im in the state dtype on
    every stage but a 'big' one, whose twiddled operands are fp32.  A knob
    value ``FFTPlan`` rejects raises ``ValueError``.
    """
    for name, value, allowed in (("engine", engine, ENGINES),
                                 ("state_dtype", state_dtype, STATE_DTYPES),
                                 ("complex_mult", complex_mult, COMPLEX_MULTS)):
        if value not in allowed:
            raise ValueError(f"bad {name} {value!r}; one of {allowed}")
    bf16 = state_dtype == "bfloat16"
    out, k = [], 1
    if engine in PLANAR_ENGINES:
        for r in radices:
            kind = "first" if k == 1 else ("kloop" if k <= MAX_KLOOP else "big")
            out.append(Stage(kind, r, k, engine == "planar" and kind == "kloop"))
            k *= r
        return tuple(out)
    pretwiddle = engine == "pretwiddle"
    for kind, r, k, p in stage_kinds(radices, grouped and not pretwiddle):
        mult3 = (grouped_mult3(kind, r, p, complex_mult) if kind == "grouped"
                 else complex_mult == "mult3" and r >= 128)
        out.append(Stage(
            kind, r, k, fold=kind == "grouped", mult3=mult3,
            round_tw=bf16 and (kind == "kloop" or (pretwiddle and kind == "big")),
            round_sum=bf16 and mult3 and kind != "big"))
    return tuple(out)


def variant(engine: str, stages: Sequence[Stage], state_dtype: str,
            cluster: int = 1, pipelined: bool = False, tile: int = 1,
            columns: bool = False, roots: bool = False) -> str:
    """The launch counters' name for a pass: the engine (none for stacked),
    the numeric knobs in effect, ``pipelined`` for kernel A's persistent
    kernel (:func:`takes_pipeline`) and ``tile<T>`` where its tiles hold
    T > 1 rows (:func:`pipeline_tile`), ``cols`` where they land straight
    from strided planes (:func:`fused_fft_columns`), ``roots`` where a
    stage of such a tile gathers its A fragments from its roots
    (:func:`roots_stage`), then ``mma`` for a
    pass on one CTA (every kernel runs those on the tensor-core engine) or
    the CTAs of its cluster, e.g. ``mma``, ``pipelined,mma``,
    ``pipelined,tile16,mma``, ``pipelined,tile16,cols,mma``,
    ``pipelined,tile32,roots,mma``,
    ``grouped,mult3,mma``, ``pretwiddle,mma`` or ``bf16_state,cluster2``."""
    tags = [] if engine == "stacked" else [engine]
    if any(st.kind == "grouped" for st in stages):
        tags.append("grouped")
    if any(st.mult3 for st in stages):
        tags.append("mult3")
    if state_dtype == "bfloat16":
        tags.append("bf16_state")
    if pipelined:
        tags.append("pipelined")
        if tile > 1:
            tags.append(f"tile{tile}")
        if columns:
            tags.append("cols")
        if roots:
            tags.append("roots")
    tags.append(f"cluster{cluster}" if cluster > 1 else "mma")
    return ",".join(tags)


def knob_free(engine: str, stages: Sequence[Stage], state_dtype: str) -> bool:
    """Whether a pass runs the knob-free stacked engine (``kEngStacked`` in
    ``csrc/fft_stages.cuh:read_plan``): no planar engine, no folded or mult3
    stage, no rounding to a bf16 state."""
    return (engine not in PLANAR_ENGINES and state_dtype != "bfloat16"
            and not any(st.fold or st.mult3 or st.round_tw or st.round_sum
                        for st in stages))


def takes_pipeline(*, dtype, algorithm: str, engine: str, stages,
                   state_dtype: str, cluster: int, batch: int, n: int,
                   pointers, sms: int) -> bool:
    """Whether a kernel A call runs the pipelined persistent kernel
    (``csrc/fused_fft_pipe.cu``, on tiles of :func:`pipeline_tile` rows)
    rather than one CTA a row (``fused_fft_tc_kernel``): bf16 storage with
    one data term, the knob-free stacked engine, one CTA a row, every
    plane's pointer 16-byte aligned, more rows than the card's ``sms`` (so
    that a CTA has a next tile to fetch while it computes one), and a
    power-of-two ``n`` from TILE_MIN_N to MAX_CTA_ELEMS, the lengths a plan
    makes.  The kernels give the same bits."""
    return (dtype is torch.bfloat16 and DATA_TERMS.get(algorithm) == 1
            and knob_free(engine, stages, state_dtype) and cluster == 1
            and all(p % 16 == 0 for p in pointers) and batch > sms
            and TILE_MIN_N <= n <= MAX_CTA_ELEMS and n & (n - 1) == 0)


def pipeline_tile(n: int, batch: int, sms: int) -> int:
    """Rows a step of the pipelined kernel, on a call that
    :func:`takes_pipeline` sends there: T consecutive rows, one contiguous
    run of T * n elements a plane, for a power-of-two ``n`` from TILE_MIN_N
    to MAX_CTA_ELEMS.  T fills the CTA (MAX_CTA_ELEMS // n) from TILE_FULL_N
    on and half of it below (64 at n = 128, 32 at 256, 16 at 512, 8 at 1024
    and 2048, 4 at 4096, 2 at 8192, 1 at 16384), halved while the batch
    still gives at most ``sms`` tiles, so that a small batch spreads over
    the SMs (4096 x 256 takes 2).  A batch that T does not divide ends in a
    short tile.  1 at any other length, and at any ``batch <= sms``."""
    if n > MAX_CTA_ELEMS or n < TILE_MIN_N or n & (n - 1):
        return 1
    t = (MAX_CTA_ELEMS if n >= TILE_FULL_N else MAX_CTA_ELEMS // 2) // n
    while t > 1 and -(-batch // (t // 2)) <= sms:
        t //= 2
    return t


def _dense(shape, strides) -> bool:
    """Whether ``strides`` (in elements) lay ``shape`` out row-major with no
    gaps, as ``Tensor.is_contiguous`` says (an axis of length 1 takes any
    stride)."""
    expect = 1
    for size, stride in zip(reversed(shape), reversed(strides)):
        if size != 1 and stride != expect:
            return False
        expect *= size
    return True


def column_tile(shape, strides, axis: int, dtype, pointers, sms: int, *,
                radices, algorithm: str, engine: str = "stacked",
                grouped: bool = False, complex_mult: str = "block",
                state_dtype: str = "float32") -> int:
    """The lines a tile of a kernel A pass along ``axis`` of planes of
    ``shape`` (the same for both planes; ``strides``, one tuple a plane, in
    elements; ``pointers``, one a plane) when its tiles land straight from
    the strided planes (:func:`fused_fft_columns`), or 0 where the pass
    takes the relayout.  The planes, seen as (outer, n, inner), must be
    dense (``_dense``) with a later axis (inner > 1); the pass must run the
    pipelined kernel (:func:`takes_pipeline` on the outer * inner lines,
    with the same ``dtype`` and pointers); and the rule's T
    (:func:`pipeline_tile`) must be at least COLUMN_MIN_TILE and divide
    inner.  Then it is that T."""
    shape = tuple(int(s) for s in shape)
    axis %= len(shape)
    n, inner = shape[axis], math.prod(shape[axis + 1:])
    if (inner <= 1 or not all(_dense(shape, st) for st in strides)
            or not TILE_MIN_N <= n <= MAX_CTA_ELEMS):
        return 0
    lines = math.prod(shape) // n
    stages = pass_stages(tuple(radices), engine, grouped, complex_mult,
                         state_dtype)
    if not takes_pipeline(dtype=dtype, algorithm=algorithm, engine=engine,
                          stages=stages, state_dtype=state_dtype, cluster=1,
                          batch=lines, n=n, pointers=pointers, sms=sms):
        return 0
    t = pipeline_tile(n, lines, sms)
    return t if t >= COLUMN_MIN_TILE and inner % t == 0 else 0


def multiprocessors(device) -> int:
    """The SMs of a CUDA device."""
    return torch.cuda.get_device_properties(device).multi_processor_count


def _stage_dtype(j: int, algorithm: str, first_dot: str):
    """A stage's matrix dtype: bf16 under the plain 'bf16' algorithm, fp32
    under a split one, and fp32 for a compensated first stage."""
    if algorithm != "bf16" or (j == 0 and first_dot != "default"):
        return torch.float32
    return torch.bfloat16


@functools.lru_cache(maxsize=None)
def _grouped_g3_table(radix: int, k: int, scale: float, sign: int):
    """(K, 3, R, R) fp64 mult3 tables of a grouped stage: slice kk holds
    Re(M_kk), Im(M_kk) and their sum formed in fp64
    (``fused_pallas._grouped_g3_table``)."""
    m = _planar_a_table(radix, k, scale, sign, True).reshape(k, 2, radix, radix)
    return np.concatenate([m, m[:, :1] + m[:, 1:]], axis=1)


def stage_matrices(radices, scales, sign, algorithm, first_dot="default",
                   stages=None):
    """Per stage of the stacked engine (CPU tensors): (M, W).

    M is (slices, 2 or 3, R, R) in the stage's matrix dtype: [D_re, D_im]
    from the stage's BD (one slice; the blocks of the JAX package's
    ``stage_table_arrays`` BD, rounded f64 -> f32 -> bf16 under the plain
    'bf16' algorithm), or on a grouped stage the K per-slice
    [Re(M_kk), Im(M_kk)] of ``_planar_a_table`` (the values of the JAX
    package's block-diagonal ``_grouped_g_table``, whose zeros and row
    permutation are a TPU layout); a mult3 stage adds its third matrix S.
    W is the fp32 (2, R, K) twiddle [re, im] of a stage after the first
    that is not grouped, else None: the JAX package's stage twiddles and,
    transposed, its pretwiddle ``epilogue_twiddle_tables``.
    """
    if stages is None:
        stages = pass_stages(tuple(radices))
    plain = block_dft_tables(radices, scales, sign, d_dtype=np.float64)
    out = []
    for j, (st, (bd, w_re, w_im), scale) in enumerate(zip(stages, plain, scales)):
        r = st.radix
        dt = _stage_dtype(j, algorithm, first_dot)
        if st.fold:
            if st.mult3:
                m = torch.from_numpy(_grouped_g3_table(
                    r, st.k, float(scale), sign).astype(np.float32)).to(dt)
            else:
                m = torch.from_numpy(_planar_a_table(
                    r, st.k, float(scale), sign, True).astype(np.float32))
                m = m.to(dt).reshape(st.k, 2, r, r)
            out.append((m, None))
            continue
        b = torch.from_numpy(bd.astype(np.float32)).to(dt)
        mats = [b[:r, :r], b[r:, :r]]
        if st.mult3:  # fused_pallas._mult3: the rounded D_re + D_im, rounded
            mats.append((mats[0].float() + mats[1].float()).to(dt))
        w = None
        if j > 0:
            w = torch.from_numpy(np.stack([w_re, w_im]))
        out.append((torch.stack(mats)[None], w))
    return out


def _round(x: torch.Tensor, bf16: bool) -> torch.Tensor:
    return x.to(torch.bfloat16).to(torch.float32) if bf16 else x


def _slice_dot(a: torch.Tensor, z: torch.Tensor, algorithm: str):
    """(slices, R_out, R_in) matrices on (rows, k, R_in, m) data: one
    matrix for every sub-transform, or K slices, slice kk on sub-transform
    kk, batched over the slices alone (a broadcast over the rows would copy
    the K tables once per row)."""
    if a.shape[0] == 1:
        return dots.dot(a, z, algorithm)
    rows, k, r_in, m = z.shape
    zz = z.permute(1, 2, 0, 3).reshape(k, r_in, rows * m)
    out = dots.dot(a, zz, algorithm).reshape(k, a.shape[1], rows, m)
    return out.permute(2, 0, 1, 3)


def run_stages(re: torch.Tensor, im: torch.Tensor, stages, matrices,
               algorithm: str, first_dot: str = "default",
               bf16_state: bool = False, round_input: bool = True):
    """Plain-torch stacked stage sequence on batch-major (rows, n) planes.

    The math of the kernels' stage (csrc/fft_stages.cuh) and of
    ``fused_pallas.stage_loop``, stage for stage: fp32 twiddle, ``dots.dot``
    products (the block-complex one, or mult3's three), and under
    ``bf16_state`` the bf16 rounding points of :class:`Stage`.  Returns fp32
    (re, im) planes in natural order.
    """
    rows, n = re.shape
    s_re = _round(re.to(torch.float32), bf16_state and round_input)
    s_im = _round(im.to(torch.float32), bf16_state and round_input)
    m = n
    for j, (st, (mat, w)) in enumerate(zip(stages, matrices)):
        r, k = st.radix, st.k
        m //= r
        mat = mat.to(re.device)
        z_re = s_re.reshape(rows, k, r, m)
        z_im = s_im.reshape(rows, k, r, m)
        if w is not None:
            w = w.to(re.device)
            w_re = w[0].T.reshape(1, k, r, 1)
            w_im = w[1].T.reshape(1, k, r, 1)
            z_re, z_im = z_re * w_re - z_im * w_im, z_re * w_im + z_im * w_re
            z_re, z_im = _round(z_re, st.round_tw), _round(z_im, st.round_tw)
        alg = _first_algorithm(algorithm, first_dot) if j == 0 else algorithm
        prod = lambda a, z: _slice_dot(a, z, alg)
        if st.mult3:  # t1 = M_re.z_re, t2 = M_im.z_im, t3 = S.(z_re + z_im)
            t1 = prod(mat[:, 0], z_re)
            t2 = prod(mat[:, 1], z_im)
            t3 = prod(mat[:, 2], _round(z_re + z_im, st.round_sum))
            o_re, o_im = t1 - t2, (t3 - t1) - t2
        else:  # [[M_re, -M_im], [M_im, M_re]] @ [z_re; z_im], per slice
            bd = torch.cat([torch.cat([mat[:, 0], -mat[:, 1]], -1),
                            torch.cat([mat[:, 1], mat[:, 0]], -1)], -2)
            out = prod(bd, torch.cat([z_re, z_im], dim=2))
            o_re, o_im = out[:, :, :r], out[:, :, r:]
        # (rows, k, r_out, m) -> state index (r_out*k + kk)*m + mm
        s_re = _round(o_re, bf16_state).transpose(1, 2).reshape(rows, n)
        s_im = _round(o_im, bf16_state).transpose(1, 2).reshape(rows, n)
    return s_re, s_im


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
    arrays = []
    stages = pass_stages(tuple(radices), "planar" if fold else "planar_vpu")
    for j, (st, scale) in enumerate(zip(stages, scales)):
        a = _planar_a_table(st.radix, st.k, float(scale), sign, st.fold)
        arrays.append(torch.from_numpy(a.astype(np.float32)).to(
            _stage_dtype(j, algorithm, first_dot)))
        if j > 0 and not st.fold:
            w_re, w_im = dft.stage_twiddle(st.radix, st.k, dtype=np.float32,
                                           sign=sign)
            arrays += [torch.from_numpy(w_re), torch.from_numpy(w_im)]
    return arrays


def run_stages_planar(re: torch.Tensor, im: torch.Tensor, radices, tables,
                      algorithm: str, first_dot: str = "default",
                      fold: bool = True, bf16_state: bool = False,
                      round_input: bool = True):
    """Plain-torch planar stage sequence on batch-major (rows, n) planes.

    The math of ``fused_pallas.stage_loop_planar``: per stage u = A @ z_re
    and v = A @ z_im as two ``dots.dot`` products, then out_re = u[:R] -
    v[R:] and out_im = u[R:] + v[:R], rounded to bf16 under ``bf16_state``
    (the twiddled operands stay fp32).  Returns fp32 (re, im) planes in
    natural order.
    """
    rows, n = re.shape
    s_re = _round(re.to(torch.float32), bf16_state and round_input)
    s_im = _round(im.to(torch.float32), bf16_state and round_input)
    tables = [t.to(re.device) for t in tables]
    m, ti = n, 0
    stages = pass_stages(tuple(radices), "planar" if fold else "planar_vpu")
    for j, st in enumerate(stages):
        r, k = st.radix, st.k
        m //= r
        a = tables[ti]
        ti += 1
        # (k, r, rows, m): digit r of sub-transform kk, every row and mm.
        z_re = s_re.reshape(rows, k, r, m).permute(1, 2, 0, 3)
        z_im = s_im.reshape(rows, k, r, m).permute(1, 2, 0, 3)
        if j > 0 and not st.fold:
            w_re = tables[ti].T.reshape(k, r, 1, 1)
            w_im = tables[ti + 1].T.reshape(k, r, 1, 1)
            ti += 2
            z_re, z_im = z_re * w_re - z_im * w_im, z_re * w_im + z_im * w_re
        alg = _first_algorithm(algorithm, first_dot) if j == 0 else algorithm
        if st.fold:  # slice kk's own A_kk: (k, 2R, R) @ (k, R, rows*m)
            prod = lambda z: dots.dot(a, z.reshape(k, r, rows * m), alg)
        else:        # the shared A: (2R, R) @ (R, k*rows*m)
            prod = lambda z: dots.dot(a[0], z.transpose(0, 1).reshape(r, -1),
                                      alg).reshape(2 * r, k, -1).transpose(0, 1)
        u, v = prod(z_re), prod(z_im)  # (k, 2R, rows*m)
        o_re = _round(u[:, :r] - v[:, r:], bf16_state)
        o_im = _round(u[:, r:] + v[:, :r], bf16_state)
        # (k, r_out, rows, m) -> state index (r_out*k + kk)*m + mm
        s_re = o_re.reshape(k, r, rows, m).permute(2, 1, 0, 3).reshape(rows, n)
        s_im = o_im.reshape(k, r, rows, m).permute(2, 1, 0, 3).reshape(rows, n)
    return s_re, s_im


def plain_pass(re, im, *, radices, scales, sign, algorithm,
               first_dot="default", engine="stacked", grouped=False,
               complex_mult="block", state_dtype="float32", round_input=True):
    """One pass's stage sequence in plain torch under ``engine`` and the
    knobs: fp32 (re, im) planes in natural order from (rows, n) planes.
    ``round_input=False`` keeps an fp32 input unrounded under bf16 state,
    as the JAX fused kernel's planar engine does."""
    bf16 = state_dtype == "bfloat16"
    if engine in PLANAR_ENGINES:
        fold = engine == "planar"
        tables = planar_stage_tables(radices, scales, sign, algorithm,
                                     fold=fold, first_dot=first_dot)
        return run_stages_planar(re, im, radices, tables, algorithm, first_dot,
                                 fold=fold, bf16_state=bf16,
                                 round_input=round_input)
    stages = pass_stages(tuple(radices), engine, grouped, complex_mult,
                         state_dtype)
    matrices = stage_matrices(radices, scales, sign, algorithm, first_dot, stages)
    return run_stages(re, im, stages, matrices, algorithm, first_dot,
                      bf16_state=bf16, round_input=round_input)


def reset_launches(wrapper) -> None:
    """Set a kernel wrapper's launch count, and its count per variant, to 0."""
    wrapper.launches = 0
    wrapper.variant_launches = collections.Counter()


def count_launch(wrapper, variant_name: str) -> None:
    """Count one launch of ``wrapper``'s kernel as ``variant_name``."""
    wrapper.launches += 1
    wrapper.variant_launches[variant_name] += 1


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


def cta_smem_bytes(n: int, lanes: int, algorithm: str, mult3: bool = False):
    """Dynamic shared memory of one CTA holding ``lanes`` transforms of
    length ``n`` (the split operand, and under ``mult3`` the split
    z_re + z_im plane), or None if they exceed one CTA."""
    if n * lanes > MAX_CTA_ELEMS or algorithm not in DATA_TERMS:
        return None
    planes = 3 if mult3 else 2
    return n * lanes * planes * 2 * DATA_TERMS[algorithm]


def fit_cta(n: int, lanes: int, algorithm: str, stages,
            what: str) -> Tuple[int, int]:
    """(lanes, cluster): the transforms of length ``n`` one CTA holds and
    the CTAs that hold one transform.  ``lanes`` is halved while the CTA
    needs more shared memory than it has (mult3's third operand plane);
    where one transform alone does not fit, it is split over the smallest
    thread-block cluster of 2, 4 or 8 CTAs (one transform per cluster) whose
    slices of n / cluster elements each fit (csrc/fft_mma_cluster.cuh).  So
    a plan that one CTA holds keeps its kernel.  ``ValueError`` where even
    MAX_CLUSTER CTAs do not hold it: no other route runs in its place."""
    mult3 = any(st.mult3 for st in stages)
    limit = H100.smem_per_block_bytes

    def fits(m, t):
        smem = cta_smem_bytes(m, t, algorithm, mult3)
        return smem is not None and smem <= limit

    while lanes > 1 and not fits(n, lanes):
        lanes //= 2
    cluster = 1
    while not fits(n // cluster, lanes):
        if cluster == MAX_CLUSTER or n & (n - 1):
            raise ValueError(
                f"{what}: a transform of length {n} under {algorithm!r}"
                f"{' with mult3 stages' if mult3 else ''} does not fit a "
                f"cluster of {MAX_CLUSTER} CTAs ({MAX_CTA_ELEMS} elements and "
                f"{limit} B of shared memory each; power-of-two lengths "
                f"only); the plan does not work on this device")
        lanes, cluster = 1, cluster * 2
    return lanes, cluster


def column_cluster(n: int, lanes: int, other: int, algorithm: str, stages,
                   what: str) -> Tuple[int, int]:
    """(lanes, cluster) of a column pass of length ``n`` over ``other``
    columns (kernel B, K4's column pass, K5): :func:`fit_cta`'s for
    ``lanes`` adjacent columns per CTA, and past one CTA a tile of adjacent
    columns per cluster (``csrc/cluster_col_tc.cuh``), each doubling of the
    lanes doubling the cluster, while the lanes divide ``other`` and the
    cluster stays within MAX_CLUSTER CTAs.  Each CTA then holds the
    elements it held with one lane, and the strided loads and stores move
    ``lanes`` contiguous elements per row.  At n = 32768 that is 4 columns
    on 8 CTAs, the fastest of the candidates (1, 2), (2, 4) and (4, 8) on
    the card (``chip_smoke.py``'s K2c candidates, PERF.md)."""
    lanes, cluster = fit_cta(n, lanes, algorithm, stages, what)
    while (cluster > 1 and other % (lanes * 2) == 0
           and cluster * 2 <= MAX_CLUSTER):
        lanes, cluster = lanes * 2, cluster * 2
    return lanes, cluster


def launch(symbol: str, tensors, dtype_codes, *args) -> None:
    """Call C launcher ``symbol`` on the current stream of the tensors'
    device: (*tensor pointers, *dtype_codes, *args, stream), inside the
    profiler span ``tfft.launch.<symbol>`` (``tracing.launch_span``)."""
    device = tensors[0].device
    with tracing.launch_span(symbol), torch.cuda.device(device):
        err = getattr(_build.library(), symbol)(
            *(t.data_ptr() for t in tensors), *dtype_codes, *args,
            torch.cuda.current_stream(device).cuda_stream,
        )
    _build.check(err, symbol)


def policy_codes(t: torch.Tensor, algorithm: str):
    """The (storage dtype, data terms) codes the stage-engine launchers take."""
    return KERNEL_DTYPES[t.dtype], DATA_TERMS[algorithm]


def _pass_matrices(radices, scales, sign, algorithm, first_dot, engine,
                   grouped, complex_mult, state_dtype):
    """Per stage of one pass: (stage, matrix terms, twiddle, mode).  The
    terms are fp32 (slices, matrices, R, R) tensors, each entry a bf16 value
    (``dots.split_bf16``'s terms, or the bf16-rounded matrix); the twiddle
    is the fp32 (2, R, K) [re, im] of an unfolded stage after the first,
    else None."""
    planar = engine in PLANAR_ENGINES
    stages = pass_stages(radices, engine, grouped, complex_mult, state_dtype)
    if planar:
        arrays = iter(planar_stage_tables(radices, scales, sign, algorithm,
                                          fold=engine == "planar",
                                          first_dot=first_dot))
        mats = []
        for j, st in enumerate(stages):
            a = next(arrays).reshape(-1, 2, st.radix, st.radix)
            w = (torch.stack([next(arrays), next(arrays)])
                 if j > 0 and not st.fold else None)
            mats.append((a, w))
        modes = [_PLANAR_FOLDED if st.fold else _PLANAR_SHARED for st in stages]
    else:
        mats = stage_matrices(radices, scales, sign, algorithm, first_dot, stages)
        modes = [_STACKED_FOLDED if st.fold else _STACKED for st in stages]
    out = []
    for j, (st, (mat, w), mode) in enumerate(zip(stages, mats, modes)):
        alg = _first_algorithm(algorithm, first_dot) if j == 0 else algorithm
        terms = [mat] if alg == "bf16" else dots.split_bf16(mat, _MATRIX_TERMS[alg])
        out.append((st, [t.to(torch.float32) for t in terms], w, mode))
    return out


def _meta(parts, d_offs, w_offs, state_dtype, round_input):
    """The int64 meta the C launchers read (see :func:`kernel_tables`)."""
    meta, flags = [len(parts)], []
    for (st, terms, _, _), d_off, w_off in zip(parts, d_offs, w_offs):
        meta += [st.radix, len(terms), d_off, w_off]
        flags.append(_MULT3 * st.mult3 + _ROUND_TW * st.round_tw
                     + _ROUND_SUM * st.round_sum)
    bf16 = state_dtype == "bfloat16"
    pass_flags = _BF16_STATE * bf16 + _ROUND_INPUT * (bf16 and round_input)
    modes = [mode for *_, mode in parts]
    return np.asarray(meta + modes + flags + [pass_flags], dtype=np.int64)


@functools.lru_cache(maxsize=64)
def kernel_tables(radices: Tuple[int, ...], scales: Tuple[float, ...],
                  sign: int, algorithm: str, first_dot: str, device,
                  engine: str = "stacked", grouped: bool = False,
                  complex_mult: str = "block", state_dtype: str = "float32",
                  round_input: bool = True):
    """Kernel operands of one pass: (tables, meta).

    ``tables`` is one fp32 tensor on ``device`` holding, per stage, the
    matrix terms [term][slice][matrix][R][R] split as the stage's dot
    algorithm splits them (the same ``dots.split_bf16`` the plain versions
    apply), then for every stage after the first that is not folded the
    twiddle [re, im][R][K].  The matrices of a slice are [D_re, D_im]
    (stacked), mult3's [M_re, M_im, S], or the planar A table; a folded
    stage has K slices, every other stage one.  ``meta`` is the int64 host
    array the C launchers read: n_stages, then per stage (radix, matrix
    terms, matrix offset, twiddle offset), then per stage its mode (0
    stacked, 1 planar with the shared table, 2 planar folded, 3 stacked
    folded), then per stage its flags (1 mult3, 2 round the twiddled
    operand, 4 round mult3's sum), then the pass's flags (1 bf16 state,
    2 round the input to it).
    """
    parts = _pass_matrices(radices, scales, sign, algorithm, first_dot,
                           engine, grouped, complex_mult, state_dtype)
    chunks, d_offs, w_offs, off = [], [], [], 0
    for _, terms, w, _ in parts:
        d_offs.append(off)
        for t in terms:
            chunks.append(t.reshape(-1))
            off += t.numel()
        w_offs.append(0)
        if w is not None:
            w_offs[-1] = off
            chunks.append(w.reshape(-1))
            off += w.numel()
    tables = torch.cat(chunks).to(device)
    return tables, _meta(parts, d_offs, w_offs, state_dtype, round_input)


def mma_route(st: Stage) -> bool:
    """Whether a stage runs on the tensor cores, on one CTA or a cluster
    (``csrc/fft_mma.cuh:mma_route``): a shared-matrix stage of
    radix >= 8; a folded stage, or one of radix < 8, takes the vector
    route."""
    return not st.fold and st.radix >= 8


def roots_route(radix: int, terms: int, mode: int = _STACKED) -> bool:
    """Whether the pipelined kernel on tiles of T > 1 rows gathers a
    stage's A fragments from the stage's ``radix`` roots in shared memory
    (``csrc/fused_fft_pipe.cu:roots_route``) rather than reading its
    fragment table: a two-term stage (``terms`` matrix terms; bf16ax2) of
    radix ROOTS_RADIX on the mma route.  Every entry (r_out, r) of such a
    stage's table is its entry (1, (r_out * r) mod radix), so the products
    are the same bits; the table (512 KiB) streamed from L2 every tile."""
    return (mode not in (_PLANAR_FOLDED, _STACKED_FOLDED)
            and radix == ROOTS_RADIX and terms == 2)


def roots_stage(meta, tile: int):
    """The stage of a pass (``meta``, :func:`kernel_tables`') whose A
    fragments the pipelined kernel on tiles of ``tile`` rows gathers from
    its roots (:func:`roots_route`; ``csrc/fused_fft_pipe.cu:roots_stage``),
    or None: at most one, and none at ``tile`` = 1."""
    n = int(meta[0])
    if tile > 1:
        for s in range(n):
            if roots_route(int(meta[1 + 4 * s]), int(meta[2 + 4 * s]),
                           int(meta[1 + 4 * n + s])):
                return s
    return None


def cluster_owner(n: int, radix: int, cluster: int, index, lanes: int = 1):
    """(rank, local index) of operand index ``index`` = r * nt + g of a
    stage of ``radix`` on a cluster of ``cluster`` CTAs holding one
    transform of ``n``, or a column tile of ``lanes`` transforms, element i
    of transform lane at i * lanes + lane (``csrc/fft_mma_cluster.cuh``):
    column g of the stage's nt = n * lanes / radix lives on rank g // ntl,
    ntl = nt / cluster, at local index r * ntl + g % ntl (before the stage's
    swizzle), so each CTA holds all R rows of its own ntl columns and reads
    only its own shared memory."""
    nt = n * lanes // radix
    ntl = nt // cluster
    r, g = np.divmod(np.asarray(index), nt)
    rank, gl = np.divmod(g, ntl)
    return rank, r * ntl + gl


def cluster_slice_base(rank: int, ntl: int, m: int, lanes: int = 1) -> int:
    """The slice at which a folded stage's tables start on ``rank`` (ntl
    columns per rank, M columns of a transform per slice, ``lanes``
    transforms side by side, all powers of two): local column gl reads slice
    ``cluster_slice_base + gl // (m * lanes)``, its own slice
    (rank * ntl + gl) // (m * lanes) (``csrc/fft_mma_cluster.cuh``)."""
    return rank * ntl // (m * lanes)


def mma_table_index(radix: int, slices: int, matrices: int, terms: int,
                    mma: bool) -> Tuple[np.ndarray, int]:
    """Where each entry of a stage's natural [term][slice][matrix][R][R]
    table (C order) lands in its bf16 block, and the block's length.

    The mma route (one slice) is in fragment order,
    [term][matrix][r_out // 8][r // 8][lane][2] with lane = (r_out % 8) * 4
    + (r % 8) // 2 and the pair r % 2: the 32-bit A-fragment register of
    lane for that 8 x 8 block.  The vector route is slice-major and
    transposed within a slice, [term][slice][r][r_out][W], the matrices of
    one entry side by side (W = 2, or 4 with a zero pad for mult3's three).
    """
    shape = (terms, slices, matrices, radix, radix)
    t, s, m, ro, ri = (np.arange(d).reshape([-1 if a == b else 1 for b in range(5)])
                       for a, d in enumerate(shape))
    if mma:
        if slices != 1:
            raise ValueError("the mma route takes one shared slice")
        chunks = radix // 8
        lane = (ro % 8) * 4 + (ri % 8) // 2
        pos = (((((t * matrices + m) * chunks + ro // 8) * chunks + ri // 8)
                * 32 + lane) * 2 + ri % 2)
        return np.broadcast_to(pos, shape).flatten(), terms * matrices * radix * radix
    w = 4 if matrices == 3 else 2
    pos = (((t * slices + s) * radix + ri) * radix + ro) * w + m
    return np.broadcast_to(pos, shape).flatten(), terms * slices * radix * radix * w


@functools.lru_cache(maxsize=64)
def mma_tables(radices: Tuple[int, ...], scales: Tuple[float, ...],
               sign: int, algorithm: str, first_dot: str, device,
               engine: str = "stacked", grouped: bool = False,
               complex_mult: str = "block", state_dtype: str = "float32",
               round_input: bool = True):
    """Operands of a pass on the tensor-core engine, on one CTA or a
    cluster: (tables, meta, mats).  ``mats`` is one bf16 tensor on
    ``device`` holding each stage's
    matrix terms in its route's layout (:func:`mma_table_index`), the same
    values as :func:`kernel_tables`' fp32 ones (each is a bf16 value, so
    the conversion is exact); ``meta`` is kernel_tables' with the matrix
    offsets in bf16 units into ``mats``; ``tables`` is kernel_tables' fp32
    buffer, of which the kernel reads the twiddles."""
    args = (radices, scales, sign, algorithm, first_dot, engine, grouped,
            complex_mult, state_dtype)
    tables, meta = kernel_tables(*args[:5], device, *args[5:], round_input)
    parts = _pass_matrices(*args)
    blocks, d_offs, off = [], [], 0
    for st, terms, _, _ in parts:
        natural = torch.stack(terms)  # (terms, slices, matrices, R, R)
        pos, size = mma_table_index(st.radix, natural.shape[1],
                                    natural.shape[2], len(terms), mma_route(st))
        block = torch.zeros(size, dtype=torch.bfloat16)
        block[torch.from_numpy(pos)] = natural.reshape(-1).to(torch.bfloat16)
        blocks.append(block)
        d_offs.append(off)
        off += size
    meta = meta.copy()
    meta[3:3 + 4 * len(parts):4] = d_offs
    return tables, meta, torch.cat(blocks).to(device)


def _launch_fused(re, im, *, radices, scales, sign, algorithm, first_dot,
                  engine, grouped, complex_mult, state_dtype, cluster=None,
                  pipelined=None, tile=None):
    """Launch kernel A on CUDA planes, counted in ``fused_fft``'s counters:
    one CTA per row, or a cluster of ``cluster`` CTAs per row (default: the
    smallest that holds a row, :func:`fit_cta`; any valid one computes the
    same output bit for bit), both on the tensor-core engine; where
    :func:`takes_pipeline` holds, the pipelined persistent kernel, on tiles
    of :func:`pipeline_tile` rows, which computes the same bits.
    ``pipelined`` True or False and ``tile`` (a pipelined call's rows a
    step, 1 for a row a step) override the rules (the card tests and
    ``chip_smoke.py``: one CTA a row as the reference, the pipelined
    kernel at a tile the rules keep off it); the C launcher refuses a
    pipelined call its kernel cannot take."""
    b, n = re.shape
    stages = pass_stages(radices, engine, grouped, complex_mult, state_dtype)
    _, fit = fit_cta(n, 1, algorithm, stages, "fused_fft")
    cluster = fit if cluster is None else cluster
    out_re, out_im = torch.empty_like(re), torch.empty_like(im)
    if b == 0:
        return out_re, out_im
    args = (radices, tuple(float(s) for s in scales), int(sign), algorithm,
            first_dot, re.device, engine, grouped, complex_mult, state_dtype,
            engine not in PLANAR_ENGINES)
    tables, meta, mats = mma_tables(*args)
    planes = (re, im, out_re, out_im)
    sms = multiprocessors(re.device)
    if pipelined is None:
        pipelined = takes_pipeline(
            dtype=re.dtype, algorithm=algorithm, engine=engine, stages=stages,
            state_dtype=state_dtype, cluster=cluster, batch=b, n=n,
            pointers=[t.data_ptr() for t in planes], sms=sms)
    if not pipelined:
        tile = 1
    elif tile is None:
        tile = pipeline_tile(n, b, sms)
    launch("tfft_fused_fft", planes, policy_codes(re, algorithm), b, n,
           cluster, sms if pipelined else 0, tile, tables.data_ptr(),
           mats.data_ptr(), meta.ctypes.data)
    count_launch(fused_fft, variant(
        engine, stages, state_dtype, cluster, pipelined, tile,
        roots=pipelined and roots_stage(meta, tile) is not None))
    return out_re, out_im


def fused_fft_reference(re, im, *, radices, scales, sign=dft.FORWARD,
                        algorithm="bf16", first_dot="default", engine="stacked",
                        grouped=False, complex_mult="block",
                        state_dtype="float32", round_input=None):
    """Plain-torch kernel A on (B, N) planes; output in the input dtype.
    Under bf16 state the input is rounded to it except by the planar
    engines, which read it raw, as the JAX fused kernel does
    (``round_input`` overrides that: K3 rounds it under every engine)."""
    if round_input is None:
        round_input = engine not in PLANAR_ENGINES
    o_re, o_im = plain_pass(re, im, radices=radices, scales=scales, sign=sign,
                            algorithm=algorithm, first_dot=first_dot,
                            engine=engine, grouped=grouped,
                            complex_mult=complex_mult, state_dtype=state_dtype,
                            round_input=round_input)
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
    :func:`fused_fft_reference`; CUDA tensors launch kernel A (a row longer
    than one CTA holds on a thread-block cluster, :func:`fit_cta`; where
    :func:`takes_pipeline` holds, the pipelined persistent kernel, on tiles
    of :func:`pipeline_tile` rows), counted
    in ``fused_fft.launches`` and, per :func:`variant`,
    ``fused_fft.variant_launches``.  A gridslice engine whose layout the JAX
    kernel refuses raises ``ValueError`` on every device.
    """
    check_planes(re, im, "fused_fft")
    b, n = re.shape
    radices = tuple(int(r) for r in radices)
    if math.prod(radices) != n:
        raise ValueError(f"radices {radices} do not multiply to N={n}")
    if engine.startswith("gridslice") and not gridslice_fits(engine, radices,
                                                             grouped):
        raise ValueError(  # the JAX kernel's gate, fused_pallas.py:895-905
            f"engine={engine!r} unsupported for radices {radices} "
            f"(grouped={grouped}): last stage must emit whole slices with a "
            f"sublane-multiple slice count divisible by the slice block")
    knobs = dict(first_dot=first_dot, engine=engine, grouped=grouped,
                 complex_mult=complex_mult, state_dtype=state_dtype)
    if re.device.type == "cpu":
        return fused_fft_reference(re, im, radices=radices, scales=scales,
                                   sign=sign, algorithm=algorithm, **knobs)
    check_kernel_operands(re, im, algorithm, "fused_fft")
    return _launch_fused(re, im, radices=radices, scales=scales, sign=sign,
                         algorithm=algorithm, **knobs)


def _launch_columns(re, im, axis, *, radices, scales, sign, algorithm,
                    first_dot, engine, grouped, complex_mult, state_dtype,
                    tile=None):
    """Launch the pipelined kernel's strided landing on CUDA planes along
    ``axis``, on tiles of ``tile`` lines (default: :func:`column_tile`'s;
    ``ValueError`` where that is 0), counted in ``fused_fft_columns``'s
    counters; returns the (outer * inner, n) rows.  The C launcher refuses
    a tile its kernel cannot take."""
    shape = tuple(re.shape)
    axis %= len(shape)
    n, inner = shape[axis], math.prod(shape[axis + 1:])
    outer = math.prod(shape[:axis])
    sms = multiprocessors(re.device)
    knobs = dict(radices=radices, algorithm=algorithm, engine=engine,
                 grouped=grouped, complex_mult=complex_mult,
                 state_dtype=state_dtype)
    if tile is None:
        tile = column_tile(shape, (re.stride(), im.stride()), axis, re.dtype,
                           (re.data_ptr(), im.data_ptr()), sms, **knobs)
        if not tile:
            raise ValueError(
                f"fused_fft_columns: the pass along axis {axis} of "
                f"{shape} {re.dtype} planes cannot land from them "
                f"(fused_cuda.column_tile)")
    stages = pass_stages(radices, engine, grouped, complex_mult, state_dtype)
    tables, meta, mats = mma_tables(
        radices, tuple(float(s) for s in scales), int(sign), algorithm,
        first_dot, re.device, engine, grouped, complex_mult, state_dtype,
        engine not in PLANAR_ENGINES)
    out_re = torch.empty(outer * inner, n, dtype=re.dtype, device=re.device)
    out_im = torch.empty_like(out_re)
    launch("tfft_fused_fft_cols", (re, im, out_re, out_im),
           policy_codes(re, algorithm), outer, n, inner, sms, tile,
           tables.data_ptr(), mats.data_ptr(), meta.ctypes.data)
    count_launch(fused_fft_columns, variant(
        engine, stages, state_dtype, 1, True, tile, columns=True,
        roots=roots_stage(meta, tile) is not None))
    return out_re, out_im


def fused_fft_columns(
    re: torch.Tensor,
    im: torch.Tensor,
    axis: int,
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
    tile=None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Kernel A along ``axis`` of planes in which that axis is not last,
    with the axis moved last in the output: contiguous planes of
    ``torch.movedim(re, axis, -1)``'s shape, equal bit for bit to
    :func:`fused_fft` on ``movedim(re, axis, -1).contiguous()`` as (B, N)
    rows, with no such copy on the card.

    CPU tensors run that: the move, the copy and
    :func:`fused_fft_reference`.  CUDA tensors, where :func:`column_tile`
    gives a tile, launch the pipelined kernel whose tiles of T lines land
    straight from the strided planes (``csrc/fused_fft_pipe.cu``,
    ``fused_fft_pipe_cols_kernel``), counted in
    ``fused_fft_columns.launches`` and, per :func:`variant` (e.g.
    ``pipelined,tile16,cols,mma``), ``fused_fft_columns.variant_launches``;
    elsewhere ``ValueError``.  ``tile`` forces the lines a tile on the card
    (``chip_smoke.py``); the C launcher refuses one its kernel cannot take.
    """
    if (re.shape != im.shape or re.dtype != im.dtype
            or re.device != im.device):
        raise ValueError(
            f"fused_fft_columns: re {tuple(re.shape)} {re.dtype} on "
            f"{re.device} and im {tuple(im.shape)} {im.dtype} on {im.device} "
            f"differ")
    axis %= re.ndim
    n = re.shape[axis]
    radices = tuple(int(r) for r in radices)
    if math.prod(radices) != n:
        raise ValueError(f"radices {radices} do not multiply to N={n}")
    moved = torch.movedim(re, axis, -1).shape
    knobs = dict(radices=radices, scales=scales, sign=sign,
                 algorithm=algorithm, first_dot=first_dot, engine=engine,
                 grouped=grouped, complex_mult=complex_mult,
                 state_dtype=state_dtype)
    if re.device.type == "cpu":
        rows = [torch.movedim(p, axis, -1).contiguous().reshape(-1, n)
                for p in (re, im)]
        out = fused_fft_reference(*rows, **knobs)
    else:
        check_kernel_operands(re, im, algorithm, "fused_fft_columns")
        out = _launch_columns(re, im, axis, tile=tile, **knobs)
    return tuple(p.reshape(moved) for p in out)


reset_launches(fused_fft)
reset_launches(fused_fft_columns)
