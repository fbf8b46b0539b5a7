"""Bailey four-step FFT: kernels B and C (``csrc/four_step_fft.cu``) and
their plain torch versions.

N = n1 * n2 on batch-major (B, N) planes viewed as (B, n1, n2):

  column pass (kernel B): n1-point FFTs down every column, times the
      four-step twiddle W[k1, j2] = P[k1, j2 // t] * Q[k1, j2 % t] (fp32,
      from the rank-separated tables of ``dft.four_step_twiddle_factors``
      with t = min(lane_tile, n2), exactly as the TPU kernel factors it),
      stored as ``mid`` in the storage dtype;
  row pass (kernel C): n2-point FFTs of every k1 row of ``mid``, stored at
      out[b, k2, k1], so the (B, n2, n1) output is the spectrum in natural
      order.

Counterpart of ``tensorfft_tpu/ops/four_step_pallas.py:four_step_fft``
(the stacked column and row kernels).  The real-to-complex path adds one
variant of each pass (K5 and K6 of the TPU package):

  four_step_fft_packed_real  the column pass reads the half-length packed
      view of a real (B, 2N) row (``column_pass_packed``), then kernel C;
  four_step_fft_to_real      kernel B, then the row pass stores its output
      interleaved into a real (B, 2N) row (``row_pass_interleave``).

Their plain versions are the plain passes composed with the plain pack and
interleave of ``rfft_cuda``: exact permutations, so the composition is
bit-identical to fusing them.

The 2D row-column FFT of (B, H, W) planes (K4, ``four_step_pallas.fft2_fused``)
is the same two passes with n1 = H and n2 = W, minus the twiddle and the
digit swap (``csrc/fft2.cu``):

  fft2_column_pass  H-point FFTs down every column, stored as ``mid``
      (B, H, W) in the storage dtype;
  fft2_row_pass     W-point FFTs of every row of ``mid``, stored in place,
      so the output is (B, kh, kw) in natural order.

K3 (``four_step_pallas.fused_fft_batch_major``) is that row pass over a
(1, B, N) view: the whole N-point transform of a tile of adjacent rows per
CTA, read row-contiguous and transposed into the shared-memory operand
(``fused_fft_batch_major``, ``csrc/fused_batch_major.cu``).

Every pass takes the stage engines and numeric knobs of ``fused_cuda``
(``grouped``, ``complex_mult``, ``state_dtype``).  The JAX package's
gridslice kernels (K2cg, K2rg and K6's column pass) defer a TPU interleave
that the port's passes do not have, so here a gridslice pass is the stacked
pass, computed bit for bit, counted under its engine's name where the JAX
gate would run the gridslice kernel and under the stacked engine's where
the JAX package falls back to the stacked one.  The four-step pairs (C2C, K5, K6) keep the
JAX narrow-panel rule: bf16 state falls back to fp32 when the plan's
``lane_tile`` or ``k1_tile`` panel is narrower than 128
(``plan.effective_state_dtype``).

Every pass runs on the tensor-core engine (``csrc/fft_mma.cuh``), reading
the bf16 ``fused_cuda.mma_tables``.  One CTA (counters ``mma``): kernels B
and C through ``csrc/four_step_tc.cuh``, K3 and K4's row pass through
``csrc/row_pass_tc.cuh``.  Past one CTA, a thread-block cluster (counters
``clusterN``) runs the engine's cluster mode: the row passes (kernel C, K3,
K4's row pass, K6) one row per cluster (``csrc/cluster_tc.cuh``), the column
passes (kernel B, K4's column pass, K5) a tile of adjacent columns per
cluster (``csrc/cluster_col_tc.cuh``, ``fused_cuda.column_cluster``).

A CPU tensor takes the plain version; a CUDA tensor launches the kernels,
and anything else raises.
"""
from __future__ import annotations

import functools
import math
from typing import Tuple

import numpy as np
import torch

from tensorfft_tpu_torch import dft
from tensorfft_tpu_torch.ops.fused_cuda import (
    MAX_CTA_ELEMS,
    check_kernel_operands,
    check_planes,
    column_cluster,
    count_launch,
    fit_cta,
    fused_fft_reference,
    launch,
    mma_tables,
    pass_stages,
    plain_pass,
    policy_codes,
    reset_launches,
    variant,
)
from tensorfft_tpu_torch.plan import effective_state_dtype, gridslice_fits
from tensorfft_tpu_torch.ops.rfft_cuda import (
    interleave_split_reference,
    pack_split_reference,
)

__all__ = [
    "four_step_fft",
    "four_step_fft_reference",
    "column_pass",
    "column_pass_reference",
    "row_pass",
    "row_pass_reference",
    "four_step_fft_packed_real",
    "four_step_fft_packed_real_reference",
    "four_step_fft_to_real",
    "four_step_fft_to_real_reference",
    "column_pass_packed",
    "column_pass_packed_reference",
    "row_pass_interleave",
    "row_pass_interleave_reference",
    "fft2_fused",
    "fft2_fused_reference",
    "fft2_column_pass",
    "fft2_column_pass_reference",
    "fft2_row_pass",
    "fft2_row_pass_reference",
    "fused_fft_batch_major",
    "batch_major_lanes",
    "four_step_tables",
    "pass_lanes",
]

# Widest tile of adjacent columns (kernel B) or rows (kernel C) one CTA takes.
_MAX_LANES = 64


@functools.lru_cache(maxsize=64)
def four_step_tables(n1: int, n2: int, lane_tile: int, sign: int):
    """(P, Q, t): P as (n2/t, 2, n1) and Q as (2, n1, t) fp32 numpy, the
    layout the TPU column kernel streams (four_step_pallas.py:359-388)."""
    t = min(lane_tile, n2)
    if n2 % t != 0:
        raise ValueError(f"n2={n2} not divisible by lane tile {t}")
    p_re, p_im, q_re, q_im = dft.four_step_twiddle_factors(
        n1, n2, t, dtype=np.float32, sign=sign
    )
    pq = np.stack([p_re, p_im]).transpose(2, 0, 1)
    qq = np.stack([q_re, q_im])
    return np.ascontiguousarray(pq), np.ascontiguousarray(qq), t


@functools.lru_cache(maxsize=64)
def _device_pq(n1, n2, lane_tile, sign, device):
    pq, qq, t = four_step_tables(n1, n2, lane_tile, sign)
    return torch.from_numpy(pq).to(device), torch.from_numpy(qq).to(device), t


def pass_lanes(n: int, other: int) -> int:
    """Transforms one CTA takes in a pass of length ``n`` over ``other``
    columns or rows: the widest power of two <= 64 that divides ``other``
    and keeps n * lanes within one CTA."""
    lanes = 1
    while (lanes * 2 <= min(_MAX_LANES, other)
           and n * lanes * 2 <= MAX_CTA_ELEMS):
        lanes *= 2
    return lanes


def _twiddle(n1, n2, lane_tile, sign, device):
    """The (n1, n2) fp32 four-step twiddle rebuilt from P and Q."""
    pq, qq, t = four_step_tables(n1, n2, lane_tile, sign)
    p = torch.from_numpy(pq).to(device)       # (n2/t, 2, n1)
    q = torch.from_numpy(qq).to(device)       # (2, n1, t)
    p_re = p[:, 0, :].T[:, :, None]           # (n1, n2/t, 1)
    p_im = p[:, 1, :].T[:, :, None]
    q_re = q[0][:, None, :]                   # (n1, 1, t)
    q_im = q[1][:, None, :]
    w_re = p_re * q_re - p_im * q_im
    w_im = p_re * q_im + p_im * q_re
    return w_re.reshape(n1, n2), w_im.reshape(n1, n2)


def pass_engine(engine: str, radices, grouped: bool,
                gridslice: bool = True) -> str:
    """The engine a pass runs under the plan's ``engine``: a gridslice
    engine names the JAX package's gridslice pass where its gate holds (the
    last stage emits whole slices, a multiple of the slice block, of radix
    >= 8: ``four_step_pallas.py:366-372``, ``:490-496``, ``:1102-1104``) and
    the stacked pass where it falls back, or always with ``gridslice=False``
    (K5's passes, K6's row pass, K3 and K4: ``:938``, ``:978``, ``:1225``)."""
    if not engine.startswith("gridslice"):
        return engine
    if gridslice and gridslice_fits(engine, radices, grouped) and radices[-1] >= 8:
        return engine
    return "stacked"


def column_pass_reference(re, im, *, n1, n2, radices1, scales1,
                          sign=dft.FORWARD, lane_tile=128, algorithm="bf16",
                          first_dot="default", engine="stacked", grouped=False,
                          complex_mult="block", state_dtype="float32"):
    """Plain-torch kernel B: (B, N) planes -> ``mid`` (B, N), input dtype.
    The stage output, in the state dtype, is upcast for the fp32 P.Q
    twiddle (``four_step_pallas.py:126-131``)."""
    b = re.shape[0]
    cols = lambda x: x.reshape(b, n1, n2).transpose(1, 2).reshape(b * n2, n1)
    s_re, s_im = plain_pass(cols(re), cols(im), radices=radices1,
                            scales=scales1, sign=sign, algorithm=algorithm,
                            first_dot=first_dot, engine=engine, grouped=grouped,
                            complex_mult=complex_mult, state_dtype=state_dtype)
    s_re = s_re.reshape(b, n2, n1).transpose(1, 2)
    s_im = s_im.reshape(b, n2, n1).transpose(1, 2)
    w_re, w_im = _twiddle(n1, n2, lane_tile, sign, re.device)
    o_re = s_re * w_re - s_im * w_im
    o_im = s_re * w_im + s_im * w_re
    return (o_re.to(re.dtype).reshape(b, n1 * n2),
            o_im.to(im.dtype).reshape(b, n1 * n2))


def row_pass_reference(mid_re, mid_im, *, n1, n2, radices2, scales2,
                       sign=dft.FORWARD, algorithm="bf16",
                       first_dot="default", engine="stacked", grouped=False,
                       complex_mult="block", state_dtype="float32"):
    """Plain-torch kernel C: ``mid`` (B, N) -> natural-order (B, N)."""
    b = mid_re.shape[0]
    s_re, s_im = plain_pass(mid_re.reshape(b * n1, n2),
                            mid_im.reshape(b * n1, n2), radices=radices2,
                            scales=scales2, sign=sign, algorithm=algorithm,
                            first_dot=first_dot, engine=engine, grouped=grouped,
                            complex_mult=complex_mult, state_dtype=state_dtype)
    out = lambda s, x: s.reshape(b, n1, n2).transpose(1, 2).to(x.dtype)
    return (out(s_re, mid_re).reshape(b, n1 * n2),
            out(s_im, mid_im).reshape(b, n1 * n2))


def _check_split(re, n1, n2, what):
    if re.shape[1] != n1 * n2:
        raise ValueError(f"{what}: N={re.shape[1]} != n1*n2 = {n1}*{n2}")


def _pass_lanes(re, im, n, other, algorithm, stages, what, column=False):
    """Shared launcher checks; returns the pass's (lanes, CTAs per cluster):
    lanes halved while mult3's third operand plane does not fit one CTA,
    and a pass longer than one CTA holds split over a thread-block cluster
    (``fused_cuda.fit_cta``), a ``column`` pass with adjacent columns per
    cluster (``fused_cuda.column_cluster``)."""
    check_kernel_operands(re, im, algorithm, what)
    if column:
        return column_cluster(n, pass_lanes(n, other), other, algorithm,
                              stages, what)
    return fit_cta(n, pass_lanes(n, other), algorithm, stages, what)


def _knobs(engine, grouped, complex_mult, state_dtype):
    return dict(engine=engine, grouped=grouped, complex_mult=complex_mult,
                state_dtype=state_dtype)


def _mma_operands(radices, scales, sign, algorithm, first_dot, device, knobs):
    """(tables, meta, mats pointer) of a pass: the tensor-core engine's bf16
    tables (``fused_cuda.mma_tables``).  Every pass but kernel A's rounds
    its input to a bf16 state."""
    tables, meta, mats = mma_tables(
        tuple(radices), tuple(map(float, scales)), int(sign), algorithm,
        first_dot, device, knobs["engine"], knobs["grouped"],
        knobs["complex_mult"], knobs["state_dtype"], True)
    return tables, meta, mats.data_ptr()


def _pass_launch(symbol, src, dst, algorithm, n, other, n1, n2, radices,
                 scales, sign, first_dot, knobs, pq=(), column=False,
                 cluster=None, lanes=None):
    """Launch pass ``symbol`` (a ``column`` pass of length ``n`` = n1 over
    ``other`` = n2 columns, or a row pass of n2 over n1 rows) from ``src``
    into ``dst`` (planes, or one real row tensor) on the tensor-core engine;
    returns the pass's variant.  ``pq``: the column pass's (P, Q, t)
    operands, if any.  ``cluster`` forces a cluster of that many CTAs per
    tile, and ``lanes`` the transforms per tile (one on a cluster unless
    given; only a column pass takes more; any valid pair computes the same
    output bit for bit)."""
    stages = pass_stages(tuple(radices), knobs["engine"], knobs["grouped"],
                         knobs["complex_mult"], knobs["state_dtype"])
    fit_lanes, fit = _pass_lanes(src[0], src[-1], n, other, algorithm,
                                 stages, symbol, column)
    if cluster is None:
        cluster = fit
    if lanes is None:
        lanes = fit_lanes if cluster == fit else 1
    tables, meta, mats = _mma_operands(radices, scales, sign, algorithm,
                                       first_dot, src[0].device, knobs)
    launch(symbol, (*src, *dst), policy_codes(src[0], algorithm),
           src[0].shape[0], n1, n2, lanes, cluster, tables.data_ptr(), mats,
           meta.ctypes.data, *pq)
    return variant(knobs["engine"], stages, knobs["state_dtype"], cluster)


def _col_launch(symbol, src, mid, algorithm, n1, n2, radices1, scales1,
                sign, lane_tile, first_dot, knobs, cluster=None, lanes=None):
    """Launch column pass ``symbol`` from ``src`` (planes or one real row
    tensor) into the ``mid`` planes; returns the pass's variant.  A
    ``lane_tile`` of None launches a pass without the four-step twiddle (no
    P/Q operands)."""
    pq = ()
    if lane_tile is not None:
        p, q, t = _device_pq(n1, n2, lane_tile, int(sign), src[0].device)
        pq = (p.data_ptr(), q.data_ptr(), t)
    return _pass_launch(symbol, src, mid, algorithm, n1, n2, n1, n2,
                        radices1, scales1, sign, first_dot, knobs, pq,
                        column=True, cluster=cluster, lanes=lanes)


def _launch_col_pass(src, *, n1, n2, radices1, scales1, sign, lane_tile,
                     algorithm, first_dot, knobs, cluster=None, lanes=None):
    """Launch a column pass on CUDA tensors, counted in its wrapper's
    counters, and return the ``mid`` planes: kernel B on (B, N) planes
    (``column_pass``), K5 on one real (B, 2N) row tensor
    (``column_pass_packed``), K4's on (B, H, W) planes (``fft2_column_pass``,
    ``lane_tile`` None).  ``cluster`` and ``lanes`` force CTAs per tile and
    adjacent columns per tile (default: ``fused_cuda.column_cluster``'s;
    any valid pair computes the same output bit for bit)."""
    x = src[0]
    if len(src) == 1:
        wrapper, symbol = column_pass_packed, "tfft_four_step_col_packed"
        mid = tuple(torch.empty((x.shape[0], n1 * n2), dtype=x.dtype,
                                device=x.device) for _ in range(2))
    else:
        wrapper, symbol = ((column_pass, "tfft_four_step_col") if x.ndim == 2
                           else (fft2_column_pass, "tfft_fft2_col"))
        mid = tuple(torch.empty_like(t) for t in src)
    if x.shape[0] == 0:
        check_kernel_operands(x, src[-1], algorithm, wrapper.__name__)
        return mid
    count_launch(wrapper, _col_launch(
        symbol, src, mid, algorithm, n1, n2, radices1, scales1, sign,
        lane_tile, first_dot, knobs, cluster, lanes))
    return mid


def _row_launch(symbol, mid, dst, algorithm, n1, n2, radices2, scales2, sign,
                first_dot, knobs, cluster=None):
    """Launch row pass ``symbol`` from the ``mid`` planes into ``dst``
    (planes or one real row tensor); returns the pass's variant."""
    return _pass_launch(symbol, mid, dst, algorithm, n2, n1, n1, n2, radices2,
                        scales2, sign, first_dot, knobs, cluster=cluster)


def column_pass(re, im, *, n1, n2, radices1, scales1, sign=dft.FORWARD,
                lane_tile=128, algorithm="bf16", first_dot="default",
                engine="stacked", grouped=False, complex_mult="block",
                state_dtype="float32"):
    """Column pass on (B, N) planes; CUDA tensors launch kernel B, counted
    in ``column_pass.launches`` and ``column_pass.variant_launches``
    (``gridslice*`` where the JAX package runs K2cg)."""
    check_planes(re, im, "column_pass")
    _check_split(re, n1, n2, "column_pass")
    knobs = _knobs(pass_engine(engine, radices1, grouped), grouped,
                   complex_mult, state_dtype)
    if re.device.type == "cpu":
        return column_pass_reference(
            re, im, n1=n1, n2=n2, radices1=radices1, scales1=scales1,
            sign=sign, lane_tile=lane_tile, algorithm=algorithm,
            first_dot=first_dot, **knobs)
    return _launch_col_pass((re, im), n1=n1, n2=n2, radices1=radices1,
                            scales1=scales1, sign=sign, lane_tile=lane_tile,
                            algorithm=algorithm, first_dot=first_dot,
                            knobs=knobs)


def row_pass(mid_re, mid_im, *, n1, n2, radices2, scales2, sign=dft.FORWARD,
             algorithm="bf16", first_dot="default", engine="stacked",
             grouped=False, complex_mult="block", state_dtype="float32"):
    """Row pass on ``mid`` (B, N) planes; CUDA tensors launch kernel C,
    counted in ``row_pass.launches`` and ``row_pass.variant_launches``
    (``gridslice*`` where the JAX package runs K2rg)."""
    check_planes(mid_re, mid_im, "row_pass")
    _check_split(mid_re, n1, n2, "row_pass")
    knobs = _knobs(pass_engine(engine, radices2, grouped), grouped,
                   complex_mult, state_dtype)
    if mid_re.device.type == "cpu":
        return row_pass_reference(
            mid_re, mid_im, n1=n1, n2=n2, radices2=radices2, scales2=scales2,
            sign=sign, algorithm=algorithm, first_dot=first_dot, **knobs)
    return _launch_row_pass(mid_re, mid_im, n1=n1, n2=n2, radices2=radices2,
                            scales2=scales2, sign=sign, algorithm=algorithm,
                            first_dot=first_dot, knobs=knobs)


def _launch_row_pass(mid_re, mid_im, *, n1, n2, radices2, scales2, sign,
                     algorithm, first_dot, knobs, cluster=None):
    """Launch kernel C on CUDA planes, counted in ``row_pass``'s counters;
    ``cluster`` forces a cluster of that many CTAs per row (default:
    ``fused_cuda.fit_cta``'s; any valid one computes the same output bit for
    bit)."""
    out_re, out_im = torch.empty_like(mid_re), torch.empty_like(mid_im)
    if mid_re.shape[0] == 0:
        check_kernel_operands(mid_re, mid_im, algorithm, "row_pass")
        return out_re, out_im
    count_launch(row_pass, _row_launch(
        "tfft_four_step_row", (mid_re, mid_im), (out_re, out_im), algorithm,
        n1, n2, radices2, scales2, sign, first_dot, knobs, cluster))
    return out_re, out_im


def column_pass_packed_reference(x, *, n1, n2, radices1, scales1,
                                 sign=dft.FORWARD, lane_tile=128,
                                 algorithm="bf16", first_dot="default",
                                 **knobs):
    """Plain-torch K5 column pass: plain pack, then the plain column pass."""
    re, im = pack_split_reference(x)
    return column_pass_reference(
        re, im, n1=n1, n2=n2, radices1=radices1, scales1=scales1, sign=sign,
        lane_tile=lane_tile, algorithm=algorithm, first_dot=first_dot, **knobs)


def row_pass_interleave_reference(mid_re, mid_im, *, n1, n2, radices2,
                                  scales2, sign=dft.FORWARD, algorithm="bf16",
                                  first_dot="default", **knobs):
    """Plain-torch K6 row pass: the plain row pass, then the plain
    interleave."""
    return interleave_split_reference(*row_pass_reference(
        mid_re, mid_im, n1=n1, n2=n2, radices2=radices2, scales2=scales2,
        sign=sign, algorithm=algorithm, first_dot=first_dot, **knobs))


def column_pass_packed(x, *, n1, n2, radices1, scales1, sign=dft.FORWARD,
                       lane_tile=128, algorithm="bf16", first_dot="default",
                       engine="stacked", grouped=False, complex_mult="block",
                       state_dtype="float32"):
    """Column pass on the half-length packed view of real (B, 2N) rows ->
    ``mid`` (B, N) planes in x's dtype; CUDA tensors launch the packed
    kernel B, counted in ``column_pass_packed.launches`` and
    ``.variant_launches``.  As in the JAX package, a gridslice engine runs
    the stacked pass."""
    if not isinstance(x, torch.Tensor) or x.ndim != 2 or x.shape[1] != 2 * n1 * n2:
        raise ValueError(
            f"column_pass_packed expects (B, 2*n1*n2) real rows, got "
            f"{getattr(x, 'shape', None)} for n1*n2 = {n1 * n2}")
    knobs = _knobs(pass_engine(engine, radices1, grouped, gridslice=False),
                   grouped, complex_mult, state_dtype)
    if x.device.type == "cpu":
        return column_pass_packed_reference(
            x, n1=n1, n2=n2, radices1=radices1, scales1=scales1, sign=sign,
            lane_tile=lane_tile, algorithm=algorithm, first_dot=first_dot,
            **knobs)
    return _launch_col_pass((x,), n1=n1, n2=n2, radices1=radices1,
                            scales1=scales1, sign=sign, lane_tile=lane_tile,
                            algorithm=algorithm, first_dot=first_dot,
                            knobs=knobs)


def row_pass_interleave(mid_re, mid_im, *, n1, n2, radices2, scales2,
                        sign=dft.FORWARD, algorithm="bf16",
                        first_dot="default", engine="stacked", grouped=False,
                        complex_mult="block", state_dtype="float32"):
    """Row pass on ``mid`` (B, N) planes with the natural-order output
    interleaved into real (B, 2N) rows; CUDA tensors launch the interleaving
    kernel C, counted in ``row_pass_interleave.launches`` and
    ``.variant_launches``.  A gridslice engine runs the stacked pass."""
    check_planes(mid_re, mid_im, "row_pass_interleave")
    _check_split(mid_re, n1, n2, "row_pass_interleave")
    knobs = _knobs(pass_engine(engine, radices2, grouped, gridslice=False),
                   grouped, complex_mult, state_dtype)
    if mid_re.device.type == "cpu":
        return row_pass_interleave_reference(
            mid_re, mid_im, n1=n1, n2=n2, radices2=radices2, scales2=scales2,
            sign=sign, algorithm=algorithm, first_dot=first_dot, **knobs)
    b = mid_re.shape[0]
    x = torch.empty((b, 2 * n1 * n2), dtype=mid_re.dtype, device=mid_re.device)
    if b == 0:
        check_kernel_operands(mid_re, mid_im, algorithm, "row_pass_interleave")
        return x
    count_launch(row_pass_interleave, _row_launch(
        "tfft_four_step_row_interleave", (mid_re, mid_im), (x,), algorithm,
        n1, n2, radices2, scales2, sign, first_dot, knobs))
    return x


reset_launches(column_pass)
reset_launches(row_pass)
reset_launches(column_pass_packed)
reset_launches(row_pass_interleave)


def _pair_kwargs(n1, n2, radices1, radices2, scales1, scales2, sign,
                 lane_tile, algorithm, grouped, state_dtype, complex_mult,
                 first_dot, engine, k1_tile):
    """(column kwargs, row kwargs) of a four-step pair; the state dtype
    after the JAX narrow-panel rule."""
    common = dict(n1=n1, n2=n2, sign=sign, algorithm=algorithm,
                  first_dot=first_dot, engine=engine, grouped=grouped,
                  complex_mult=complex_mult,
                  state_dtype=effective_state_dtype(state_dtype, n1, n2,
                                                    lane_tile, k1_tile))
    return (dict(radices1=radices1, scales1=scales1, lane_tile=lane_tile,
                 **common),
            dict(radices2=radices2, scales2=scales2, **common))


def four_step_fft(
    re: torch.Tensor,
    im: torch.Tensor,
    *,
    n1: int,
    n2: int,
    radices1: Tuple[int, ...],
    radices2: Tuple[int, ...],
    scales1: Tuple[float, ...],
    scales2: Tuple[float, ...],
    sign: int = dft.FORWARD,
    lane_tile: int = 128,
    algorithm: str = "bf16",
    grouped: bool = False,
    state_dtype: str = "float32",
    complex_mult: str = "block",
    first_dot: str = "default",
    engine: str = "stacked",
    k1_tile: int = 128,
):
    """Large-N FFT on batch-major (B, N) planes, N = n1*n2; returns (B, N)
    planes in natural frequency order in the input dtype.  ``k1_tile`` is
    read only by the narrow-panel rule."""
    col, row = _pair_kwargs(n1, n2, radices1, radices2, scales1, scales2,
                            sign, lane_tile, algorithm, grouped, state_dtype,
                            complex_mult, first_dot, engine, k1_tile)
    return row_pass(*column_pass(re, im, **col), **row)


def four_step_fft_reference(re, im, *, n1, n2, radices1, radices2, scales1,
                            scales2, sign=dft.FORWARD, lane_tile=128,
                            algorithm="bf16", first_dot="default",
                            engine="stacked", grouped=False,
                            complex_mult="block", state_dtype="float32",
                            k1_tile=128):
    """Plain-torch four-step: the two plain passes back to back (a gridslice
    engine computes the stacked passes)."""
    col, row = _pair_kwargs(n1, n2, radices1, radices2, scales1, scales2,
                            sign, lane_tile, algorithm, grouped, state_dtype,
                            complex_mult, first_dot, engine, k1_tile)
    return row_pass_reference(*column_pass_reference(re, im, **col), **row)


def four_step_fft_packed_real(
    x: torch.Tensor,
    *,
    n1: int,
    n2: int,
    radices1: Tuple[int, ...],
    radices2: Tuple[int, ...],
    scales1: Tuple[float, ...],
    scales2: Tuple[float, ...],
    sign: int = dft.FORWARD,
    lane_tile: int = 128,
    algorithm: str = "bf16",
    grouped: bool = False,
    state_dtype: str = "float32",
    complex_mult: str = "block",
    first_dot: str = "default",
    engine: str = "stacked",
    k1_tile: int = 128,
):
    """Four-step FFT of the half-length packed view of real (B, 2N) rows,
    N = n1*n2: ``four_step_fft(x[:, 0::2], x[:, 1::2])`` with the
    deinterleave folded into the column pass's loads.  Returns (B, N) planes
    in x's dtype.  As in the JAX package, a gridslice engine runs the
    stacked passes (the outputs are bit-identical)."""
    engine = pass_engine(engine, radices1, grouped, gridslice=False)
    col, row = _pair_kwargs(n1, n2, radices1, radices2, scales1, scales2,
                            sign, lane_tile, algorithm, grouped, state_dtype,
                            complex_mult, first_dot, engine, k1_tile)
    return row_pass(*column_pass_packed(x, **col), **row)


def four_step_fft_to_real(
    re: torch.Tensor,
    im: torch.Tensor,
    *,
    n1: int,
    n2: int,
    radices1: Tuple[int, ...],
    radices2: Tuple[int, ...],
    scales1: Tuple[float, ...],
    scales2: Tuple[float, ...],
    sign: int = dft.INVERSE,
    lane_tile: int = 128,
    algorithm: str = "bf16",
    grouped: bool = False,
    state_dtype: str = "float32",
    complex_mult: str = "block",
    first_dot: str = "default",
    engine: str = "stacked",
    k1_tile: int = 128,
):
    """Four-step FFT of (B, N) planes whose natural-order output is
    interleaved into real (B, 2N) rows inside the row pass's store
    (``interleave_split(*four_step_fft(re, im))``), in the input dtype.  The
    column pass follows ``engine`` (gridslice included), the interleaving
    row pass runs a gridslice engine as stacked."""
    col, row = _pair_kwargs(n1, n2, radices1, radices2, scales1, scales2,
                            sign, lane_tile, algorithm, grouped, state_dtype,
                            complex_mult, first_dot, engine, k1_tile)
    return row_pass_interleave(*column_pass(re, im, **col), **row)


def four_step_fft_packed_real_reference(x, **kwargs):
    """Plain-torch K5: plain pack, then the plain four-step."""
    return four_step_fft_reference(*pack_split_reference(x), **kwargs)


def four_step_fft_to_real_reference(re, im, **kwargs):
    """Plain-torch K6: the plain four-step, then the plain interleave."""
    return interleave_split_reference(*four_step_fft_reference(re, im, **kwargs))


# -- K4: the 2D row-column FFT on (B, H, W) planes ---------------------------

def fft2_column_pass_reference(re, im, *, radices1, scales1, sign=dft.FORWARD,
                               algorithm="bf16", engine="stacked",
                               grouped=False, complex_mult="block",
                               state_dtype="float32"):
    """Plain-torch K4 column pass: (B, H, W) planes -> ``mid`` (B, H, W) in
    the input dtype (``_col_kernel(twiddle=False)``)."""
    b, h, w = re.shape
    cols = lambda x: x.transpose(1, 2).reshape(b * w, h)
    s_re, s_im = plain_pass(cols(re), cols(im), radices=radices1,
                            scales=scales1, sign=sign, algorithm=algorithm,
                            engine=engine, grouped=grouped,
                            complex_mult=complex_mult, state_dtype=state_dtype)
    out = lambda s, x: s.reshape(b, w, h).transpose(1, 2).to(x.dtype).contiguous()
    return out(s_re, re), out(s_im, im)


def fft2_row_pass_reference(mid_re, mid_im, *, radices2, scales2,
                            sign=dft.FORWARD, algorithm="bf16",
                            engine="stacked", grouped=False,
                            complex_mult="block", state_dtype="float32"):
    """Plain-torch K4 row pass: ``mid`` (B, H, W) -> (B, kh, kw) in the
    input dtype (``_row_kernel(transposed=False)``)."""
    b, h, w = mid_re.shape
    s_re, s_im = plain_pass(mid_re.reshape(b * h, w), mid_im.reshape(b * h, w),
                            radices=radices2, scales=scales2, sign=sign,
                            algorithm=algorithm, engine=engine, grouped=grouped,
                            complex_mult=complex_mult, state_dtype=state_dtype)
    return (s_re.reshape(b, h, w).to(mid_re.dtype),
            s_im.reshape(b, h, w).to(mid_im.dtype))


def _fft2_grouped(grouped):
    return grouped if isinstance(grouped, tuple) else (grouped,) * 2


def fft2_fused_reference(re, im, *, radices1, radices2, scales1, scales2,
                         sign=dft.FORWARD, algorithm="bf16", engine="stacked",
                         grouped=False, complex_mult="block",
                         state_dtype="float32"):
    """Plain-torch K4: the two plain passes back to back."""
    g1, g2 = _fft2_grouped(grouped)
    kw = dict(sign=sign, algorithm=algorithm, engine=engine,
              complex_mult=complex_mult, state_dtype=state_dtype)
    mid = fft2_column_pass_reference(re, im, radices1=radices1,
                                     scales1=scales1, grouped=g1, **kw)
    return fft2_row_pass_reference(*mid, radices2=radices2, scales2=scales2,
                                   grouped=g2, **kw)


def _check_volumes(re, im, axis, radices, what):
    """(B, H, W) planes whose length along ``axis`` the radices multiply to."""
    check_planes(re, im, what, ndim=3)
    if math.prod(radices) != re.shape[axis]:
        raise ValueError(f"{what}: radices {tuple(radices)} do not multiply "
                         f"to {re.shape[axis]}")


def fft2_column_pass(re, im, *, radices1, scales1, sign=dft.FORWARD,
                     algorithm="bf16", engine="stacked", grouped=False,
                     complex_mult="block", state_dtype="float32"):
    """K4 column pass on (B, H, W) planes; CUDA tensors launch the column
    kernel, counted in ``fft2_column_pass.launches`` and
    ``fft2_column_pass.variant_launches``."""
    _check_volumes(re, im, 1, radices1, "fft2_column_pass")
    knobs = _knobs(pass_engine(engine, radices1, grouped, gridslice=False),
                   grouped, complex_mult, state_dtype)
    if re.device.type == "cpu":
        return fft2_column_pass_reference(re, im, radices1=radices1,
                                          scales1=scales1, sign=sign,
                                          algorithm=algorithm, **knobs)
    _, h, w = re.shape
    return _launch_col_pass((re, im), n1=h, n2=w, radices1=radices1,
                            scales1=scales1, sign=sign, lane_tile=None,
                            algorithm=algorithm, first_dot="default",
                            knobs=knobs)


def fft2_row_pass(mid_re, mid_im, *, radices2, scales2, sign=dft.FORWARD,
                  algorithm="bf16", engine="stacked", grouped=False,
                  complex_mult="block", state_dtype="float32"):
    """K4 row pass on ``mid`` (B, H, W) planes; CUDA tensors launch the row
    kernel, counted in ``fft2_row_pass.launches`` and
    ``fft2_row_pass.variant_launches``."""
    _check_volumes(mid_re, mid_im, 2, radices2, "fft2_row_pass")
    knobs = _knobs(pass_engine(engine, radices2, grouped, gridslice=False),
                   grouped, complex_mult, state_dtype)
    if mid_re.device.type == "cpu":
        return fft2_row_pass_reference(mid_re, mid_im, radices2=radices2,
                                       scales2=scales2, sign=sign,
                                       algorithm=algorithm, **knobs)
    b, h, w = mid_re.shape
    out_re, out_im = torch.empty_like(mid_re), torch.empty_like(mid_im)
    if b == 0:
        check_kernel_operands(mid_re, mid_im, algorithm, "fft2_row_pass")
        return out_re, out_im
    count_launch(fft2_row_pass, _row_launch(
        "tfft_fft2_row", (mid_re, mid_im), (out_re, out_im), algorithm, h, w,
        radices2, scales2, sign, "default", knobs))
    return out_re, out_im


reset_launches(fft2_column_pass)
reset_launches(fft2_row_pass)


def fft2_fused(
    re: torch.Tensor,
    im: torch.Tensor,
    *,
    radices1: Tuple[int, ...],
    radices2: Tuple[int, ...],
    scales1: Tuple[float, ...],
    scales2: Tuple[float, ...],
    sign: int = dft.FORWARD,
    algorithm: str = "bf16",
    grouped: bool | Tuple[bool, bool] = False,
    state_dtype: str = "float32",
    complex_mult: str = "block",
    engine: str = "stacked",
):
    """2D FFT of (B, H, W) planes (H = prod(radices1), W = prod(radices2)):
    the column pass, then the row pass stored in place.  Returns (B, kh, kw)
    planes in natural order in the input dtype.  As in the JAX package, both
    passes run the plain (``"default"``) first stage whatever the plans'
    ``first_dot``; ``grouped`` may differ per pass, the other knobs apply to
    both."""
    g1, g2 = _fft2_grouped(grouped)
    kw = dict(sign=sign, algorithm=algorithm, engine=engine,
              complex_mult=complex_mult, state_dtype=state_dtype)
    mid_re, mid_im = fft2_column_pass(re, im, radices1=radices1,
                                      scales1=scales1, grouped=g1, **kw)
    return fft2_row_pass(mid_re, mid_im, radices2=radices2, scales2=scales2,
                         grouped=g2, **kw)


# -- K3: the whole transform on (B, N) row tiles -------------------------------

def batch_major_lanes(n: int, b: int) -> int:
    """Rows one K3 CTA transforms: the largest power of two <= min(row tile,
    64) with n * lanes <= 16384, where the row tile is the TPU kernel's, the
    largest power-of-two divisor of b capped at 128."""
    row_tile = 1
    while row_tile * 2 <= 128 and b % (row_tile * 2) == 0:
        row_tile *= 2
    lanes = 1
    while (lanes * 2 <= min(row_tile, _MAX_LANES)
           and n * lanes * 2 <= MAX_CTA_ELEMS):
        lanes *= 2
    return lanes


def fused_fft_batch_major(
    re: torch.Tensor,
    im: torch.Tensor,
    *,
    radices: Tuple[int, ...],
    scales: Tuple[float, ...],
    sign: int = dft.FORWARD,
    algorithm: str = "bf16",
    grouped: bool = False,
    state_dtype: str = "float32",
    complex_mult: str = "block",
    first_dot: str = "default",
    engine: str = "stacked",
):
    """Whole-transform FFT along the last axis of (B, N) planes, a tile of
    ``batch_major_lanes(N, B)`` rows per CTA (halved while mult3's operand
    plane does not fit), or a row longer than one CTA holds on a
    thread-block cluster (``fused_cuda.fit_cta``; K3,
    ``four_step_pallas.fused_fft_batch_major``; ``csrc/fused_batch_major.cu``).

    The same function as kernel A (``fused_cuda.fused_fft``), whose plain
    version it shares, except that it rounds its input to a bf16 state
    under every engine (``four_step_pallas.py:760``), and that a gridslice
    engine runs the stacked pass.  CUDA tensors launch the kernel, counted
    in ``fused_fft_batch_major.launches`` and ``.variant_launches``.
    """
    check_planes(re, im, "fused_fft_batch_major")
    b, n = re.shape
    radices = tuple(int(r) for r in radices)
    if math.prod(radices) != n:
        raise ValueError(f"radices {radices} do not multiply to N={n}")
    knobs = _knobs(pass_engine(engine, radices, grouped, gridslice=False),
                   grouped, complex_mult, state_dtype)
    if re.device.type == "cpu":
        return fused_fft_reference(re, im, radices=radices, scales=scales,
                                   sign=sign, algorithm=algorithm,
                                   first_dot=first_dot, round_input=True,
                                   **knobs)
    check_kernel_operands(re, im, algorithm, "fused_fft_batch_major")
    return _launch_batch_major(re, im, radices=radices, scales=scales,
                               sign=sign, algorithm=algorithm,
                               first_dot=first_dot, knobs=knobs)


def _launch_batch_major(re, im, *, radices, scales, sign, algorithm,
                        first_dot, knobs, cluster=None):
    """Launch K3 on CUDA planes, counted in ``fused_fft_batch_major``'s
    counters; ``cluster`` forces a cluster of that many CTAs per row
    (default: ``fused_cuda.fit_cta``'s; any valid one computes the same
    output bit for bit)."""
    b, n = re.shape
    out_re, out_im = torch.empty_like(re), torch.empty_like(im)
    if b == 0:
        return out_re, out_im
    stages = pass_stages(tuple(radices), knobs["engine"], knobs["grouped"],
                         knobs["complex_mult"], knobs["state_dtype"])
    lanes, fit = fit_cta(n, batch_major_lanes(n, b), algorithm, stages,
                         "fused_fft_batch_major")
    if cluster is None:
        cluster = fit
    elif cluster > 1:
        lanes = 1
    tables, meta, mats = _mma_operands(radices, scales, sign, algorithm,
                                       first_dot, re.device, knobs)
    launch("tfft_fused_batch_major", (re, im, out_re, out_im),
           policy_codes(re, algorithm), b, n, lanes, cluster,
           tables.data_ptr(), mats, meta.ctypes.data)
    count_launch(fused_fft_batch_major,
                 variant(knobs["engine"], stages, knobs["state_dtype"], cluster))
    return out_re, out_im


reset_launches(fused_fft_batch_major)
