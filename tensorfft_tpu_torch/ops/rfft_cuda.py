"""Epilogue kernels of the real-to-complex path (``csrc/rfft_epilogue.cu``)
and their plain torch versions.

With M = N/2, a real (B, N) signal is packed as the complex (B, M) signal
z[m] = x[2m] + i x[2m+1], transformed with the complex pipeline, and
untangled:

    U[k] = Z[k],  V[k] = conj(Z[(M-k) mod M]),   k = 0 .. M-1
    X[k] = ((U + V) - i w[k] (U - V)) * scale,    w[k] = exp(-2 pi i k / N)
    X[M] = 2 scale (Re Z[0] - Im Z[0]),  Im X[M] = 0

  pack_split        K7  (B, 2M) real -> even/odd planes (B, M)
  interleave_split  K8  even/odd planes (B, M) -> (B, 2M) real
  untangle_fwd      K9  Z (B, M) -> X (B, M+1)
  retangle_inv      K10 X (B, M+1) -> Z (B, M), the inverse pairing

Counterparts of ``tensorfft_tpu/ops/rfft_pallas.py``; the plain versions are
the XLA formulations of ``tensorfft_tpu/rfft.py`` (``_deinterleave``,
``_untangle_fwd``, ``_retangle_inv``, ``_interleave``) in torch, with the
complex products unfused.  A CPU tensor takes the plain version; a CUDA
tensor launches the kernel, for every M >= 1, and anything else raises.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from tensorfft_tpu_torch.ops.fused_cuda import KERNEL_DTYPES, check_planes, launch

__all__ = [
    "phase_tables",
    "pack_split",
    "pack_split_reference",
    "interleave_split",
    "interleave_split_reference",
    "untangle_fwd",
    "untangle_fwd_reference",
    "retangle_inv",
    "retangle_inv_reference",
]


@functools.lru_cache(maxsize=64)
def phase_tables(n: int, sign: int, bins: int):
    """(cos, sin) of sign*2*pi*k/n for k < bins: fp64, rounded once to fp32
    (bit-identical to ``rfft._pack_tables`` and the leading ``bins`` entries
    of ``rfft_pallas._pack_phase_tables``)."""
    k = np.arange(bins, dtype=np.float64)
    phase = sign * 2.0 * np.pi * k / n
    return np.cos(phase).astype(np.float32), np.sin(phase).astype(np.float32)


@functools.lru_cache(maxsize=64)
def _device_phase(n: int, sign: int, bins: int, device):
    """The kernels' (2, bins) fp32 [cos; sin] table on ``device``."""
    return torch.from_numpy(np.stack(phase_tables(n, sign, bins))).to(device)


def _phase(n, sign, bins, device):
    w = _device_phase(n, sign, bins, device)
    return w[0], w[1]


def _require_cuda(tensors, what):
    for t in tensors:
        if t.device.type != "cuda":
            raise ValueError(
                f"{what} runs on CPU tensors (plain torch) or CUDA tensors "
                f"(kernel), got {t.device}")
        if t.dtype not in KERNEL_DTYPES:
            raise TypeError(
                f"{what}: kernel takes bfloat16 or float32, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{what}: kernel needs contiguous rows")


def _reverse_mod(z):
    """z[..., (M-k) mod M] at k (rfft._reverse_mod)."""
    return torch.flip(torch.roll(z, -1, dims=-1), dims=(-1,))


# -- K7 / K8: exact permutations ---------------------------------------------


def pack_split_reference(x):
    """Plain-torch K7: (B, 2M) -> even/odd planes (B, M) in x's dtype."""
    z = x.reshape(x.shape[0], x.shape[1] // 2, 2)
    return z[..., 0].contiguous(), z[..., 1].contiguous()


def interleave_split_reference(re, im):
    """Plain-torch K8: even/odd planes (B, M) -> (B, 2M) in re's dtype."""
    return torch.stack([re, im], dim=-1).reshape(re.shape[0], 2 * re.shape[1])


def _check_real_rows(x, what):
    if not isinstance(x, torch.Tensor):
        raise TypeError(f"{what} expects a torch tensor")
    if x.ndim != 2 or x.shape[1] % 2:
        raise ValueError(f"{what} expects (B, 2M) rows, got {tuple(x.shape)}")


def pack_split(x):
    """(B, 2M) real -> even/odd planes (B, M); CUDA tensors launch K7's
    kernel, counted in ``pack_split.launches``."""
    _check_real_rows(x, "pack_split")
    if x.device.type == "cpu":
        return pack_split_reference(x)
    _require_cuda([x], "pack_split")
    b, m = x.shape[0], x.shape[1] // 2
    re = torch.empty((b, m), dtype=x.dtype, device=x.device)
    im = torch.empty_like(re)
    if b == 0 or m == 0:
        return re, im
    launch("tfft_pack_split", (x, re, im), (KERNEL_DTYPES[x.dtype],), b, m)
    pack_split.launches += 1
    return re, im


def interleave_split(re, im):
    """Even/odd planes (B, M) -> (B, 2M) real; CUDA tensors launch K8's
    kernel, counted in ``interleave_split.launches``."""
    check_planes(re, im, "interleave_split")
    if re.device.type == "cpu":
        return interleave_split_reference(re, im)
    _require_cuda([re, im], "interleave_split")
    b, m = re.shape
    x = torch.empty((b, 2 * m), dtype=re.dtype, device=re.device)
    if b == 0 or m == 0:
        return x
    launch("tfft_interleave_split", (re, im, x), (KERNEL_DTYPES[re.dtype],),
           b, m)
    interleave_split.launches += 1
    return x


# -- K9 / K10: the untangle pair ----------------------------------------------


def untangle_fwd_reference(z_re, z_im, *, n: int, scale: float):
    """Plain-torch K9 (rfft._untangle_fwd): Z (B, M) -> X (B, M+1) in Z's
    dtype, computed in fp32."""
    m = n // 2
    Z_re = z_re.to(torch.float32)
    Z_im = z_im.to(torch.float32)
    u_re, u_im = Z_re, Z_im
    v_re = _reverse_mod(Z_re)
    v_im = -_reverse_mod(Z_im)
    w_re, w_im = _phase(n, -1, m, z_re.device)
    a_re, a_im = u_re + v_re, u_im + v_im          # U + V
    b_re, b_im = u_re - v_re, u_im - v_im          # U - V
    # -i * w * b
    c_re = w_re * b_im + w_im * b_re
    c_im = -(w_re * b_re - w_im * b_im)
    out_re = (a_re + c_re) * scale
    out_im = (a_im + c_im) * scale
    nyq_re = 2.0 * scale * (Z_re[:, :1] - Z_im[:, :1])
    out_re = torch.cat([out_re, nyq_re], dim=-1)
    out_im = torch.cat([out_im, torch.zeros_like(nyq_re)], dim=-1)
    return out_re.to(z_re.dtype), out_im.to(z_im.dtype)


def retangle_inv_reference(re, im, *, n: int, scale: float, out_dtype):
    """Plain-torch K10 (rfft._retangle_inv): X (B, M+1) -> Z (B, M) in
    ``out_dtype``, computed in fp32."""
    m = n // 2
    re = re.to(torch.float32)
    im = im.to(torch.float32)
    x_re_k, x_im_k = re[:, :m], im[:, :m]
    x_re_r = torch.flip(re, dims=(-1,))[:, :m]
    x_im_r = -torch.flip(im, dims=(-1,))[:, :m]
    a_re, a_im = x_re_k + x_re_r, x_im_k + x_im_r
    b_re, b_im = x_re_k - x_re_r, x_im_k - x_im_r
    w_re, w_im = _phase(n, 1, m, re.device)
    # i * w * b
    c_re = -(w_re * b_im + w_im * b_re)
    c_im = w_re * b_re - w_im * b_im
    return (((a_re + c_re) * scale).to(out_dtype),
            ((a_im + c_im) * scale).to(out_dtype))


def _check_half_length(n, m, what):
    if n != 2 * m or m < 1:
        raise ValueError(f"{what}: n={n} must be 2*M with M={m} >= 1")


def untangle_fwd(z_re, z_im, *, n: int, scale: float):
    """Half-length spectrum Z (B, M) -> R2C spectrum X (B, M+1) in Z's
    dtype; CUDA tensors launch K9's kernel, counted in
    ``untangle_fwd.launches``."""
    check_planes(z_re, z_im, "untangle_fwd")
    b, m = z_re.shape
    _check_half_length(n, m, "untangle_fwd")
    if z_re.device.type == "cpu":
        return untangle_fwd_reference(z_re, z_im, n=n, scale=scale)
    _require_cuda([z_re, z_im], "untangle_fwd")
    x_re = torch.empty((b, m + 1), dtype=z_re.dtype, device=z_re.device)
    x_im = torch.empty_like(x_re)
    if b == 0:
        return x_re, x_im
    w = _device_phase(n, -1, m, z_re.device)
    launch("tfft_untangle_fwd", (z_re, z_im, x_re, x_im),
           (KERNEL_DTYPES[z_re.dtype],), b, m, w.data_ptr(), float(scale))
    untangle_fwd.launches += 1
    return x_re, x_im


def retangle_inv(re, im, *, n: int, scale: float, out_dtype):
    """R2C spectrum X (B, M+1) -> half-length spectrum Z (B, M) in
    ``out_dtype``; CUDA tensors launch K10's kernel (bf16 or fp32 in, bf16 or
    fp32 out), counted in ``retangle_inv.launches``."""
    check_planes(re, im, "retangle_inv")
    b, m = re.shape[0], re.shape[1] - 1
    _check_half_length(n, m, "retangle_inv")
    if re.device.type == "cpu":
        return retangle_inv_reference(re, im, n=n, scale=scale,
                                      out_dtype=out_dtype)
    _require_cuda([re, im], "retangle_inv")
    if out_dtype not in KERNEL_DTYPES:
        raise TypeError(
            f"retangle_inv: kernel writes bfloat16 or float32, got {out_dtype}")
    z_re = torch.empty((b, m), dtype=out_dtype, device=re.device)
    z_im = torch.empty_like(z_re)
    if b == 0:
        return z_re, z_im
    w = _device_phase(n, 1, m, re.device)
    launch("tfft_retangle_inv", (re, im, z_re, z_im),
           (KERNEL_DTYPES[re.dtype], KERNEL_DTYPES[out_dtype]), b, m,
           w.data_ptr(), float(scale))
    retangle_inv.launches += 1
    return z_re, z_im


pack_split.launches = 0
interleave_split.launches = 0
untangle_fwd.launches = 0
retangle_inv.launches = 0
