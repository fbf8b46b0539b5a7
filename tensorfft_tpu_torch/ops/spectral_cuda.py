"""The spectral operator of the periodic Poisson solve (``csrc/spectral.cu``)
and its plain torch version.

On the half spectrum F (nx, ny, nz/2+1) of ``rfftn_split``, with one fp32
eigenvalue table per axis (k0: nx, k1: ny, k2: nz/2+1 entries):

    U[i, j, k] = F[i, j, k] * (1 / ((k0[i] + k1[j]) + k2[k])),  U[0, 0, 0] = 0

computed in fp32 (each sum, the reciprocal and the product rounded once)
and stored in F's dtype as dense C-order planes, whatever F's strides.  A
CPU tensor takes the plain version; a CUDA tensor (bf16 or fp32) launches
the kernel, which equals it bit for bit.  The JAX package multiplies by a
full (nx, ny, nz) table of 1/lambda and a mask instead
(``tensorfft_tpu/models/poisson.py``).
"""
from __future__ import annotations

import torch

from tensorfft_tpu_torch.ops.fused_cuda import KERNEL_DTYPES, check_planes, launch

__all__ = ["poisson_scale", "poisson_scale_reference"]


def _check(re, im, k0, k1, k2):
    check_planes(re, im, "poisson_scale", ndim=3)
    shape = tuple(re.shape)
    for axis, table in enumerate((k0, k1, k2)):
        if table.ndim != 1 or table.shape[0] != shape[axis]:
            raise ValueError(f"poisson_scale: table {axis} has shape "
                             f"{tuple(table.shape)} for the spectrum's {shape}")
        if table.dtype != torch.float32 or table.device != re.device:
            raise ValueError(f"poisson_scale: table {axis} must be float32 on "
                             f"{re.device}, got {table.dtype} on {table.device}")


def poisson_scale_reference(re, im, k0, k1, k2):
    """Plain-torch poisson_scale: dense planes in ``re``'s dtype."""
    _check(re, im, k0, k1, k2)
    inv = torch.reciprocal((k0[:, None, None] + k1[None, :, None]) + k2[None, None, :])
    out = []
    for plane in (re, im):
        u = plane.to(torch.float32) * inv
        u[0, 0, 0] = 0.0
        out.append(u.to(re.dtype).contiguous())
    return tuple(out)


def _launch_args(re, im, out, k0, k1):
    """The launcher's tables, sizes, strides and mode (``csrc/spectral.cu``).
    The tile runs along a, the innermost of axes 0 and 1 in ``re``'s strides,
    and c is the other; mode 0 when k is innermost, 2 when both planes are
    unit-stride along a with even strides, an even extent along a and
    pair-aligned pointers, else 1."""
    a, c = (1, 0) if re.stride(1) <= re.stride(0) else (0, 1)
    if re.stride(2) < re.stride(a):
        mode = 0
    elif (re.shape[a] % 2 == 0
          and all(p.stride(a) == 1 and p.stride(c) % 2 == 0 and p.stride(2) % 2 == 0
                  and p.data_ptr() % (2 * p.element_size()) == 0 for p in (re, im))):
        mode = 2
    else:
        mode = 1
    tables = (k0, k1)
    return ((tables[a], tables[c]),
            (re.shape[a], re.shape[c], re.shape[2], re.stride(a), re.stride(c), re.stride(2),
             im.stride(a), im.stride(c), im.stride(2), out.stride(a), out.stride(c), mode))


def poisson_scale(re, im, k0, k1, k2):
    """The half spectrum times 1/lambda, mean mode zeroed, as dense planes in
    its dtype; CUDA planes launch the kernel, counted in
    ``poisson_scale.launches``."""
    if re.device.type == "cpu":
        return poisson_scale_reference(re, im, k0, k1, k2)
    _check(re, im, k0, k1, k2)
    if re.device.type != "cuda" or re.dtype not in KERNEL_DTYPES:
        raise ValueError(f"poisson_scale runs on CPU tensors (plain torch) or bf16 / "
                         f"fp32 CUDA tensors (kernel), got {re.dtype} on {re.device}")
    nx, ny, nk = re.shape
    out_re = torch.empty((nx, ny, nk), dtype=re.dtype, device=re.device)
    out_im = torch.empty_like(out_re)
    if out_re.numel() == 0:
        return out_re, out_im
    tables, args = _launch_args(re, im, out_re, k0, k1)
    launch("tfft_poisson_scale", (re, im, out_re, out_im, *tables, k2),
           (KERNEL_DTYPES[re.dtype],), *args)
    poisson_scale.launches += 1
    return out_re, out_im


poisson_scale.launches = 0
