"""The spectral operators of the models (``csrc/spectral.cu``) and their
plain torch versions.  A CPU tensor takes the plain version; a CUDA tensor
(bf16 or fp32) launches the kernel, which equals it bit for bit.

``poisson_scale``, the periodic Poisson solve's: on the half spectrum F
(nx, ny, nz/2+1) of ``rfftn_split``, with one fp32 eigenvalue table per
axis (k0: nx, k1: ny, k2: nz/2+1 entries):

    U[i, j, k] = F[i, j, k] * (1 / ((k0[i] + k1[j]) + k2[k])),  U[0, 0, 0] = 0

computed in fp32 (each sum, the reciprocal and the product rounded once)
and stored in F's dtype as dense C-order planes, whatever F's strides.  The
JAX package multiplies by a full (nx, ny, nz) table of 1/lambda and a mask
instead (``tensorfft_tpu/models/poisson.py``).

``spectral_product``, the convolutions': P = A * B, complex and
elementwise, with A and B broadcast against each other, as the JAX
package's ``_cmul`` on float32 casts (``tensorfft_tpu/models/fft_conv.py``):

    P_re = A_re * B_re - A_im * B_im,  P_im = A_re * B_im + A_im * B_re

each product, sum and difference rounded once in fp32, stored as dense
fp32 planes of the broadcast shape.
"""
from __future__ import annotations

import math

import torch

from tensorfft_tpu_torch.ops.fused_cuda import KERNEL_DTYPES, check_planes, launch

__all__ = ["poisson_scale", "poisson_scale_reference", "spectral_product",
           "spectral_product_reference"]

# Elements a thread of the product kernel takes in one access of each plane
# (``csrc/spectral.cu`` kProductWidth).
_WIDTH = 4


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


def _check_product(a_re, a_im, b_re, b_im):
    for name, (re, im) in (("A", (a_re, a_im)), ("B", (b_re, b_im))):
        if not (isinstance(re, torch.Tensor) and isinstance(im, torch.Tensor)):
            raise TypeError("spectral_product expects torch tensors")
        if re.shape != im.shape:
            raise ValueError(f"spectral_product: {name}'s planes differ in shape "
                             f"({tuple(re.shape)} vs {tuple(im.shape)})")
    planes = (a_re, a_im, b_re, b_im)
    if len({(p.dtype, p.device) for p in planes}) != 1:
        raise ValueError("spectral_product: the four planes differ in dtype or device "
                         f"({[f'{p.dtype} on {p.device}' for p in planes]})")
    return torch.broadcast_shapes(a_re.shape, b_re.shape)


def spectral_product_reference(a_re, a_im, b_re, b_im):
    """Plain-torch spectral_product: dense fp32 planes of the broadcast
    shape."""
    _check_product(a_re, a_im, b_re, b_im)
    a_re, a_im, b_re, b_im = (p.to(torch.float32) for p in (a_re, a_im, b_re, b_im))
    return a_re * b_re - a_im * b_im, a_re * b_im + a_im * b_re


def _batch_planes(shape, a, b):
    """The product of ``shape`` as B planes of M elements: M those of its
    axes from the first one at which neither operand is broadcast, B those
    of the axes before it.  Each operand (re, im) comes back as dense planes
    with its batch stride: 0 where it holds one plane for the whole batch
    (the kernel reads it again for every plane), M where it holds all B (an
    operand broadcast some other way is expanded to ``shape`` first)."""
    padded = [(1,) * (len(shape) - re.ndim) + tuple(re.shape) for re, _ in (a, b)]
    k = max((d + 1 for p in padded for d in range(len(shape)) if p[d] != shape[d]),
            default=0)
    m, batch = math.prod(shape[k:]), math.prod(shape[:k])
    out = []
    for (re, im), p in zip((a, b), padded):
        if batch > 1 and math.prod(p[:k]) == 1:
            out.append((re.contiguous(), im.contiguous(), 0))
        else:
            out.append((re.expand(shape).contiguous(), im.expand(shape).contiguous(), m))
    return m, batch, out


def spectral_product(a_re, a_im, b_re, b_im):
    """A times B, complex and elementwise, as dense fp32 planes of their
    broadcast shape; CUDA planes launch the kernel (one launch, counted in
    ``spectral_product.launches``)."""
    if a_re.device.type == "cpu":
        return spectral_product_reference(a_re, a_im, b_re, b_im)
    shape = _check_product(a_re, a_im, b_re, b_im)
    if a_re.device.type != "cuda" or a_re.dtype not in KERNEL_DTYPES:
        raise ValueError(f"spectral_product runs on CPU tensors (plain torch) or bf16 / "
                         f"fp32 CUDA tensors (kernel), got {a_re.dtype} on {a_re.device}")
    p_re = torch.empty(shape, dtype=torch.float32, device=a_re.device)
    p_im = torch.empty_like(p_re)
    if p_re.numel() == 0:
        return p_re, p_im
    m, batch, ((ar, ai, sa), (br, bi, sb)) = _batch_planes(shape, (a_re, a_im),
                                                           (b_re, b_im))
    planes = (ar, ai, br, bi, p_re, p_im)
    # Batch strides are 0 or m, so a whole vector of m elements aligns them.
    vec = m % _WIDTH == 0 and all(p.data_ptr() % (_WIDTH * p.element_size()) == 0
                                  for p in planes)
    launch("tfft_spectral_product", planes, (KERNEL_DTYPES[a_re.dtype],),
           m, batch, sa, sb, int(vec))
    spectral_product.launches += 1
    return p_re, p_im


spectral_product.launches = 0
