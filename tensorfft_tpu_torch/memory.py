"""Device memory and layout conventions.

The reference owns device memory explicitly: DataHandler cudaMallocs 4N
halves partitioned into input-RE/input-IM/result-RE/result-IM and copies
split-complex host buffers across (DataHandler.h:22-82), and ComputeFFT
ping-pongs the input/result arrays (Plan.h:109-115).  Here PyTorch's caching
allocator owns allocation; this module is the thin surface of that mapping:
host staging into the split planar device layout, the reference's
interleaved host format, and a transform that writes back into its input
tensors.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from tensorfft_tpu_torch.plan import FFTPlan

__all__ = [
    "to_device_split",
    "from_device_split",
    "interleaved_to_split",
    "split_to_interleaved",
    "donate_fft",
]


def to_device_split(
    re, im, plan: Optional[FFTPlan] = None, device="cuda"
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Stage split planar host data onto ``device`` in the plan's storage
    dtype, bf16 without a plan (the CopyDataHostToDevice analog,
    DataHandler.h:45-53)."""
    dtype = plan.precision.storage_dtype if plan else torch.bfloat16
    return (torch.as_tensor(re).to(device, dtype),
            torch.as_tensor(im).to(device, dtype))


def from_device_split(re_d, im_d, dtype=np.float32):
    """Fetch results to host numpy in ``dtype`` (CopyResultsDeviceToHost
    analog, DataHandler.h:55-70)."""
    def host(x):
        if isinstance(x, torch.Tensor):
            x = x.detach().cpu().to(torch.float64).numpy()
        return np.asarray(x, dtype)
    return host(re_d), host(im_d)


def interleaved_to_split(buf):
    """Split the reference's host I/O format — one array of 2N reals, RE in
    the first half, IM in the second (ComputeFFT.h:1-16) — into planes
    (copies; tensors stay on their device)."""
    if isinstance(buf, torch.Tensor):
        n = buf.shape[-1] // 2
        return buf[..., :n].clone(), buf[..., n:].clone()
    buf = np.asarray(buf)
    n = buf.shape[-1] // 2
    return buf[..., :n].copy(), buf[..., n:].copy()


def split_to_interleaved(re, im):
    """Inverse of :func:`interleaved_to_split`."""
    if isinstance(re, torch.Tensor):
        return torch.cat([re, im], dim=-1)
    return np.concatenate([np.asarray(re), np.asarray(im)], axis=-1)


def donate_fft(plan: FFTPlan, forward: bool = True):
    """A transform that returns its result in the caller's input tensors
    (the reference reuses its input arrays as ping-pong scratch,
    ComputeFFT.h:89-120).

    The returned ``fn(re, im)`` takes planes in the plan's storage dtype,
    runs :func:`fft_split` (or ``ifft_split``) and copies the result into
    ``re`` and ``im``, which it returns.  The kernels write out of place,
    so the copy follows the transform: peak memory is that of
    ``fft_split`` and no memory is saved; what the caller gets is the
    reference's in-place contract (the result where the input was).
    """
    from tensorfft_tpu_torch.fft import fft_split, ifft_split

    storage = plan.precision.storage_dtype
    run = fft_split if forward else ifft_split

    def fn(re: torch.Tensor, im: torch.Tensor):
        if re.dtype != storage or im.dtype != storage:
            raise ValueError(
                f"donate_fft needs planes in the plan's storage dtype "
                f"{storage}, got {re.dtype} / {im.dtype}")
        o_re, o_im = run(re, im, plan)
        re.copy_(o_re)
        im.copy_(o_im)
        return re, im

    return fn
