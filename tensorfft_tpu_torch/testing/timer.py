"""Device timing with CUDA events.

``measure`` times ``fn(*args)`` on the GPU: warm-up calls first, then one
pair of CUDA events around each timed call on the current stream, and one
synchronize at the end, so the host clock never stands in for device time.
It raises when the tensors are not on a CUDA device: a CPU run has no device
time to report.  With ``flush``, a buffer larger than the L2 cache is
overwritten before each timed call (outside its events), so every call finds
its inputs in device memory rather than in L2, as a caller that has just
moved on from other work would.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Sequence

import numpy as np
import torch

__all__ = ["BenchResult", "measure"]


@dataclasses.dataclass(frozen=True)
class BenchResult:
    """Mean and standard deviation of per-call device time, in ns."""

    average_time_ns: float
    std_deviation_ns: float
    samples: int

    @property
    def average_time_ms(self) -> float:
        return self.average_time_ns / 1e6


def measure(fn: Callable, args: Sequence = (), warmup: int = 3,
            iters: int = 20,
            flush: Optional[torch.Tensor] = None) -> BenchResult:
    """Per-call device time of ``fn(*args)`` from CUDA events; ``flush`` is
    zeroed before each timed call when given."""
    tensors = [a for a in args if isinstance(a, torch.Tensor)]
    if not tensors or any(t.device.type != "cuda" for t in tensors):
        raise ValueError("measure() times CUDA work: pass CUDA tensors")
    if iters < 1:
        raise ValueError(f"iters must be >= 1, got {iters}")
    with torch.cuda.device(tensors[0].device):
        for _ in range(warmup):
            fn(*args)
        events = [(torch.cuda.Event(enable_timing=True),
                   torch.cuda.Event(enable_timing=True)) for _ in range(iters)]
        for start, end in events:
            if flush is not None:
                flush.zero_()
            start.record()
            fn(*args)
            end.record()
        torch.cuda.synchronize()
    times = np.array([s.elapsed_time(e) for s, e in events]) * 1e6  # ms -> ns
    return BenchResult(
        average_time_ns=float(times.mean()),
        std_deviation_ns=float(times.std()),
        samples=iters,
    )
