"""The traced part of a ``--trace 1`` run: ``torch.profiler`` over a steady
run of steps, reduced to device intervals and the benchmark's host spans.

The profiler starts a quarter into the window, discards ``WARMUP`` steps
(its own start-up), records ``ACTIVE`` steps and stops, so the trace stays
small whatever the window's length.  The chrome trace goes to a temporary
file under ``TMPDIR``, is read and deleted; nothing is kept.

Host spans are the benchmark's own (``torch.profiler.record_function``),
opened only while the profiler is on: ``step`` around each step, one span
per call named by the entry (``fft_split``, ``ifft_split``) and
``synchronize``.  The traced window runs
from the first recorded ``step`` span's start to the last one's end.
"""
from __future__ import annotations

import bisect
import collections
import contextlib
import dataclasses
import json
import os
import tempfile
from typing import Dict, List, Optional, Tuple

START_FRACTION = 0.25
WARMUP = 10
ACTIVE = 300
DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")
# Launch to kernel start on an idle H100, as a trace with aligned clocks read
# it (7.5-13 us, median about 9).
LAUNCH_LATENCY_US = 9.0
TOP = 10
_NO_SPAN = contextlib.nullcontext()


@dataclasses.dataclass
class Trace:
    """Times in microseconds on the profiler's clock."""

    window: Tuple[float, float]
    device_ops: List[Tuple[float, float, str]]   # (start, end, name), clipped
    spans: List[Tuple[float, float, str]]        # host spans in the window
    call_bounds: Dict[str, float]                # call span -> bound seconds

    @property
    def window_s(self) -> float:
        return (self.window[1] - self.window[0]) * 1e-6

    def busy(self) -> List[Tuple[float, float]]:
        """Union of the device intervals, merged and sorted."""
        merged: List[List[float]] = []
        for start, end, _ in sorted(self.device_ops):
            if merged and start <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], end)
            else:
                merged.append([start, end])
        return [(a, b) for a, b in merged]

    @property
    def busy_s(self) -> float:
        return sum(b - a for a, b in self.busy()) * 1e-6

    def calls(self):
        return [s for s in self.spans if s[2] in self.call_bounds]

    def breakdown(self) -> dict:
        """Device time by operation name, and idle device time by the host
        span that was open (innermost), the largest first."""
        ops = collections.Counter()
        for start, end, name in self.device_ops:
            ops[name] += (end - start) * 1e-6
        return {"device_ops": [[k, v] for k, v in ops.most_common(TOP)],
                "idle_gaps": [[k, v] for k, v in self._idle_by_span().most_common(TOP)]}

    def _idle_by_span(self) -> collections.Counter:
        lo, hi = self.window
        idle, cursor = [], lo
        for a, b in self.busy():
            if a > cursor:
                idle.append((cursor, a))
            cursor = max(cursor, b)
        if hi > cursor:
            idle.append((cursor, hi))
        # Label each piece between span edges with the innermost open span:
        # paint the steps first, then the spans nested inside them.
        edges = sorted({lo, hi, *(t for s in self.spans for t in s[:2])})
        labels = ["between_steps"] * (len(edges) - 1)
        for start, end, name in sorted(self.spans, key=lambda s: s[2] != "step"):
            for i in range(bisect.bisect_left(edges, start),
                           bisect.bisect_left(edges, end)):
                labels[i] = name
        by_span = collections.Counter()
        for a, b in idle:
            for i in range(max(bisect.bisect_right(edges, a) - 1, 0),
                           min(bisect.bisect_left(edges, b), len(labels))):
                overlap = min(b, edges[i + 1]) - max(a, edges[i])
                if overlap > 0:
                    by_span[labels[i]] += overlap * 1e-6
        return by_span


def parse(path: str, call_bounds: Dict[str, float]) -> Optional[Trace]:
    """Reduce a chrome trace to a :class:`Trace`; None without a step."""
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    spans, device, launches = [], [], {}
    for e in events:
        if e.get("ph") != "X" or "dur" not in e:
            continue
        start, end = float(e["ts"]), float(e["ts"]) + float(e["dur"])
        if e.get("cat") == "user_annotation":
            spans.append((start, end, e["name"]))
        elif e.get("cat") in DEVICE_CATEGORIES:
            device.append((start, end, e["name"], e.get("args", {}).get("correlation")))
        elif e.get("cat") == "cuda_runtime" and "correlation" in e.get("args", {}):
            launches[e["args"]["correlation"]] = start
    steps = sorted(s for s in spans if s[2] == "step")
    if not steps:
        return None
    shift = _device_clock_shift(steps, device, launches)
    device = [(a - shift(a), b - shift(a), n) for a, b, n, _ in device]
    lo, hi = steps[0][0], max(s[1] for s in steps)
    keep = {"step", "synchronize", *call_bounds}
    return Trace(
        window=(lo, hi),
        device_ops=[(max(a, lo), min(b, hi), n) for a, b, n in device
                    if b > lo and a < hi],
        spans=sorted(s for s in spans if s[2] in keep and lo <= s[0] < hi),
        call_bounds=call_bounds,
    )


def _device_clock_shift(steps, device, launches):
    """How far the trace's device timestamps run ahead of its host clock, as
    a linear function of time.  Over a trace of a second or more the two
    clocks were seen to drift apart by several hundred microseconds, which
    would put a device gap under the wrong host span.  Each step starts on an
    idle card (the previous step ended with a synchronize), so its first
    kernel starts ``LAUNCH_LATENCY_US`` after its launch; the shift is the
    least-squares line through the excess, over the steps."""
    starts = [s[0] for s in steps]
    first = {}
    for a, _, _, corr in device:
        launch = launches.get(corr)
        if launch is None:
            continue
        i = bisect.bisect_right(starts, launch) - 1
        if i >= 0 and launch < steps[i][1] and (i not in first or launch < first[i][0]):
            first[i] = (launch, a)
    if len(first) < 3:
        return lambda t: 0.0
    xs = [a for _, a in first.values()]   # the line is read at device times
    ys = [a - launch - LAUNCH_LATENCY_US for launch, a in first.values()]
    mx, my = sum(xs) / len(xs), sum(ys) / len(ys)
    sxx = sum((x - mx) ** 2 for x in xs)
    slope = sum((x - mx) * (y - my) for x, y in zip(xs, ys)) / sxx if sxx else 0.0
    return lambda t: my + slope * (t - mx)


class Tracer:
    """Starts the profiler a quarter into the window and stops it after
    ``WARMUP + ACTIVE`` steps or at the window's end; :meth:`result` then
    gives the :class:`Trace` (None when nothing was recorded)."""

    def __init__(self, seconds: float, device_type: str):
        import torch

        self._torch = torch
        self._start_at = START_FRACTION * seconds
        self._steps = 0
        self._prof = None
        self._done = False
        self._activities = [torch.profiler.ProfilerActivity.CPU]
        if device_type == "cuda":
            self._activities.append(torch.profiler.ProfilerActivity.CUDA)
        fd, self._path = tempfile.mkstemp(suffix=".json", prefix="portbench_trace_")
        os.close(fd)
        self._written = False
        # The profiler's first start takes seconds (its library's set-up):
        # pay it here, in set-up, and not inside the window.
        with torch.profiler.profile(activities=self._activities):
            torch.zeros(1)

    @property
    def recording(self) -> bool:
        """Whether the profiler is on (its warm-up steps included)."""
        return self._prof is not None

    def span(self, name: str):
        """A host span while the profiler is on; nothing otherwise, so the
        steps it does not record run as in an untraced run."""
        if self._prof is None:
            return _NO_SPAN
        return self._torch.profiler.record_function(name)

    def before_step(self, elapsed: float) -> None:
        if self._prof is None and not self._done and elapsed >= self._start_at:
            profiler = self._torch.profiler
            self._prof = profiler.profile(
                activities=self._activities,
                schedule=profiler.schedule(wait=0, warmup=WARMUP, active=ACTIVE,
                                           repeat=1),
                on_trace_ready=self._save)
            self._prof.start()

    def after_step(self) -> None:
        if self._prof is None:
            return
        self._prof.step()
        self._steps += 1
        if self._steps >= WARMUP + ACTIVE:
            self.stop()

    def stop(self) -> None:
        if self._prof is not None:
            self._prof.stop()
            self._prof = None
            self._done = True

    def _save(self, prof) -> None:
        prof.export_chrome_trace(self._path)
        self._written = True

    def result(self, call_bounds: Dict[str, float]) -> Optional[Trace]:
        self.stop()
        try:
            return parse(self._path, call_bounds) if self._written else None
        finally:
            os.unlink(self._path)
