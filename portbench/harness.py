"""One run of one cell: set-up, the measured window, the check of its outputs
and the metrics.  ``run.py`` is the command; this module is what it runs, so
tests and ``calibrate.py`` can drive a run with another callable in the
program's place.

Set-up (counted in ``setup_s``, its parts in ``setup_parts_s``): the
import of torch, the CUDA driver's start (``run.py`` marks both), the
entry's plan, the CUDA context and the input pools, and a warm-up of every
call of a step, holding as many outputs as the window's sample will, so
that nothing is built, loaded or first allocated inside the window.  The
window: steps back to back for ``seconds`` (a closed loop with one caller),
each step the traffic's calls on the next inputs of each direction's pool,
then one synchronize.  The inverse never reads the forward's output, so
every call reads its input from device memory.  Each step and each call is
timed on the host clock; the steps the profiler records (``--trace 1``) are
kept apart from the others, which the host-clock readers use.
"""
from __future__ import annotations

import contextlib
import dataclasses
import random
import subprocess
import time
from typing import Callable, Dict, List, Optional

import torch

from portbench import check, spec, traffic, work
from portbench.trace import Trace, Tracer

_NO_SPAN = contextlib.nullcontext()


@dataclasses.dataclass
class Run:
    """What a window leaves for the metric readers (``metrics/<name>.py``,
    each a ``read(run) -> float | None``)."""

    setup_s: float
    window_s: float
    step_times: List[float]          # every step of the window, seconds
    flops: float
    trace: Optional[Trace]
    untraced_step_times: List[float]  # the steps the profiler did not record
    untraced_call_times: List[float]  # host seconds of each call of those steps


def _no_span(name):
    return _NO_SPAN


def window(calls: Dict[str, Callable], spans: Dict[str, str], pools, step,
           seconds: float, sync: Callable, samplers, tracer: Optional[Tracer]):
    """Steps for ``seconds`` (at least one); returns (window seconds, step
    times, calls, times of the steps the profiler did not record, host
    times of their calls)."""
    span = tracer.span if tracer else _no_span
    cursor = {d: 0 for d in pools}
    step_times, n_calls, untraced, call_times = [], 0, [], []
    t0 = t = time.perf_counter()
    while not step_times or t - t0 < seconds:
        if tracer:
            tracer.before_step(t - t0)
        recorded = tracer is not None and tracer.recording
        with span("step"):
            ts = time.perf_counter()
            for d in step:
                p = cursor[d] % len(pools[d])
                cursor[d] += 1
                with span(spans[d]):
                    tc = time.perf_counter()
                    out = calls[d](*pools[d][p])
                    tc = time.perf_counter() - tc
                samplers[d].offer((p, *out))
                if not recorded:
                    call_times.append(tc)
            with span("synchronize"):
                sync()
            t = time.perf_counter()
        step_times.append(t - ts)
        if not recorded:
            untraced.append(t - ts)
        n_calls += len(step)
        if tracer:
            tracer.after_step()
    return t - t0, step_times, n_calls, untraced, call_times


def run(cell: spec.Cell, seed: int, seconds: float, trace: bool,
        device: torch.device, t_start: float,
        make_calls: Optional[Callable[[dict], Dict[str, Callable]]] = None,
        marks: Optional[List] = None) -> dict:
    """One run; returns the result line's object.  ``make_calls`` puts another
    callable in the program's place (the control, a planted fault); ``marks``
    are the (name, time) of the set-up's parts before this call, each part
    ending at its time."""
    marks = list(marks or []) + [("harness_and_cell", time.perf_counter())]
    entry = spec.load_module("entries", cell.entry)
    reference = spec.load_module("references", cell.entry)
    config = cell.config
    lay = traffic.layout(cell.traffic, config)
    calls = (make_calls or entry.make)(config)
    marks.append(("program_and_plan", time.perf_counter()))
    pools = traffic.make_pools(lay, config["precision"], seed, device)
    sync = torch.cuda.synchronize if device.type == "cuda" else (lambda: None)
    sync()
    marks.append(("context_and_pools", time.perf_counter()))

    k = check.sample_size(lay.rows * lay.n * 2 * work.STORAGE_BYTES[config["precision"]])
    held = [calls[d](*pools[d][i % lay.pool]) for i in range(k + 1) for d in lay.step]
    sync()
    del held
    marks.append(("warmup", time.perf_counter()))

    rng = random.Random(seed)
    samplers = {d: check.Reservoir(k, rng) for d in lay.directions}
    tracer = Tracer(seconds, device.type) if trace else None
    setup_s = time.perf_counter() - t_start
    window_s, step_times, n_calls, untraced, call_times = window(
        calls, entry.SPANS, pools, lay.step, seconds, sync, samplers, tracer)
    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0

    flops, nbytes = entry.work_of_call(config, lay.rows)
    bound = work.bound_seconds(flops, nbytes, config["peak_flops"])
    record = Run(setup_s=setup_s, window_s=window_s, step_times=step_times,
                 flops=flops * n_calls,
                 trace=tracer.result({entry.SPANS[d]: bound for d in lay.directions})
                 if tracer else None,
                 untraced_step_times=untraced, untraced_call_times=call_times)
    del calls  # the program's state; the reference runs after it is freed

    samples = {d: s.items for d, s in samplers.items()}
    numbers, failed = check.compare(samples, pools, reference, config["scaling"],
                                    cell.limits)
    metrics = {}
    for m in cell.metrics(trace):
        value = spec.load_module("metrics", m["name"]).read(record)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
           "count": cell.chips, "memory_peak_bytes": peak}
    result = {"correct": failed == 0 and all(s.seen for s in samplers.values()),
              "attempted": n_calls, "failed": failed, "metrics": metrics, "device": dev}
    if record.trace is not None:
        dev["busy_s"] = record.trace.busy_s
        dev["window_s"] = record.trace.window_s
        result["breakdown"] = record.trace.breakdown()
    result["setup_parts_s"] = {name: t - prev for (name, t), prev
                               in zip(marks, [t_start] + [t for _, t in marks])}
    result["card"] = card(device)
    result["steps"] = len(step_times)
    result["checks"] = {name: {"value": v, "limit": cell.limits[name]}
                        for name, v in numbers.items()}
    return result


def card(device: torch.device) -> str:
    """The card's name and power limit, as ``nvidia-smi`` reads them."""
    if device.type != "cuda":
        return "no card"
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader",
             f"--id={device.index or 0}"],
            capture_output=True, text=True, timeout=30, check=True).stdout.strip()
    except (OSError, subprocess.SubprocessError) as exc:
        return f"nvidia-smi not read ({type(exc).__name__})"
    return out
