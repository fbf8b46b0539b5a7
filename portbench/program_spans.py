"""The port's own profiler spans in a traced window, and what they split.

The port opens ``torch.profiler`` spans of its own while a profiler records
(``tensorfft_tpu_torch/tracing.py``): ``tfft.entry`` around each
``fft_split``/``ifft_split`` call, ``tfft.dispatch`` inside it, and
``tfft.launch.<symbol>`` around each C launcher call.  :func:`parse` reads a
chrome trace as ``trace.parse`` does and keeps, besides, those spans and
torch's ``cpu_op`` events inside them (:class:`ProgramTrace`).  With them:

* each device operation is named ``<launcher>/<kernel>``, the launcher being
  the ``tfft.launch.*`` span that holds its CUDA runtime launch event (the
  same ``correlation`` id), so kernels B and C, one symbol, get a row each;
* idle device time goes to the innermost open span of the benchmark's, the
  program's and those ``cpu_op`` events, the spans painted by nesting depth;
* the readers below give entry, dispatch and launch host time per call, the
  program's share of the idle time and the table builds in the window.

``run.py`` does not read these yet: it keeps ``trace.parse``'s spans only.

    python3 portbench/program_spans.py --workload <cell> --seed <n> --seconds <s>

runs one window of the cell as a ``--trace 1`` run does (profiler a quarter
in, ``trace.WARMUP`` + ``trace.ACTIVE`` steps), skips the check of its
outputs, and prints one JSON line: the readings, the breakdown by the
program's spans, the idle time as the benchmark's own spans label it, and
the launches the program counted in the window.
"""
from __future__ import annotations

import argparse
import bisect
import collections
import dataclasses
import json
import os
import random
import sys
import time
from pathlib import Path
from typing import Dict, List, Optional, Tuple

ROOT = Path(__file__).resolve().parent.parent
# Run as a script, Python puts portbench/ itself first on the path, where its
# modules would shadow others of the same name; the checkout's root replaces it.
if sys.path and Path(sys.path[0]).resolve() == ROOT / "portbench":
    sys.path[0] = str(ROOT)
elif str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from portbench import check, harness, spec, trace, traffic, work  # noqa: E402

PREFIX = "tfft."
ENTRY = "tfft.entry"
DISPATCH = "tfft.dispatch"
LAUNCH = "tfft.launch."
CPU_OP = "cpu_op"

Span = Tuple[float, float, str]


@dataclasses.dataclass
class ProgramTrace(trace.Trace):
    """A :class:`trace.Trace` whose device operations carry their launcher,
    with the program's spans and the ``cpu_op`` events inside them."""

    program_spans: List[Span] = dataclasses.field(default_factory=list)

    def _idle_by_span(self) -> collections.Counter:
        return idle_by_innermost(self.window, self.busy(),
                                 self.spans + self.program_spans)


def nesting_order(spans: List[Span]) -> List[Tuple[int, Span]]:
    """(depth, span) for every span, outer spans first: at an equal start the
    longer span is the outer one, and of two equal spans the one listed first."""
    order = sorted(range(len(spans)), key=lambda i: (spans[i][0], -spans[i][1], i))
    out, stack = [], []
    for i in order:
        start, end, _ = spans[i]
        while stack and stack[-1] <= start:
            stack.pop()
        out.append((len(stack), spans[i]))
        stack.append(end)
    return out


def idle_by_innermost(window: Tuple[float, float], busy: List[Tuple[float, float]],
                      spans: List[Span]) -> collections.Counter:
    """Idle seconds of the window (its time outside ``busy``) by the
    innermost span open over them; ``between_steps`` where none is."""
    lo, hi = window
    idle, cursor = [], lo
    for a, b in busy:
        if a > cursor:
            idle.append((cursor, a))
        cursor = max(cursor, b)
    if hi > cursor:
        idle.append((cursor, hi))
    edges = sorted({lo, hi, *(t for s in spans for t in s[:2])})
    labels = ["between_steps"] * (len(edges) - 1)
    for _, (start, end, name) in sorted(nesting_order(spans), key=lambda d: d[0]):
        for i in range(bisect.bisect_left(edges, start), bisect.bisect_left(edges, end)):
            labels[i] = name
    by_span = collections.Counter()
    for a, b in idle:
        for i in range(max(bisect.bisect_right(edges, a) - 1, 0),
                       min(bisect.bisect_left(edges, b), len(labels))):
            overlap = min(b, edges[i + 1]) - max(a, edges[i])
            if overlap > 0:
                by_span[labels[i]] += overlap * 1e-6
    return by_span


def _inside(intervals: List[Tuple[float, float, str]], t: float) -> Optional[str]:
    """The name of the interval of ``intervals`` (sorted, not overlapping)
    that holds ``t``, if one does."""
    i = bisect.bisect_right(intervals, (t, float("inf"), "")) - 1
    if i >= 0 and intervals[i][0] <= t <= intervals[i][1]:
        return intervals[i][2]
    return None


def parse(path: str, call_bounds: Dict[str, float]) -> Optional[ProgramTrace]:
    """``trace.parse`` of the chrome trace at ``path``, with the program's
    spans kept and its device operations named by launcher."""
    base = trace.parse(path, call_bounds)
    if base is None:
        return None
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    steps = sorted(s for s in base.spans if s[2] == "step")
    program = collections.defaultdict(list)   # thread -> tfft.* spans
    ops, device, launches = [], [], {}
    for e in events:
        if e.get("ph") != "X" or "dur" not in e:
            continue
        start, end = float(e["ts"]), float(e["ts"]) + float(e["dur"])
        cat, name, tid = e.get("cat"), e["name"], e.get("tid")
        if cat == "user_annotation" and name.startswith(PREFIX):
            program[tid].append((start, end, name))
        elif cat == CPU_OP:
            ops.append((start, end, name, tid))
        elif cat in trace.DEVICE_CATEGORIES:
            device.append((start, end, name, e.get("args", {}).get("correlation")))
        elif cat == "cuda_runtime" and "correlation" in e.get("args", {}):
            launches[e["args"]["correlation"]] = (start, tid)
    # The launch spans of a thread never overlap: the innermost that holds a
    # launch event is the only one.
    launch_spans = {tid: sorted((a, b, n[len(LAUNCH):]) for a, b, n in spans
                                if n.startswith(LAUNCH))
                    for tid, spans in program.items()}
    tops = {tid: _outermost(spans) for tid, spans in program.items()}
    shift = trace._device_clock_shift(
        steps, device, {c: t for c, (t, _) in launches.items()})
    lo, hi = base.window
    named = []
    for a, b, name, corr in device:
        a, b = a - shift(a), b - shift(a)
        if not (b > lo and a < hi):
            continue
        t, tid = launches.get(corr, (None, None))
        launcher = _inside(launch_spans.get(tid, []), t) if t is not None else None
        named.append((max(a, lo), min(b, hi), f"{launcher}/{name}" if launcher else name))
    kept = [(a, b, n) for spans in program.values() for a, b, n in spans]
    kept += [(a, b, n) for a, b, n, tid in ops if _inside(tops.get(tid, []), a)]
    return ProgramTrace(
        window=base.window, device_ops=named, spans=base.spans,
        call_bounds=base.call_bounds,
        program_spans=sorted(s for s in kept if lo <= s[0] < hi))


def _outermost(spans: List[Span]) -> List[Span]:
    """The spans no other span holds, sorted."""
    return sorted(s for depth, s in nesting_order(spans) if depth == 0)


# -- readers: each takes the ProgramTrace of a traced window -------------------


def _covered(parent: Span, children: List[Span]) -> float:
    """How much of ``parent`` the ``children`` (not overlapping) cover."""
    return sum(max(0.0, min(b, parent[1]) - max(a, parent[0])) for a, b, _ in children)


def _self_ms(t: ProgramTrace, name: str, child) -> Optional[float]:
    """Mean over the traced calls of the time inside ``name`` spans less the
    time their ``child(name)`` spans cover, in ms."""
    calls = len(t.calls())
    mine = [s for s in t.program_spans if s[2] == name]
    if not calls or not mine:
        return None
    inner = sorted(s for s in t.program_spans if child(s[2]))
    total = 0.0
    for s in mine:
        lo = bisect.bisect_left(inner, (s[0], -float("inf"), ""))
        hi = bisect.bisect_right(inner, (s[1], float("inf"), ""))
        total += s[1] - s[0] - _covered(s, inner[lo:hi])
    return total / calls * 1e-3


def entry_ms(t: ProgramTrace) -> Optional[float]:
    """Self time of ``tfft.entry`` (its ``tfft.dispatch`` child out) per call."""
    return _self_ms(t, ENTRY, lambda n: n == DISPATCH)


def dispatch_ms(t: ProgramTrace) -> Optional[float]:
    """Self time of ``tfft.dispatch`` (its ``tfft.launch.*`` children out) per call."""
    return _self_ms(t, DISPATCH, lambda n: n.startswith(LAUNCH))


def launch_ms(t: ProgramTrace) -> Optional[float]:
    """Time inside ``tfft.launch.*`` spans per call."""
    calls = len(t.calls())
    inside = [b - a for a, b, n in t.program_spans if n.startswith(LAUNCH)]
    if not calls or not inside:
        return None
    return sum(inside) / calls * 1e-3


def idle_in_program_pct(t: ProgramTrace) -> Optional[float]:
    """Share of the window's idle device time whose innermost open span is
    one of the program's, or a ``cpu_op`` inside one, in %."""
    if not t.device_ops or not t.program_spans:
        return None
    idle = t._idle_by_span()
    program = {n for _, _, n in t.program_spans}
    total = sum(idle.values())
    return 100.0 * sum(v for k, v in idle.items() if k in program) / total if total else None


def tables_built(before: Optional[dict], after: Optional[dict]) -> Optional[int]:
    """Table builds between two ``tracing.counters()`` readings."""
    if before is None or after is None:
        return None
    return sum(after["table_builds"].values()) - sum(before["table_builds"].values())


# -- the command -----------------------------------------------------------------


class Tracer(trace.Tracer):
    """``trace.Tracer`` whose result is a :class:`ProgramTrace`."""

    def result(self, call_bounds: Dict[str, float]) -> Optional[ProgramTrace]:
        self.stop()
        try:
            return parse(self._path, call_bounds) if self._written else None
        finally:
            os.unlink(self._path)


def measure(cell: spec.Cell, seed: int, seconds: float, device) -> dict:
    """One traced window of ``cell``; the result line's object."""
    import torch

    from tensorfft_tpu_torch import tracing

    entry = spec.load_module("entries", cell.entry)
    lay = traffic.layout(cell.traffic, cell.config)
    calls = entry.make(cell.config)
    pools = traffic.make_pools(lay, cell.config["precision"], seed, device)
    sync = torch.cuda.synchronize if device.type == "cuda" else (lambda: None)
    for d in lay.step:
        calls[d](*pools[d][0])
    sync()
    samplers = {d: check.Reservoir(1, random.Random(seed)) for d in lay.directions}
    tracer = Tracer(seconds, device.type)
    before = tracing.counters()
    _, steps, n_calls, _, call_times = harness.window(
        calls, entry.SPANS, pools, lay.step, seconds, sync, samplers, tracer)
    after = tracing.counters()
    flops, nbytes = entry.work_of_call(cell.config, lay.rows)
    bound = work.bound_seconds(flops, nbytes, cell.config["peak_flops"])
    t = tracer.result({entry.SPANS[d]: bound for d in lay.directions})
    if t is None:
        raise RuntimeError("the profiler recorded no step")
    enqueue = sum(call_times) / len(call_times) * 1e3 if call_times else None
    readings = {"entry_ms": entry_ms(t), "dispatch_ms": dispatch_ms(t),
                "launch_ms": launch_ms(t), "idle_in_program_pct": idle_in_program_pct(t),
                "tables_built": tables_built(before, after), "enqueue_ms": enqueue}
    parts = [readings[k] for k in ("entry_ms", "dispatch_ms", "launch_ms")]
    if enqueue and None not in parts:
        readings["traced_over_untraced"] = sum(parts) / enqueue
    # The benchmark's own labels of the same idle time: its spans alone.
    idle = {"benchmark": trace.Trace._idle_by_span(t), "program": t._idle_by_span()}
    in_calls = {k: sum(v[s] for s in entry.SPANS.values()) for k, v in idle.items()}
    return {
        "workload": cell.name, "seed": seed, "steps": len(steps), "calls": n_calls,
        "traced_calls": len(t.calls()), "device": str(device),
        "card": harness.card(device),
        "readings": readings,
        "call_idle_still_in_calls_pct": (
            100.0 * in_calls["program"] / in_calls["benchmark"]
            if in_calls["benchmark"] else None),
        "breakdown": t.breakdown(),
        "benchmark_idle_gaps": [[k, v] for k, v in idle["benchmark"].most_common(trace.TOP)],
        "launches": {k: after["launches"][k] - before["launches"][k]
                     for k in after["launches"] if after["launches"][k] != before["launches"][k]},
    }


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    args = parser.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("program_spans: needs a CUDA device", file=sys.stderr)
        return 2
    start = time.perf_counter()
    result = measure(spec.load_cell(args.workload), args.seed, args.seconds,
                     torch.device("cuda", 0))
    result["seconds"] = time.perf_counter() - start
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
